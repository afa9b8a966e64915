"""The engine's fetch a micro-batch: self time of ``query.offsets`` and
``query.packed`` under ``query.batch`` (run merging, PG-Fuse's
``prefetch_range`` and ``pread`` over cached blocks; the storage reads
they cause are left to ``storage_ms.query``), ms."""

from perfbench.metrics._spans import self_ms_per_batch


def read(ctx):
    return self_ms_per_batch(ctx, ("query.offsets", "query.packed"))
