"""The engine's batching machinery a micro-batch: self time of the
``gather`` tier (``query.batch`` less the storage and decode spans it
encloses), ms."""

from perfbench.metrics._shared import tier_ms_per_batch


def read(ctx):
    return tier_ms_per_batch(ctx, ("gather",))
