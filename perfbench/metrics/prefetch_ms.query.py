"""The hot-set prefetch on the engine's worker, per micro-batch: the
wall time of the window's ``query.prefetch`` roots over its
``query.batch`` roots, ms."""

from perfbench.metrics._spans import roots


def read(ctx):
    batches = roots(ctx, "query.batch")
    if not batches:
        return None
    return 1e3 * sum(r.duration_s for r in roots(ctx, "query.prefetch")) \
        / len(batches)
