"""PG-Fuse's underlying reads a micro-batch: self time of the
``storage`` tier (``pgfuse.read`` spans under the engine's), ms."""

from perfbench.metrics._shared import tier_ms_per_batch


def read(ctx):
    return tier_ms_per_batch(ctx, ("storage",))
