"""The decode arm a micro-batch: self time of the ``decode`` and
``h2d`` tiers (``query.decode`` and ``query.h2d``: host or device
decode, the packed bytes' copy and K1 on the device arm), ms."""

from perfbench.metrics._shared import tier_ms_per_batch


def read(ctx):
    return tier_ms_per_batch(ctx, ("decode", "h2d"))
