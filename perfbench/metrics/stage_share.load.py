"""Percent of each load's wall time spent in the loader's staging
stage (``StreamStats.decode_s``: H2D of the packed bytes, K1, a stream
sync), summed over the window's loads.  A low share means the
producer's storage reads set the pace."""


def read(ctx):
    c = ctx.counters
    if c.get("wall_s", 0) <= 0:
        return None
    return 100.0 * c["decode_s"] / c["wall_s"]
