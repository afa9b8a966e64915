"""Percent of the hot-set tier's lookups in the window that it
answered (``HotSetStats`` hits over lookups)."""


def read(ctx):
    c = ctx.counters
    if not c.get("hotset_lookups"):
        return None
    return 100.0 * c["hotset_hits"] / c["hotset_lookups"]
