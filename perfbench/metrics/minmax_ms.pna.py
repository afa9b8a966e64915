"""Device milliseconds a step in the max and min aggregators' forward
``index_reduce`` kernels (``models/gnn/layers.py::scatter_max``; the
min is the max of the negated messages).  On the H100 with torch
2.11.0+cu128 ``index_reduce(..., "amax")`` launches
``indexFuncLargeIndex<..., ReduceMaximum>``: the needle is the reduce
functor's name, which no other kernel of the step carries."""

NEEDLES = ("ReduceMaximum", "ReduceMinimum")


def read(ctx):
    tr, c = ctx.trace, ctx.counters
    if tr is None or not tr.device or not c.get("steps") \
            or "n_layers" not in c:
        return None
    return 1e3 * tr.seconds(tr.kernels(*NEEDLES)) / c["steps"]
