"""K2's share of its bound in the PNA cell: per step the two sums a
layer that the step needs, the messages' and their squares' (D
``d_hidden``, for the mean and the std) at
:func:`perfbench.gen.arith.k2_bytes`, against the device time of all of
K2's forward kernels.  The mean summed again inside the std and the
in-degree sums are not counted: a step that repeats them spends time on
no counted bytes."""

from perfbench.gen import arith


def read(ctx):
    tr, c = ctx.trace, ctx.counters
    if tr is None or not c.get("steps") or "n_layers" not in c:
        return None
    ops = [o for o in tr.kernels("k2_") if "k2_grad" not in o.name]
    per_step = 2 * c["n_layers"] * arith.k2_bytes(
        c["e_slots"], c["d_hidden"], c["n_slots"], c["valid_edges"])
    return arith.roofline_share(per_step * c["steps"], tr.seconds(ops))
