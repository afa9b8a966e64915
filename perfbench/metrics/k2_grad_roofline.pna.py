"""``k2_grad``'s share of its bound in the PNA cell: per step the
backward of the same two sums a layer that ``k2_roofline.pna`` counts
(D ``d_hidden``) at :func:`perfbench.gen.arith.k2_grad_bytes`, against
the device time of every ``k2_grad`` kernel (the repeated mean's
backward included, uncounted)."""

from perfbench.gen import arith


def read(ctx):
    tr, c = ctx.trace, ctx.counters
    if tr is None or not c.get("steps") or "n_layers" not in c:
        return None
    per_step = 2 * c["n_layers"] * arith.k2_grad_bytes(
        c["e_slots"], c["d_hidden"], c["grad_rows"])
    return arith.roofline_share(per_step * c["steps"],
                                tr.seconds(tr.kernels("k2_grad")))
