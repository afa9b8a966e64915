"""``k2_grad``'s share of its bound over the traced steps: per step the
backward of layer 1's sum (D ``d_hidden``) at
:func:`perfbench.gen.arith.k2_grad_bytes`, against its device time."""

from perfbench.gen import arith


def read(ctx):
    tr, c = ctx.trace, ctx.counters
    if tr is None or not c.get("steps"):
        return None
    per_step = arith.k2_grad_bytes(c["e_slots"], c["d_hidden"],
                                   c["grad_rows"])
    return arith.roofline_share(per_step * c["steps"],
                                tr.seconds(tr.kernels("k2_grad")))
