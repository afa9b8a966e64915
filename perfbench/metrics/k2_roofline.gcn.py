"""K2's share of its bound over the traced steps: per step the two
layers' sums (D ``d_in``, ``d_hidden``) at
:func:`perfbench.gen.arith.k2_bytes`, against the device time of all of
K2's forward kernels.  The in-degree is not counted: the step needs it
once per graph, so a step that sums it again spends time on no
counted bytes."""

from perfbench.gen import arith


def read(ctx):
    tr, c = ctx.trace, ctx.counters
    if tr is None or not c.get("steps"):
        return None
    ops = [o for o in tr.kernels("k2_") if "k2_grad" not in o.name]
    per_step = sum(arith.k2_bytes(c["e_slots"], d, c["n_slots"],
                                  c["valid_edges"])
                   for d in (c["d_in"], c["d_hidden"]))
    return arith.roofline_share(per_step * c["steps"], tr.seconds(ops))
