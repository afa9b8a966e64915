"""K1's share of its bound: the window's decoded ids at ``b + 4`` bytes
each over HBM bandwidth, against K1's device time in the trace."""

from perfbench.gen import arith


def read(ctx):
    tr, c = ctx.trace, ctx.counters
    if tr is None or not c.get("edges"):
        return None
    secs = tr.seconds(tr.kernels("decode_vec4", "decode_scalar"))
    return arith.roofline_share(arith.k1_bytes(c["edges"], c["b"]), secs)
