"""The whole GCN step's share of the card's float32 peak: the step's
operations (:func:`perfbench.gen.arith.gcn_step_flops`) over the traced
window's time a step, over 67 TFLOP/s."""

from perfbench.gen import arith


def read(ctx):
    c = ctx.counters
    if not c.get("step_s"):
        return None
    return 100.0 * c["flops"] / c["step_s"] / arith.FP32_FLOPS_PER_S
