"""The whole PNA step's share of the card's float32 peak: the step's
operations (:func:`perfbench.gen.pna_arith.pna_step_flops`) over the
traced window's time a step, over 67 TFLOP/s."""

from perfbench.gen import arith


def read(ctx):
    c = ctx.counters
    if not c.get("step_s") or "n_layers" not in c:
        return None
    return 100.0 * c["flops"] / c["step_s"] / arith.FP32_FLOPS_PER_S
