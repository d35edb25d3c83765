"""The products one step needs (linears, convolutions, attention, counted
from the configuration and the traffic on the reference's graph), over the
mean host time of the traced run's untraced steps and the card's bf16
peak."""


def read(ctx):
    if ctx.peak is None or not ctx.untraced_step_s:
        return None
    mean_s = sum(ctx.untraced_step_s) / len(ctx.untraced_step_s)
    return 100.0 * ctx.step_flops() / mean_s / ctx.peak["bf16_flop_s"]
