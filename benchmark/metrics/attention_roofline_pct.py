"""The sum over a step's attention calls of each call's bound (the larger
of its operations at the bf16 peak and its bytes at the memory rate, from
the shapes the configuration and traffic fix), over the device time per
traced step of the kernels that do attention (roofline/attention.json)."""

from benchmark.roofline import attention


def read(ctx):
    if ctx.trace is None or ctx.peak is None:
        return None
    t = ctx.trace.device_s(attention.is_attention) / ctx.trace.steps
    if not t:
        return None
    bound = sum(attention.bound_s(c, ctx.peak) for c in ctx.attention_calls())
    return 100.0 * bound / t
