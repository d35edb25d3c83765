"""Device time per traced step of the kernels that the frozen kernel_family
puts in 'elementwise, reductions, device copies'."""

from benchmark.families import ELEMENTWISE, kernel_family


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace.device_s(lambda n: kernel_family(n) == ELEMENTWISE)
    return t / ctx.trace.steps * 1e3 if t else None
