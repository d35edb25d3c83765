"""Device ms a traced step of the work launched while the program's band
step is in `prisma.step.epilogue`, wherever it ran after: the depth step's
per-frame min, max and heat map, the flow step's float32 casts, HSV images
and consistency masks. None for a program without spans."""

from benchmark import spans


def read(ctx):
    return spans.device_ms_per_step(ctx.trace, ("prisma.step.epilogue",))
