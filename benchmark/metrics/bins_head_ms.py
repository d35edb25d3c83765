"""Device ms a traced step of the work launched under the metric model's
`prisma.model.bins_head`: the ZoeDepth head in float32 over the core's
features. None for a program without spans."""

from benchmark import spans


def read(ctx):
    return spans.device_ms_per_step(ctx.trace, ("prisma.model.bins_head",))
