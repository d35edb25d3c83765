"""Device ms a traced step of the work launched under SOLOv2's
`prisma.model.mask_results`: each frame's point NMS, top-K, dynamic masks,
matrix NMS, upsample to the frame and instance slab. None for a program
without spans."""

from benchmark import spans


def read(ctx):
    return spans.device_ms_per_step(ctx.trace, ("prisma.model.mask_results",))
