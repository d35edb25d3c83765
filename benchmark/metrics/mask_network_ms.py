"""Device ms a traced step of the work launched under SOLOv2's
`prisma.model.mask_backbone` (ResNet-101 and the FPN) and
`prisma.model.mask_head` (the mask features, the kernel and class
branches), wherever it ran after. None for a program without spans."""

from benchmark import spans


def read(ctx):
    return spans.device_ms_per_step(ctx.trace, ("prisma.model.mask_backbone",
                                                "prisma.model.mask_head"))
