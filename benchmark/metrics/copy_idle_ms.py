"""Idle ms of the device a traced step while the program's band step is in
`prisma.step.inputs` (the frames made a tensor and moved to the card) or
`prisma.step.outputs` (the outputs allocated and copied to pageable host
memory): the host side of the copies. None for a program without spans."""

from benchmark import spans


def read(ctx):
    return spans.idle_ms_per_step(ctx.trace, ("prisma.step.inputs",
                                              "prisma.step.outputs"))
