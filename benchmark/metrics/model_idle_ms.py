"""Idle ms of the device a traced step while the program's band step is in
`prisma.step.model`: the host's syncs and launch gaps inside the model.
None for a program without spans."""

from benchmark import spans


def read(ctx):
    return spans.idle_ms_per_step(ctx.trace, ("prisma.step.model",))
