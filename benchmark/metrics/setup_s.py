"""Seconds from the process's start to the first timed step: imports, the
card, the weights made and loaded through the band's loader, the kernels
built or loaded, the frames made and the warm-up steps."""


def read(ctx):
    return ctx.setup_s
