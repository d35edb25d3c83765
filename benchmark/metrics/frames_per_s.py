"""Video frames whose band outputs reached host memory in the window, over
the window's seconds (host clock). A step that fails adds nothing."""


def read(ctx):
    return ctx.frames_done / ctx.window_s
