"""Device time per traced step of the host copies: Memcpy HtoD (the frames)
and DtoH (the outputs)."""


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace.device_s(lambda n: n.startswith(("Memcpy HtoD",
                                                   "Memcpy DtoH")))
    return t / ctx.trace.steps * 1e3 if t else None
