"""Host seconds of the run's process under the program's set-up span
`prisma.setup.weights`: the band loader's checkpoint read and strict load,
and the cast and move to the card (`profiling.setup_seconds()`). None for
a program that keeps no such table."""

import importlib

SPAN = "prisma.setup.weights"


def read(ctx):
    try:
        profiling = importlib.import_module(
            "prisma_tpu_torch.runtime.profiling")
    except ImportError:
        return None
    table = getattr(profiling, "setup_seconds", None)
    return table().get(SPAN) if table is not None else None
