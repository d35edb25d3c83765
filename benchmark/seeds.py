"""Independent streams drawn from one --seed: the weights, the frames and
the sample of outputs that the reference checks each get their own."""

from __future__ import annotations

import numpy as np

WEIGHTS, FRAMES, SAMPLE = 0, 1, 2


def substream(seed: int, stream: int) -> int:
    """A 63-bit seed for one stream of a run's --seed (any whole number)."""
    ss = np.random.SeedSequence([abs(int(seed)), int(seed < 0), stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))
