"""The 90th percentile, over every step of the window, of a step's host
time from the call with host frames to the returned host arrays."""

import numpy as np


def read(ctx):
    return float(np.percentile(ctx.step_s, 90)) * 1e3
