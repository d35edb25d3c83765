"""The device's idle time in a traced stretch put down to the stage of the
program's band step that the host was in: each gap between the device's
busy intervals inside the window goes to the `prisma.step.*` range on the
main thread that covers the gap's middle, or to IN_STEP (inside
`prisma.step`, under no stage) or OUTSIDE (no `prisma.step`: the
benchmark's own ranges, between steps). Every gap counts; the stages sum to
the window less the busy time. A program that opens no `prisma.` range (one
older than its spans) gives None."""

from __future__ import annotations

from collections import defaultdict

import numpy as np

PREFIX = "prisma."
STEP = "prisma.step"
STAGE_PREFIX = STEP + "."
IN_STEP = "in prisma.step, no stage"
OUTSIDE = "outside the step"


def gaps(trace) -> list:
    """(start ns, end ns) of each idle gap inside the window."""
    edges = [trace.t0] + [t for iv in trace.busy_intervals for t in iv] \
        + [trace.t1]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def _cover(spans: list, mids: np.ndarray) -> list:
    """For each middle, the name of the innermost span that covers it, or
    None."""
    out = [None] * len(mids)
    best = np.full(len(mids), np.inf)
    for name, s, e in spans:
        inside = (mids >= s) & (mids <= e) & (e - s < best)
        best[inside] = e - s
        for i in np.nonzero(inside)[0]:
            out[i] = name
    return out


def idle_by_stage(trace) -> dict | None:
    """{stage: idle seconds over the traced stretch}, or None where the trace
    holds no `prisma.` range."""
    if trace is None or not any(h[0].startswith(PREFIX) for h in trace.host):
        return None
    steps = [h for h in trace.host if h[0] == STEP]
    stages = [h for h in trace.host if h[0].startswith(STAGE_PREFIX)]
    found = gaps(trace)
    mids = np.array([(s + e) // 2 for s, e in found], dtype=np.int64)
    in_stage = _cover(stages, mids)
    in_step = _cover(steps, mids)
    out = defaultdict(float)
    for (s, e), stage, step in zip(found, in_stage, in_step):
        out[stage or (IN_STEP if step else OUTSIDE)] += (e - s) * 1e-9
    return dict(out)


def idle_ms_per_step(trace, names) -> float | None:
    """Idle ms a traced step under the stages `names`; None where the trace
    holds no `prisma.` range."""
    by_stage = idle_by_stage(trace)
    if by_stage is None:
        return None
    return sum(by_stage.get(n, 0.0) for n in names) / trace.steps * 1e3
