"""A traced stretch put down to the program's spans, two ways.

The device's idle time by the stage of the program's band step that the
host was in: each gap between the device's busy intervals inside the window
goes to the `prisma.step.*` range on the main thread that covers the gap's
middle, or to IN_STEP (inside `prisma.step`, under no stage) or OUTSIDE (no
`prisma.step`: the benchmark's own ranges, between steps). Every gap
counts; the stages sum to the window less the busy time.

The device's time by the span that launched it: each kernel, copy and set
goes, by the correlation id of its launch, to the innermost `prisma.` range
on the main thread that was open when the CUDA runtime or driver call that
launched it was made, whenever the work itself ran; to OUTSIDE_SPANS where
no such range was open or another thread launched it, and to NO_LAUNCH
where the trace holds no launch of that id. Every device event counts once;
the spans sum to `Trace.device_s(lambda n: True)`. (A frozen copy of
`span_stages` in prisma_tpu_torch/runtime/profile_step.py, which gives an
event to every range open at its launch, on the launching thread;
`key_averages()` would put a kernel under the torch operator that launched
it, and so misses the port's kernels, launched through ctypes outside any
operator.)

A program that opens no `prisma.` range (one older than its spans) gives
None."""

from __future__ import annotations

from collections import defaultdict

import numpy as np

PREFIX = "prisma."
STEP = "prisma.step"
STAGE_PREFIX = STEP + "."
IN_STEP = "in prisma.step, no stage"
OUTSIDE = "outside the step"
OUTSIDE_SPANS = "outside any span"
NO_LAUNCH = "launch not in the trace"


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


def _has_spans(trace) -> bool:
    return trace is not None and any(h[0].startswith(PREFIX)
                                     for h in trace.host)


def idle_by_stage(trace) -> dict | None:
    """{stage: idle seconds over the traced stretch}, or None where the trace
    holds no `prisma.` range."""
    if not _has_spans(trace):
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


def device_by_span(trace) -> dict | None:
    """{span: device seconds over the traced stretch launched under it},
    with OUTSIDE_SPANS and NO_LAUNCH; None where the trace holds no
    `prisma.` range."""
    if not _has_spans(trace):
        return None
    ranges = [h for h in trace.host if h[0].startswith(PREFIX)]
    at = [trace.launches.get(c) for c in trace.device_corr]
    on_main = np.array([a is not None and a[1] == trace.main_thread
                        for a in at], dtype=bool)
    launched = np.array([a[0] if a is not None else 0 for a in at],
                        dtype=np.int64)
    names = [None] * len(at)
    mine = np.nonzero(on_main)[0]
    for i, name in zip(mine, _cover(ranges, launched[mine])):
        names[i] = name
    out = defaultdict(float)
    for (_, s, e), a, name in zip(trace.device, at, names):
        out[name or (OUTSIDE_SPANS if a is not None else NO_LAUNCH)] += \
            (e - s) * 1e-9
    return dict(out)


def device_ms_per_step(trace, names) -> float | None:
    """Device ms a traced step launched under the spans `names`; None where
    the trace holds no `prisma.` range."""
    by_span = device_by_span(trace)
    if by_span is None:
        return None
    return sum(by_span.get(n, 0.0) for n in names) / trace.steps * 1e3
