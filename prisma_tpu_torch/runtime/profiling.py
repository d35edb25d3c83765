"""Spans and per-stage profiling (counterpart of
prisma_tpu/runtime/profiling.py).

Usage:
    with span("prisma.step.model"):      # a range on torch.profiler's trace
        ...
    with timed("prisma.setup.weights"):  # the same, and host seconds kept
        ...                              # in setup_seconds()
    prof = StageProfiler(enabled=True)
    with prof.stage("prisma.sink"):
        ...
    prof.report()  # prints per-stage totals, means, throughput

`span(name)` opens a `torch.profiler.record_function` only while a profiler
records on this thread, so its ranges sit on the profiler's clock beside the
CUDA activity they launch; otherwise it is a shared null context and costs
one flag read. The band steps open `prisma.step` once a call and, inside it,
`prisma.step.inputs`, `.model`, `.epilogue` and `.outputs`; the models open
`prisma.model.*` ranges under `.model`; the run loops open
`prisma.decode_wait` and `prisma.sink`.

Set PRISMA_TPU_PROFILE=1 to enable a StageProfiler's host totals in the band
drivers. A stage measures host time; the band's device step ends in a host
copy, so it includes device time. PRISMA_TPU_TRACE=<dir> additionally
records a torch.profiler trace (CPU and, with a card, CUDA activities)
between start_device_trace and stop_device_trace, written into <dir> as a
Chrome trace when it stops.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import Counter, defaultdict

import torch

# the set-up span of a band's weights: the loaders of weights/store.py (the
# checkpoint read or the random init, the strict load) and the bands' cast
# and move to the card
SETUP_WEIGHTS = "prisma.setup.weights"

_profiler_enabled = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_SETUP: dict[str, float] = defaultdict(float)
_OPEN: Counter = Counter()
_END = object()


def span(name: str):
    """A range `name` on the running profiler's trace; a null context when
    none records."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


@contextlib.contextmanager
def timed(name: str):
    """A set-up span: `span(name)`, and its host seconds added to
    setup_seconds()[name] whether a profiler runs or not (a span nested in
    another of the same name adds nothing of its own). Also a decorator."""
    _OPEN[name] += 1
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        _OPEN[name] -= 1
        if not _OPEN[name]:
            _SETUP[name] += time.perf_counter() - t0


def setup_seconds() -> dict[str, float]:
    """{set-up span: host seconds} over this process's `timed` spans."""
    return dict(_SETUP)


class StageProfiler:
    def __init__(self, enabled: bool | None = None):
        if enabled is None:
            enabled = os.environ.get("PRISMA_TPU_PROFILE", "0") == "1"
        self.enabled = enabled
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._trace_dir = os.environ.get("PRISMA_TPU_TRACE")
        self._trace = None

    @contextlib.contextmanager
    def host(self, name: str):
        """The host seconds of the block added to stage `name` when enabled,
        with no span (for a call that opens its own, as a band step does)."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    @contextlib.contextmanager
    def stage(self, name: str):
        """`span(name)` and the host totals of `host(name)`."""
        with span(name), self.host(name):
            yield

    def iterate(self, items, name: str):
        """items, each one's wait (its next()) timed as stage `name`."""
        it = iter(items)
        while True:
            with self.stage(name):
                item = next(it, _END)
            if item is _END:
                return
            yield item

    def start_device_trace(self) -> None:
        """Start the torch.profiler trace if PRISMA_TPU_TRACE names a
        directory and none is running."""
        if self._trace_dir and self._trace is None:
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._trace = profile(activities=activities)
            self._trace.start()

    def stop_device_trace(self) -> str | None:
        """Stop the running trace and write it into PRISMA_TPU_TRACE as a
        Chrome trace -> its path (None if no trace ran)."""
        if self._trace is None:
            return None
        trace, self._trace = self._trace, None
        trace.stop()
        os.makedirs(self._trace_dir, exist_ok=True)
        path = os.path.join(self._trace_dir, f"prisma_tpu_torch_{os.getpid()}_"
                            f"{time.time_ns()}.pt.trace.json")
        trace.export_chrome_trace(path)
        return path

    def report(self, items: int | None = None,
               counts: dict[str, Counter] | None = None) -> str:
        """Print and return the stages' host totals, the set-up spans, the
        kernel builds, the host copies and each of `counts` (a name and its
        Counter, e.g. the fused loop's dispatches), when enabled."""
        if not self.enabled or not self.totals:
            return ""
        lines = ["[prisma_tpu_torch profile]"]
        total = sum(self.totals.values())
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"  {name:<26} {t:8.3f}s total  "
                         f"{t / max(n, 1) * 1000:8.2f}ms/call  x{n}  "
                         f"({t / total * 100:5.1f}%)")
        if items:
            lines.append(f"  {'throughput':<26} {items / total:8.2f} items/s "
                         f"over {items}")
        for name, t in sorted(_SETUP.items()):
            lines.append(f"  {name:<26} {t:8.3f}s set-up")
        from prisma_tpu_torch.ops.cuda import build
        from prisma_tpu_torch.runtime import host_copy
        if build.BUILT or build.CACHED:
            lines.append("  kernels: nvcc builds "
                         + _counted(build.BUILT) + "; cache loads "
                         + _counted(build.CACHED))
        if host_copy.COPIES:
            lines.append("  host copies: " + host_copy.summary())
        for name, counter in (counts or {}).items():
            lines.append(f"  {name}: " + _counted(counter))
        out = "\n".join(lines)
        print(out)
        return out


def _counted(counter: Counter) -> str:
    return ", ".join(f"{k} x{n}" for k, n in sorted(counter.items())) or "none"
