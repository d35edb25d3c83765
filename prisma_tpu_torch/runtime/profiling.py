"""Per-stage pipeline profiling (counterpart of prisma_tpu/runtime/profiling.py).

Usage:
    prof = StageProfiler(enabled=True)
    with prof.stage("decode"):
        ...
    prof.report()  # prints per-stage totals, means, throughput

Set PRISMA_TPU_PROFILE=1 to enable in the band drivers. A stage measures host
time; the band's device step ends in a host copy, so it includes device time.
PRISMA_TPU_TRACE=<dir> additionally records a torch.profiler trace (CPU and,
with a card, CUDA activities) between start_device_trace and
stop_device_trace, written into <dir> as a Chrome trace when it stops.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


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
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def start_device_trace(self) -> None:
        """Start the torch.profiler trace if PRISMA_TPU_TRACE names a
        directory and none is running."""
        if self._trace_dir and self._trace is None:
            import torch
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

    def report(self, items: int | None = None) -> str:
        if not self.enabled or not self.totals:
            return ""
        lines = ["[prisma_tpu_torch profile]"]
        total = sum(self.totals.values())
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            line = (f"  {name:<12} {t:8.3f}s total  {t / max(n, 1) * 1000:8.2f}ms/call"
                    f"  x{n}  ({t / total * 100:5.1f}%)")
            lines.append(line)
        if items:
            lines.append(f"  throughput   {items / total:8.2f} items/s over {items}")
        out = "\n".join(lines)
        print(out)
        return out
