"""Per-stage pipeline profiling (counterpart of prisma_tpu/runtime/profiling.py,
without the JAX device trace).

Usage:
    prof = StageProfiler(enabled=True)
    with prof.stage("decode"):
        ...
    prof.report()  # prints per-stage totals, means, throughput

Set PRISMA_TPU_PROFILE=1 to enable in the band drivers. A stage measures host
time; the band's device step ends in a host copy, so it includes device time.
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
