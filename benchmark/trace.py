"""The reduction of a torch.profiler trace of a stretch of steps to what the
per-layer metrics read: the device's kernels, copies and sets with their
times and the correlation ids of their launches, the host's ranges and
operations, the launches (CUDA runtime and driver calls) with their threads
and times, the traced wall window, the device's busy time in it, and the
idle gaps labelled by what the host was doing."""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from benchmark.families import kernel_family

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
BENCH_PREFIX = "bench."
# the host events that launch device work: CUDA runtime calls (cudaLaunchKernel,
# cudaMemcpyAsync, ...; also those of the port's own kernels, made from ctypes
# outside any torch operator) and driver calls (cuLaunchKernel)
LAUNCH_PREFIX = "cu"


def _activity(e) -> str:
    """The event's kineto activity ('kernel', 'gpu_memcpy', ...); some
    builds of torch give '' for every device event."""
    try:
        return e.activity_type()
    except AttributeError:
        return ""


class Trace:
    """One profiled stretch of `steps` steps, from the kineto results of
    torch.profiler (CPU and CUDA activities).

    device: (name, start ns, end ns) of each device event; device_corr: the
    correlation id of each one's launch, in the same order; launches:
    {correlation id: (start ns, thread)} of the host's launch calls on any
    thread; host: (name, start ns, end ns) of the host's events on the
    main thread, the one that opens the benchmark's ranges."""

    def __init__(self, kineto_results, steps: int):
        self.steps = steps
        self.device, self.host, self.device_corr = [], [], []
        self.launches = {}
        self.main_thread = None
        for e in kineto_results.events():
            span = (e.name(), e.start_ns(), e.end_ns())
            act = _activity(e)
            if act in DEVICE_ACTIVITIES or (
                    e.device_type() == torch.autograd.DeviceType.CUDA
                    and not e.is_user_annotation()
                    and "annotation" not in act):
                self.device.append(span)
                self.device_corr.append(e.correlation_id())
            elif e.device_type() == torch.autograd.DeviceType.CPU:
                self.host.append(span + (e.start_thread_id(),))
                if e.name().startswith(BENCH_PREFIX):
                    self.main_thread = e.start_thread_id()
                if e.name().startswith(LAUNCH_PREFIX):
                    self.launches[e.correlation_id()] = (e.start_ns(),
                                                         e.start_thread_id())
        self.host = [h[:3] for h in self.host if h[3] == self.main_thread]
        bench = [h for h in self.host if h[0].startswith(BENCH_PREFIX)]
        if not bench:
            raise RuntimeError("the trace holds none of the benchmark's "
                               "ranges")
        self.t0 = min(h[1] for h in bench)
        self.t1 = max(h[2] for h in bench)
        self.busy_intervals = self._union()

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def _union(self) -> list:
        spans = sorted((max(s, self.t0), min(e, self.t1))
                       for _, s, e in self.device
                       if e > self.t0 and s < self.t1)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals) * 1e-9

    def device_s(self, keep) -> float:
        """Seconds of device work whose name `keep` accepts, over the
        stretch (each event's own duration; overlaps count twice)."""
        return sum(e - s for n, s, e in self.device if keep(n)) * 1e-9

    def families(self) -> dict:
        out = defaultdict(float)
        for n, s, e in self.device:
            out[kernel_family(n)] += (e - s) * 1e-9
        return dict(out)

    def idle_gaps(self, label_top: int = 400) -> dict:
        """{what the host was doing: idle seconds}: the gaps between the
        device's busy intervals inside the window, the longest `label_top`
        of them labelled by the benchmark range and the innermost host
        operation that cover the gap's middle; the rest as 'short gaps'."""
        edges = [self.t0] + [t for iv in self.busy_intervals for t in iv] \
            + [self.t1]
        gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
                for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        names = [h[0] for h in self.host]
        starts = np.array([h[1] for h in self.host], dtype=np.int64)
        ends = np.array([h[2] for h in self.host], dtype=np.int64)
        out = defaultdict(float)
        for length, s, e in gaps[:label_top]:
            mid = (s + e) // 2
            cover = np.nonzero((starts <= mid) & (ends >= mid))[0]
            inner = max(cover, key=lambda i: (starts[i], -ends[i]),
                        default=None)
            outer = [names[i] for i in cover
                     if names[i].startswith(BENCH_PREFIX)]
            label = outer[0] if outer else "outside the benchmark's ranges"
            if inner is not None and not names[inner].startswith(BENCH_PREFIX):
                label += " / " + names[inner]
            out[label] += length * 1e-9
        rest = sum(g[0] for g in gaps[label_top:]) * 1e-9
        if rest:
            out["short gaps (not labelled)"] += rest
        return dict(out)

    def breakdown(self, top: int = 10) -> dict:
        """The device families and the idle labels that took the most
        seconds, per traced step."""
        def ranked(d):
            return [[k, v / self.steps] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": ranked(self.families()),
                "idle_gaps": ranked(self.idle_gaps())}
