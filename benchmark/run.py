"""The benchmark of prisma_tpu_torch: one run of one cell on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or `python3 -m benchmark.run ...`) from the root of a checkout. The cell is
found by name in BENCHMARK.json; its configuration, traffic, limits and
metrics are files found by name under benchmark/:
- configs/<config>.json, the sizes as run (with `reference`, the path of
  its plain reference from the checkout's root), and configs/<config>.py,
  its builder (below);
- traffic/<traffic>.json, read by the one frame generator (frames.py);
- limits/<cell>.json, the limit of each number that decides `correct`;
- metrics/<metric>.py, a reader `read(ctx)` of each metric, returning None
  where it finds nothing to read.

A configuration's builder module has these names, which this file, the
control (control.py) and the tests (tests/) call:
- OVERLAP: frames that consecutive inputs share; a step counts the input's
  frames less OVERLAP, and each of its outputs has that many rows.
- PRIMARY: the output that the planted fault "one answer altered" alters.
- TINY: the configuration's overrides that run it on the CPU in seconds
  (narrow, float32), for the tests (tests/tiny.py).
- param_specs(cfg): the weights the benchmark makes (weights.py).
- save_checkpoint(sd, models_dir, cfg): writes them under the checkpoints'
  real names and keys in models_dir; returns the path written, or a list
  of the paths where the configuration has several checkpoints. The run
  removes each of them afterwards, whether it failed or not.
- load_reference_weights(saved, device): the float32 weights for the
  reference from what save_checkpoint returned.
- build_step(cfg, traffic, models_dir, device): the port's step, built
  through the band's own builders and loader: host uint8 frames [T, H, W, 3]
  -> {name: host array}.
- reference(sd, frames, cfg, traffic, ops): the reference's outputs for
  one input, on frames' device (reference/common.Ops carries the products).
- compare(out, ref): {number: value} for one input.
- NULL_FLOOR, and optionally RATIOS: how `judge` turns the sample's
  compared values into the numbers held to the cell's limits.
- step_flops(cfg, traffic), attention_calls(cfg, traffic): one step's work.

A configuration is added as new files only: its .json and builder under
configs/, its reference under reference/, a limits file of each cell, and
its entries in BENCHMARK.json; a new traffic mix or per-layer metric is one
more file each (the device ms a step launched under a span of the program:
`spans.device_ms_per_step`, as metrics/epilogue_ms.py). No file already
here needs an edit.

A run finds the card or fails, makes the weights from the seed on the card,
saves them under the checkpoints' real names and loads them through the
port's own loader, makes a pool of host frames from the seed, warms the
cell's one input shape, then calls the step in a closed loop for --seconds.
With --trace 1, torch.profiler covers a stretch of steps after the first
half of the window, and the per-layer metrics are read from it. Once the
window has closed and the program's state is freed, the plain reference
checks one output of each input of the pool, drawn from the seed among
the window's steps on that input. The last line
of standard output is the result as one JSON object.
"""

from __future__ import annotations

import os
import sys
import time

T_TOP = time.perf_counter()


def _process_age() -> float:
    """Seconds since this process started (Linux /proc; 0 where absent)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


AGE_AT_TOP = _process_age()
BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import frames, seeds, spans, weights  # noqa: E402
from benchmark.trace import Trace  # noqa: E402
from benchmark.reference.common import Ops, bf16_round, no_tf32  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "prisma_tpu")
TRACE_WARMUP, TRACE_ACTIVE = 1, 5


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


class Cell:
    """A cell of BENCHMARK.json with its files."""

    def __init__(self, manifest: dict, name: str, bench_dir: str = BENCH_DIR):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.name = name
        self.spec = cells[name]
        self.cfg = load_json(bench_dir, "configs",
                             self.spec["config"] + ".json")
        self.builder = load_module(
            os.path.join(bench_dir, "configs", self.spec["config"] + ".py"),
            "benchmark_config_" + self.spec["config"].replace(".", "_"))
        self.traffic = load_json(bench_dir, "traffic",
                                 self.spec["traffic"] + ".json")
        self.limits = load_json(bench_dir, "limits", name + ".json")["limits"]

        def mine(m):
            return name in m.get("workloads", [name])

        self.end_to_end = [m for m in manifest["end_to_end"] if mine(m)]
        self.per_layer = [m for m in manifest["per_layer"] if mine(m)]
        self.readers = {
            m["name"]: load_module(os.path.join(bench_dir, "metrics",
                                                m["name"] + ".py"),
                                   "benchmark_metric_" + m["name"])
            for m in self.end_to_end + self.per_layer}

    @property
    def frames_per_step(self) -> int:
        return self.traffic["frames_per_input"] - self.builder.OVERLAP


class Context:
    """What the metric readers read."""

    def __init__(self, cell: Cell, window: dict, setup_s: float, kind: str):
        self.cell = cell
        self.setup_s = setup_s
        self.frames_done = window["frames_done"]
        self.window_s = window["window_s"]
        self.step_s = window["step_s"]
        self.untraced_step_s = window["untraced_step_s"]
        self.peak_bytes = window["peak_bytes"]
        self.trace = window["trace"]
        self.peak = load_json(BENCH_DIR, "peaks.json").get(kind)
        self._flops = None

    def step_flops(self) -> float:
        if self._flops is None:
            self._flops = self.cell.builder.step_flops(self.cell.cfg,
                                                       self.cell.traffic)
        return self._flops

    def attention_calls(self) -> list:
        return self.cell.builder.attention_calls(self.cell.cfg,
                                                 self.cell.traffic)


def well_formed(out, n: int) -> bool:
    return isinstance(out, dict) and bool(out) and all(
        isinstance(v, np.ndarray) and v.shape[:1] == (n,)
        for v in out.values())


def measure(step, pool: list, seconds: float, trace: bool, n_frames: int,
            sample_seed: int, device: str) -> dict:
    """The closed loop: one step after the other over the pool's inputs for
    `seconds` (with trace, untraced for half of them, then a profiled
    stretch of TRACE_WARMUP + TRACE_ACTIVE steps, then the end)."""
    from torch.profiler import ProfilerActivity, profile, record_function, \
        schedule

    rng = random.Random(sample_seed)
    kept, seen = {}, {}  # one output of each input, drawn from the seed
    step_s, untraced = [], []
    attempted = failed = frames_done = 0
    prof = None
    results = []
    cuda = device.startswith("cuda")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    deadline = t_start + (seconds / 2 if trace else seconds)
    i = 0
    while True:
        if prof is None and time.perf_counter() >= deadline:
            if not trace or results:
                break
            activities = [ProfilerActivity.CPU] + \
                ([ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=activities,
                           schedule=schedule(wait=0, warmup=TRACE_WARMUP,
                                             active=TRACE_ACTIVE, repeat=1),
                           on_trace_ready=lambda p: results.append(
                               p.profiler.kineto_results))
            prof.start()
            left = TRACE_WARMUP + TRACE_ACTIVE
        with record_function("bench.next_input"):
            k = i % len(pool)
            frames_in = pool[k]
        t0 = time.perf_counter()
        try:
            with record_function("bench.step_call"):
                out = step(frames_in)
        except Exception:  # a failed step adds no frames and fails the run
            traceback.print_exc()
            out = None
        t1 = time.perf_counter()
        with record_function("bench.outputs"):
            attempted += 1
            step_s.append(t1 - t0)
            if well_formed(out, n_frames):
                frames_done += n_frames
                seen[k] = seen.get(k, 0) + 1
                if rng.random() < 1.0 / seen[k]:
                    kept[k] = out
            else:
                failed += 1
        if prof is None:
            untraced.append(t1 - t0)
        else:
            prof.step()
            left -= 1
            if left == 0:
                prof.stop()
                prof = None
        i += 1
    t_end = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    return {"attempted": attempted, "failed": failed,
            "frames_done": frames_done, "window_s": t_end - t_start,
            "step_s": step_s, "untraced_step_s": untraced,
            "peak_bytes": peak, "kept": sorted(kept.items()),
            "trace": Trace(results[0], TRACE_ACTIVE) if results else None}


def host(out: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in out.items()}


def judge(builder, sample: list) -> dict:
    """The numbers compared over a sample of (output, float32 reference,
    null) for several inputs: each gap that the builder's NULL_FLOOR names,
    as its mean over the sample over the null's mean gap (the null is the
    reference with its products' operands rounded to bfloat16, the
    configuration's precision: a seed's random model amplifies rounding by
    its own factor, which the quotient cancels), named `<gap>_vs_null`;
    every other gap as its mean over the sample; and each number that the
    builder's RATIOS names, (numerator, denominator, floor), the quotient
    of two of those means, the second at least the floor, so that every
    pixel of the sample weighs alike."""
    raw, base = {}, {}
    for out, want, null in sample:
        for k, v in builder.compare(out, want).items():
            raw.setdefault(k, []).append(v)
        if null is not None:
            for k, v in builder.compare(host(null), want).items():
                base.setdefault(k, []).append(v)
    nums = {}
    for k, v in raw.items():
        mean = sum(v) / len(v)
        if k in builder.NULL_FLOOR:
            nums[k + "_vs_null"] = mean / max(sum(base[k]) / len(base[k]),
                                              builder.NULL_FLOOR[k])
        else:
            nums[k] = mean
    for k, (num, den, floor) in getattr(builder, "RATIOS", {}).items():
        if den in nums:
            nums[k] = nums[num] / max(nums[den], floor)
    return {k: v if math.isfinite(v) else math.inf for k, v in nums.items()}


def references(cell: Cell, sd: dict, frames_u8: torch.Tensor) -> tuple:
    """(float32 reference, null) outputs for one input."""
    b = cell.builder
    return (b.reference(sd, frames_u8, cell.cfg, cell.traffic),
            b.reference(sd, frames_u8, cell.cfg, cell.traffic,
                        Ops(bf16_round)))


@contextlib.contextmanager
def checkpoint(cell: Cell, seed: int, device: str):
    """The weights made from the seed on the device and saved under the
    checkpoints' real names and keys in a models directory under TMPDIR;
    yields (models_dir, what save_checkpoint returned: a path or a list of
    paths) and removes every file of it after, also where the run raised."""
    b = cell.builder
    models_dir = os.path.join(tempfile.gettempdir(), "prisma_benchmark_models")
    os.makedirs(models_dir, exist_ok=True)
    sd = weights.make_state_dict(b.param_specs(cell.cfg),
                                 seeds.substream(seed, seeds.WEIGHTS), device)
    saved = b.save_checkpoint(sd, models_dir, cell.cfg)
    del sd
    try:
        yield models_dir, saved
    finally:
        for path in [saved] if isinstance(saved, str) else saved:
            if os.path.exists(path):
                os.remove(path)


def make_pool(cell: Cell, seed: int, device: str) -> list:
    return frames.make_pool(cell.traffic, seeds.substream(seed, seeds.FRAMES),
                            cell.builder.OVERLAP, device)


def free_program(device: str) -> None:
    """After the program's step is dropped: its memory back, and the
    reference's float32 products in float32 (no TF32)."""
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
        no_tf32()


def check(cell: Cell, pool: list, kept: list, saved, device: str,
          failed: int) -> tuple:
    """(correct, {number: {value, limit}}): the references over the
    sampled inputs, the sample judged, each number held to its limit."""
    sd = cell.builder.load_reference_weights(saved, device)
    refs = {}
    for k, _ in kept:
        if k not in refs:
            refs[k] = references(cell, sd,
                                 torch.from_numpy(pool[k]).to(device))
    nums = judge(cell.builder, [(out, *refs[k]) for k, out in kept])
    checks = {name: {"value": nums.get(name), "limit": lim}
              for name, lim in cell.limits.items()}
    correct = (failed == 0 and bool(kept) and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values()))
    for c in checks.values():
        if c["value"] is not None and not math.isfinite(c["value"]):
            c["value"] = None
    return correct, checks


def report_spans(trace: Trace) -> None:
    """The traced steps' device seconds by the span that launched them, on
    standard error, against all the trace's device seconds."""
    by_span = spans.device_by_span(trace)
    if by_span is None:
        return
    print("device s by span over the traced steps: "
          + json.dumps(dict(sorted(by_span.items(), key=lambda kv: -kv[1])))
          + f"; together {sum(by_span.values())!r} of the trace's "
          f"{trace.device_s(lambda n: True)!r}", file=sys.stderr, flush=True)


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: str = "cuda", kind: str | None = None) -> dict:
    """One run of the cell -> the result object (without printing)."""
    b = cell.builder
    t = time.perf_counter()
    with checkpoint(cell, seed, device) as (models_dir, saved):
        t_w = time.perf_counter()
        step = b.build_step(cell.cfg, cell.traffic, models_dir, device)
        t_b = time.perf_counter()
        pool = make_pool(cell, seed, device)
        t_f = time.perf_counter()
        for x in pool[:2]:  # the cell's one input shape, built and warm
            step(x)
        t_u = time.perf_counter()
        setup_s = AGE_AT_TOP + (t_u - T_TOP)
        print(f"setup: {setup_s:.3f} s; weights made and saved "
              f"{t_w - t:.3f} s, step built and loaded {t_b - t_w:.3f} s, "
              f"frames {t_f - t_b:.3f} s, warm-up {t_u - t_f:.3f} s",
              file=sys.stderr, flush=True)
        window = measure(step, pool, seconds, trace, cell.frames_per_step,
                         seeds.substream(seed, seeds.SAMPLE), device)
        del step
        free_program(device)
        correct, checks = check(cell, pool, window["kept"], saved, device,
                                window["failed"])

    ctx = Context(cell, window, setup_s, kind)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cell.readers[m["name"]].read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.startswith("cuda") else device,
           "kind": kind, "count": cell.spec["chips"],
           "memory_peak_bytes": int(window["peak_bytes"])}
    result = {"correct": correct, "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics, "device": dev}
    if trace and window["trace"] is not None:
        dev["busy_s"] = window["trace"].busy_s
        dev["window_s"] = window["trace"].window_s
        result["breakdown"] = window["trace"].breakdown()
        report_spans(window["trace"])
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(load_json(ROOT, "BENCHMARK.json"), args.workload)
    chips = cell.spec["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {chips} CUDA card(s); torch sees "
              f"{n}", file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    print(f"card: {kind}, {torch.cuda.device_count()} visible, "
          f"{chips} used; nvidia-smi: {power_limit()}", flush=True)
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", kind)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}, which it must not",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
