"""The default video run's configuration (process_default) at tiny sizes on
the CPU: the plain reference against the port in float32, the control in
fp8 failing the cell's limits, the faults of the mask band coming out not
correct, the random model keeping instances, the step's work, and the
readers of its three per-layer metrics on a synthetic trace. On the card
(`-m cuda`), the mask faults at the cell's size."""

from __future__ import annotations

import math
import tempfile

import numpy as np
import pytest
import torch

from benchmark import control, run, weights
from benchmark.reference import solov2
from benchmark.tests.faults import run_with
from benchmark.tests.test_bench_spans import Event, Results, kernel, \
    _ctx, _reader
from benchmark.tests.tiny import tiny_cell
from benchmark.trace import Trace

CELL = "process_default.1080p"
SEEDS = [2 ** 31 + s for s in range(12)]

# float32 on both sides: the port and the reference part by the order of
# float32 sums (batched against one-frame products, the port's resize
# matrices, its single-pass group norms), a few 1e-6 of a value's range.
# That flips the uint8 floor of a heat or HSV pixel by a level now and then
# (as in the depth and GMFlow cells: 0.05 levels) and a mask pixel at the
# masks' 0.5 cut here and there: seed 5 marks one pixel of 6,144 outside
# the reference's band in its worst frame (1.6e-4) and moves the green by
# 2e-3 levels there. An instance whose score sits at a cut stays inside the
# band (MASK_TOLERANCE). The SDF of the port's own mask is the same exact
# distance on both sides (green_self_gap: float rounding alone). A slip of
# an equation (an eps, a resize corner, a missing layer) moves instances on
# every frame and reads a level or more of heat or HSV everywhere.
F32_AGREE = {"mask_px_gap": 1e-3, "green_gap": 0.05,
             "mask_mismatch_of_marked": 1e-3, "green_self_gap": 1e-3,
             "heat_gap": 0.05, "fwd_rgb_gap": 0.05}


def _worst_raw_gaps(b, sample):
    """The raw gaps, not over the null: the largest over the sample."""
    per = [b.compare(out, want) for out, want, _ in sample]
    nums = {k: max(p[k] for p in per) for k in per[0]}
    for k, (num, den, _) in b.RATIOS.items():
        nums[k] = sum(p[num] for p in per) / max(sum(p[den] for p in per), 1)
    return nums


def test_reference_agrees_with_the_port_in_f32(monkeypatch, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(run, "judge", _worst_raw_gaps)
    r = control.readings(tiny_cell(CELL), 5, "cpu", control=False)
    for k, v in r["program"].items():
        assert v <= F32_AGREE.get(k, math.inf), (k, v)
    assert r["program"]["mask_kept"] > 0
    assert 0 < r["program"]["mask_marked_share"] < 1


def test_control_fails_the_limits(monkeypatch, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    cell = tiny_cell(CELL)
    r = control.readings(cell, 6, "cpu", program=False)
    assert any(r["control"][k] > lim for k, lim in cell.limits.items()), r


def _mask(fn):
    """A fault planted where the mask band's outputs are produced: fn(the
    composites, the greens) -> the pair the step returns instead."""
    def fault(out):
        out["mask.composite"], out["mask.green"] = fn(
            out["mask.composite"].copy(), out["mask.green"].copy())
        return out
    return fault


def _reversed(comp, green):
    return comp[::-1].copy(), green[::-1].copy()


MASK_FAULTS = {
    "inverted": _mask(lambda c, g: (np.where(c != 0, 0.0, 255.0)
                                    .astype(c.dtype), 1.0 - g)),
    "all false": _mask(lambda c, g: (np.zeros_like(c), np.zeros_like(g))),
    "swapped between frames": _mask(_reversed)}
MASK_NUMBERS = ("mask_px_gap_vs_null", "green_gap_vs_null",
                "mask_mismatch_of_marked", "green_self_gap")


@pytest.mark.parametrize("fault", sorted(MASK_FAULTS))
def test_mask_faults_are_not_correct(fault, monkeypatch, tmp_path):
    planted = MASK_FAULTS[fault]
    res = run_with(tiny_cell(CELL),
                   lambda step, _: lambda frames: planted(step(frames)),
                   monkeypatch, tmp_path)
    assert res["correct"] is False and res["failed"] == 0
    checks = res["checks"]
    assert any(checks[k]["value"] > checks[k]["limit"]
               for k in MASK_NUMBERS), checks


def test_the_init_keeps_instances():
    """Over 12 seeds, the tiny random SOLOv2 (the configuration's init, its
    biases calibrated) keeps an instance of the band's classes whichever way
    its scores round on most frames of every seed, and marks neither no
    pixel nor most of them."""
    cell = tiny_cell(CELL)
    cfg = cell.cfg["mask"]
    traffic = dict(cell.traffic, frames_per_input=4, pool=1)
    from benchmark import frames as gen
    for seed in SEEDS:
        sd = weights.make_state_dict(solov2.param_specs(cfg), seed, "cpu",
                                     torch.float32)
        solov2.calibrate(sd, cell.builder.calibration_frame(cfg, "cpu"), cfg)
        x = torch.from_numpy(gen.make_pool(traffic, seed, 0, "cpu")[0])
        with torch.inference_mode():
            out = solov2.band_outputs(sd, x, cfg,
                                      tol=cell.builder.MASK_TOLERANCE)
        kept = out["sure_kept"].numpy()
        marked = float(out["sure"].float().mean())
        assert np.mean(kept > 0) >= 0.75, (seed, kept)
        assert 0.01 < marked < 0.5, (seed, marked)


def test_the_step_work():
    """K1 over the metric core's 7 batches (24 calls each at [8 x 16, 1037,
    64]) and GMFlow's 8 windows (15 calls each); the products of the three
    networks over 56 frames, SOLOv2's dynamic-mask product among them."""
    from benchmark.run import Cell
    from benchmark.tests.tiny import manifest

    cell = Cell(manifest(), CELL)
    calls = cell.builder.attention_calls(cell.cfg, cell.traffic)
    shapes = [(c["B"], c["N"], c["d"], c["dv"]) for c in calls]
    assert shapes.count((128, 1037, 64, 64)) == 7 * 24
    assert shapes.count((56, 4590, 128, 128)) == 8 * 12
    assert shapes.count((7, 18360, 128, 2)) == 8 * 2
    assert shapes.count((14, 18360, 128, 2)) == 8
    assert len(calls) == 7 * 24 + 8 * 15
    flops = cell.builder.step_flops(cell.cfg, cell.traffic)
    dynamic = 2 * 500 * 256 * 192 * 336 * 56
    assert 1e14 < flops < 1e15 and flops > 20 * dynamic


def _model_spans_trace(with_spans=True) -> Trace:
    """One step: kernels launched under SOLOv2's backbone (100 ns), head
    (50 ns) and results (30 ns), the metric model's bins head (20 ns, run
    after its span closed) and the encoder (40 ns)."""
    events = [Event("bench.step_call", 0, 1000),
              Event("cudaLaunchKernel", 110, 111, corr=1),
              kernel(120, 220, corr=1),
              Event("cudaLaunchKernel", 310, 311, corr=2),
              kernel(320, 370, corr=2),
              Event("cudaLaunchKernel", 410, 411, corr=3),
              kernel(420, 450, corr=3),
              Event("cudaLaunchKernel", 510, 511, corr=4),
              kernel(640, 660, corr=4),
              Event("cudaLaunchKernel", 610, 611, corr=5),
              kernel(700, 740, corr=5)]
    if with_spans:
        events += [Event("prisma.step", 0, 1000),
                   Event("prisma.step.model", 100, 600),
                   Event("prisma.model.mask_backbone", 100, 300),
                   Event("prisma.model.mask_head", 300, 400),
                   Event("prisma.model.mask_results", 400, 500),
                   Event("prisma.model.bins_head", 500, 600),
                   Event("prisma.model.encoder", 600, 700)]
    return Trace(Results(events), 2)


def test_the_model_span_readers():
    ctx = _ctx(_model_spans_trace())
    assert _reader("mask_network_ms").read(ctx) == pytest.approx(75e-6)
    assert _reader("mask_results_ms").read(ctx) == pytest.approx(15e-6)
    assert _reader("bins_head_ms").read(ctx) == pytest.approx(10e-6)
    for name in ("mask_network_ms", "mask_results_ms", "bins_head_ms"):
        assert _reader(name).read(_ctx(_model_spans_trace(False))) is None
        assert _reader(name).read(_ctx(None)) is None


@pytest.mark.cuda
def test_mask_faults_on_the_card_at_the_cells_size():
    """At the cell's size, one seed: the program within every limit, each
    mask fault over a mask limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: faults at the cell's size")
    cell = run.Cell(run.load_json(run.ROOT, "BENCHMARK.json"), CELL)
    r = control.readings(cell, SEEDS[0], "cuda", control=False,
                         faults=MASK_FAULTS)
    print(r)
    assert all(r["program"][k] <= lim for k, lim in cell.limits.items())
    for name, nums in r["faults"].items():
        assert any(nums[k] > cell.limits[k] for k in MASK_NUMBERS), \
            (name, nums)
