"""The plain reference against prisma_tpu_torch in float32 at tiny widths on
the CPU; the control (the reference in fp8) and the planted faults come out
not correct under the cells' limits; a sound run comes out correct."""

from __future__ import annotations

import math
import tempfile

import numpy as np
import pytest
import torch

from benchmark import control, run
from benchmark.reference.common import fwdbwd_masks
from benchmark.tests.faults import FAULTS, files_left, run_with
from benchmark.tests.tiny import names, tiny_cell

# float32 on both sides at tiny widths: the two part by the order of f32
# sums and the port's resize matrices, a few 1e-6 of the range, which flips
# the uint8 floor of a few pixels in a hundred by one level; a slip of an
# equation (an eps, a resize corner, a missing LayerScale) reads 1e-2 of
# the range or a level on every pixel
F32_AGREE = {"heat_gap": 0.05, "fwd_rgb_gap": 0.05, "fwd_flow_gap": 1e-3,
             "bwd_flow_gap": 1e-3, "bwd_rgb_gap": 0.05,
             "mask_mismatch_of_marked": 1e-2}


@pytest.mark.parametrize("name", ["depth_anything_vitl.1080p",
                                  "gmflow_sintel.1080p_bidir_mask"])
def test_reference_agrees_with_the_port_in_f32(name, monkeypatch, tmp_path):
    """The raw gaps, not over the null: a float32 port against the float32
    reference."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    cell = tiny_cell(name)
    monkeypatch.setattr(run, "judge", _worst_raw_gaps)
    r = control.readings(cell, 5, "cpu", control=False)
    for k, v in r["program"].items():
        assert v <= F32_AGREE.get(k, math.inf), (k, v)
    assert r["program"].get("mask_marked_px", 1) > 0


def _worst_raw_gaps(b, sample):
    per = [b.compare(out, want) for out, want, _ in sample]
    nums = {k: max(p[k] for p in per) for k in per[0]}
    for k, (num, den, _) in getattr(b, "RATIOS", {}).items():
        nums[k] = sum(p[num] for p in per) / max(sum(p[den] for p in per), 1)
    return nums


@pytest.mark.parametrize("name", ["depth_anything_vitl.1080p",
                                  "gmflow_sintel.1080p_bidir_mask"])
def test_control_fails_the_limits(name, monkeypatch, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    cell = tiny_cell(name)
    r = control.readings(cell, 6, "cpu", program=False)
    assert any(r["control"][k] > lim for k, lim in cell.limits.items()), r


@pytest.mark.parametrize("name", names())
@pytest.mark.parametrize("fault", list(FAULTS))
def test_faults_are_not_correct(name, fault, monkeypatch, tmp_path):
    cell = tiny_cell(name)
    res = run_with(cell, FAULTS[fault], monkeypatch, tmp_path)
    assert res["correct"] is (fault is None), res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert files_left(tmp_path) == []


def _masks(fn):
    """A fault planted where the masks are produced: fn(output) gives the
    (fwd_mask, bwd_mask) the step returns instead of its own."""
    def fault(out):
        out["fwd_mask"], out["bwd_mask"] = fn(out)
        return out
    return fault


def _threshold_doubled(out):
    """The consistency test's constant term alpha_2 at 1 instead of 0.5."""
    return tuple(m.numpy() for m in fwdbwd_masks(
        torch.from_numpy(out["fwd"]), torch.from_numpy(out["bwd"]),
        alpha_2=1.0))


# The faults that the mask number catches at the cell's size wherever the
# reference marks a pixel consistent (the inversion everywhere). A changed
# threshold moves only the few pixels near it there, and shows only at the
# tiny size, where the random flows are consistent on about 1% of pixels.
CARD_MASK_FAULTS = {
    "swapped": _masks(lambda o: (o["bwd_mask"], o["fwd_mask"])),
    "inverted": _masks(lambda o: (~o["fwd_mask"], ~o["bwd_mask"])),
    "all false": _masks(lambda o: (np.zeros_like(o["fwd_mask"]),
                                   np.zeros_like(o["bwd_mask"]))),
}
MASK_FAULTS = {**CARD_MASK_FAULTS,
               "threshold doubled": _masks(_threshold_doubled)}


@pytest.mark.parametrize("fault", sorted(MASK_FAULTS))
def test_mask_faults_are_not_correct(fault, monkeypatch, tmp_path):
    cell = tiny_cell("gmflow_sintel.1080p_bidir_mask")
    planted = MASK_FAULTS[fault]
    res = run_with(cell, lambda step, _: lambda frames: planted(step(frames)),
                   monkeypatch, tmp_path)
    assert res["correct"] is False
    check = res["checks"]["mask_mismatch_of_marked"]
    assert check["value"] > check["limit"], check


@pytest.mark.cuda
def test_mask_faults_on_the_card_at_the_cells_size():
    """The mask number's upper readings: each fault planted in the port's
    outputs at the cell's size on three seeds. Where the reference marks
    fewer than the floor's 25 pixels an input consistent (905 none, 906 one
    in three inputs), masks left all false or swapped are all but right,
    and only the inversion is held to show."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: faults at the cell's size")
    cell = run.Cell(run.load_json(run.ROOT, "BENCHMARK.json"),
                    "gmflow_sintel.1080p_bidir_mask")
    limit = cell.limits["mask_mismatch_of_marked"]
    rs = [control.readings(cell, seed, "cuda", control=False,
                           faults=MASK_FAULTS) for seed in (904, 905, 906)]
    print(rs)
    for r in rs:
        assert r["program"]["mask_mismatch_of_marked"] <= limit
        marked = r["program"]["mask_marked_px"] >= 25
        for name in CARD_MASK_FAULTS:
            if marked or name == "inverted":
                nums = r["faults"][name]
                assert nums["mask_mismatch_of_marked"] > limit, (name, nums)


@pytest.mark.cuda
@pytest.mark.parametrize("name", names())
def test_control_on_the_card_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control at the cell's size")
    cell = run.Cell(run.load_json(run.ROOT, "BENCHMARK.json"), name)
    for seed in (901, 902, 903):
        r = control.readings(cell, seed, "cuda")
        assert all(r["program"][k] <= lim for k, lim in cell.limits.items())
        assert any(r["control"][k] > lim for k, lim in cell.limits.items())
