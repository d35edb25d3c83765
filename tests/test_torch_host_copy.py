"""The band steps' host copies (runtime/host_copy.py), on both routes.

Each test runs on the CPU, where the route is `.to(device)` and
`.cpu().numpy()`, and on a card (marker `cuda`, skipped without one), where
both directions go through pinned blocks: `to_device` equals
`torch.as_tensor(x).to(device)` and `to_host` equals `{k: v.cpu().numpy()}`
in values, dtypes, shapes and strides, the arrays' storage pinned on a card;
the counters name the route and `StageProfiler.report` prints them, on a
card with the allocator's pinned bytes; an output of a depth step and of a
GMFlow step with backwards flows and masks, held while three more steps run,
keeps its values (no buffer is reused under a caller). On a card alone: one call of each step counts only pinned copies
and returns what the pageable route returns, bit for bit. On the card:
`python -m pytest --noconftest -m cuda tests/test_torch_host_copy.py`.
"""

import functools
from collections import Counter

import numpy as np
import pytest
import torch

from prisma_tpu_torch.runtime import host_copy, profiling

FRAMES = np.random.default_rng(0).integers(0, 256, (4, 8, 32, 48, 3),
                                           dtype=np.uint8)
# the outputs of one call: the depth step's with need_depth, the flow
# step's with -b --mask
OUTPUTS = {"depth": {"heat", "min", "max", "depth"},
           "flow": {"fwd_rgb", "max_disp", "fwd", "bwd", "bwd_rgb",
                    "fwd_mask", "bwd_mask"}}


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return request.param


@pytest.fixture
def counts(monkeypatch):
    """host_copy's counters, fresh for the test."""
    monkeypatch.setattr(host_copy, "COPIES", Counter())
    monkeypatch.setattr(host_copy, "BYTES", Counter())
    return host_copy


def _outputs(device) -> dict:
    """Device tensors of the kinds the steps return (uint8, f32, bool) and
    of other layouts: permuted (dense, not contiguous), expanded
    (overlapping) and sliced (not dense)."""
    g = torch.Generator().manual_seed(1)
    t = {"heat": torch.randint(0, 256, (3, 5, 7, 3), generator=g,
                               dtype=torch.uint8),
         "min": torch.randn(3, generator=g),
         "mask": torch.rand(2, 4, 6, generator=g) > 0.5,
         "flow": torch.randn(2, 2, 4, 6, generator=g)}
    t = {k: v.to(device) for k, v in t.items()}
    t["flow"] = t["flow"].permute(0, 2, 3, 1)
    t["slice"] = t["min"][None].expand(4, 3)[:, 1:]
    t["rows"] = t["flow"][:, 1:3]
    return t


def test_to_device_equals_to(device):
    for frames in (FRAMES[0], torch.from_numpy(FRAMES[1]),
                   FRAMES[2].astype(np.float32) / 255):
        got = host_copy.to_device(frames, device)
        want = torch.as_tensor(frames).to(device)
        assert got.device == want.device and got.dtype == want.dtype
        assert got.shape == want.shape and torch.equal(got, want)


def test_to_host_equals_cpu_numpy(device):
    t = _outputs(device)
    got = host_copy.to_host(t)
    want = {k: v.cpu().numpy() for k, v in t.items()}
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape
        assert got[k].strides == w.strides and np.array_equal(got[k], w)
        assert torch.from_numpy(got[k]).is_pinned() == (device == "cuda")


def test_counters_and_report(device, counts):
    host_copy.to_device(FRAMES[0], device)
    t = _outputs(device)
    host_copy.to_host(t)
    route = "pinned" if device == "cuda" else "pageable"
    assert counts.COPIES == {f"{route} H2D": 1, f"{route} D2H": len(t)}
    assert counts.BYTES == {f"{route} H2D": FRAMES[0].nbytes,
                            f"{route} D2H": sum(v.numel() * v.element_size()
                                                for v in t.values())}
    prof = profiling.StageProfiler(enabled=True)
    with prof.host("prisma.step"):
        pass
    report = prof.report()
    share = "100.0%" if device == "cuda" else "0.0%"
    assert (f"host copies: {route} D2H x{len(t)} "
            f"({counts.BYTES[f'{route} D2H'] / 1e6:.1f} MB), {route} H2D x1 "
            f"({FRAMES[0].nbytes / 1e6:.1f} MB); pinned {share} of the "
            "copies") in report
    # on a card, the bytes the caching host allocator holds follow
    assert ("; pinned host blocks " in report) == (device == "cuda")


@pytest.fixture(scope="module")
def steps():
    """(band, device) -> the band's step on device, built once: a tiny
    random ViT (the widths of tests/test_torch_tracing.py's) with the heat
    and the depth back, or the random GMFlow at 24x36 with backwards flows
    and masks, both in f32."""
    built = {}

    def get(band: str, device: str):
        if (band, device) in built:
            return built[band, device]
        if band == "depth":
            from prisma_tpu_torch.bands import depth_base
            from prisma_tpu_torch.models import depth_anything as da
            from prisma_tpu_torch.models import vit

            model = da.init_params(
                da.build(vit.ViTConfig(embed_dim=64, depth=4, num_heads=2),
                         32, (32, 64, 128, 128)),
                torch.Generator().manual_seed(0)).to(device)
            step = depth_base.make_step(
                model, functools.partial(da.infer, target=70), True, True)
        else:
            from prisma_tpu_torch.bands.flow_base import make_flow_step
            from prisma_tpu_torch.models import gmflow as gm

            model = gm.init_params(gm.build(gm.GMFlowConfig()),
                                   torch.Generator().manual_seed(0))
            step = make_flow_step(model.to(device), gm.infer_pairs, (24, 36),
                                  need_masks=True, need_flow=True)
        built[band, device] = step
        return step

    return get


@pytest.mark.parametrize("band", ["depth", "flow"])
def test_held_output_keeps_its_values(steps, device, band):
    step = steps(band, device)
    held = step(FRAMES[0])
    want = {k: v.copy() for k, v in held.items()}
    image = "fwd_rgb" if band == "flow" else "heat"
    for frames in FRAMES[1:]:  # other frames: other outputs
        assert not np.array_equal(step(frames)[image], want[image])
    assert held.keys() == want.keys() == OUTPUTS[band]
    for k, v in want.items():
        assert np.array_equal(held[k], v, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("band", ["depth", "flow"])
def test_steps_copy_pinned_and_match_the_pageable_route(steps, band, counts,
                                                        monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    step = steps(band, "cuda")
    step(FRAMES[0])  # built and warm
    counts.COPIES.clear()
    pinned = step(FRAMES[1])
    assert counts.COPIES == {"pinned H2D": 1,
                             "pinned D2H": len(OUTPUTS[band])}
    assert all(torch.from_numpy(v).is_pinned() for v in pinned.values())
    monkeypatch.setattr(host_copy, "to_device",
                        lambda frames, d: torch.as_tensor(frames).to(d))
    monkeypatch.setattr(host_copy, "to_host",
                        lambda t: {k: v.cpu().numpy() for k, v in t.items()})
    pageable = step(FRAMES[1])
    assert not any(torch.from_numpy(v).is_pinned() for v in pageable.values())
    assert pinned.keys() == pageable.keys() == OUTPUTS[band]
    for k, v in pageable.items():
        assert pinned[k].dtype == v.dtype and pinned[k].shape == v.shape
        assert np.array_equal(pinned[k], v, equal_nan=True)
