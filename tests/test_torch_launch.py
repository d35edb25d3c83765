"""The port's shared kernel-launch path and its build's cache key.

On the CPU: `ops/cuda/launch.launch` hands the C entry its arguments and the
raw current stream of the tensors' device, enters that device only when it is
not the current one, and raises on a refused launch (a fake entry and a fake
CUDA state stand in for the card); `build.library_path` names a library by
its source and every csrc/ header the source includes, so an edited header
rebuilds. The card-only tests run the wrappers on a side stream and on a
second card; run them with `python -m pytest --noconftest -m cuda
tests/test_torch_launch.py`.
"""

import contextlib

import numpy as np
import pytest
import torch

from prisma_tpu_torch.ops.cuda import build, launch
from prisma_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_streamed, flash_attention_streamed_ref, streamed_bounds)
from prisma_tpu_torch.ops.cuda.probe_gather import lane_gather, lane_gather_ref


@pytest.fixture
def fake_cuda(monkeypatch):
    """Current device 0, raw streams 1000 + index, and a record of the
    devices entered."""
    entered = []

    @contextlib.contextmanager
    def device(index):
        entered.append(index)
        yield

    monkeypatch.setattr(launch, "_cuda_state", lambda: (lambda: 0, lambda i: 1000 + i))
    monkeypatch.setattr(torch.cuda, "device", device)
    return entered


def test_launch_passes_the_arguments_and_the_current_stream(fake_cuda):
    calls = []
    launch.launch("k", lambda *a: calls.append(a) or 0, 0, 11, 2.5)
    assert calls == [(11, 2.5, 1000)]
    assert fake_cuda == []  # device 0 is the current one: no switch


def test_launch_enters_another_device_only_for_its_call(fake_cuda):
    calls = []
    launch.launch("k", lambda *a: calls.append(a) or 0, 1, 7)
    assert calls == [(7, 1001)]
    assert fake_cuda == [1]


def test_launch_raises_on_a_refused_launch(fake_cuda):
    with pytest.raises(RuntimeError, match=r"k kernel launch failed: cudaError 1\b"):
        launch.launch("k", lambda *a: 1, 0)


def _sources(tmp_path, header_text):
    (tmp_path / "k.cu").write_text('#include <cstdint>\n#include "a.cuh"\nint x;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text(header_text)


def test_library_path_follows_the_included_headers(tmp_path, monkeypatch):
    """An edit to a header included through another header renames the
    library, so a stale build is never loaded; system headers are not
    followed."""
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    _sources(tmp_path, "// one\n")
    assert [p.rsplit("/", 1)[1] for p in build._inputs("k")] == ["k.cu", "a.cuh", "b.cuh"]
    before = build.library_path("k")
    assert build.library_path("k") == before
    _sources(tmp_path, "// two\n")
    assert build.library_path("k") != before


def test_library_path_of_the_attention_sources_covers_hopper_header():
    for name in ("flash_attention", "flash_attention_streamed"):
        assert any(p.endswith("hopper.cuh") for p in build._inputs(name))


def _gather_case():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((5760, 102)).astype(np.float32))
    off = torch.from_numpy(rng.integers(0, 92, 5760).astype(np.int32))
    return x, off, lane_gather_ref(x, off, 10)


@pytest.mark.cuda
def test_wrapper_on_a_side_stream():
    """A wrapper launches on the current stream of its tensors' device: on a
    side stream under torch.cuda.stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, off, ref = _gather_case()
    side = torch.cuda.Stream()
    xc, offc = x.cuda(), off.cuda()
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        out = lane_gather(xc, offc, 10)
    side.synchronize()
    assert torch.equal(out.cpu(), ref)


@pytest.mark.cuda
def test_wrappers_on_a_second_card():
    """Wrappers on the second card while the first is current: K6a, and K3,
    whose shared-memory cap is raised once per card (on the first card
    first, so that the second needs its own)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    x, off, ref = _gather_case()
    rng = np.random.default_rng(1)
    q, k = (torch.from_numpy(rng.normal(size=(2, n, 128)).astype(np.float32))
            .to(torch.bfloat16) for n in (300, 700))
    v = torch.from_numpy(rng.uniform(0, 1440, size=(2, 700, 2)).astype(np.float32))
    streamed_ref = flash_attention_streamed_ref(q, k, v, 128 ** -0.5)
    with torch.cuda.device(0):
        first = flash_attention_streamed(q.cuda(0), k.cuda(0), v.cuda(0), 128 ** -0.5)
        x1, off1 = x.to("cuda:1"), off.to("cuda:1")
        out = lane_gather(x1, off1, 10)
        second = flash_attention_streamed(q.cuda(1), k.cuda(1), v.cuda(1), 128 ** -0.5)
        torch.cuda.synchronize(0)
        torch.cuda.synchronize(1)
    assert out.device == x1.device and torch.equal(out.cpu(), ref)
    assert second.device == x1.device
    tol = streamed_bounds(v)
    for got in (first, second):
        assert float((got.cpu() - streamed_ref).abs().max()) <= tol[0]
