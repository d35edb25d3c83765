"""K6a and K6b: the port's probe kernels against the TPU probe's.

On the CPU each wrapper takes its plain version, which is held against the
TPU kernels of scripts/probe_gather_kernel.py run in interpret mode, at the
probe's own shapes, in f32 and bf16. Both functions only move values, so the
check is equality. The card-only tests hold the CUDA kernels against the
plain versions on the card; run them with `python -m pytest --noconftest -m
cuda tests/test_torch_probe_gather.py`.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from prisma_tpu_torch.ops.cuda.probe_gather import (lane_gather, lane_gather_ref,
                                                    minor_transpose,
                                                    minor_transpose_ref)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAPS = 10
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _probe():
    spec = importlib.util.spec_from_file_location(
        "probe_gather_kernel",
        os.path.join(REPO_ROOT, "scripts", "probe_gather_kernel.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _gather_case(S, H, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random((S, H)).astype(np.float32)).to(dtype)
    off = torch.from_numpy(rng.integers(-6, H + 2, S).astype(np.int32))
    return x, off


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("S,H", [(16, 128), (16, 256), (64, 102)])
def test_lane_gather_matches_probe_kernel(S, H, dtype):
    """The probe's semantic shapes [16, 128] and [16, 256], and a slice of
    its perf shape [5760, 102]; offsets run past both ends of the row."""
    import jax.numpy as jnp
    x, off = _gather_case(S, H, DTYPES[dtype])
    ours = lane_gather(x, off, TAPS)
    theirs = _probe().run_lane_gather(jnp.asarray(x.float().numpy(), dtype),
                                      jnp.asarray(off.numpy()), TAPS,
                                      interpret=True)
    assert ours.dtype == x.dtype and ours.shape == (S, H)
    np.testing.assert_array_equal(ours.float().numpy(),
                                  np.asarray(theirs, np.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_minor_transpose_matches_probe_kernel(dtype):
    import jax.numpy as jnp
    x = torch.from_numpy(np.random.default_rng(1).random((8, 180, 16))
                         .astype(np.float32)).to(DTYPES[dtype])
    ours = minor_transpose(x)
    theirs = _probe().run_transpose(jnp.asarray(x.float().numpy(), dtype),
                                    interpret=True)
    assert ours.shape == (8, 16, 180) and ours.is_contiguous()
    np.testing.assert_array_equal(ours.float().numpy(),
                                  np.asarray(theirs, np.float32))


def test_cpu_wrappers_take_plain_versions():
    x, off = _gather_case(16, 128, torch.float32)
    before = (lane_gather.launches, minor_transpose.launches)
    assert torch.equal(lane_gather(x, off, TAPS), lane_gather_ref(x, off, TAPS))
    y = x.reshape(4, 32, 16)
    assert torch.equal(minor_transpose(y), minor_transpose_ref(y))
    assert (lane_gather.launches, minor_transpose.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,H", [(16, 128), (16, 256), (5760, 102), (7, 33)])
def test_lane_gather_kernel_on_card(S, H, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, off = (t.cuda() for t in _gather_case(S, H, dtype))
    before = lane_gather.launches
    out = lane_gather(x, off, TAPS)
    torch.cuda.synchronize()
    assert lane_gather.launches == before + 1
    assert torch.equal(out, lane_gather_ref(x, off, TAPS))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 180, 16), (3, 45, 70)])
def test_minor_transpose_kernel_on_card(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.randn(shape, device="cuda").to(dtype)
    before = minor_transpose.launches
    out = minor_transpose(x)
    torch.cuda.synchronize()
    assert minor_transpose.launches == before + 1
    assert torch.equal(out, minor_transpose_ref(x))
