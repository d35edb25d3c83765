"""K6a and K6b: the port's probe kernels against the TPU probe's.

On the CPU each wrapper takes its plain version, which is held against the
TPU kernels of scripts/probe_gather_kernel.py run in interpret mode, at the
probe's own shapes and at ragged ones (taps of 1 and past the row, offsets
past both ends of the row, H = 33, odd W and T), in f32 and bf16. Both
functions only move values, so the check is equality. The card-only tests
hold the CUDA kernels against the plain versions on the card, bit for bit,
through each kernel's tail paths and past the 65535 batches of the previous
design's grid; run them with `python -m pytest --noconftest -m cuda
tests/test_torch_probe_gather.py`.
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


def _gather_case(S, H, dtype, seed=0, span=None):
    """x [S, H] and int32 offsets from -6 to H + 1, or from -span to span."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random((S, H)).astype(np.float32)).to(dtype)
    lo, hi = (-6, H + 2) if span is None else (-span, span)
    off = torch.from_numpy(rng.integers(lo, hi, S).astype(np.int32))
    return x, off


def _bits(t):
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("S,H,taps,span", [
    pytest.param(16, 128, TAPS, None, id="16-128"),
    pytest.param(16, 256, TAPS, None, id="16-256"),
    pytest.param(64, 102, TAPS, None, id="64-102"),
    pytest.param(7, 33, 1, 66, id="7-33-taps1"),
    pytest.param(7, 33, TAPS, 66, id="7-33-taps10"),
    pytest.param(7, 33, 40, 66, id="7-33-taps40"),
    pytest.param(33, 102, 1, 204, id="33-102-taps1"),
    pytest.param(33, 102, 120, 204, id="33-102-taps120")])
def test_lane_gather_matches_probe_kernel(S, H, taps, span, dtype):
    """The probe's semantic shapes [16, 128] and [16, 256], and a slice of
    its perf shape [5760, 102]; offsets run past both ends of the row. Then
    H = 33 and 102 with taps of 1 (every column the offset's value), 10 and
    past the row (taps > H: the shifted row whole), offsets up to 2H below 0
    and past H."""
    import jax.numpy as jnp
    x, off = _gather_case(S, H, DTYPES[dtype], span=span)
    ours = lane_gather(x, off, taps)
    theirs = _probe().run_lane_gather(jnp.asarray(x.float().numpy(), dtype),
                                      jnp.asarray(off.numpy()), taps,
                                      interpret=True)
    assert ours.dtype == x.dtype and ours.shape == (S, H)
    np.testing.assert_array_equal(ours.float().numpy(),
                                  np.asarray(theirs, np.float32))


def _transpose_matches_probe_kernel(shape, dtype):
    import jax.numpy as jnp
    B, W, T = shape
    x = torch.from_numpy(np.random.default_rng(1).random(shape)
                         .astype(np.float32)).to(DTYPES[dtype])
    ours = minor_transpose(x)
    theirs = _probe().run_transpose(jnp.asarray(x.float().numpy(), dtype),
                                    interpret=True)
    assert ours.shape == (B, T, W) and ours.is_contiguous()
    np.testing.assert_array_equal(ours.float().numpy(),
                                  np.asarray(theirs, np.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_minor_transpose_matches_probe_kernel(dtype):
    _transpose_matches_probe_kernel((8, 180, 16), dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(8, 181, 17), (3, 45, 7)])
def test_minor_transpose_odd_sizes_match_probe_kernel(shape, dtype):
    """Odd W and T: no run of w or t fills a warp or a 16-byte chunk."""
    _transpose_matches_probe_kernel(shape, dtype)


def test_cpu_wrappers_take_plain_versions():
    x, off = _gather_case(16, 128, torch.float32)
    before = (lane_gather.launches, minor_transpose.launches)
    assert torch.equal(lane_gather(x, off, TAPS), lane_gather_ref(x, off, TAPS))
    y = x.reshape(4, 32, 16)
    assert torch.equal(minor_transpose(y), minor_transpose_ref(y))
    assert (lane_gather.launches, minor_transpose.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,H,taps,span", [
    pytest.param(16, 128, TAPS, None, id="16-128"),
    pytest.param(16, 256, TAPS, None, id="16-256"),
    pytest.param(5760, 102, TAPS, None, id="5760-102"),
    # ragged last tiles (the tail path), H = 33, taps of 1 and past the row
    pytest.param(7, 33, TAPS, None, id="7-33"),
    pytest.param(7, 33, 1, 66, id="7-33-taps1"),
    pytest.param(7, 33, 40, 66, id="7-33-taps40"),
    pytest.param(33, 102, 120, 204, id="33-102-taps120"),
    pytest.param(1001, 33, TAPS, 66, id="1001-33"),
    # rows longer than a span: chunks of a row, 4-byte rows not 16-byte aligned
    pytest.param(5, 4099, TAPS, 8198, id="5-4099"),
    pytest.param(3, 20000, 9000, 40000, id="3-20000-taps9000")])
def test_lane_gather_kernel_on_card(S, H, taps, span, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, off = (t.cuda() for t in _gather_case(S, H, dtype, span=span))
    before = lane_gather.launches
    out = lane_gather(x, off, taps)
    torch.cuda.synchronize()
    assert lane_gather.launches == before + 1
    assert torch.equal(_bits(out), _bits(lane_gather_ref(x, off, taps)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,misaligned", [
    pytest.param((8, 180, 16), False, id="shape0"),
    pytest.param((3, 45, 70), False, id="shape1"),
    pytest.param((8, 181, 17), False, id="8-181-17"),
    # odd T through the bulk path, many slabs a tile
    pytest.param((640, 48, 3), False, id="640-48-3"),
    # input not 16-byte aligned: the tail path
    pytest.param((8, 180, 16), True, id="8-180-16-misaligned"),
    # slabs larger than a buffer: the tiled path
    pytest.param((2, 300, 70), False, id="2-300-70"),
    # B past the previous grid's 65535
    pytest.param((70000, 4, 4), False, id="70000-4-4"),
    pytest.param((70001, 3, 5), False, id="70001-3-5")])
def test_minor_transpose_kernel_on_card(shape, misaligned, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = int(np.prod(shape))
    x = torch.randn(n + misaligned, device="cuda").to(dtype)[misaligned:].view(shape)
    before = minor_transpose.launches
    out = minor_transpose(x)
    torch.cuda.synchronize()
    assert minor_transpose.launches == before + 1
    assert torch.equal(_bits(out), _bits(minor_transpose_ref(x)))


@pytest.mark.parametrize("kernel,dtype,bound_ms,whole_x_ms", [
    ("K6a", "float32", 1.784, 3.236), ("K6a", "bfloat16", 0.900, 1.626),
    ("K6b", "float32", 0.1263, None), ("K6b", "bfloat16", 0.0631, None)])
def test_bounds_at_a_raft_level0_iteration(kernel, dtype, bound_ms, whole_x_ms):
    """The bytes behind the at-scale bounds (runtime/check_gather.py): K6a
    at [2295·5760, 102] with taps 10 counts what its outputs need (each
    row's window, the output, the offsets), beside the count with all of x
    read; K6b at [2295·8, 180, 16] reads and writes each slab once."""
    from prisma_tpu_torch.runtime import check_gather as cg
    if kernel == "K6a":
        x = torch.empty(cg.SCALE_A, dtype=DTYPES[dtype], device="meta")
        assert cg.SCALE_A == (13219200, 102)
        nb = cg.gather_bytes(x, cg.TAPS)
        assert round(1e3 * nb["whole_x"] / cg.HBM_BYTES_S, 3) == whole_x_ms
        # taps past the row read the row whole
        assert cg.gather_bytes(x, 200)["windows"] == nb["whole_x"]
        nb = nb["windows"]
    else:
        x = torch.empty(cg.SCALE_B[0], dtype=DTYPES[dtype], device="meta")
        assert cg.SCALE_B[0] == (18360, 180, 16) and cg.SCALE_B[1][0] > 65535
        nb = cg.transpose_bytes(x)
    assert round(1e3 * nb / cg.HBM_BYTES_S, len(str(bound_ms)) - 2) == bound_ms
