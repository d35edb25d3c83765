"""RAFT's bilinear correlation-window lookup over the whole pyramid.

`window_lookup` launches the hand-written Hopper kernel of
`csrc/raft_lookup.cu` (K5, the counterpart of the TPU kernels `_fetch_kernel`
in `prisma_tpu/ops/pallas/raft_lookup.py` and `_window_kernel` in
`prisma_tpu/ops/pallas/raft_window.py`, which compute the same function) on
CUDA tensors, and takes the plain version `window_lookup_ref` on CPU tensors.
There is no fallback: a CUDA tensor the kernel does not take raises.

The function (reference corr.py:30-43 with utils.bilinear_sampler): for each
pixel n and level l, the centre c = coords[n] / 2^l; the (2r+1)² taps at
integer offsets from c, each a bilinear blend of the plane [Hl, Wl] of pixel
n, zero outside the plane (grid_sample zero padding); within a level the tap
(dx, dy) sits at (dx + r)·(2r+1) + (dy + r), the x-offset on the slow axis;
levels are concatenated level-major.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from prisma_tpu_torch.ops.cuda import build

RADIUS = 4
MAX_LEVELS = 4
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def clamped_centres(c: torch.Tensor, hw, r: int):
    """Centres [N, 2] at one level -> (x0, y0, fx, fy): the integer
    patch corner floor(c) and the fraction c - floor(c), with c clamped to
    [-(r+2), W+r] x [-(r+2), H+r] first (outside that every tap is off the
    plane, so the clamp changes no output) and a non-finite centre moved off
    the plane, as the kernel does. chip_smoke.py counts the bytes a lookup
    must read from these."""
    H, W = hw
    finite = torch.isfinite(c).all(dim=1)
    c = torch.where(finite[:, None], c, torch.full_like(c, -(r + 2.0)))
    cx = c[:, 0].clamp(-(r + 2.0), W + float(r))
    cy = c[:, 1].clamp(-(r + 2.0), H + float(r))
    x0, y0 = torch.floor(cx), torch.floor(cy)
    return x0.long(), y0.long(), cx - x0, cy - y0


def window_lookup_ref(pyramid, coords: torch.Tensor, r: int = RADIUS,
                      blend_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version, as the JAX package's `_window_patch_lookup`: per level
    one (2r+2)² integer patch per pixel (one torch.gather over the flattened
    plane, indices clamped, taps off the plane zeroed), the four shifted
    (2r+1)² slices blended with the shared fraction in `blend_dtype`, one
    cast to the volume's dtype. blend_dtype=torch.float32 is what the kernel
    computes; the volume's own dtype (bf16) is the JAX package's bf16 blend.

    pyramid: list of [N, Hl, Wl] (a level may be empty); coords [N, 2] f32
    (x, y) at level 0's scale -> [N, len(pyramid)·(2r+1)²]."""
    n = 2 * r + 1
    p = n + 1
    ks = torch.arange(p, device=coords.device)
    out = []
    for level, vol in enumerate(pyramid):
        N, H, W = vol.shape
        if H == 0 or W == 0:
            out.append(vol.new_zeros(N, n * n))
            continue
        x0, y0, fx, fy = clamped_centres(coords.float() / 2 ** level, (H, W), r)
        xi = x0[:, None] - r + ks                        # [N, p]
        yi = y0[:, None] - r + ks
        idx = (yi.clamp(0, H - 1)[:, :, None] * W
               + xi.clamp(0, W - 1)[:, None, :])         # [N, p(y), p(x)]
        patch = torch.gather(vol.reshape(N, H * W), 1, idx.reshape(N, p * p))
        valid = (((yi >= 0) & (yi < H))[:, :, None]
                 & ((xi >= 0) & (xi < W))[:, None, :]).reshape(N, p * p)
        pv = torch.where(valid, patch.to(blend_dtype),
                         torch.zeros((), dtype=blend_dtype, device=vol.device))
        pv = pv.reshape(N, p, p)
        fx = fx.to(blend_dtype)[:, None, None]
        fy = fy.to(blend_dtype)[:, None, None]
        gx, gy = 1 - fx, 1 - fy
        win = (gx * gy * pv[:, :n, :n] + fx * gy * pv[:, :n, 1:]
               + gx * fy * pv[:, 1:, :n] + fx * fy * pv[:, 1:, 1:])  # [N, y, x]
        out.append(win.transpose(1, 2).reshape(N, n * n).to(vol.dtype))
    return torch.cat(out, dim=1)


def bounds(ref: torch.Tensor) -> tuple[float, float]:
    """(max, mean) bounds on |kernel - ref| for K5 against its plain version.
    Both blend the same f32 values in the same order with round-to-nearest
    operations and cast once, so they agree to the last bit unless the
    compiler reorders; the bounds allow an f32 rounding step: in f32 max
    |err| <= 1e-6 of max |ref| (and the mean within 2^-20 of mean |ref|); in
    bf16 max |err| <= 1 ulp of max |ref| and mean |err| <= 2^-12 of mean
    |ref|, as K4's. A window in y-slow order, edge taps clamped instead of
    zeroed, or a level's centre not divided by 2^l moves whole windows and
    breaks both (tests/test_torch_raft_lookup.py)."""
    a = ref.float().abs()
    top = float(a.max()) if a.numel() else 0.0
    mean = float(a.mean()) if a.numel() else 0.0
    if ref.dtype == torch.float32:
        return 1e-6 * top, 2.0 ** -20 * mean
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0
    return ulp, 2.0 ** -12 * mean


@functools.cache
def _kernel():
    """The C entry point, built and loaded at first use."""
    fn = build.load("raft_lookup").prisma_raft_window_lookup
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def window_lookup(pyramid, coords: torch.Tensor, r: int = RADIUS) -> torch.Tensor:
    """pyramid: 1 to 4 contiguous [N, Hl, Wl] planes of one dtype (float32
    or bfloat16); coords [N, 2] float32 (x, y) at level 0's scale -> [N,
    levels·(2r+1)²] in the pyramid's dtype, blended in f32."""
    if any(vol.device != coords.device for vol in pyramid):
        raise ValueError("the pyramid and the coords must lie on one device")
    if coords.device.type == "cpu":
        return window_lookup_ref(pyramid, coords, r)
    if coords.device.type != "cuda":
        raise ValueError(f"window_lookup runs on cuda or cpu, not {coords.device}")
    if r != RADIUS:
        raise ValueError(f"the kernel is built for radius {RADIUS}, not {r}")
    if not 1 <= len(pyramid) <= MAX_LEVELS:
        raise ValueError(f"1 to {MAX_LEVELS} levels, got {len(pyramid)}")
    if coords.dtype != torch.float32 or coords.dim() != 2 or coords.shape[1] != 2 \
            or not coords.is_contiguous():
        raise ValueError(f"coords must be contiguous [N, 2] float32, got "
                         f"{coords.dtype} {tuple(coords.shape)}")
    N = coords.shape[0]
    dtype = pyramid[0].dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"the volume must be float32 or bfloat16, got {dtype}")
    hw = []
    for vol in pyramid:
        if vol.dtype != dtype or vol.dim() != 3 or vol.shape[0] != N \
                or not vol.is_contiguous():
            raise ValueError(f"each level must be a contiguous [{N}, Hl, Wl] "
                             f"{dtype}, got {vol.dtype} {tuple(vol.shape)}")
        if vol.shape[1] * vol.shape[2] >= 2 ** 31:
            raise ValueError(f"a plane of {tuple(vol.shape[1:])} is too large")
        hw += [vol.shape[1], vol.shape[2]]
    L = len(pyramid)
    out = torch.empty(N, L * (2 * r + 1) ** 2, dtype=dtype, device=coords.device)
    vols = (ctypes.c_void_p * L)(*(vol.data_ptr() for vol in pyramid))
    dims = (ctypes.c_int * (2 * L))(*hw)
    with torch.cuda.device(coords.device):
        err = _kernel()(vols, dims, L, coords.data_ptr(), out.data_ptr(), N, r,
                        _DTYPE_CODES[dtype],
                        torch.cuda.current_stream(coords.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"window_lookup kernel launch failed: cudaError {err}")
    window_lookup.launches += 1
    return out


window_lookup.launches = 0  # K5 launches; chip_smoke.py reads them
