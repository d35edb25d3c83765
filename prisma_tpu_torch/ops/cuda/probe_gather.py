"""The two probe kernels of `scripts/probe_gather_kernel.py`: a per-row
offset gather and a minor-axis transpose.

`lane_gather` and `minor_transpose` launch the hand-written Hopper kernels of
`csrc/probe_gather.cu` (K6a and K6b, the counterparts of the TPU kernels
`lane_gather_kernel` and `transpose_kernel`) on CUDA tensors, and take their
plain versions on CPU tensors. There is no fallback: a CUDA tensor a kernel
does not take raises. No band or model calls them; they are ported because
the TPU code has them, and `chip_smoke.py` drives them as the probe did.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from prisma_tpu_torch.ops.cuda import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def lane_gather_ref(x: torch.Tensor, off: torch.Tensor, taps: int) -> torch.Tensor:
    """Plain version: o[s, l] = x[s, clip(off[s] + min(l, taps - 1), 0,
    H - 1)] for x [S, H] and int32 offsets off [S]."""
    S, H = x.shape
    li = torch.arange(H, device=x.device).clamp_max(taps - 1)
    idx = (off.long()[:, None] + li[None, :]).clamp(0, H - 1)
    return torch.gather(x, 1, idx)


def minor_transpose_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version: [B, W, T] -> [B, T, W]."""
    return x.transpose(1, 2).contiguous()


@functools.cache
def _lib():
    lib = build.load("probe_gather")
    lib.prisma_lane_gather.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.prisma_minor_transpose.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.prisma_lane_gather.restype = ctypes.c_int
    lib.prisma_minor_transpose.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, name: str, dim: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != dim or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"{name}: x must be a non-empty contiguous {dim}-d "
                         f"tensor, got {tuple(x.shape)}")


def lane_gather(x: torch.Tensor, off: torch.Tensor, taps: int) -> torch.Tensor:
    """x [S, H] float32 or bfloat16, off [S] int32 -> [S, H] of x's dtype."""
    if off.device != x.device:
        raise ValueError("x and off must lie on one device")
    if x.device.type == "cpu":
        return lane_gather_ref(x, off, taps)
    _check(x, "lane_gather", 2)
    S, H = x.shape
    if off.dtype != torch.int32 or off.shape != (S,) or not off.is_contiguous():
        raise ValueError(f"off must be a contiguous [{S}] int32")
    if taps < 1:
        raise ValueError(f"taps must be positive, got {taps}")
    o = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _lib().prisma_lane_gather(
            x.data_ptr(), off.data_ptr(), o.data_ptr(), S, H, taps,
            _DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lane_gather kernel launch failed: cudaError {err}")
    lane_gather.launches += 1
    return o


def minor_transpose(x: torch.Tensor) -> torch.Tensor:
    """x [B, W, T] float32 or bfloat16 -> [B, T, W]."""
    if x.device.type == "cpu":
        return minor_transpose_ref(x)
    _check(x, "minor_transpose", 3)
    B, W, T = x.shape
    if B > 65535 or W * T >= 2 ** 31:
        raise ValueError(f"minor_transpose takes B <= 65535 and W·T < 2^31, "
                         f"got {tuple(x.shape)}")
    o = torch.empty(B, T, W, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().prisma_minor_transpose(
            x.data_ptr(), o.data_ptr(), B, W, T, _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"minor_transpose kernel launch failed: cudaError {err}")
    minor_transpose.launches += 1
    return o


lane_gather.launches = 0      # K6a launches; chip_smoke.py reads them
minor_transpose.launches = 0  # K6b launches
