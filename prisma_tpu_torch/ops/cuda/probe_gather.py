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

from prisma_tpu_torch.ops.cuda import launch

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
def _entries():
    """The C entries of csrc/probe_gather.cu: (lane gather, minor transpose).
    Its third, an empty kernel, is `runtime/launch_cost.empty_launch`'s."""
    p, i = ctypes.c_void_p, ctypes.c_int
    return (launch.entry("probe_gather", "prisma_lane_gather",
                         [p, p, p, ctypes.c_longlong, i, i, i]),
            launch.entry("probe_gather", "prisma_minor_transpose",
                         [p, p, ctypes.c_longlong, i, i, i]))


def _check(x: torch.Tensor, name: str, dim: int) -> None:
    """Raises the error that x earns (the slow path of a failed check)."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != dim or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"{name}: x must be a non-empty contiguous {dim}-d "
                         f"tensor, got {tuple(x.shape)}")


def lane_gather(x: torch.Tensor, off: torch.Tensor, taps: int) -> torch.Tensor:
    """x [S, H] float32 or bfloat16, off [S] int32 -> [S, H] of x's dtype."""
    if not x.is_cuda:
        if off.device != x.device:
            raise ValueError("x and off must lie on one device")
        if x.device.type == "cpu":
            return lane_gather_ref(x, off, taps)
        raise ValueError(f"lane_gather runs on cuda or cpu, not {x.device}")
    # the checks in one condition, each a cheap attribute; a failure finds its
    # message below
    code = _DTYPE_CODES.get(x.dtype)
    shape = x.shape
    device = x.get_device()
    if (code is None or len(shape) != 2 or not x.is_contiguous() or not x.numel()
            or off.get_device() != device or off.dtype != torch.int32
            or off.shape != shape[:1] or not off.is_contiguous() or taps < 1
            or shape[1] >= 2 ** 30):
        _check(x, "lane_gather", 2)
        if shape[1] >= 2 ** 30:
            raise ValueError(f"lane_gather takes rows shorter than 2^30, got {shape[1]}")
        if off.get_device() != device:
            raise ValueError("x and off must lie on one device")
        if taps < 1:
            raise ValueError(f"taps must be positive, got {taps}")
        raise ValueError(f"off must be a contiguous [{shape[0]}] int32")
    o = torch.empty_like(x)
    launch.launch("lane_gather", _entries()[0], device, x.data_ptr(),
                  off.data_ptr(), o.data_ptr(), shape[0], shape[1], taps, code)
    lane_gather.launches += 1
    return o


def minor_transpose(x: torch.Tensor) -> torch.Tensor:
    """x [B, W, T] float32 or bfloat16 -> [B, T, W]."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return minor_transpose_ref(x)
        raise ValueError(f"minor_transpose runs on cuda or cpu, not {x.device}")
    code = _DTYPE_CODES.get(x.dtype)
    shape = x.shape
    if code is None or len(shape) != 3 or not x.is_contiguous() or not x.numel():
        _check(x, "minor_transpose", 3)
    B, W, T = shape
    if W * T >= 2 ** 31:
        raise ValueError(f"minor_transpose takes W·T < 2^31, got {tuple(shape)}")
    o = x.new_empty((B, T, W))
    launch.launch("minor_transpose", _entries()[1], x.get_device(),
                  x.data_ptr(), o.data_ptr(), B, W, T, code)
    minor_transpose.launches += 1
    return o


lane_gather.launches = 0      # K6a launches; chip_smoke.py reads them
minor_transpose.launches = 0  # K6b launches
