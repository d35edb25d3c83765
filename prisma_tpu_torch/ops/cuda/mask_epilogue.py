"""The mask band's epilogue: the kept instances' composite and the capped SDF
green channel.

`kept_composite` and `sdf_green` launch the hand-written Hopper kernels of
`csrc/mask_epilogue.cu` on CUDA tensors and take the plain versions of
`ops/sdf.py` (`kept_composite`, `sdf_green_device`) on CPU tensors. The
kernels replace no TPU kernel (the JAX package computes both with jnp ops)
and equal the plain versions bit for bit. There is no fallback: a CUDA
tensor the kernels do not take raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from prisma_tpu_torch.ops import sdf
from prisma_tpu_torch.ops.cuda import launch

MAX_FRAMES = 32  # frames a composite launch (csrc/mask_epilogue.cu)
MAX_INSTANCES = 48 * 1024  # keep flags in a block's shared memory


@functools.cache
def _kernels():
    """The C entry points, built and loaded at first use."""
    p, i = ctypes.c_void_p, ctypes.c_int
    return (launch.entry("mask_epilogue", "prisma_kept_composite",
                         [p, p, i, i, ctypes.c_longlong, p, p, i]),
            launch.entry("mask_epilogue", "prisma_sdf_green", [p, p, i, i, i]))


def _check_slab(masks: torch.Tensor, keep: torch.Tensor, shape) -> None:
    if masks.dtype != torch.bool or keep.dtype != torch.bool:
        raise TypeError(f"masks and keep must be bool, got {masks.dtype}, "
                        f"{keep.dtype}")
    if masks.dim() != 3 or tuple(masks.shape) != shape \
            or tuple(keep.shape) != shape[:1]:
        raise ValueError(f"every frame's masks must be {list(shape)} with keep "
                         f"[{shape[0]}], got {tuple(masks.shape)}, "
                         f"{tuple(keep.shape)}")
    if not masks.is_contiguous() or not keep.is_contiguous():
        raise ValueError("masks and keep must be contiguous")


def kept_composite(masks: list, keep: list) -> tuple[torch.Tensor, torch.Tensor]:
    """One slab a frame: masks[b] [N, H, W] bool, keep[b] [N] bool on one
    device -> (composite [B, H, W] f32, the sum of the kept masks x 255;
    marked [B, H, W] bool, composite != 0)."""
    if len(masks) != len(keep) or not masks:
        raise ValueError(f"{len(masks)} slabs and {len(keep)} keep flags")
    device = masks[0].device
    if device.type == "cpu":
        composite = torch.stack([sdf.kept_composite(m, k)
                                 for m, k in zip(masks, keep)])
        return composite, composite != 0.0
    if device.type != "cuda":
        raise ValueError(f"kept_composite runs on cuda or cpu, not {device}")
    shape = tuple(masks[0].shape)
    for m, k in zip(masks, keep):
        if m.device != device or k.device != device:
            raise ValueError("every slab and keep flag must be on one device")
        _check_slab(m, k, shape)
    n, H, W = shape
    if n == 0 or H * W == 0:
        raise ValueError(f"empty slab {list(shape)}")
    if n > MAX_INSTANCES:
        raise ValueError(f"{n} instance slots, more than {MAX_INSTANCES}")
    B = len(masks)
    composite = torch.empty((B, H, W), dtype=torch.float32, device=device)
    marked = torch.empty((B, H, W), dtype=torch.bool, device=device)
    # the 16-byte path: a 16-byte aligned start for every mask plane and output
    vec = int(H * W % 16 == 0 and all(m.data_ptr() % 16 == 0 for m in masks))
    fn = _kernels()[0]
    for b0 in range(0, B, MAX_FRAMES):
        chunk = range(b0, min(B, b0 + MAX_FRAMES))
        ptrs = (ctypes.c_void_p * len(chunk))
        launch.launch("kept_composite", fn, device.index, ptrs(
            *(masks[b].data_ptr() for b in chunk)), ptrs(
            *(keep[b].data_ptr() for b in chunk)), len(chunk), n, H * W,
            composite[b0].data_ptr(), marked[b0].data_ptr(), vec)
        kept_composite.launches += 1
    return composite, marked


def sdf_green(mask: torch.Tensor) -> torch.Tensor:
    """The green channel of ops/sdf.sdf_green_device from a bool mask
    [..., H, W]: f32 of the same shape."""
    if not mask.is_cuda:
        if mask.device.type == "cpu":
            return sdf.sdf_green_device(mask)
        raise ValueError(f"sdf_green runs on cuda or cpu, not {mask.device}")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    if mask.dim() < 2:
        raise ValueError(f"mask must be [..., H, W], got {tuple(mask.shape)}")
    if not mask.is_contiguous():
        raise ValueError("mask must be contiguous")
    if mask.numel() == 0:
        raise ValueError(f"empty mask {tuple(mask.shape)}")
    H, W = mask.shape[-2:]
    B = mask.numel() // (H * W)
    if B > 65535:
        raise ValueError(f"{B} frames, more than a launch's 65535")
    green = torch.empty(mask.shape, dtype=torch.float32, device=mask.device)
    launch.launch("sdf_green", _kernels()[1], mask.get_device(),
                  mask.data_ptr(), green.data_ptr(), B, H, W)
    sdf_green.launches += 1
    return green


kept_composite.launches = 0  # launches; chip_smoke.py reads them
sdf_green.launches = 0
