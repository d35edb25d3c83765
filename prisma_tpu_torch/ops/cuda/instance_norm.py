"""Instance norm (+ optional ReLU) over the H·W plane of each (sample,
channel) of an NCHW tensor.

`instance_norm_relu` launches the hand-written Hopper kernel of
`csrc/instance_norm.cu` (K4, the counterpart of the TPU kernels
`_stats_kernel` + `_apply_kernel` in `prisma_tpu/ops/pallas/instance_norm.py`)
on CUDA tensors, and takes the plain version `instance_norm_relu_ref` on CPU
tensors. There is no fallback: a CUDA tensor the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from prisma_tpu_torch.ops.cuda import launch

EPS = 1e-5
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def instance_norm_relu_ref(x: torch.Tensor, eps: float = EPS,
                           relu: bool = False) -> torch.Tensor:
    """Plain version: f32 single-pass moments over (H, W), then
    (x - mean) · rsqrt(max(E[x²] - mean², 0) + eps) in f32, an optional
    ReLU, and one cast back to x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=(-2, -1), keepdim=True)
    var = ((xf * xf).mean(dim=(-2, -1), keepdim=True) - mean * mean).clamp_min(0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def bounds(ref: torch.Tensor) -> tuple[float, float]:
    """(max, mean) bounds on |kernel - ref| for K4 against its plain version.
    Both compute every value in f32 and cast once; they part by the order of
    the f32 sums only, a relative 1e-6 or so. In f32 that is far below the
    2e-5 of the JAX package's instance-norm tests, which an eps slip (1e-5
    -> 1e-3) or a ddof slip (an unbiased variance) breaks on small planes
    (tests/test_torch_instance_norm.py). In bf16 the cast can flip the last
    bit where the f32 value sits at a rounding edge: max |err| <= 1 ulp of
    max |ref|, and mean |err| <= 2^-12 mean |ref|, which a wrong mean or
    variance on a whole plane breaks."""
    if ref.dtype == torch.float32:
        return 2e-5, 2e-5
    a = ref.float().abs()
    top = float(a.max())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0
    return ulp, 2.0 ** -12 * float(a.mean())


@functools.cache
def _kernel():
    """The C entry point, built and loaded at first use."""
    i = ctypes.c_int
    return launch.entry("instance_norm", "prisma_instance_norm_relu",
                        [ctypes.c_void_p] * 2 + [i] * 3 + [ctypes.c_float, i])


def instance_norm_relu(x: torch.Tensor, eps: float = EPS,
                       relu: bool = False) -> torch.Tensor:
    """x [N, C, H, W] contiguous, float32 or bfloat16 -> the same shape and
    dtype: each (n, c) plane normalised by its own f32 mean and variance,
    then ReLU when relu."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return instance_norm_relu_ref(x, eps, relu)
        raise ValueError(f"instance_norm_relu runs on cuda or cpu, not {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be [N, C, H, W], got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (NCHW)")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    N, C, H, W = x.shape
    if N * C == 0 or H * W == 0:
        raise ValueError(f"empty instance-norm input {tuple(x.shape)}")
    y = torch.empty_like(x)
    launch.launch("instance_norm_relu", _kernel(), x.get_device(), x.data_ptr(),
                  y.data_ptr(), N * C, H * W, _DTYPE_CODES[x.dtype], float(eps),
                  int(relu))
    instance_norm_relu.launches += 1
    return y


instance_norm_relu.launches = 0  # K4 launches; chip_smoke.py reads them
