"""Flash attention: softmax(q·kᵀ·d^-0.5)·v over [B, N, d] rows.

`flash_attention` launches the hand-written Hopper kernel of
`csrc/flash_attention.cu` (the counterpart of the TPU kernel `_flash_kernel`
in `prisma_tpu/ops/pallas/flash_attention.py`) on CUDA tensors, and takes the
plain version `flash_attention_ref` on CPU tensors. There is no fallback: a
CUDA tensor the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from prisma_tpu_torch.ops.cuda import build

SUPPORTED_HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        round_p: bool = False) -> torch.Tensor:
    """Plain version: dense f32 scores and softmax, cast back to q's dtype
    (the JAX package's `_xla_attention`).

    round_p: round the unnormalised probabilities P to v's dtype before P·V
    while the denominator sums f32 P, as the kernel and the TPU kernel do
    (a no-op for f32). Checks of the bf16 kernel hold it to this form.
    """
    s = torch.bmm(q.float() * q.shape[-1] ** -0.5, k.float().transpose(1, 2))
    if not round_p:
        return torch.bmm(torch.softmax(s, dim=-1), v.float()).to(q.dtype)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    pv = torch.bmm(p.to(v.dtype).float(), v.float())
    return (pv / p.sum(dim=-1, keepdim=True)).to(q.dtype)


def bf16_bounds(ref: torch.Tensor) -> tuple[float, float]:
    """(max, mean) bounds on |kernel - ref| for a bf16 kernel output against
    `flash_attention_ref(..., round_p=True)`. Each output may land one bf16
    ulp off, and P rounded at a running max differs from P rounded at the row
    max by an ulp of P, so max |err| <= 2 ulp of max |ref|. Those differences
    are unbiased and average out, so mean |err| <= 2^-8 mean |ref| (half an
    ulp); a fault that moves every output of a row (a key lost or added, an
    unmasked tail, a wrong scale) breaks the mean bound."""
    a = ref.float().abs()
    top = float(a.max())
    return 2 * 2.0 ** (math.floor(math.log2(top)) - 7), 2.0 ** -8 * float(a.mean())


@functools.cache
def _kernel():
    """The C entry point, built and loaded at first use."""
    fn = build.load("flash_attention").prisma_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one [B, N, d] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {SUPPORTED_HEAD_DIMS}")
    if q.shape[0] == 0 or q.shape[1] == 0:
        raise ValueError(f"empty attention input {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """q, k, v [B, N, d] contiguous, float32 or bfloat16, d in (32, 64, 128)
    -> [B, N, d] in q's dtype. f32 softmax state and accumulation."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    _check(q, k, v)
    out = torch.empty_like(q)
    B, N, d = q.shape
    with torch.cuda.device(q.device):
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), B, N, d, _DTYPE_CODES[q.dtype],
                        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0  # kernel launches; chip_smoke.py reads it
