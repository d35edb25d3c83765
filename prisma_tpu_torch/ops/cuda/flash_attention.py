"""Flash attention over [B, N, d] rows, and streamed global attention.

`flash_attention` launches the hand-written Hopper kernels of
`csrc/flash_attention.cu` on CUDA tensors: K1 without a bias, K2 with GMFlow's
shifted-window region bias (the counterparts of the TPU kernel `_flash_kernel`
in `prisma_tpu/ops/pallas/flash_attention.py`, bias-free and with
`region_bands`/`ids`). `flash_attention_streamed` launches K3 of
`csrc/flash_attention_streamed.cu` (the counterpart of
`_flash_kernel_streamed`): softmax(q·kᵀ·scale)·v with a narrow f32 v, for
GMFlow's global matching and propagation. On CPU tensors each takes its plain
version (`flash_attention_ref`, `flash_attention_streamed_ref`). There is no
fallback: a CUDA tensor a kernel does not take raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from prisma_tpu_torch.ops.cuda import launch

SUPPORTED_HEAD_DIMS = (32, 64, 128)
MAX_STREAMED_DV = 4
REGION_PENALTY = 100.0  # GMFlow's additive bias between tokens of two regions
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MODE_NONE, _MODE_BANDS, _MODE_IDS = 0, 1, 2


def region_codes(batch: int, n: int, region_bands: torch.Tensor,
                 win_w: int) -> torch.Tensor:
    """[batch, n] region code of each token, from per-window bands: batch row
    b is window b % nwin (the window axis fastest, as GMFlow's window split
    lays it out) and token j's code is 2·(j >= bh·win_w) + (j % win_w >= bw)."""
    bands = region_bands.long()
    j = torch.arange(n, device=bands.device)
    codes = (2 * (j[None] >= bands[:, :1] * win_w)
             + ((j % win_w)[None] >= bands[:, 1:]))
    return codes.repeat(batch // bands.shape[0], 1)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        region_bands: torch.Tensor | None = None,
                        win_w: int = 0, ids: torch.Tensor | None = None,
                        round_p: bool = False) -> torch.Tensor:
    """Plain version: dense f32 scores and softmax, cast back to q's dtype
    (the JAX package's `_xla_attention`). With region_bands + win_w, or ids
    ([B, N] labels), scores between tokens of different regions get -100.

    round_p: round the unnormalised probabilities P to v's dtype before P·V
    while the denominator sums f32 P, as the kernels and the TPU kernel do
    (a no-op for f32). Checks of the bf16 kernels hold them to this form.
    """
    s = torch.bmm(q.float() * q.shape[-1] ** -0.5, k.float().transpose(1, 2))
    if region_bands is not None:
        ids = region_codes(q.shape[0], q.shape[1], region_bands, win_w)
    if ids is not None:
        s -= (ids[:, :, None] != ids[:, None, :]).float().mul_(REGION_PENALTY)
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
    unmasked tail, a wrong scale or region) breaks the mean bound."""
    a = ref.float().abs()
    top = float(a.max())
    return 2 * 2.0 ** (math.floor(math.log2(top)) - 7), 2.0 ** -8 * float(a.mean())


@functools.cache
def _kernel():
    """The C entry point of K1/K2, built and loaded at first use."""
    p, i = ctypes.c_void_p, ctypes.c_int
    return launch.entry("flash_attention", "prisma_flash_attention",
                        [p] * 4 + [i] * 5 + [p] * 2 + [i] * 2)


def _check_operand(name: str, t: torch.Tensor, device: int) -> None:
    if t.get_device() != device:
        raise ValueError(f"{name} is on {t.device}, q on cuda:{device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


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
        _check_operand(name, t, q.get_device())


def _check_region(q, region_bands, win_w, ids):
    """-> (mode, bands, ids, nwin) for the C entry point."""
    B, N, _ = q.shape
    if region_bands is not None and ids is not None:
        raise ValueError("give region_bands or ids, not both")
    for name, t in (("region_bands", region_bands), ("ids", ids)):
        if t is not None:
            if t.dtype != torch.int32:
                raise TypeError(f"{name} must be int32, got {t.dtype}")
            _check_operand(name, t, q.get_device())
    if region_bands is not None:
        if region_bands.dim() != 2 or region_bands.shape[1] != 2:
            raise ValueError(f"region_bands must be [nwin, 2], got "
                             f"{tuple(region_bands.shape)}")
        nwin = region_bands.shape[0]
        if win_w <= 0 or B % nwin:
            raise ValueError(f"bands need win_w > 0 and a batch ({B}) that is "
                             f"a multiple of nwin ({nwin}); win_w={win_w}")
        return _MODE_BANDS, region_bands.data_ptr(), None, nwin
    if ids is not None:
        if tuple(ids.shape) != (B, N):
            raise ValueError(f"ids must be [{B}, {N}], got {tuple(ids.shape)}")
        return _MODE_IDS, None, ids.data_ptr(), 0
    return _MODE_NONE, None, None, 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    region_bands: torch.Tensor | None = None, win_w: int = 0,
                    ids: torch.Tensor | None = None) -> torch.Tensor:
    """q, k, v [B, N, d] contiguous, float32 or bfloat16, d in (32, 64, 128)
    -> [B, N, d] in q's dtype. f32 softmax state and accumulation.

    region_bands ([nwin, 2] int32 (bh, bw) per window) + win_w, or ids ([B,
    N] int32): GMFlow's shifted-window bias, -100 between tokens of
    different regions (K2); neither: K1."""
    if not q.is_cuda:
        if q.device.type == "cpu":
            return flash_attention_ref(q, k, v, region_bands=region_bands,
                                       win_w=win_w, ids=ids)
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    _check(q, k, v)
    mode, bands_ptr, ids_ptr, nwin = _check_region(q, region_bands, win_w, ids)
    out = torch.empty_like(q)
    B, N, d = q.shape
    launch.launch("flash_attention", _kernel(), q.get_device(), q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), out.data_ptr(), B, N, d,
                  _DTYPE_CODES[q.dtype], mode, bands_ptr, ids_ptr, nwin, win_w)
    if mode == _MODE_NONE:
        flash_attention.launches += 1
    else:
        flash_attention.region_launches += 1
    return out


flash_attention.launches = 0         # K1 launches; chip_smoke.py reads them
flash_attention.region_launches = 0  # K2 launches


# --------------------------------------------------------------- streamed (K3)

def flash_attention_streamed_ref(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, scale: float,
                                 key_chunk: int = 2048) -> torch.Tensor:
    """Plain version: softmax(q·kᵀ·scale)·v streamed over key chunks with
    an online softmax in f32, never materialising [B, N, M] (the JAX
    package's `_attn_blockwise`). q [B, N, C], k [B, M, C], v [M, dv]
    (shared) or [B, M, dv] -> [B, N, dv] f32. The scores are f32 products of
    q and k upcast, as the kernel's tensor cores and the TPU kernel
    (preferred_element_type=f32) compute them."""
    B, N, _ = q.shape
    M = k.shape[1]
    if v.dim() == 2:
        v = v[None].expand(B, *v.shape)
    qf = q.float()
    m = torch.full((B, N), -math.inf, device=q.device)
    den = torch.zeros(B, N, device=q.device)
    num = torch.zeros(B, N, v.shape[-1], device=q.device)
    for k0 in range(0, M, key_chunk):
        s = torch.bmm(qf, k[:, k0:k0 + key_chunk].float().transpose(1, 2)) * scale
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        den = den * alpha + p.sum(dim=-1)
        num = num * alpha[..., None] + torch.bmm(p, v[:, k0:k0 + key_chunk].float())
        m = m_new
    return num / den[..., None]


def streamed_bounds(v: torch.Tensor) -> tuple[float, float]:
    """(max, mean) bounds on |kernel - ref| for K3 against its plain version.
    Both take f32 scores, f32 unrounded P and f32 v, so they part only by
    summation order and exp2 against exp: relative errors near 1e-6 in each
    weight, which move an output by about 1e-6 of the spread of v. The
    bounds are 2^-14 and 2^-18 of max |v| (0.088 and 0.0055 px for v up to
    1440); an unmasked ragged tail or a lost key tile moves every output by
    far more (tests/test_torch_flash_attention.py)."""
    top = float(v.float().abs().max())
    return 2.0 ** -14 * top, 2.0 ** -18 * top


@functools.cache
def _streamed_kernel():
    """The C entry point of K3, built and loaded at first use."""
    return launch.entry("flash_attention_streamed",
                        "prisma_flash_attention_streamed",
                        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float])


def flash_attention_streamed(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, scale: float) -> torch.Tensor:
    """q [B, N, d], k [B, M, d] contiguous, float32 or bfloat16, d in (32,
    64, 128); v [B, M, dv] contiguous float32 with 1 <= dv <= 4 -> [B, N, dv]
    f32. P·V in f32 with P unrounded. A bf16 v raises TypeError: upcast it
    (exact) first. The kernel takes a positive, finite scale (a softmax
    temperature); another raises ValueError."""
    if not q.is_cuda:
        if q.device.type == "cpu":
            return flash_attention_streamed_ref(q, k, v, scale)
        raise ValueError(f"flash_attention_streamed runs on cuda or cpu, "
                         f"not {q.device}")
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"q, k, v must be [B, N, d], [B, M, d], [B, M, dv]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, N, d = q.shape
    M, dv = k.shape[1], v.shape[-1]
    if k.shape[0] != B or k.shape[2] != d or v.shape[:2] != (B, M):
        raise ValueError(f"shapes do not agree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype:
        raise TypeError(f"q, k must both be float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}")
    if v.dtype != torch.float32:
        raise TypeError(f"v must be float32 (upcast it first), got {v.dtype}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {SUPPORTED_HEAD_DIMS}")
    if not 1 <= dv <= MAX_STREAMED_DV or B == 0 or N == 0 or M == 0:
        raise ValueError(f"need 1 <= dv <= {MAX_STREAMED_DV} and non-empty "
                         f"B, N, M; got {tuple(v.shape)}, N={N}")
    if not 0 < scale < math.inf:
        raise ValueError(f"the scale must be positive and finite, got {scale}")
    device = q.get_device()
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, device)
    out = torch.empty((B, N, dv), device=q.device, dtype=torch.float32)
    launch.launch("flash_attention_streamed", _streamed_kernel(), device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                  N, M, d, dv, _DTYPE_CODES[q.dtype], float(scale))
    flash_attention_streamed.launches += 1
    return out


flash_attention_streamed.launches = 0  # K3 launches; chip_smoke.py reads them
