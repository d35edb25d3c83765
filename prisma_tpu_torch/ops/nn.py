"""Small neural-net primitives (counterpart of prisma_tpu/ops/nn.py).

Each op takes its parameters as `p`, any object with the torch layout's
`weight` and `bias` (None where absent): an nn.Linear, nn.Conv2d,
nn.LayerNorm, ..., as the JAX ops take a parameter dict. Convolutions are
NCHW with OIHW weights. The numerics follow the JAX ops: a single-pass
f32-moment layer norm, and gelu tanh-approximate on bf16 and exact on f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from prisma_tpu_torch.ops.cuda.flash_attention import flash_attention


def linear(p, x: torch.Tensor) -> torch.Tensor:
    """x @ Wᵀ + b with W stored [out, in]."""
    return F.linear(x, p.weight, p.bias)


def layer_norm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Stats in f32 whatever x's dtype, single pass (E[x²] − E[x]², clamped
    at 0); normalised, cast back to x's dtype, then scaled and shifted."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
    y = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    return y * p.weight + p.bias


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) gelu on f32; tanh-approximate on bf16."""
    if x.dtype == torch.bfloat16:
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)


def conv2d(p, x: torch.Tensor, stride: int = 1, padding: int = 0,
           groups: int = 1) -> torch.Tensor:
    """NCHW conv with weights stored OIHW ([cout, cin/groups, kh, kw])."""
    return F.conv2d(x, p.weight, p.bias, stride=stride,
                    padding=padding, groups=groups)


def batch_norm(bn, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode batch norm as the JAX package computes it: folded in f32 to
    a per-channel affine, scale = w / sqrt(var + eps), bias = b - mean·scale
    (`torch_convert._fold_bn`), applied in x's dtype on NCHW."""
    scale = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
    bias = bn.bias.float() - bn.running_mean.float() * scale
    return (x * scale.to(x.dtype)[:, None, None]
            + bias.to(x.dtype)[:, None, None])


def conv_transpose_blocky(p, x: torch.Tensor) -> torch.Tensor:
    """ConvTranspose2d with kernel_size == stride and no padding, weights
    [in, out, k, k]: each input pixel emits a k x k block (one einsum)."""
    w = p.weight
    k = w.shape[-1]
    B, _, H, W = x.shape
    y = torch.einsum("bchw,coij->bohiwj", x, w).reshape(B, w.shape[1],
                                                         H * k, W * k)
    if p.bias is not None:
        y = y + p.bias[:, None, None]
    return y


def attention(p, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Multi-head self-attention (DINOv2/timm convention), x [B, N, D].

    p has `qkv` (D -> 3D) and `proj` (D -> D). The softmax(QKᵀ)V core goes
    through `flash_attention`: the CUDA kernel on the card, the plain dense
    form on the CPU.
    """
    B, N, D = x.shape
    d = D // num_heads
    qkv = linear(p.qkv, x).reshape(B, N, 3, num_heads, d)
    qkv = qkv.permute(2, 0, 3, 1, 4).contiguous().view(3, B * num_heads, N, d)
    out = flash_attention(qkv[0], qkv[1], qkv[2])
    out = out.reshape(B, num_heads, N, d).transpose(1, 2).reshape(B, N, D)
    return linear(p.proj, out)


def mlp(p, x: torch.Tensor) -> torch.Tensor:
    return linear(p.fc2, gelu(linear(p.fc1, x)))
