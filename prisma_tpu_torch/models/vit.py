"""Vision Transformers: DINOv2 (patch 14) and timm's ViT (MiDaS DPT_Large's
ViT-L/16), counterpart of prisma_tpu/models/vit.py.

Parameter names are the checkpoints' (`cls_token`, `pos_embed`,
`patch_embed.proj`, `blocks.{i}.{norm1,attn.qkv,attn.proj,ls1.gamma,
norm2,mlp.fc1,mlp.fc2,ls2.gamma}`, `norm`; DINOv2 adds `mask_token`, timm's
blocks have no LayerScale), so a real state_dict loads with strict=True.
`mask_token` is only read under masked-image modelling and is kept for the
load. The forward follows the JAX functions: patch embedding as reshape +
one matmul in (c, kh, kw) order of the conv weight, the position embedding
resampled in f32 (DINOv2's scale-factor bicubic with w0 + 0.1, or MiDaS's
`_resize_pos_embed` bilinear), pre-norm blocks, and the selected blocks'
tokens, through the final LayerNorm or raw.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from prisma_tpu_torch.ops import nn as pnn
from prisma_tpu_torch.ops.resize import resize2d_nchw


@dataclass(frozen=True)
class ViTConfig:
    embed_dim: int
    depth: int
    num_heads: int
    patch_size: int = 14
    mlp_ratio: int = 4
    base_img_size: int = 518  # pos-embed grid = base_img_size // patch_size
    layerscale: bool = True  # DINOv2's ls1/ls2; timm's ViT has none
    interpolate_offset: float = 0.1

    @property
    def pos_grid(self) -> int:
        return self.base_img_size // self.patch_size


VIT_CONFIGS = {
    "vits": ViTConfig(embed_dim=384, depth=12, num_heads=6),
    "vitb": ViTConfig(embed_dim=768, depth=12, num_heads=12),
    "vitl": ViTConfig(embed_dim=1024, depth=24, num_heads=16),
}


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))


class Attention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        D = cfg.embed_dim
        self.num_heads = cfg.num_heads
        self.norm1 = nn.LayerNorm(D, eps=1e-6)
        self.attn = Attention(D)
        self.ls1 = LayerScale(D) if cfg.layerscale else None
        self.norm2 = nn.LayerNorm(D, eps=1e-6)
        self.mlp = Mlp(D, cfg.mlp_ratio * D)
        self.ls2 = LayerScale(D) if cfg.layerscale else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = pnn.attention(self.attn, pnn.layer_norm(self.norm1, x),
                          self.num_heads)
        x = x + (self.ls1.gamma * y if self.ls1 is not None else y)
        y = pnn.mlp(self.mlp, pnn.layer_norm(self.norm2, x))
        return x + (self.ls2.gamma * y if self.ls2 is not None else y)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        P = cfg.patch_size
        self.proj = nn.Conv2d(3, cfg.embed_dim, P, stride=P)


class VisionTransformer(nn.Module):
    """timm's VisionTransformer without its classifier (MiDaS DPT_Large's
    `pretrained.model`)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.embed_dim
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.pos_grid ** 2 + 1, D))
        self.patch_embed = PatchEmbed(cfg)
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(D, eps=1e-6)


class DinoVisionTransformer(VisionTransformer):
    def __init__(self, cfg: ViTConfig):
        super().__init__(cfg)
        self.mask_token = nn.Parameter(torch.zeros(1, cfg.embed_dim))


def patch_embed(p: PatchEmbed, x: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, 3, H, W] -> [B, (H/p)*(W/p), D] via reshape + matmul."""
    B, C, H, W = x.shape
    ph, pw = H // patch, W // patch
    x = x.reshape(B, C, ph, patch, pw, patch).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(B, ph * pw, C * patch * patch)
    w = p.proj.weight
    return torch.nn.functional.linear(x, w.reshape(w.shape[0], -1), p.proj.bias)


def interpolated_pos_embed(pos_embed: torch.Tensor, ph: int, pw: int,
                           cfg: ViTConfig, method: str = "cubic") -> torch.Tensor:
    """Resample the patch pos-embed grid to (ph, pw) in f32; cls stays.

    method 'cubic': DINOv2's scale-factor bicubic (w0 + 0.1 trick);
    'linear': MiDaS's `_resize_pos_embed`, bilinear with align_corners
    False."""
    g = cfg.pos_grid
    if ph == pw == g:
        return pos_embed
    cls_pe = pos_embed[:, :1]
    patch_pe = pos_embed[:, 1:].reshape(1, g, g, -1).permute(0, 3, 1, 2)
    if method == "cubic":
        off = cfg.interpolate_offset
        scale = ((ph + off) / g, (pw + off) / g)
        patch_pe = resize2d_nchw(patch_pe.float(), (ph, pw), method="cubic",
                                 align_corners=False, scale=scale)
    else:
        patch_pe = resize2d_nchw(patch_pe.float(), (ph, pw), method="linear",
                                 align_corners=False)
    patch_pe = patch_pe.permute(0, 2, 3, 1).reshape(1, ph * pw, -1)
    return torch.cat([cls_pe, patch_pe.to(pos_embed.dtype)], dim=1)


def get_intermediate_layers(vit: VisionTransformer, x: torch.Tensor,
                            n: int = 4, indices=None, norm: bool = True,
                            pos_embed_method: str = "cubic") -> list:
    """Run the ViT on x [B, 3, H, W]; return [(patch_tokens, cls_token)] of
    the last n blocks, each through the final LayerNorm (DINOv2), or, with
    explicit `indices` and norm=False, the raw outputs of those blocks
    (timm's forward hooks, as MiDaS DPT takes them)."""
    cfg = vit.cfg
    B, _, H, W = x.shape
    ph, pw = H // cfg.patch_size, W // cfg.patch_size
    tokens = patch_embed(vit.patch_embed, x, cfg.patch_size)
    cls = vit.cls_token.expand(B, 1, cfg.embed_dim).to(tokens.dtype)
    tokens = torch.cat([cls, tokens], dim=1)
    tokens = tokens + interpolated_pos_embed(vit.pos_embed, ph, pw, cfg,
                                             pos_embed_method)

    take = set(indices) if indices is not None \
        else set(range(cfg.depth - n, cfg.depth))
    outputs = []
    for i, block in enumerate(vit.blocks):
        tokens = block(tokens)
        if i in take:
            out = pnn.layer_norm(vit.norm, tokens) if norm else tokens
            outputs.append((out[:, 1:], out[:, 0]))
    return outputs
