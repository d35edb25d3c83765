"""BEiT-Large backbone, the MiDaS DPT_BEiT_L_384 core (counterpart of
prisma_tpu/models/beit.py).

The core of ZoeD_N and of PatchFusion's coarse and fine models: a patch-16
ViT-L without absolute position embeddings; in each block a relative
position bias, a learned table over the (2h-1)x(2w-1) offsets plus 3 cls
entries, resampled bilinearly from the square 24x24 pretraining window to
the input's grid (the MiDaS adapter); q and v biases (k has none); and
LayerScale (gamma_1, gamma_2) on both residual branches.

Parameter names are the timm BEiT's, as the MiDaS checkpoint holds them
under `pretrained.model.*`: `cls_token`, `patch_embed.proj`,
`blocks.{i}.{norm1, attn.qkv (no bias), attn.q_bias, attn.v_bias,
attn.relative_position_bias_table, attn.proj, gamma_1, norm2, mlp.fc1,
mlp.fc2, gamma_2}`. The checkpoint's `relative_position_index` buffers are a
function of the grid and are computed here instead.

Attention stays dense plain torch (the bias is arbitrary): the scores in the
compute dtype, the bias table resampled and gathered in f32 and cast where
it joins the scores, as the JAX function does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from prisma_tpu_torch.models import vit
from prisma_tpu_torch.ops import nn as pnn
from prisma_tpu_torch.ops.resize import resize2d

PRETRAIN_WINDOW = (24, 24)  # 384 / 16
HOOKS = (5, 11, 17, 23)


@dataclass(frozen=True)
class BEiTConfig:
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    patch_size: int = 16
    mlp_ratio: int = 4


def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """[wh*ww + 1, wh*ww + 1] indices into a table of (2wh-1)(2ww-1) + 3
    rows (timm's convention: the last three rows are cls->token,
    token->cls and cls->cls)."""
    num_rel = (2 * wh - 1) * (2 * ww - 1)
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel.astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    idx = np.zeros((wh * ww + 1, wh * ww + 1), np.int64)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, 0:] = num_rel
    idx[0:, 0] = num_rel + 1
    idx[0, 0] = num_rel + 2
    return idx


def resize_rel_pos_table(table: torch.Tensor, old_window, new_window):
    """The MiDaS adapter: the (2h-1)x(2w-1) sub-table resampled bilinearly
    (align_corners False) to the new window in f32; the 3 cls rows pass
    through. The table is returned as it is when the windows agree."""
    oh, ow = 2 * old_window[0] - 1, 2 * old_window[1] - 1
    nh, nw = 2 * new_window[0] - 1, 2 * new_window[1] - 1
    if (oh, ow) == (nh, nw):
        return table
    sub = table[: oh * ow].reshape(oh, ow, -1).float()
    new_sub = resize2d(sub, (nh, nw), method="linear")
    return torch.cat([new_sub.reshape(nh * nw, -1),
                      table[oh * ow:].float()], dim=0)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        num_rel = (2 * PRETRAIN_WINDOW[0] - 1) * (2 * PRETRAIN_WINDOW[1] - 1)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(num_rel + 3, num_heads))
        self.proj = nn.Linear(dim, dim)


class Block(nn.Module):
    def __init__(self, cfg: BEiTConfig):
        super().__init__()
        D = cfg.embed_dim
        self.norm1 = nn.LayerNorm(D, eps=1e-6)
        self.attn = Attention(D, cfg.num_heads)
        self.gamma_1 = nn.Parameter(torch.ones(D))
        self.norm2 = nn.LayerNorm(D, eps=1e-6)
        self.mlp = vit.Mlp(D, cfg.mlp_ratio * D)
        self.gamma_2 = nn.Parameter(torch.ones(D))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: BEiTConfig):
        super().__init__()
        P = cfg.patch_size
        self.proj = nn.Conv2d(3, cfg.embed_dim, P, stride=P)


class BEiT(nn.Module):
    def __init__(self, cfg: BEiTConfig):
        super().__init__()
        self.cfg = cfg
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.embed_dim))
        self.patch_embed = PatchEmbed(cfg)
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self._bias_cache: dict = {}

    def rel_pos_bias(self, wh: int, ww: int) -> list[torch.Tensor]:
        """Each block's bias [heads, N, N] (f32) for a (wh, ww) token grid.

        Computed once per grid and kept until a table changes (a load, a
        cast or a move gives new storage or a new version)."""
        tables = [b.attn.relative_position_bias_table for b in self.blocks]
        key = (wh, ww, tuple((t.data_ptr(), t._version) for t in tables))
        cached = self._bias_cache.get((wh, ww))
        if cached is not None and cached[0] == key:
            return cached[1]
        idx = torch.from_numpy(relative_position_index(wh, ww)).to(
            tables[0].device)
        with torch.no_grad():
            biases = [resize_rel_pos_table(t, PRETRAIN_WINDOW, (wh, ww))
                      .float()[idx].permute(2, 0, 1).contiguous()
                      for t in tables]
        self._bias_cache[(wh, ww)] = (key, biases)
        return biases


def attention(p: Attention, x: torch.Tensor,
              rel_bias: torch.Tensor) -> torch.Tensor:
    """x [B, N, D]; q and v biased, k not; the f32 bias [heads, N, N] cast
    to the scores' dtype where it joins them."""
    B, N, D = x.shape
    h = p.num_heads
    d = D // h
    qkv = pnn.linear(p.qkv, x).view(B, N, 3, h, d)
    q = qkv[:, :, 0] + p.q_bias.view(h, d)
    k = qkv[:, :, 1]
    v = qkv[:, :, 2] + p.v_bias.view(h, d)
    attn = torch.einsum("bnhd,bmhd->bhnm", q * d ** -0.5, k)
    attn = torch.softmax(attn + rel_bias.to(attn.dtype), dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(B, N, D)
    return pnn.linear(p.proj, out)


def block(p: Block, x: torch.Tensor, rel_bias: torch.Tensor) -> torch.Tensor:
    x = x + p.gamma_1 * attention(p.attn, pnn.layer_norm(p.norm1, x), rel_bias)
    return x + p.gamma_2 * pnn.mlp(p.mlp, pnn.layer_norm(p.norm2, x))


def get_intermediate_layers(model: BEiT, x: torch.Tensor, hooks=None) -> list:
    """x [B, 3, H, W] normalised (H, W multiples of 16) -> [(tokens, cls)]
    after the hooked blocks (5, 11, 17, 23), raw (no final norm); a model
    shallower than 24 blocks hooks its last four."""
    B, _, H, W = x.shape
    depth = len(model.blocks)
    if hooks is None:
        hooks = HOOKS if depth >= 24 else tuple(range(depth - 4, depth))
    P = model.cfg.patch_size
    biases = model.rel_pos_bias(H // P, W // P)
    tokens = vit.patch_embed(model.patch_embed, x, P)
    cls = model.cls_token.expand(B, 1, tokens.shape[-1]).to(tokens.dtype)
    tokens = torch.cat([cls, tokens], dim=1)
    outputs = []
    for i, (blk, bias) in enumerate(zip(model.blocks, biases)):
        tokens = block(blk, tokens, bias)
        if i in hooks:
            outputs.append((tokens[:, 1:], tokens[:, 0]))
    return outputs


@torch.no_grad()
def init_params(model: BEiT, generator: torch.Generator) -> BEiT:
    """Random init in place with the JAX package's distributions (its
    weights differ: they come from jax.random): linear and patch weights
    normal * fan_in^-0.5, biases zero, norms one, cls normal * 0.02, the
    bias tables normal * 0.02, LayerScales 0.1."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            w = m.weight
            w.normal_(generator=generator).mul_(w[0].numel() ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, Attention):
            m.q_bias.zero_()
            m.v_bias.zero_()
            m.relative_position_bias_table.normal_(generator=generator).mul_(0.02)
        elif isinstance(m, Block):
            m.gamma_1.fill_(0.1)
            m.gamma_2.fill_(0.1)
    model.cls_token.normal_(generator=generator).mul_(0.02)
    return model
