"""Stable Diffusion 2's UNet and VAE, the Marigold backbone (counterpart of
prisma_tpu/models/sd2.py).

The diffusers UNet2DConditionModel and AutoencoderKL of the Marigold
snapshot: UNet in 8 channels, out 4, blocks (320, 640, 1280, 1280), two
layers a block, cross-attention over 1024-wide context, linear projections,
heads of 64; the VAE's 4-channel latents over (128, 256, 512, 512).
Parameter names are the snapshot's (`unet/`, `vae/`): `time_embedding.
linear_{1,2}`, `conv_in`, `down_blocks.{i}.resnets.{j}.{norm1, conv1,
time_emb_proj, norm2, conv2, conv_shortcut}`, `.attentions.{j}.{norm,
proj_in, transformer_blocks.0.{norm1, attn1, norm2, attn2, norm3,
ff.net.0.proj, ff.net.2}, proj_out}`, `.downsamplers.0.conv`, `mid_block`,
`up_blocks` (`upsamplers.0.conv`), `conv_norm_out`, `conv_out`; the VAE's
`encoder.*`, `quant_conv`, `post_quant_conv`, `decoder.*`, its mid-block
attention `group_norm`, `to_q`, `to_k`, `to_v`, `to_out.0`.

The numerics are the JAX package's: group norms take both moments in f32
in one pass (eps 1e-6 everywhere), the timestep embedding flips sin to cos
with a frequency shift of 1, and an odd latent size's nearest-2x map is
cropped to the next skip's size before the upsampler's conv. Attention: a
self-attention over N >= 1024 tokens with heads of 32, 64 or 128 channels
runs through `flash_attention` (K1 on the card), as the JAX package sends
it to its Pallas kernel; cross-attention (over the 2 tokens of the empty
prompt) and the VAE's one-head attention (512 channels) stay dense. NCHW
throughout.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from prisma_tpu_torch.ops import nn as pnn
from prisma_tpu_torch.ops.cuda.flash_attention import (SUPPORTED_HEAD_DIMS,
                                                       flash_attention)

FLASH_MIN_TOKENS = 1024


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 8
    out_channels: int = 4
    block_channels: tuple = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    head_dim: int = 64
    norm_groups: int = 32


@dataclass(frozen=True)
class VAEConfig:
    block_channels: tuple = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    norm_groups: int = 32


# ------------------------------------------------------------------ modules

class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int,
                 temb: int | None = None):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=1e-6)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb, cout) if temb else None
        self.norm2 = nn.GroupNorm(groups, cout, eps=1e-6)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None


class Attention(nn.Module):
    """diffusers Attention: to_q, to_k, to_v (biased in the VAE only) and
    `to_out.0`; `group_norm` in the VAE's mid block."""

    def __init__(self, dim: int, kv_dim: int, bias: bool = False,
                 groups: int | None = None):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, dim, eps=1e-6) if groups \
            else None
        self.to_q = nn.Linear(dim, dim, bias=bias)
        self.to_k = nn.Linear(kv_dim, dim, bias=bias)
        self.to_v = nn.Linear(kv_dim, dim, bias=bias)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim), nn.Identity()])


class GEGLU(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Linear(dim, 8 * dim)


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim), nn.Identity(),
                                  nn.Linear(4 * dim, dim)])


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, ctx: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, dim)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, ctx)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)


class Transformer2DModel(nn.Module):
    def __init__(self, dim: int, ctx: int, groups: int):
        super().__init__()
        self.norm = nn.GroupNorm(groups, dim, eps=1e-6)
        self.proj_in = nn.Linear(dim, dim)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(dim, ctx)])
        self.proj_out = nn.Linear(dim, dim)


class Sampler(nn.Module):
    """Downsample2D / Upsample2D: one 3x3 conv under `conv`."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)


class Block(nn.Module):
    """A down or up block: resnets, attentions (or none), a down- or
    upsampler (or none)."""

    def __init__(self, resnets: list, attentions: list | None = None,
                 down: int = 0, up: int = 0):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions) if attentions else None
        self.downsamplers = nn.ModuleList([Sampler(down)]) if down else None
        self.upsamplers = nn.ModuleList([Sampler(up)]) if up else None


class MidBlock(nn.Module):
    def __init__(self, resnets: list, attention: nn.Module):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList([attention])


class TimestepEmbedding(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(cin, dim)
        self.linear_2 = nn.Linear(dim, dim)


class UNet2DConditionModel(nn.Module):
    def __init__(self, cfg: UNetConfig = UNetConfig()):
        super().__init__()
        self.cfg = cfg
        bc, g, ctx = cfg.block_channels, cfg.norm_groups, cfg.cross_attention_dim
        temb = bc[0] * 4
        self.time_embedding = TimestepEmbedding(bc[0], temb)
        self.conv_in = nn.Conv2d(cfg.in_channels, bc[0], 3, padding=1)
        skips, cin, down = [bc[0]], bc[0], []
        for bi, ch in enumerate(bc):
            last = bi == len(bc) - 1
            resnets, attns = [], []
            for li in range(cfg.layers_per_block):
                resnets.append(ResnetBlock2D(cin if li == 0 else ch, ch, g, temb))
                if not last:
                    attns.append(Transformer2DModel(ch, ctx, g))
                skips.append(ch)
            if not last:
                skips.append(ch)
            down.append(Block(resnets, attns, down=0 if last else ch))
            cin = ch
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = MidBlock(
            [ResnetBlock2D(bc[-1], bc[-1], g, temb) for _ in range(2)],
            Transformer2DModel(bc[-1], ctx, g))
        up, prev = [], bc[-1]
        for bi, ch in enumerate(reversed(bc)):
            resnets, attns = [], []
            for li in range(cfg.layers_per_block + 1):
                cin = (prev if li == 0 else ch) + skips.pop()
                resnets.append(ResnetBlock2D(cin, ch, g, temb))
                if bi > 0:
                    attns.append(Transformer2DModel(ch, ctx, g))
            up.append(Block(resnets, attns, up=ch if bi < len(bc) - 1 else 0))
            prev = ch
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = nn.GroupNorm(g, bc[0], eps=1e-6)
        self.conv_out = nn.Conv2d(bc[0], cfg.out_channels, 3, padding=1)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        vc, g = cfg.block_channels, cfg.norm_groups
        self.conv_in = nn.Conv2d(3, vc[0], 3, padding=1)
        blocks, cin = [], vc[0]
        for bi, ch in enumerate(vc):
            blocks.append(Block(
                [ResnetBlock2D(cin if li == 0 else ch, ch, g)
                 for li in range(cfg.layers_per_block)],
                down=ch if bi < len(vc) - 1 else 0))
            cin = ch
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _vae_mid(vc[-1], g)
        self.conv_norm_out = nn.GroupNorm(g, vc[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(vc[-1], 2 * cfg.latent_channels, 3, padding=1)


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        vc, g = cfg.block_channels, cfg.norm_groups
        rvc = list(reversed(vc))
        self.conv_in = nn.Conv2d(cfg.latent_channels, vc[-1], 3, padding=1)
        self.mid_block = _vae_mid(vc[-1], g)
        blocks = []
        for bi, ch in enumerate(rvc):
            prev = rvc[max(bi - 1, 0)]
            blocks.append(Block(
                [ResnetBlock2D(prev if li == 0 else ch, ch, g)
                 for li in range(cfg.layers_per_block + 1)],
                up=ch if bi < len(rvc) - 1 else 0))
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = nn.GroupNorm(g, vc[0], eps=1e-6)
        self.conv_out = nn.Conv2d(vc[0], 3, 3, padding=1)


def _vae_mid(ch: int, groups: int) -> MidBlock:
    return MidBlock([ResnetBlock2D(ch, ch, groups) for _ in range(2)],
                    Attention(ch, ch, bias=True, groups=groups))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        lat = cfg.latent_channels
        self.encoder = Encoder(cfg)
        self.quant_conv = nn.Conv2d(2 * lat, 2 * lat, 1)
        self.post_quant_conv = nn.Conv2d(lat, lat, 1)
        self.decoder = Decoder(cfg)


# -------------------------------------------------------------- functions

def group_norm(p: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """Both moments in f32 in one pass over [B, C, H, W] (E[x²] − E[x]²,
    clamped at 0); normalised, cast back to x's dtype, then scaled and
    shifted in it."""
    B, C, H, W = x.shape
    g = x.reshape(B, p.num_groups, -1).float()
    mu = g.mean(dim=-1, keepdim=True)
    var = ((g * g).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
    g = ((g - mu) * torch.rsqrt(var + p.eps)).reshape(B, C, H, W).to(x.dtype)
    return g * p.weight[:, None, None] + p.bias[:, None, None]


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0,
                       shift: float = 1.0) -> torch.Tensor:
    """diffusers get_timestep_embedding with flip_sin_to_cos and
    downscale_freq_shift 1: [cos, sin] of t·exp(-ln(P)·i / (half − 1)), f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device)
                      / (half - shift))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def resnet_block(p: ResnetBlock2D, x: torch.Tensor,
                 temb: torch.Tensor | None = None) -> torch.Tensor:
    h = pnn.conv2d(p.conv1, F.silu(group_norm(p.norm1, x)), padding=1)
    if p.time_emb_proj is not None:
        h = h + pnn.linear(p.time_emb_proj, F.silu(temb))[:, :, None, None]
    h = pnn.conv2d(p.conv2, F.silu(group_norm(p.norm2, h)), padding=1)
    if p.conv_shortcut is not None:
        x = pnn.conv2d(p.conv_shortcut, x)
    return x + h


def attention_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int) -> torch.Tensor:
    """softmax(q·kᵀ·d^-½)·v in the inputs' dtype: q [B, N, C], k and v
    [B, M, C] -> [B, N, C]."""
    B, N, C = q.shape
    M = k.shape[1]
    d = C // heads
    q = q.reshape(B, N, heads, d).transpose(1, 2)
    k = k.reshape(B, M, heads, d).transpose(1, 2)
    v = v.reshape(B, M, heads, d).transpose(1, 2)
    attn = torch.softmax(torch.matmul(q * d ** -0.5, k.transpose(-1, -2)),
                         dim=-1)
    return torch.matmul(attn, v).transpose(1, 2).reshape(B, N, C)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              heads: int) -> torch.Tensor:
    """A long self-attention (N >= 1024 keys as queries, heads of 32, 64 or
    128) through `flash_attention`, folded to [B·heads, N, d]; the rest
    dense."""
    B, N, C = q.shape
    d = C // heads
    if N >= FLASH_MIN_TOKENS and k.shape[1] == N and d in SUPPORTED_HEAD_DIMS:
        def fold(t):
            return t.reshape(B, N, heads, d).transpose(1, 2).reshape(
                B * heads, N, d).contiguous()

        out = flash_attention(fold(q), fold(k), fold(v))
        return out.reshape(B, heads, N, d).transpose(1, 2).reshape(B, N, C)
    return attention_dense(q, k, v, heads)


def cross_attention(p: Attention, x: torch.Tensor, context: torch.Tensor,
                    heads: int) -> torch.Tensor:
    out = attention(pnn.linear(p.to_q, x), pnn.linear(p.to_k, context),
                    pnn.linear(p.to_v, context), heads)
    return pnn.linear(p.to_out[0], out)


def geglu_ff(p: FeedForward, x: torch.Tensor) -> torch.Tensor:
    a, b = pnn.linear(p.net[0].proj, x).chunk(2, dim=-1)
    return pnn.linear(p.net[2], a * pnn.gelu(b))


def basic_transformer(p: BasicTransformerBlock, x: torch.Tensor,
                      context: torch.Tensor, heads: int) -> torch.Tensor:
    h = pnn.layer_norm(p.norm1, x, eps=1e-5)
    x = x + cross_attention(p.attn1, h, h, heads)
    h = pnn.layer_norm(p.norm2, x, eps=1e-5)
    x = x + cross_attention(p.attn2, h, context, heads)
    return x + geglu_ff(p.ff, pnn.layer_norm(p.norm3, x, eps=1e-5))


def spatial_transformer(p: Transformer2DModel, x: torch.Tensor,
                        context: torch.Tensor, heads: int) -> torch.Tensor:
    """Transformer2DModel with linear projections (SD2)."""
    B, C, H, W = x.shape
    h = group_norm(p.norm, x).reshape(B, C, H * W).transpose(1, 2)
    h = pnn.linear(p.proj_in, h)
    for bp in p.transformer_blocks:
        h = basic_transformer(bp, h, context, heads)
    h = pnn.linear(p.proj_out, h)
    return h.transpose(1, 2).reshape(B, C, H, W) + x


def _upsample_nearest(h: torch.Tensor, size=None) -> torch.Tensor:
    """Nearest 2x, cropped to `size` (an odd skip: 27 -> 14 -> 28 -> 27)."""
    h = h.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    if size is not None and tuple(h.shape[-2:]) != tuple(size):
        h = h[..., :size[0], :size[1]]
    return h


def unet_forward(model: UNet2DConditionModel, x: torch.Tensor, t: torch.Tensor,
                 context: torch.Tensor) -> torch.Tensor:
    """x [B, in_ch, H, W]; t [B]; context [B, L, ctx] -> [B, out_ch, H, W]."""
    cfg = model.cfg
    temb = timestep_embedding(t, cfg.block_channels[0]).to(x.dtype)
    te = model.time_embedding
    temb = pnn.linear(te.linear_2, F.silu(pnn.linear(te.linear_1, temb)))

    h = pnn.conv2d(model.conv_in, x, padding=1)
    skips = [h]
    for bi, block in enumerate(model.down_blocks):
        heads = cfg.block_channels[bi] // cfg.head_dim
        for li, rp in enumerate(block.resnets):
            h = resnet_block(rp, h, temb)
            if block.attentions is not None:
                h = spatial_transformer(block.attentions[li], h, context, heads)
            skips.append(h)
        if block.downsamplers is not None:
            h = pnn.conv2d(block.downsamplers[0].conv, h, stride=2, padding=1)
            skips.append(h)

    heads = cfg.block_channels[-1] // cfg.head_dim
    mid = model.mid_block
    h = resnet_block(mid.resnets[0], h, temb)
    h = spatial_transformer(mid.attentions[0], h, context, heads)
    h = resnet_block(mid.resnets[1], h, temb)

    for bi, block in enumerate(model.up_blocks):
        heads = cfg.block_channels[len(cfg.block_channels) - 1 - bi] \
            // cfg.head_dim
        for li, rp in enumerate(block.resnets):
            skip = skips.pop()
            h = resnet_block(rp, torch.cat([h, skip], dim=1), temb)
            if block.attentions is not None:
                h = spatial_transformer(block.attentions[li], h, context, heads)
        if block.upsamplers is not None:
            # diffusers resizes to the next skip's size before the conv, so
            # an odd map's boundary row convolves over zero padding
            h = _upsample_nearest(h, skips[-1].shape[-2:] if skips else None)
            h = pnn.conv2d(block.upsamplers[0].conv, h, padding=1)

    h = F.silu(group_norm(model.conv_norm_out, h))
    return pnn.conv2d(model.conv_out, h, padding=1)


def _vae_attention(p: Attention, x: torch.Tensor) -> torch.Tensor:
    B, C, H, W = x.shape
    h = group_norm(p.group_norm, x).reshape(B, C, H * W).transpose(1, 2)
    out = attention(pnn.linear(p.to_q, h), pnn.linear(p.to_k, h),
                    pnn.linear(p.to_v, h), 1)
    out = pnn.linear(p.to_out[0], out)
    return x + out.transpose(1, 2).reshape(B, C, H, W)


def _vae_mid_forward(mid: MidBlock, h: torch.Tensor) -> torch.Tensor:
    h = resnet_block(mid.resnets[0], h)
    h = _vae_attention(mid.attentions[0], h)
    return resnet_block(mid.resnets[1], h)


def vae_encode(vae: AutoencoderKL, x: torch.Tensor) -> torch.Tensor:
    """x [B, 3, H, W] -> the latent mean [B, 4, H/8, W/8] (unscaled)."""
    enc = vae.encoder
    h = pnn.conv2d(enc.conv_in, x, padding=1)
    for block in enc.down_blocks:
        for rp in block.resnets:
            h = resnet_block(rp, h)
        if block.downsamplers is not None:
            # diffusers' VAE downsampler pads (0, 1, 0, 1)
            h = pnn.conv2d(block.downsamplers[0].conv, F.pad(h, (0, 1, 0, 1)),
                           stride=2)
    h = _vae_mid_forward(enc.mid_block, h)
    h = F.silu(group_norm(enc.conv_norm_out, h))
    moments = pnn.conv2d(vae.quant_conv, pnn.conv2d(enc.conv_out, h, padding=1))
    return moments[:, :vae.cfg.latent_channels]


def vae_decode(vae: AutoencoderKL, z: torch.Tensor) -> torch.Tensor:
    """z [B, 4, h, w] (unscaled) -> [B, 3, 8h, 8w]."""
    dec = vae.decoder
    h = pnn.conv2d(dec.conv_in, pnn.conv2d(vae.post_quant_conv, z), padding=1)
    h = _vae_mid_forward(dec.mid_block, h)
    for block in dec.up_blocks:
        for rp in block.resnets:
            h = resnet_block(rp, h)
        if block.upsamplers is not None:
            h = pnn.conv2d(block.upsamplers[0].conv, _upsample_nearest(h),
                           padding=1)
    h = F.silu(group_norm(dec.conv_norm_out, h))
    return pnn.conv2d(dec.conv_out, h, padding=1)


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init in place with the JAX package's distributions (its
    weights differ: they come from jax.random): conv and linear weights
    normal * fan_in^-0.5, biases zero, norms one and zero."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            w = m.weight
            w.normal_(generator=generator).mul_(w[0].numel() ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model
