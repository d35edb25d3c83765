"""GMFlow optical flow (counterpart of prisma_tpu/models/gmflow.py).

The reference's vendored GMFlow (`bands/gmflow/gmflow.py`, `transformer.py`,
`matching.py`, `backbone.py`, `position.py`, `trident_conv.py`): a 1/8 CNN
encoder with instance norms, a sine position embedding added inside 2x2
attention splits, 6 swin-style self + cross transformer blocks (shifted
windows on odd layers), global correlation softmax matching (bidirectional:
the backward direction swaps queries and keys), global flow-propagation
self-attention, and RAFT-style convex x8 upsampling. The 2-scale
gmflow_with_refine (`refine_config()`, the bands' --num_scales 2) runs
layer3 at stride 1 and a weight-shared trident conv for a 1/8 and a 1/4
feature, then refines at 1/4: feature1 warped by the upsampled flow, 8x8
attention splits, local correlation matching (radius 4), local-window
propagation (radius 1) and a convex x4 upsample.

The modules carry the reference checkpoint's names (`backbone.*`,
`transformer.layers.{i}.{self_attn,cross_attn_ffn}.*`, `feature_flow_attn.*`,
`upsampler.*`), so `gmflow_sintel-0c07dcb3.pth` and
`gmflow_with_refine_sintel-3ed1cf48.pth` load with strict=True. The public
functions keep the JAX layout at their boundary ([B, H, W, C]); the backbone
runs NCHW. The kernels carry the model on a CUDA device:
- every backbone instance norm is K4 (`ops/cuda/instance_norm.py`);
- every window attention is K1 (unshifted layers) or K2 (shifted layers,
  the region bias from per-window bands), `ops/cuda/flash_attention.py`;
- global matching and global propagation are K3
  (`flash_attention_streamed`), with f32 values.
On the CPU each wrapper takes its plain version. The refinement's warp,
local matching and local propagation are plain torch, as the JAX package
computes them outside any Pallas kernel. `forward` opens the spans
`prisma.model.backbone`, then for each scale `.transformer` (with the
refinement's warp), `.matching` and `.propagation`, then `.upsample`.
"""

from __future__ import annotations

import functools
import itertools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from prisma_tpu_torch.models.raft import convex_upsample, pad_to_multiple, unpad
from prisma_tpu_torch.ops import nn as pnn
from prisma_tpu_torch.ops.cuda.flash_attention import (flash_attention,
                                                       flash_attention_streamed)
from prisma_tpu_torch.ops.cuda.instance_norm import instance_norm_relu
from prisma_tpu_torch.ops.resize import resize2d
from prisma_tpu_torch.runtime.profiling import span

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclass(frozen=True)
class GMFlowConfig:
    feature_channels: int = 128
    num_transformer_layers: int = 6
    attn_splits: int = 2
    ffn_dim_expansion: int = 4
    upsample_factor: int = 8
    # 2-scale refinement (gmflow_with_refine, reference gmflow.py:75-90):
    # the per-scale lists default to the reference CLI's ((2,)/(-1,)/(-1,)
    # at one scale; (2, 8)/(-1, 4)/(-1, 1) for refinement,
    # flow_gmflow.py:243-245); -1 is global matching or propagation
    num_scales: int = 1
    attn_splits_list: tuple | None = None
    corr_radius_list: tuple | None = None
    prop_radius_list: tuple | None = None
    padding_factor: int = 16

    def __post_init__(self):
        if self.num_scales not in (1, 2):
            raise ValueError(f"num_scales must be 1 or 2, not {self.num_scales}")
        for name in ("attn_splits_list", "corr_radius_list",
                     "prop_radius_list"):
            given = getattr(self, name)
            if given is not None and len(given) != self.num_scales:
                raise ValueError(f"{name} {given} needs one entry per scale "
                                 f"({self.num_scales})")

    def scale_lists(self):
        """Resolved (attn_splits, corr_radius, prop_radius) per scale."""
        if self.num_scales == 1:
            return ((self.attn_splits_list or (self.attn_splits,)),
                    (self.corr_radius_list or (-1,)),
                    (self.prop_radius_list or (-1,)))
        return ((self.attn_splits_list or (2, 8)),
                (self.corr_radius_list or (-1, 4)),
                (self.prop_radius_list or (-1, 1)))


def refine_config(**overrides) -> GMFlowConfig:
    """The reference gmflow_with_refine configuration (2-scale, x4 upsample,
    /32 padding)."""
    kw = dict(num_scales=2, upsample_factor=4, padding_factor=32)
    kw.update(overrides)
    return GMFlowConfig(**kw)


# ---------------------------------------------------------------------------
# Modules (the reference checkpoint's names)
# ---------------------------------------------------------------------------

class ResidualBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        # the reference's Sequential(conv, norm3); the instance norm has no
        # parameters, so only the conv is kept (key downsample.0)
        self.downsample = (nn.Sequential(nn.Conv2d(cin, cout, 1, stride))
                           if stride != 1 or cin != cout else None)


class CNNEncoder(nn.Module):
    def __init__(self, out_channels: int, num_scales: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, 1),
                                    ResidualBlock(64, 64, 1))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, 2),
                                    ResidualBlock(96, 96, 1))
        # two scales: layer3 stays at 1/4 (reference backbone.py:59-62)
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, 1 if num_scales > 1
                                                  else 2),
                                    ResidualBlock(128, 128, 1))
        self.conv2 = nn.Conv2d(128, out_channels, 1)
        # the reference's MultiScaleTridentConv: one bias-free 3x3 weight
        # applied at strides 1 and 2 (key backbone.trident_conv.weight)
        self.trident_conv = (nn.Conv2d(out_channels, out_channels, 3,
                                       bias=False) if num_scales > 1 else None)


class TransformerLayer(nn.Module):
    def __init__(self, C: int, no_ffn: bool, expansion: int):
        super().__init__()
        self.q_proj = nn.Linear(C, C, bias=False)
        self.k_proj = nn.Linear(C, C, bias=False)
        self.v_proj = nn.Linear(C, C, bias=False)
        self.merge = nn.Linear(C, C, bias=False)
        self.norm1 = nn.LayerNorm(C)
        self.mlp = None
        if not no_ffn:
            self.mlp = nn.Sequential(
                nn.Linear(2 * C, 2 * C * expansion, bias=False), nn.GELU(),
                nn.Linear(2 * C * expansion, C, bias=False))
            self.norm2 = nn.LayerNorm(C)


class TransformerBlock(nn.Module):
    def __init__(self, C: int, expansion: int):
        super().__init__()
        self.self_attn = TransformerLayer(C, True, expansion)
        self.cross_attn_ffn = TransformerLayer(C, False, expansion)


class FeatureTransformer(nn.Module):
    def __init__(self, cfg: GMFlowConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerBlock(cfg.feature_channels, cfg.ffn_dim_expansion)
            for _ in range(cfg.num_transformer_layers))


class FeatureFlowAttention(nn.Module):
    def __init__(self, C: int):
        super().__init__()
        self.q_proj = nn.Linear(C, C)
        self.k_proj = nn.Linear(C, C)


class GMFlow(nn.Module):
    def __init__(self, cfg: GMFlowConfig = GMFlowConfig()):
        super().__init__()
        self.cfg = cfg
        C = cfg.feature_channels
        self.backbone = CNNEncoder(C, cfg.num_scales)
        self.transformer = FeatureTransformer(cfg)
        self.feature_flow_attn = FeatureFlowAttention(C)
        self.upsampler = nn.Sequential(
            nn.Conv2d(2 + C, 256, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(256, cfg.upsample_factor ** 2 * 9, 1))


def build(cfg: GMFlowConfig = GMFlowConfig(),
          device: str | torch.device = "cpu") -> GMFlow:
    """A model with uninitialised storage on `device` (the caller fills it
    with `init_params` or `load_state_dict`)."""
    with torch.device("meta"):
        model = GMFlow(cfg)
    return model.to_empty(device=device).eval()


@torch.no_grad()
def init_params(model: GMFlow, generator: torch.Generator) -> GMFlow:
    """Random init in place with the JAX package's distributions (its
    weights differ: they come from jax.random): weights normal · fan_in^-0.5,
    biases zero, layer norms one and zero."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            m.weight.normal_(generator=generator).mul_(m.weight[0].numel() ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model


# ---------------------------------------------------------------------------
# CNN backbone (1/8, instance-norm residual stages), NCHW
# ---------------------------------------------------------------------------

def backbone_forward(bb: CNNEncoder, x: torch.Tensor):
    """x [B, 3, H, W] normalised, contiguous -> [B, C, H/8, W/8] (one
    scale), or [lo [B, C, H/8, W/8], hi [B, C, H/4, W/4]] (two scales: the
    trident conv at strides 2 and 1 over the 1/4 feature); its 15 instance
    norms go through `instance_norm_relu` (K4 on the card)."""
    x = instance_norm_relu(pnn.conv2d(bb.conv1, x, stride=2, padding=3),
                           relu=True)
    for block in (*bb.layer1, *bb.layer2, *bb.layer3):
        s = block.stride
        y = instance_norm_relu(pnn.conv2d(block.conv1, x, stride=s, padding=1),
                               relu=True)
        y = instance_norm_relu(pnn.conv2d(block.conv2, y, padding=1),
                               relu=True)
        if block.downsample is not None:
            x = instance_norm_relu(pnn.conv2d(block.downsample[0], x, stride=s),
                                   relu=False)
        x = F.relu(x + y)
    x = pnn.conv2d(bb.conv2, x)
    if bb.trident_conv is None:
        return x
    hi = pnn.conv2d(bb.trident_conv, x, padding=1)
    lo = pnn.conv2d(bb.trident_conv, x, stride=2, padding=1)
    return [lo, hi]


# ---------------------------------------------------------------------------
# Position embedding (DETR sine, computed in-window)
# ---------------------------------------------------------------------------

def sine_pos_embed(h: int, w: int, num_pos_feats: int = 64,
                   temperature: float = 10000.0) -> np.ndarray:
    """[h, w, 2·num_pos_feats] numpy constant (y-channels then x-channels)."""
    y_embed = np.arange(1, h + 1, dtype=np.float32)[:, None] * np.ones((1, w), np.float32)
    x_embed = np.ones((h, 1), np.float32) * np.arange(1, w + 1, dtype=np.float32)[None, :]
    eps = 1e-6
    scale = 2 * math.pi
    y_embed = y_embed / (y_embed[-1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, -1:] + eps) * scale
    dim_t = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)
    px = x_embed[:, :, None] / dim_t
    py = y_embed[:, :, None] / dim_t
    px = np.stack([np.sin(px[:, :, 0::2]), np.cos(px[:, :, 1::2])], axis=3).reshape(h, w, -1)
    py = np.stack([np.sin(py[:, :, 0::2]), np.cos(py[:, :, 1::2])], axis=3).reshape(h, w, -1)
    return np.concatenate([py, px], axis=-1)


def _split_windows(x: torch.Tensor, ns: int) -> torch.Tensor:
    """[B, H, W, C] -> [B·ns·ns, H/ns, W/ns, C] (row-major split order)."""
    B, H, W, C = x.shape
    x = x.reshape(B, ns, H // ns, ns, W // ns, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B * ns * ns, H // ns, W // ns, C)


def _merge_windows(x: torch.Tensor, ns: int) -> torch.Tensor:
    Bk, h, w, C = x.shape
    B = Bk // (ns * ns)
    x = x.reshape(B, ns, ns, h, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, ns * h, ns * w, C)


def add_position(feature0: torch.Tensor, feature1: torch.Tensor,
                 attn_splits: int):
    B, H, W, C = feature0.shape
    s = attn_splits
    pos = torch.from_numpy(sine_pos_embed(H // s, W // s, C // 2)).to(
        device=feature0.device, dtype=feature0.dtype)
    if s > 1:
        return (_merge_windows(_split_windows(feature0, s) + pos, s),
                _merge_windows(_split_windows(feature1, s) + pos, s))
    return feature0 + pos, feature1 + pos


# ---------------------------------------------------------------------------
# Transformer (swin-style single-head self/cross attention)
# ---------------------------------------------------------------------------

def shift_window_region_ids(h: int, w: int, ns: int) -> np.ndarray:
    """[ns·ns, win] int region labels for the shifted-window layers: tokens
    from different pre-shift regions must not attend to each other."""
    wh, ww = h // ns, w // ns
    sh, sw = wh // 2, ww // 2
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -wh), slice(-wh, -sh), slice(-sh, None)):
        for ws in (slice(0, -ww), slice(-ww, -sw), slice(-sw, None)):
            img[hs, ws] = cnt
            cnt += 1
    return img.reshape(ns, wh, ns, ww).transpose(0, 2, 1, 3).reshape(-1, wh * ww)


@functools.lru_cache(maxsize=None)
def shift_window_region_bands(h: int, w: int, ns: int) -> np.ndarray:
    """[ns·ns, 2] int32 (bh, bw): each window's at-most-one in-window region
    boundary per axis (the window's extent where there is none). Of the swin
    region edges {dim - win, dim - shift}, only dim - shift can fall strictly
    inside a window, so each window's region labels are separable band tests;
    verified here against shift_window_region_ids."""
    wh, ww = h // ns, w // ns
    ids = shift_window_region_ids(h, w, ns).reshape(ns * ns, wh, ww)
    bands = np.zeros((ns * ns, 2), np.int32)
    for k in range(ns * ns):
        dh = np.nonzero(ids[k, :, 0] != ids[k, 0, 0])[0]
        dw = np.nonzero(ids[k, 0, :] != ids[k, 0, 0])[0]
        bh = int(dh[0]) if dh.size else wh
        bw = int(dw[0]) if dw.size else ww
        bands[k] = (bh, bw)
        hb = (np.arange(wh) >= bh).astype(np.int32)
        wb = (np.arange(ww) >= bw).astype(np.int32)
        sep = hb[:, None] * 2 + wb[None, :]
        same_sep = sep[:, :, None, None] == sep[None, None, :, :]
        same_ids = ids[k][:, :, None, None] == ids[k][None, None, :, :]
        if not np.array_equal(same_sep, same_ids):
            raise ValueError(f"window {k}: region ids are not separable "
                             f"single-boundary bands for ({h},{w},ns={ns})")
    return bands


@functools.lru_cache(maxsize=None)
def region_bands(h: int, w: int, ns: int, device) -> torch.Tensor:
    """shift_window_region_bands as an int32 tensor on `device` (made
    outside inference mode, as ops/resize's cached matrices are)."""
    with torch.inference_mode(False):
        return torch.from_numpy(shift_window_region_bands(h, w, ns)).to(device)


def _win_split(x: torch.Tensor, h: int, w: int, ns: int,
               shifted: bool) -> torch.Tensor:
    """[B, L, C] -> [B·ns·ns, win, C] window tokens (the shifted-window roll
    applied first when shifted)."""
    B, L, C = x.shape
    t = x.reshape(B, h, w, C)
    if shifted:
        t = torch.roll(t, (-(h // ns // 2), -(w // ns // 2)), dims=(1, 2))
    return _split_windows(t, ns).reshape(B * ns * ns, -1, C)


def _win_merge(out: torch.Tensor, B: int, h: int, w: int, ns: int,
               shifted: bool) -> torch.Tensor:
    """Inverse of _win_split -> [B, h·w, C]."""
    C = out.shape[-1]
    out = _merge_windows(out.reshape(B * ns * ns, h // ns, w // ns, C), ns)
    if shifted:
        out = torch.roll(out, (h // ns // 2, w // ns // 2), dims=(1, 2))
    return out.reshape(B, h * w, C)


def _window_attention_core(qw: torch.Tensor, kw: torch.Tensor,
                           vw: torch.Tensor, bands: torch.Tensor | None = None,
                           win_w: int = 0) -> torch.Tensor:
    """Attention over windowed tokens [B·ns·ns, win, C]: K1 without bands,
    K2 with the shifted layers' per-window bands (win_w the window width).
    Every window attention takes the kernel on a CUDA tensor."""
    if bands is None:
        return flash_attention(qw, kw, vw)
    return flash_attention(qw, kw, vw, region_bands=bands, win_w=win_w)


def _layer_norm(p: nn.LayerNorm, x: torch.Tensor, eps: float = 1e-5):
    """GMFlow's layer norm as the JAX model computes it: single-pass f32
    moments, normalised, scaled and shifted in f32, then cast back."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p.weight.float() + p.bias.float()).to(x.dtype)


def _sublayer_windowed(p: TransformerLayer, sw: torch.Tensor,
                       tw: torch.Tensor, bands, win_w: int) -> torch.Tensor:
    """One attention sublayer over windowed tokens [B·ns·ns, win, C] (tw is
    sw for self-attention); every op but the attention is per token, so the
    residual, norms and FFN run in window layout."""
    C = sw.shape[-1]
    if tw is sw:
        w = torch.cat([p.q_proj.weight, p.k_proj.weight, p.v_proj.weight])
        qkv = F.linear(sw, w)
        q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    else:
        q = F.linear(sw, p.q_proj.weight)
        kv = F.linear(tw, torch.cat([p.k_proj.weight, p.v_proj.weight]))
        k, v = kv[..., :C], kv[..., C:]
    out = _window_attention_core(q.contiguous(), k.contiguous(),
                                 v.contiguous(), bands, win_w)
    message = _layer_norm(p.norm1, F.linear(out, p.merge.weight))
    if p.mlp is not None:
        y = torch.cat([sw, message], dim=-1)
        y = F.linear(pnn.gelu(F.linear(y, p.mlp[0].weight)), p.mlp[2].weight)
        message = _layer_norm(p.norm2, y)
    return sw + message


def transformer_forward(tf: FeatureTransformer, feature0: torch.Tensor,
                        feature1: torch.Tensor, attn_splits: int):
    """The self + cross blocks over the doubled batch [f0, f1] (queries)
    against [f1, f0] (cross keys); odd layers shift their windows."""
    B, H, W, C = feature0.shape
    ns = attn_splits
    concat0 = torch.cat([feature0, feature1]).reshape(2 * B, H * W, C)
    concat1 = torch.cat([feature1, feature0]).reshape(2 * B, H * W, C)
    for i, layer in enumerate(tf.layers):
        shifted = ns > 1 and i % 2 == 1
        bands = region_bands(H, W, ns, concat0.device) if shifted else None
        sw = _win_split(concat0, H, W, ns, shifted)
        tw = _win_split(concat1, H, W, ns, shifted)
        sw = _sublayer_windowed(layer.self_attn, sw, sw, bands, W // ns)
        sw = _sublayer_windowed(layer.cross_attn_ffn, sw, tw, bands, W // ns)
        concat0 = _win_merge(sw, 2 * B, H, W, ns, shifted)
        concat1 = torch.cat([concat0[B:], concat0[:B]])
    return (concat0[:B].reshape(B, H, W, C), concat0[B:].reshape(B, H, W, C))


# ---------------------------------------------------------------------------
# Matching + flow propagation + upsample
# ---------------------------------------------------------------------------

def _coords_grid_flat(H: int, W: int, device) -> torch.Tensor:
    gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                            torch.arange(W, dtype=torch.float32, device=device),
                            indexing="ij")
    return torch.stack([gx, gy], dim=-1).reshape(H * W, 2)


def _global_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v for the O((HW)²) global matching and
    propagation, streamed: K3 on the card, its plain version (the JAX
    package's `_attn_blockwise`) on the CPU. v ([M, dv] shared or [B, M,
    dv]) is taken in f32 (pixel coordinates or flow) -> [B, N, dv] f32."""
    if v.dim() == 2:
        v = v[None].expand(q.shape[0], *v.shape)
    return flash_attention_streamed(q.contiguous(), k.contiguous(),
                                    v.float().contiguous(), scale)


def global_correlation_softmax(feature0: torch.Tensor, feature1: torch.Tensor,
                               bidir: bool) -> torch.Tensor:
    """[B, H, W, C] x2 -> flow [B or 2B, H, W, 2] (f32) via the expected
    coordinates of a global softmax; the backward direction swaps queries
    and keys (the reference's transposed-correlation softmax)."""
    B, H, W, C = feature0.shape
    f0 = feature0.reshape(B, H * W, C)
    f1 = feature1.reshape(B, H * W, C)
    grid = _coords_grid_flat(H, W, feature0.device)
    scale = 1.0 / C ** 0.5
    corresp = _global_attend(f0, f1, grid, scale)
    if bidir:
        corresp = torch.cat([corresp, _global_attend(f1, f0, grid, scale)])
    return corresp.reshape(-1, H, W, 2) - grid.reshape(1, H, W, 2)


def flow_propagation(p: FeatureFlowAttention, feature0: torch.Tensor,
                     flow: torch.Tensor) -> torch.Tensor:
    """Global self-attention with the flow as value. Reference quirk: the
    key projection is applied on top of the query projection
    (transformer.py:357-364)."""
    B, H, W, C = feature0.shape
    q = pnn.linear(p.q_proj, feature0.reshape(B, H * W, C))
    k = pnn.linear(p.k_proj, q)
    out = _global_attend(q, k, flow.reshape(B, H * W, 2), 1.0 / C ** 0.5)
    return out.to(flow.dtype).reshape(B, H, W, 2)


def _window_taps(radius: int):
    """The (dy, dx) offsets of a (2r+1)² window, dy slow and dx fast (the
    reference's window_grid order)."""
    return list(itertools.product(range(-radius, radius + 1), repeat=2))


def _tap(xp: torch.Tensor, r: int, dy: int, dx: int, H: int, W: int):
    """The [B, H, W, C] slice of an r-padded xp shifted by (dy, dx)."""
    return xp[:, r + dy:r + dy + H, r + dx:r + dx + W]


def local_correlation_softmax(feature0: torch.Tensor, feature1: torch.Tensor,
                              radius: int) -> torch.Tensor:
    """Windowed correlation softmax matching (reference matching.py:39-83,
    the JAX package's taps form): per pixel, the dot products with the
    (2r+1)² integer-offset window of feature1 (zeros outside), taps off the
    image masked to -1e9, an f32 softmax, and the expected offset as the flow
    [B, H, W, 2] in the feature dtype. The dot products are taken in f32."""
    B, H, W, C = feature0.shape
    r = radius
    f0 = feature0.float()
    f1p = F.pad(feature1.float(), (0, 0, r, r, r, r))
    taps = _window_taps(r)
    corr = torch.stack([(f0 * _tap(f1p, r, dy, dx, H, W)).sum(-1)
                        for dy, dx in taps], dim=-1) * C ** -0.5
    offs = torch.tensor(taps, dtype=torch.float32, device=feature0.device)
    oy, ox = offs[:, 0], offs[:, 1]
    gx = torch.arange(W, dtype=torch.float32, device=feature0.device)[:, None]
    gy = torch.arange(H, dtype=torch.float32, device=feature0.device)[:, None, None]
    valid = ((gx + ox >= 0) & (gx + ox < W) & (gy + oy >= 0) & (gy + oy < H))
    prob = torch.softmax(corr.masked_fill(~valid, -1e9), dim=-1)
    flow = torch.stack([(prob * ox).sum(-1), (prob * oy).sum(-1)], dim=-1)
    return flow.to(feature0.dtype)


def _flow_warp(feature: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp feature [B, H, W, C] by flow [B, H, W, 2] (reference geometry.py
    flow_warp: bilinear grid_sample with align_corners=True, zeros outside):
    each of the four corners off the map contributes zero. The blend is in
    f32, cast back to the feature's dtype, in the JAX package's order."""
    B, H, W, C = feature.shape
    dev = feature.device
    fx = flow[..., 0].float() + torch.arange(W, dtype=torch.float32, device=dev)
    fy = flow[..., 1].float() + torch.arange(H, dtype=torch.float32,
                                             device=dev)[:, None]
    x0, y0 = fx.floor(), fy.floor()
    ax, ay = (fx - x0)[..., None], (fy - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    flat = feature.reshape(B * H * W, C)
    base = (torch.arange(B, device=dev) * (H * W))[:, None, None]

    def corner(yi, xi):
        valid = ((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H))[..., None]
        idx = base + yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        return flat[idx.reshape(-1)].view(B, H, W, C), valid

    out = None
    for dy, wy in ((0, 1 - ay), (1, ay)):
        v0, m0 = corner(y0 + dy, x0)
        v1, m1 = corner(y0 + dy, x0 + 1)
        row = v0 * (1 - ax) * m0 + v1 * ax * m1
        out = row * wy if out is None else out + row * wy
    return out.to(feature.dtype)


def flow_propagation_local(p: FeatureFlowAttention, feature0: torch.Tensor,
                           flow: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """Local-window flow propagation (reference transformer.py:377-409):
    queries q_proj(feature0) and keys k_proj(feature0), the keys from the
    raw feature (unlike the global path's k_proj(q_proj(x))), scored over
    the (2r+1)² zero-padded neighbourhood with no mask (the reference's
    unfold zero-pads, so border taps score 0 and still take softmax mass);
    the values are the zero-padded flow window. Scores in f32."""
    B, H, W, C = feature0.shape
    r = radius
    q = pnn.linear(p.q_proj, feature0).float()
    kp = F.pad(pnn.linear(p.k_proj, feature0).float(), (0, 0, r, r, r, r))
    fp = F.pad(flow.float(), (0, 0, r, r, r, r))
    taps = _window_taps(r)
    s = torch.stack([(q * _tap(kp, r, dy, dx, H, W)).sum(-1)
                     for dy, dx in taps], dim=-1) * C ** -0.5
    v = torch.stack([_tap(fp, r, dy, dx, H, W) for dy, dx in taps], dim=-2)
    out = (torch.softmax(s, dim=-1)[..., None] * v).sum(-2)
    return out.to(flow.dtype)


def forward(model: GMFlow, img0: torch.Tensor, img1: torch.Tensor,
            pred_bidir: bool = True) -> torch.Tensor:
    """img0/1 [B, H, W, 3] in [0, 255], in the model's dtype, H and W
    multiples of 16 (32 for two scales) -> flow [B or 2B, H, W, 2] in that
    dtype (forward rows first, then backward when bidir).

    Two scales (reference gmflow.py:93-166): the 1/4 features carry forward
    and backward as a doubled batch, feature1 is warped by the scale-0 flow
    upsampled x2, and the flow is refined by local matching and local
    propagation before the convex x4 upsample."""
    cfg = model.cfg
    B = img0.shape[0]
    with span("prisma.model.backbone"):  # with the normalisation
        mean = torch.tensor(IMAGENET_MEAN, dtype=img0.dtype,
                            device=img0.device)
        std = torch.tensor(IMAGENET_STD, dtype=img0.dtype, device=img0.device)
        n0 = (img0 / 255.0 - mean) / std
        n1 = (img1 / 255.0 - mean) / std
        x = torch.cat([n0, n1]).permute(0, 3, 1, 2).contiguous()
        feats = backbone_forward(model.backbone, x)
    if cfg.num_scales == 1:
        feats = [feats]
    splits_l, corr_l, prop_l = cfg.scale_lists()
    flow = None
    for si, feats_s in enumerate(feats):
        with span("prisma.model.transformer"):  # the warp of a refinement too
            feats_s = feats_s.permute(0, 2, 3, 1)
            feature0, feature1 = feats_s[:B], feats_s[B:]
            if si > 0:
                if pred_bidir:
                    feature0, feature1 = (torch.cat([feature0, feature1]),
                                          torch.cat([feature1, feature0]))
                flow = (resize2d(flow.float(), feature0.shape[1:3],
                                 method="linear", align_corners=True)
                        * 2.0).to(feature0.dtype)
                feature1 = _flow_warp(feature1, flow)
            feature0, feature1 = add_position(feature0, feature1,
                                              splits_l[si])
            feature0, feature1 = transformer_forward(
                model.transformer, feature0, feature1, splits_l[si])
        with span("prisma.model.matching"):
            if corr_l[si] == -1:
                flow_pred = global_correlation_softmax(
                    feature0, feature1,
                    pred_bidir and si == 0).to(feature0.dtype)
            else:
                flow_pred = local_correlation_softmax(feature0, feature1,
                                                      corr_l[si])
            flow = flow_pred if flow is None else flow + flow_pred
        with span("prisma.model.propagation"):
            if pred_bidir and si == 0:
                feature0 = torch.cat([feature0, feature1])
            if prop_l[si] == -1:
                flow = flow_propagation(model.feature_flow_attn, feature0,
                                        flow)
            else:
                flow = flow_propagation_local(model.feature_flow_attn,
                                              feature0, flow, prop_l[si])

    with span("prisma.model.upsample"):
        concat = torch.cat([flow.to(feature0.dtype), feature0], dim=-1)
        y = F.relu(pnn.conv2d(model.upsampler[0], concat.permute(0, 3, 1, 2),
                              padding=1))
        mask = pnn.conv2d(model.upsampler[2], y).permute(0, 2, 3, 1)
        return convex_upsample(flow, mask, cfg.upsample_factor)


def infer_pairs(model: GMFlow, image1: torch.Tensor, image2: torch.Tensor,
                inference_size=None):
    """Bidirectional inference -> (fwd, bwd) [B, H, W, 2].

    inference_size=None: pad H and W to a multiple of the config's
    padding_factor (16; 32 for two scales), infer, unpad (reference flow_gmflow.py:72-74).
    inference_size=(h, w): bilinear align_corners resize to (h, w), infer
    without padding, resize the flow back in f32 and rescale its components
    by the size ratio (reference flow_gmflow.py:78-98)."""
    B = image1.shape[0]
    if inference_size is not None:
        ih, iw = inference_size
        oh, ow = image1.shape[1], image1.shape[2]
        i1 = resize2d(image1, (ih, iw), method="linear", align_corners=True)
        i2 = resize2d(image2, (ih, iw), method="linear", align_corners=True)
        flow = forward(model, i1, i2, pred_bidir=True)
        flow = resize2d(flow.float(), (oh, ow), method="linear",
                        align_corners=True)
        flow = flow * torch.tensor([ow / iw, oh / ih], dtype=flow.dtype,
                                   device=flow.device)
        return flow[:B], flow[B:]
    i1, pads = pad_to_multiple(image1, model.cfg.padding_factor)
    i2, _ = pad_to_multiple(image2, model.cfg.padding_factor)
    flow = unpad(forward(model, i1, i2, pred_bidir=True), pads)
    return flow[:B], flow[B:]
