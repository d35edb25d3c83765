"""PatchFusion: tiled high-resolution metric depth (counterpart of
prisma_tpu/models/patchfusion.py).

The network (reference zoedepth_custom/patchfusion.py): two ZoeDepthCustom
sub-models over BEiT-L cores, the coarse one on the whole image at the
model size and the fine one on each tile; six levels of feature hooks of
each, projected; the coarse levels cut to each tile's box with roi_align
and fused with the fine ones; UNetv1 over (the coarse depth cut to the
tile, the prior, the tile), with a G2L swin attention over each whole-image
coarse level (plus the tile's area prior) at every level; the ZoeDepth bins
head over the UNet's pyramid.

The tiling engine (reference infer_user.py and depth_patchfusion.py): the
image resized to a ladder resolution, crops of a quarter of it resized to
the model size; p16 is one grid pass, p49 four (the grid and its three
half-crop shifts: 16 + 12 + 12 + 9 tiles), rN p49's passes and then N random
tiles in passes of eight. Each pass reads a prior frozen at its start, the
running average; every tile's depth is blended into the average with a
Gaussian mask. Within a pass the tiles run in batches of at most tile_batch:
the width changes how a pass is batched, not what it computes.

Parameter names are `patchfusion_u4k.pt`'s: `coarse_model.*`,
`fine_model.*` (each a zoed.ZoeDepth), `coarse_input_proj.{0-5}`,
`fine_input_proj.{0-5}`, `fusion_conv_list.{0-5}`, `fusion_extractor.*`
(the UNet: `inc`, `down{1-5}`, `up{1-5}`, `conv{0-5}`, `g2l{0-5}`) and the
bins head at the top level. NCHW throughout; the bins heads (the two
sub-models' and the top one) run in f32 on any compute dtype, as do the
UNet's folded batch norms and the BEiT bias tables.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from prisma_tpu_torch.models import beit, midas, vit, zoed
from prisma_tpu_torch.models import zoedepth as zoe
from prisma_tpu_torch.ops import nn as pnn
from prisma_tpu_torch.ops.resize import _resize_weights, resize2d, \
    resize2d_nchw
from prisma_tpu_torch.ops.roi_align import roi_align
from prisma_tpu_torch.parallel import mesh

MODEL_HW = (384, 512)    # ZoeDepthCustom's input (config img_size)
N_MIDAS_OUT = 32
BTLNCK = 256
PF_CONFIG = zoe.ZoeDepthConfig()  # n_bins 64, softplus, inv/mean
G2L_SPECS = [  # (num_heads, depth) of g2l5 .. g2l0 (coarse level 0 .. 5)
    (32, 4), (32, 4), (16, 3), (16, 3), (8, 2), (8, 2)]
WINDOW = 12              # G2L's swin window
RANDOM_PASS = 8          # rN: random tiles per pass
RANDOM_SEED = 2024       # rN: the tile positions' generator
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def level_hw(model_hw=MODEL_HW):
    """The pyramid's sizes, model/32 up to the model size."""
    mh, mw = model_hw
    return [(mh >> (5 - k), mw >> (5 - k)) for k in range(6)]


def hr_hw(model_hw=MODEL_HW):
    """The reference's fixed (2160, 3840) upsample of the coarse depth,
    scaled with the model size (2160 = 384 * 45/8, 3840 = 512 * 60/8)."""
    return (model_hw[0] * 45 // 8, model_hw[1] * 60 // 8)


# ---------------------------------------------------------------------------
# G2L: swin window attention over a whole-image level
# ---------------------------------------------------------------------------

class SwinAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * WINDOW - 1) ** 2, num_heads))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = SwinAttention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = vit.Mlp(dim, 4 * dim)


class G2LLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, depth: int):
        super().__init__()
        self.blocks = nn.ModuleList(SwinBlock(dim, num_heads)
                                    for _ in range(depth))


class G2L(nn.Module):
    def __init__(self, dim: int, num_heads: int, depth: int, num_patches: int):
        super().__init__()
        self.embed_proj = nn.Conv2d(1, dim, 1)
        self.absolute_pos_embed = nn.Parameter(torch.zeros(1, num_patches, dim))
        self.g2l_layer = G2LLayer(dim, num_heads, depth)
        self.g2l_layer_norm = nn.LayerNorm(dim, eps=1e-5)


@functools.lru_cache(maxsize=None)
def _swin_rel_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def _swin_attn_mask(Hp: int, Wp: int, ws: int, shift: int, device,
                    dtype: torch.dtype) -> torch.Tensor:
    """[nW, ws*ws, ws*ws], made on `device`: -100 between tokens of
    different regions of the shifted image, 0 within one."""
    img = torch.zeros((Hp, Wp), dtype=torch.int32, device=device)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.view(Hp // ws, ws, Wp // ws, ws).permute(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)
    apart = win[:, None, :] != win[:, :, None]
    return torch.zeros(apart.shape, dtype=dtype, device=device).masked_fill_(
        apart, -100.0)


def _window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    B, H, W, C = x.shape
    x = x.view(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def _window_reverse(w: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    B = w.shape[0] // (H // ws * W // ws)
    x = w.view(B, H // ws, W // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, -1)


def swin_block(p: SwinBlock, x: torch.Tensor, H: int, W: int, shift: int,
               mask: torch.Tensor | None, rel_idx: torch.Tensor) -> torch.Tensor:
    """x [B, H*W, C]: a W-MSA (shift 0) or SW-MSA block; rel_idx the
    window's [N, N] relative position index on x's device."""
    B, L, C = x.shape
    ws = WINDOW
    shortcut = x
    x = pnn.layer_norm(p.norm1, x, eps=1e-5).view(B, H, W, C)
    pad_b, pad_r = (-H) % ws, (-W) % ws
    x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
    Hp, Wp = H + pad_b, W + pad_r
    if shift > 0:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    xw = _window_partition(x, ws)                       # [B*nW, N, C]

    a = p.attn
    h = a.num_heads
    d = C // h
    Bw, N, _ = xw.shape
    qkv = pnn.linear(a.qkv, xw).view(Bw, N, 3, h, d)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    attn = torch.einsum("bnhd,bmhd->bhnm", q * d ** -0.5, k)
    rel = a.relative_position_bias_table[rel_idx].permute(2, 0, 1)
    attn = attn + rel.to(attn.dtype)
    if mask is not None:
        nW = mask.shape[0]
        attn = (attn.view(Bw // nW, nW, h, N, N)
                + mask[None, :, None]).view(Bw, h, N, N)
    attn = torch.softmax(attn, dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(Bw, N, C)
    out = pnn.linear(a.proj, out)

    x = _window_reverse(out, ws, Hp, Wp)
    if shift > 0:
        x = torch.roll(x, (shift, shift), dims=(1, 2))
    x = shortcut + x[:, :H, :W].reshape(B, L, C)
    return x + pnn.mlp(p.mlp, pnn.layer_norm(p.norm2, x, eps=1e-5))


def g2l_fusion(p: G2L, x: torch.Tensor, area_prior: torch.Tensor) -> torch.Tensor:
    """G2LFusion: x [B, C, H, W] plus the embedded area prior [B, 1, H, W]
    and the absolute position embedding, through the swin blocks
    (alternately shifted by half a window) and the final norm."""
    B, C, H, W = x.shape
    x = x + pnn.conv2d(p.embed_proj, area_prior)
    t = x.flatten(2).transpose(1, 2) + p.absolute_pos_embed
    ws, shift = WINDOW, WINDOW // 2
    Hp, Wp = H + (-H) % ws, W + (-W) % ws
    mask = _swin_attn_mask(Hp, Wp, ws, shift, x.device, x.dtype)
    rel_idx = torch.from_numpy(_swin_rel_index(ws)).to(x.device)
    for i, blk in enumerate(p.g2l_layer.blocks):
        t = swin_block(blk, t, H, W, 0 if i % 2 == 0 else shift,
                       None if i % 2 == 0 else mask, rel_idx)
    t = pnn.layer_norm(p.g2l_layer_norm, t, eps=1e-5)
    return t.transpose(1, 2).reshape(B, C, H, W)


# ---------------------------------------------------------------------------
# UNetv1
# ---------------------------------------------------------------------------

class DoubleConv(nn.Module):
    """conv (no bias), batch norm, ReLU, twice."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.double_conv = nn.Sequential(
            nn.Conv2d(cin, cout, 3, padding=1, bias=False), nn.BatchNorm2d(cout),
            nn.ReLU(), nn.Conv2d(cout, cout, 3, padding=1, bias=False),
            nn.BatchNorm2d(cout), nn.ReLU())


class DoubleConvWOBN(nn.Module):
    def __init__(self, cin: int, cout: int, mid: int):
        super().__init__()
        self.double_conv = nn.Sequential(
            nn.Conv2d(cin, mid, 3, padding=1), nn.ReLU(),
            nn.Conv2d(mid, cout, 3, padding=1), nn.ReLU())


class Down(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.maxpool_conv = nn.Sequential(nn.MaxPool2d(2), DoubleConv(cin, cout))


class Up(nn.Module):
    def __init__(self, cin: int, cout: int, mid: int):
        super().__init__()
        self.conv = DoubleConvWOBN(cin, cout, mid)


class UNetv1(nn.Module):
    def __init__(self, features: int = BTLNCK, midas_out: int = N_MIDAS_OUT,
                 model_hw=MODEL_HW):
        super().__init__()
        B, M = features, midas_out
        self.inc = DoubleConv(5, M)
        for i in range(1, 6):
            setattr(self, f"down{i}", Down(M if i == 1 else B, B))
        for i in range(1, 5):
            setattr(self, f"up{i}", Up(3 * B, B, 3 * B // 2))
        self.up5 = Up(2 * B + M, M, (2 * B + M) // 2)
        self.conv0 = DoubleConvWOBN(2 * M, M, M)
        for i in range(1, 6):
            setattr(self, f"conv{i}", DoubleConvWOBN(2 * B, B, B))
        for k, ((h, w), (heads, depth)) in enumerate(zip(level_hw(model_hw),
                                                         G2L_SPECS)):
            setattr(self, f"g2l{5 - k}",
                    G2L(M if k == 5 else B, heads, depth, h * w))


def _double_conv_bn(p: DoubleConv, x: torch.Tensor) -> torch.Tensor:
    s = p.double_conv
    y = F.relu(pnn.batch_norm(s[1], pnn.conv2d(s[0], x, padding=1)))
    return F.relu(pnn.batch_norm(s[4], pnn.conv2d(s[3], y, padding=1)))


def _double_conv(p: DoubleConvWOBN, x: torch.Tensor) -> torch.Tensor:
    s = p.double_conv
    y = F.relu(pnn.conv2d(s[0], x, padding=1))
    return F.relu(pnn.conv2d(s[2], y, padding=1))


def _up_v1(p: Up, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    x1 = resize2d_nchw(x1, (x1.shape[-2] * 2, x1.shape[-1] * 2),
                       method="linear", align_corners=True)
    return _double_conv(p.conv, torch.cat([x2, x1], dim=1))


def _roi_sampling(out_h: int, model_h: int) -> int:
    return max(1, int(round(model_h / out_h)))


def unet_v1(p: UNetv1, input_tensor: torch.Tensor, guide_cat: list,
            coarse_whole: list, crop_area_resize: list, bbox: torch.Tensor,
            model_hw=MODEL_HW) -> list:
    """input_tensor [N, 5, mh, mw]; guide_cat: the six fused guides (level
    0 = model/32 first); coarse_whole: the six whole-image coarse levels
    (batch 1); bbox [N, 4] in the model frame. Returns [x6 .. x1], low
    resolution first."""
    x1 = _double_conv_bn(p.inc, input_tensor)
    downs = [x1]
    for i in range(1, 6):
        downs.append(_double_conv_bn(getattr(p, f"down{i}").maxpool_conv[1],
                                     F.max_pool2d(downs[-1], 2)))
    x1, x2, x3, x4, x5, x6 = downs
    N = input_tensor.shape[0]
    lv = level_hw(model_hw)
    tile_idx = torch.arange(N, device=input_tensor.device)

    def g2l_roi(level):
        # every tile embeds its own area prior into the shared whole-image
        # level, so the swin fusion runs per tile
        whole = coarse_whole[level].expand(N, *coarse_whole[level].shape[1:])
        g = g2l_fusion(getattr(p, f"g2l{5 - level}"), whole,
                       crop_area_resize[level])
        return roi_align(g, bbox, tile_idx, lv[level],
                         spatial_scale=lv[level][0] / model_hw[0],
                         sampling_ratio=_roi_sampling(lv[level][0], model_hw[0]))

    x = _double_conv(p.conv5, torch.cat([x6, g2l_roi(0)], dim=1))
    outs = [x]
    for level, skip in zip(range(1, 6), (x5, x4, x3, x2, x1)):
        x = _up_v1(getattr(p, f"up{level}"), torch.cat([x, guide_cat[level - 1]],
                                                      dim=1), skip)
        x = _double_conv(getattr(p, f"conv{5 - level}"),
                         torch.cat([x, g2l_roi(level)], dim=1))
        outs.append(x)
    return outs


# ---------------------------------------------------------------------------
# The network
# ---------------------------------------------------------------------------

class PatchFusion(nn.Module):
    def __init__(self, beit_cfg: beit.BEiTConfig = beit.BEiTConfig(),
                 features: int = BTLNCK, out_channels=midas.OUT_CHANNELS,
                 model_hw=MODEL_HW, cfg: zoe.ZoeDepthConfig = PF_CONFIG):
        super().__init__()
        self.model_hw = tuple(model_hw)
        B, M = features, cfg.midas_out_channels
        self.coarse_model = zoed.ZoeDepth(beit_cfg, features, out_channels, cfg)
        self.fine_model = zoed.ZoeDepth(beit_cfg, features, out_channels, cfg)
        proj_ch = [B, B, B, B, M, B]   # index 4: the 32-channel final feature
        self.coarse_input_proj = nn.ModuleList(
            nn.Conv2d(c, c, 3, padding=1) for c in proj_ch)
        self.fine_input_proj = nn.ModuleList(
            nn.Conv2d(c, c, 3, padding=1) for c in proj_ch)
        self.fusion_conv_list = nn.ModuleList(
            nn.Conv2d(2 * c, c, 3, padding=1) for c in [B] * 5 + [M])
        self.fusion_extractor = UNetv1(B, M, model_hw)
        zoe.add_bins_head(self, features, cfg)

    def cast(self, dtype: torch.dtype) -> "PatchFusion":
        """Everything in dtype but the bins heads, the UNet's batch norms
        and the BEiT bias tables, which stay f32."""
        bn = {f"{mn}.{pn}" for mn, m in self.named_modules()
              if isinstance(m, nn.BatchNorm2d)
              for pn, _ in m.named_parameters(recurse=False)}

        def keep(name):
            parts = name.split(".")
            if parts[0] in ("coarse_model", "fine_model"):
                parts = parts[1:]
            return (parts[0] in zoe.HEAD_MODULES or name in bn
                    or (".pretrained.model." in name
                        and name.endswith("relative_position_bias_table")))

        pnn.cast_floating(self, dtype, keep)
        return self


def _normalize(x: torch.Tensor) -> torch.Tensor:
    """ImageNet normalisation in x's dtype."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean[:, None, None]) / std[:, None, None]


def zoedepth_custom_forward(model: zoed.ZoeDepth, x: torch.Tensor):
    """x [B, 3, mh, mw] normalised -> (metric depth [B, mh, mw] f32, hooks):
    x_d0 (the bottleneck, model/32), x_blocks_feat_0..3 (r4..r1) and
    midas_final_feat (32 channels at the model size), in x's dtype. The
    bins math runs in f32."""
    rel, feats = zoed.core_forward(model.core.core, x)
    depth = zoe.bins_head(model, rel, feats)
    hooks = {"x_d0": pnn.conv2d(model.conv2, feats["l4_rn"].float()).to(x.dtype),
             "midas_final_feat": feats["out_conv"]}
    for i, name in enumerate(("r4", "r3", "r2", "r1")):
        hooks[f"x_blocks_feat_{i}"] = feats[name]
    return depth, hooks


def _proj6(plist: nn.ModuleList, hooks: dict) -> list:
    """The six input projections, level 0 (model/32) first."""
    return [pnn.conv2d(plist[5], hooks["x_d0"], padding=1)] + [
        pnn.conv2d(plist[i], hooks[f"x_blocks_feat_{i}"], padding=1)
        for i in range(4)] + [
        pnn.conv2d(plist[4], hooks["midas_final_feat"], padding=1)]


def coarse_pass(model: PatchFusion, img_lr: torch.Tensor):
    """The whole-image pass, shared by every tile: img_lr [1, 3, mh, mw] in
    [0, 1] (compute dtype) -> (the six projected coarse levels, the coarse
    depth upsampled to hr_hw in f32 [1, 1, hh, hw])."""
    depth, hooks = zoedepth_custom_forward(model.coarse_model,
                                           _normalize(img_lr))
    feats = _proj6(model.coarse_input_proj, hooks)
    hr = resize2d_nchw(depth[:, None], hr_hw(model.model_hw), method="linear",
                       align_corners=True)
    return feats, hr


def patchfusion_tiles(model: PatchFusion, crops: torch.Tensor,
                      bbox: torch.Tensor, crop_areas: torch.Tensor,
                      prior: torch.Tensor | None, coarse) -> torch.Tensor:
    """One batch of tiles: crops [N, 3, mh, mw] in [0, 1] (compute dtype);
    bbox [N, 4] (x1, y1, x2, y2) in the model frame; crop_areas
    [N, 1, mh, mw] f32; prior [N, 1, mh, mw] or None (the fine depth
    then); coarse: coarse_pass's result. -> tile depths [N, mh, mw] f32."""
    mh, mw = model.model_hw
    dtype = crops.dtype
    coarse_feats, coarse_hr = coarse
    N = crops.shape[0]
    fine_depth, fine_hooks = zoedepth_custom_forward(model.fine_model,
                                                     _normalize(crops))
    fine_feats = _proj6(model.fine_input_proj, fine_hooks)

    lv = level_hw(model.model_hw)
    zeros = torch.zeros(N, dtype=torch.long, device=crops.device)
    coarse_roi = [roi_align(coarse_feats[i], bbox, zeros, lv[i],
                            spatial_scale=lv[i][0] / mh,
                            sampling_ratio=_roi_sampling(lv[i][0], mh))
                  for i in range(6)]
    hh, hw = coarse_hr.shape[-2:]
    scale = torch.tensor([hw / mw, hh / mh, hw / mw, hh / mh],
                         dtype=torch.float32, device=bbox.device)
    whole_depth_roi = roi_align(coarse_hr, bbox * scale, zeros, (mh, mw),
                                spatial_scale=1.0, sampling_ratio=5).to(dtype)
    guide_cat = [pnn.conv2d(model.fusion_conv_list[i],
                            torch.cat([coarse_roi[i], fine_feats[i]], dim=1),
                            padding=1) for i in range(6)]
    if prior is None:
        prior = fine_depth[:, None]
    input_tensor = torch.cat([whole_depth_roi, prior.to(dtype), crops], dim=1)
    crop_area_resize = [resize2d_nchw(crop_areas, hw2, method="linear",
                                      align_corners=True).to(dtype)
                        for hw2 in lv]
    out = unet_v1(model.fusion_extractor, input_tensor, guide_cat,
                  coarse_feats, crop_area_resize, bbox, model.model_hw)
    # the bins head over the pyramid; the relative-depth condition is zero
    rel_cond = torch.zeros_like(out[5][:, :1], dtype=torch.float32)
    return zoe.bins_from_bottleneck(model, out[0], out[1:5], out[5], rel_cond)


# ---------------------------------------------------------------------------
# The tiling engine
# ---------------------------------------------------------------------------

def _gaussian_kernel(k: int, sigma: float) -> np.ndarray:
    """OpenCV's getGaussianKernel(k, sigma) for sigma > 0, as float32."""
    x = np.arange(k, dtype=np.float64) - (k - 1) * 0.5
    g = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (g / g.sum()).astype(np.float32)


def _blur_reflect101(img: np.ndarray, kern: np.ndarray) -> np.ndarray:
    """Separable filter of a 2-D image with OpenCV's default border
    (BORDER_REFLECT_101: the edge pixel is not repeated), rows first."""
    r = len(kern) // 2
    k = kern.astype(np.float64)
    out = img.astype(np.float64)
    for axis in (1, 0):
        pad = [(0, 0), (0, 0)]
        pad[axis] = (r, r)
        padded = np.pad(out, pad, mode="reflect")
        n = out.shape[axis]
        out = sum(k[i] * np.take(padded, np.arange(i, i + n), axis=axis)
                  for i in range(len(k)))
    return out.astype(np.float32)


@functools.lru_cache(maxsize=8)
def generate_blur_mask(size) -> np.ndarray:
    """The Gaussian blend mask (reference infer_user.py:246-255): ones inside
    a 10% border, blurred by cv2.GaussianBlur((k, k), h/16), scaled to
    [0, 1]; here without OpenCV."""
    h, w = size
    mask = np.zeros((h, w), np.float32)
    sigma = int(h / 16)
    k = int(2 * np.ceil(2 * int(h / 16)) + 1)
    mask[int(0.1 * h):h - int(0.1 * h), int(0.1 * w):w - int(0.1 * w)] = 1
    mask = _blur_reflect101(mask, _gaussian_kernel(k, sigma))
    mask = ((mask - mask.min()) / (mask.max() - mask.min())).astype(np.float32)
    mask.setflags(write=False)
    return mask


def pick_resolution(h: int, w: int):
    """The resolution ladder (reference depth_patchfusion.py:80-88)."""
    if h <= 480 and w <= 640:
        return (480, 640)
    if h <= 1080 and w <= 1920:
        return (1080, 1920)
    return (2160, 3840)


def _tile_grid(resolution, crop, off_x: int, off_y: int) -> list:
    h, w = crop
    nx = (resolution[1] - off_x) // w
    ny = (resolution[0] - off_y) // h
    return [(y * h + off_y, x * w + off_x) for x in range(nx) for y in range(ny)]


@functools.lru_cache(maxsize=64)
def _pass_areas(tiles_key, resolution, crop, model_hw):
    """-> (area maps [n, mh, mw] f32, bboxes [n, 4] f32) of a pass's tiles.

    The reference's area map (ones over the tile, bilinearly resized with
    align_corners to the model size) is separable: the outer product of the
    per-axis weight sums over the tile's extent, in float64."""
    ch, cw = crop
    mh, mw = model_hw
    Wh = _resize_weights(resolution[0], mh, "linear", True, None).astype(np.float64)
    Ww = _resize_weights(resolution[1], mw, "linear", True, None).astype(np.float64)
    Ah = np.concatenate([np.zeros((mh, 1)), np.cumsum(Wh, axis=1)], axis=1)
    Aw = np.concatenate([np.zeros((mw, 1)), np.cumsum(Ww, axis=1)], axis=1)
    areas, bboxes = [], []
    for (y, x) in tiles_key:
        areas.append(np.outer(Ah[:, y + ch] - Ah[:, y],
                              Aw[:, x + cw] - Aw[:, x]).astype(np.float32))
        bboxes.append([x / resolution[1] * mw, y / resolution[0] * mh,
                       (x + cw) / resolution[1] * mw,
                       (y + ch) / resolution[0] * mh])
    areas, bboxes = np.stack(areas), np.array(bboxes, np.float32)
    areas.setflags(write=False)
    bboxes.setflags(write=False)
    return areas, bboxes


def tile_passes(mode: str, resolution, crop) -> list:
    """The tile positions (y, x) of each pass of a mode, in order: the grid,
    then (but for p16) its three half-crop shifts, then for rN the N random
    tiles in passes of RANDOM_PASS, drawn from a generator seeded
    RANDOM_SEED, y before x."""
    offsets = [(0, 0)]
    if mode != "p16":
        offsets += [(crop[1] // 2, 0), (0, crop[0] // 2),
                    (crop[1] // 2, crop[0] // 2)]
    passes = [_tile_grid(resolution, crop, ox, oy) for ox, oy in offsets]
    n_random = int(mode[1:]) if mode.startswith("r") and mode[1:].isdigit() else 0
    rng = np.random.default_rng(RANDOM_SEED)
    for start in range(0, n_random, RANDOM_PASS):
        passes.append([(int(rng.integers(0, resolution[0] - crop[0] + 1)),
                        int(rng.integers(0, resolution[1] - crop[1] + 1)))
                       for _ in range(min(RANDOM_PASS, n_random - start))])
    return passes


def _crop_resize(img: torch.Tensor, tiles, crop, model_hw) -> torch.Tensor:
    """img [C, R0, R1] -> the tiles' crops [n, C, *model_hw] (bilinear,
    align_corners)."""
    ch, cw = crop
    crops = torch.stack([img[:, y:y + ch, x:x + cw] for y, x in tiles])
    return resize2d_nchw(crops, model_hw, method="linear", align_corners=True)


def _tiles_split(replicas, devices, coarses, crops, bbox, areas, prior):
    """patchfusion_tiles over the devices: the batch edge-padded to a
    multiple of their count and split, each part on its replica (coarses:
    the coarse pass moved to each device) -> the depths [N, mh, mw] on the
    first device."""
    n = len(devices)
    parts = [mesh.split_batch_padded(t, devices)[0] if t is not None
             else [None] * n for t in (crops, bbox, areas, prior)]
    outs = mesh.run_replicas(patchfusion_tiles, devices,
                             list(zip(replicas, *parts, coarses)))
    return mesh.gather(outs, crops.shape[0], crops.device)


@torch.inference_mode()
def infer(model: PatchFusion, image: torch.Tensor, mode: str = "p16",
          compute_dtype: torch.dtype = torch.float32,
          tile_batch: int = 8, devices=None) -> torch.Tensor:
    """One image [H, W, 3] (uint8, or float in [0, 1]) on the model's device
    -> metric depth [H, W] f32. The model must already be cast.

    devices (`parallel.mesh`): each batch of tiles is edge-padded to a
    multiple of their count and split over replicas of the model there
    (the JAX package's tiles across chips); the coarse pass, the crops and
    the blend stay on the model's device."""
    H, W = image.shape[:2]
    model_hw = model.model_hw
    resolution = pick_resolution(H, W)
    crop = (resolution[0] // 4, resolution[1] // 4)
    img = image.float() / 255.0 if image.dtype == torch.uint8 else image.float()
    img_t = resize2d(img[None], resolution, method="cubic",
                     align_corners=True)[0].permute(2, 0, 1)   # [3, R0, R1]
    img_lr = resize2d_nchw(img_t[None], model_hw, method="linear",
                           align_corners=True)
    blur = torch.from_numpy(generate_blur_mask(crop) + 1e-3).to(img.device)
    coarse = coarse_pass(model, img_lr.to(compute_dtype))
    if devices and len(devices) > 1:
        replicas = mesh.replicate(model, devices)
        coarses = [([f.to(d) for f in coarse[0]], coarse[1].to(d))
                   for d in devices]
    else:
        replicas = None

    avg = torch.zeros(resolution, dtype=torch.float32, device=img.device)
    cnt = torch.zeros_like(avg)
    ch, cw = crop
    for pass_i, tiles in enumerate(tile_passes(mode, resolution, crop)):
        areas, bboxes = _pass_areas(tuple(tiles), resolution, crop, model_hw)
        # the prior is frozen at the start of the pass
        ratio = (avg / cnt)[None] if pass_i > 0 else None
        for s in range(0, len(tiles), tile_batch):
            sub = tiles[s:s + tile_batch]
            crops = _crop_resize(img_t, sub, crop, model_hw).to(compute_dtype)
            prior = None if ratio is None else \
                _crop_resize(ratio, sub, crop, model_hw)
            bbox = torch.tensor(bboxes[s:s + tile_batch], device=img.device)
            area = torch.tensor(areas[s:s + tile_batch, None], device=img.device)
            if replicas is None:
                d = patchfusion_tiles(model, crops, bbox, area, prior, coarse)
            else:
                d = _tiles_split(replicas, devices, coarses, crops, bbox,
                                 area, prior)
            d = resize2d_nchw(d[:, None], crop, method="linear",
                              align_corners=True)[:, 0]
            for (y, x), d_i in zip(sub, d):
                avg[y:y + ch, x:x + cw] += d_i * blur
                cnt[y:y + ch, x:x + cw] += blur
    depth = avg / cnt
    return resize2d_nchw(depth[None, None], (H, W), method="linear")[0, 0]


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------

def build(beit_cfg: beit.BEiTConfig = beit.BEiTConfig(), features: int = BTLNCK,
          out_channels=midas.OUT_CHANNELS, model_hw=MODEL_HW,
          device: str | torch.device = "cpu") -> PatchFusion:
    """A model with uninitialised storage on `device` (filled by init_params
    or load_state_dict)."""
    with torch.device("meta"):
        model = PatchFusion(beit_cfg, features, out_channels, model_hw)
    return model.to_empty(device=device).eval()


@torch.no_grad()
def init_params(model: PatchFusion, generator: torch.Generator) -> PatchFusion:
    """Random init in place with the JAX package's distributions (its
    weights differ: they come from jax.random): the sub-models as
    zoed.init_params; convs and linears normal * fan_in^-0.5 with zero
    biases; norms one and zero (batch norms with mean 0, variance 1); the
    swin bias tables normal * 0.02; the position embeddings zero."""
    zoed.init_params(model.coarse_model, generator)
    zoed.init_params(model.fine_model, generator)
    for name, m in model.named_modules():
        if name.startswith(("coarse_model", "fine_model")):
            continue
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            m.weight.normal_(generator=generator).mul_(m.weight[0].numel() ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
                m.num_batches_tracked.zero_()
        elif isinstance(m, SwinAttention):
            m.relative_position_bias_table.normal_(generator=generator).mul_(0.02)
        elif isinstance(m, G2L):
            m.absolute_pos_embed.zero_()
    return model
