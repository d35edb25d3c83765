"""SOLOv2 instance segmentation: ResNet-101 + FPN + dynamic-kernel head, with
the static-shape inference of the JAX package (counterpart of
prisma_tpu/models/solov2.py).

Reference: the vendored mmdet slice (`solov2_head.py`, `necks/fpn.py`,
`post_processing/matrix_nms.py`) with the solov2_r101_fpn_3x_coco config
(80 classes, feat_channels 512, strides [8, 8, 16, 32, 32], grids
[40, 36, 24, 16, 12], GN-32, mask stride 4; test_cfg nms_pre 500, score_thr
0.1, mask_thr 0.5, filter_thr 0.05, gaussian sigma 2, max_per_img 100).

Module names are the mmdet checkpoint's (`backbone.*` torchvision ResNet,
`neck.lateral_convs.{i}.conv`, `neck.fpn_convs.{i}.conv`,
`mask_head.mask_feature_head.convs_all_levels.{i}.conv{j}.{conv,gn}`,
`...conv_pred.{conv,gn}`, `mask_head.{kernel,cls}_convs.{i}.{conv,gn}`,
`mask_head.conv_kernel`, `mask_head.conv_cls`). NCHW throughout; the frames
of a batch go through the network together and `get_results` takes one.

Inference keeps the JAX package's fixed shapes: a top-K (K = nms_pre) over
all grid points x classes with invalid slots at score 0, the dynamic 1x1
convolutions as one [K, C] x [C, Hm*Wm] matmul, matrix NMS at [K, K] and a
[max_per_img] slab with a validity mask. Its top-Ks and sorts are stable,
as `jax.lax.top_k` and `jnp.argsort` are, so equal scores keep their order
on every device.

`network` and `forward` open the spans `prisma.model.mask_backbone` (ResNet
and the FPN), `prisma.model.mask_head` (the mask features, the kernel and
class branches) and `prisma.model.mask_results` (each frame's get_results:
point NMS, top-K, the dynamic masks, matrix NMS, the upsample and the
slab), named apart from the other models' so that a fused step's device
time falls to each model's own stages.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from prisma_tpu_torch.models import resnet
from prisma_tpu_torch.ops import nn as pnn
from prisma_tpu_torch.ops.resize import resize2d_nchw
from prisma_tpu_torch.runtime.profiling import span

BN_EPS = 1e-5


@dataclass(frozen=True)
class SOLOv2Config:
    num_classes: int = 80
    in_channels: int = 256
    feat_channels: int = 512
    stacked_convs: int = 4
    strides: tuple = (8, 8, 16, 32, 32)
    num_grids: tuple = (40, 36, 24, 16, 12)
    mask_feat_channels: int = 128
    mask_out_channels: int = 256
    mask_stride: int = 4
    gn_groups: int = 32
    # test cfg
    nms_pre: int = 500
    score_thr: float = 0.1
    mask_thr: float = 0.5
    filter_thr: float = 0.05
    sigma: float = 2.0
    max_per_img: int = 100
    # keep-ratio resize budget (long_edge, short_edge) of the mmdet test
    # pipeline; None = test_scale's (1333, 800)
    scale: tuple | None = None


class ConvModule(nn.Module):
    """mmcv ConvModule: conv (bias-free under a norm) and an optional GN."""

    def __init__(self, cin: int, cout: int, k: int, gn: int = 0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=k // 2, bias=not gn)
        if gn:
            self.gn = nn.GroupNorm(gn, cout)


class FPN(nn.Module):
    def __init__(self, in_channels=(256, 512, 1024, 2048), out: int = 256):
        super().__init__()
        self.lateral_convs = nn.ModuleList(ConvModule(c, out, 1)
                                           for c in in_channels)
        self.fpn_convs = nn.ModuleList(ConvModule(out, out, 3)
                                       for _ in in_channels)


class MaskFeatModule(nn.Module):
    def __init__(self, cfg: SOLOv2Config):
        super().__init__()
        fc, g = cfg.mask_feat_channels, cfg.gn_groups
        levels = []
        for i in range(4):
            level = nn.Module()
            for j in range(max(i, 1)):
                cin = (cfg.in_channels + (2 if i == 3 else 0)) if j == 0 else fc
                setattr(level, f"conv{j}", ConvModule(cin, fc, 3, g))
            levels.append(level)
        self.convs_all_levels = nn.ModuleList(levels)
        self.conv_pred = ConvModule(fc, cfg.mask_out_channels, 1, g)


class SOLOv2Head(nn.Module):
    def __init__(self, cfg: SOLOv2Config):
        super().__init__()
        fc, g = cfg.feat_channels, cfg.gn_groups
        self.mask_feature_head = MaskFeatModule(cfg)
        self.kernel_convs = nn.ModuleList(
            ConvModule(cfg.in_channels + 2 if i == 0 else fc, fc, 3, g)
            for i in range(cfg.stacked_convs))
        self.cls_convs = nn.ModuleList(
            ConvModule(cfg.in_channels if i == 0 else fc, fc, 3, g)
            for i in range(cfg.stacked_convs))
        self.conv_kernel = nn.Conv2d(fc, cfg.mask_out_channels, 3, padding=1)
        self.conv_cls = nn.Conv2d(fc, cfg.num_classes, 3, padding=1)


class SOLOv2(nn.Module):
    def __init__(self, cfg: SOLOv2Config = SOLOv2Config()):
        super().__init__()
        self.cfg = cfg
        self.backbone = resnet.ResNet(101)
        self.neck = FPN()
        self.mask_head = SOLOv2Head(cfg)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def group_norm(gn: nn.GroupNorm, x: torch.Tensor, eps: float = 1e-5):
    """Single-pass f32 moments per (sample, group), normalised in f32, cast
    back to x's dtype, then the per-channel affine (the JAX package's form)."""
    B, C, H, W = x.shape
    g = x.view(B, gn.num_groups, C // gn.num_groups, H, W).float()
    mu = g.mean(dim=(2, 3, 4), keepdim=True)
    var = ((g * g).mean(dim=(2, 3, 4), keepdim=True) - mu * mu).clamp_min(0.0)
    g = ((g - mu) * torch.rsqrt(var + eps)).to(x.dtype).view(B, C, H, W)
    return g * gn.weight[:, None, None] + gn.bias[:, None, None]


def conv_gn_relu(p: ConvModule, x: torch.Tensor) -> torch.Tensor:
    return F.relu(group_norm(p.gn, pnn.conv2d(p.conv, x, padding=1)))


def coord_feature(B: int, H: int, W: int, dtype, device) -> torch.Tensor:
    """[-1, 1] linspace coordinate channels (x then y) [B, 2, H, W]
    (mmdet generate_coordinate)."""
    xs = torch.linspace(-1.0, 1.0, W, dtype=dtype, device=device)
    ys = torch.linspace(-1.0, 1.0, H, dtype=dtype, device=device)
    grid = torch.stack([xs[None, :].expand(H, W), ys[:, None].expand(H, W)])
    return grid[None].expand(B, 2, H, W)


def _with_coords(x: torch.Tensor) -> torch.Tensor:
    B, _, H, W = x.shape
    return torch.cat([x, coord_feature(B, H, W, x.dtype, x.device)], dim=1)


def fpn_forward(neck: FPN, feats) -> list:
    """C2..C5 -> P2..P6: lateral 1x1, top-down nearest x2 (by repetition,
    cropped), 3x3 out convs, and the extra stride-2 level (max_pool2d with
    kernel 1 and stride 2, a subsample)."""
    laterals = [pnn.conv2d(p.conv, f) for p, f in zip(neck.lateral_convs, feats)]
    for i in range(len(laterals) - 1, 0, -1):
        th, tw = laterals[i - 1].shape[-2:]
        up = laterals[i].repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        laterals[i - 1] = laterals[i - 1] + up[:, :, :th, :tw]
    outs = [pnn.conv2d(p.conv, lat, padding=1)
            for p, lat in zip(neck.fpn_convs, laterals)]
    outs.append(outs[-1][:, :, ::2, ::2])
    return outs


def mask_feat_forward(mfh: MaskFeatModule, feats) -> torch.Tensor:
    """FPN P2..P5 -> the unified mask features [B, Cm, H/4, W/4]."""
    th, tw = feats[0].shape[-2:]
    total = None
    for i, level in enumerate(mfh.convs_all_levels):
        x = feats[i]
        if i == len(mfh.convs_all_levels) - 1:
            x = _with_coords(x)
        for j in range(max(i, 1)):
            x = conv_gn_relu(getattr(level, f"conv{j}"), x)
            if i > 0:
                x = resize2d_nchw(x, (x.shape[-2] * 2, x.shape[-1] * 2),
                                  method="linear", align_corners=False)
        x = x[:, :, :th, :tw]
        total = x if total is None else total + x
    # conv_pred is a 1x1 ConvModule (conv -> GN -> ReLU)
    return F.relu(group_norm(mfh.conv_pred.gn,
                             pnn.conv2d(mfh.conv_pred.conv, total)))


def head_forward(head: SOLOv2Head, fpn_feats, cfg: SOLOv2Config):
    """-> (kernel_preds [lvl][B, Ck, g, g], cls_preds [lvl][B, nc, g, g],
    mask_feats [B, Cm, Hm, Wm])."""
    mask_feats = mask_feat_forward(head.mask_feature_head, fpn_feats)
    # resize_feats: the first level down to the second, the last up to the
    # one before it (solo_head.py:133-151)
    feats = list(fpn_feats)
    feats[0] = resize2d_nchw(feats[0], feats[1].shape[-2:], method="linear")
    feats[-1] = resize2d_nchw(feats[-1], feats[-2].shape[-2:], method="linear")

    kernel_preds, cls_preds = [], []
    for lvl, x in enumerate(feats):
        g = cfg.num_grids[lvl]
        x = resize2d_nchw(_with_coords(x), (g, g), method="linear")
        cate = x[:, :-2]
        kern = x
        for p in head.kernel_convs:
            kern = conv_gn_relu(p, kern)
        kern = pnn.conv2d(head.conv_kernel, kern, padding=1)
        for p in head.cls_convs:
            cate = conv_gn_relu(p, cate)
        cate = pnn.conv2d(head.conv_cls, cate, padding=1)
        kernel_preds.append(kern)
        cls_preds.append(cate)
    return kernel_preds, cls_preds, mask_feats


# ---------------------------------------------------------------------------
# Static-shape inference (get_results)
# ---------------------------------------------------------------------------

def _top_k(x: torch.Tensor, k: int):
    """jax.lax.top_k's order: descending, the lower index first among equal
    values (torch.topk promises no order of ties on CUDA)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _point_local_max(scores: torch.Tensor) -> torch.Tensor:
    """2x2/s1/p1 max-pool local-max NMS on [nc, g, g] sigmoid scores (keep
    where a score equals the max of its up-left-inclusive 2x2 window)."""
    p = F.pad(scores, (1, 0, 1, 0), value=float("-inf"))
    local_max = torch.maximum(torch.maximum(p[:, 1:, 1:], p[:, :-1, 1:]),
                              torch.maximum(p[:, 1:, :-1], p[:, :-1, :-1]))
    return scores * (local_max == scores)


def matrix_nms_static(masks_flat, labels, scores, areas, valid,
                      sigma: float) -> torch.Tensor:
    """Gaussian matrix NMS over a fixed candidate slab.

    masks_flat [K, M] f32 binary, labels/scores/areas/valid [K], sorted by
    score descending (invalid last). Returns the decayed scores [K]. The
    intersections are f32 sums of 0/1 products: exact integer counts."""
    inter = masks_flat @ masks_flat.T
    union = areas[:, None] + areas[None, :] - inter
    iou = torch.where(union > 0, inter / union, 0.0)
    K = scores.shape[0]
    triu = torch.ones(K, K, dtype=torch.bool, device=scores.device).triu(1)
    label_eq = (labels[:, None] == labels[None, :]) & triu
    both = label_eq & valid[:, None] & valid[None, :]
    iou = torch.where(both, iou.triu(1), 0.0)
    # compensate[i]: the largest IoU of suppressor row i with anything above
    # it (reference matrix_nms.py:80-91: per-column max, indexed by row)
    compensate = iou.amax(dim=0)
    decay = torch.exp(-sigma * iou ** 2) / torch.exp(-sigma * compensate[:, None] ** 2)
    decay_coef = torch.where(both, decay, float("inf")).amin(dim=0)
    decay_coef = torch.where(torch.isfinite(decay_coef), decay_coef,
                             1.0).clamp(max=1.0)
    return scores * decay_coef


def get_results(kernel_preds, cls_preds, mask_feats, img_hw, ori_hw,
                cfg: SOLOv2Config = SOLOv2Config()) -> dict:
    """One image's head outputs (batch of one, as head_forward gives them
    for a frame) -> the instance slab: masks [max_per_img, oh, ow] bool,
    their probabilities `probs` (f32 or the model's dtype) before the
    threshold, labels, scores and valid [max_per_img].

    img_hw: (h, w) of the resized image before padding; ori_hw: the frame's."""
    nc = cfg.num_classes
    dev = mask_feats.device
    # all levels flat, point-major then class: scores [P, nc], kernels [P, Ck]
    scores = torch.cat([_point_local_max(torch.sigmoid(c[0])).permute(1, 2, 0)
                        .reshape(-1, nc) for c in cls_preds])
    kernels = torch.cat([k[0].permute(1, 2, 0).reshape(-1, k.shape[1])
                         for k in kernel_preds])
    strides = torch.from_numpy(np.concatenate(
        [np.full(g * g, s, np.float32)
         for g, s in zip(cfg.num_grids, cfg.strides)])).to(dev)

    flat = scores.reshape(-1)
    flat = torch.where(flat > cfg.score_thr, flat, 0.0)
    K = cfg.nms_pre
    top_scores, top_idx = _top_k(flat, K)
    point_idx = top_idx // nc
    labels = top_idx % nc
    valid = top_scores > 0.0

    # the dynamic 1x1 convolutions as one matmul
    Cm, Hm, Wm = mask_feats.shape[1:]
    logits = (kernels[point_idx] @ mask_feats[0].reshape(Cm, Hm * Wm)).view(K, Hm, Wm)
    mask_preds = torch.sigmoid(logits)
    masks = mask_preds > cfg.mask_thr
    areas = masks.sum(dim=(1, 2)).float()
    valid = valid & (areas > strides[point_idx])
    maskness = torch.where(areas > 0, (mask_preds * masks).sum(dim=(1, 2)) / areas,
                           0.0)
    scores_k = torch.where(valid, top_scores * maskness, 0.0)

    # sort descending (invalid slots have score 0 and sink to the end)
    order = torch.argsort(-scores_k, stable=True)
    scores_k, labels, masks, mask_preds, areas, valid = (
        t[order] for t in (scores_k, labels, masks, mask_preds, areas, valid))

    scores_k = matrix_nms_static(masks.view(K, -1).float(), labels, scores_k,
                                 areas, valid, cfg.sigma)
    valid = valid & (scores_k >= cfg.filter_thr)
    scores_k = torch.where(valid, scores_k, 0.0)

    out_scores, out_idx = _top_k(scores_k, cfg.max_per_img)
    out_preds = mask_preds[out_idx]
    # upsample x mask_stride, crop to the unpadded image, resize to the frame
    up = resize2d_nchw(out_preds, (Hm * cfg.mask_stride, Wm * cfg.mask_stride),
                       method="linear")
    up = resize2d_nchw(up[:, :img_hw[0], :img_hw[1]], tuple(ori_hw),
                       method="linear")
    return {"masks": up > cfg.mask_thr, "probs": up, "labels": labels[out_idx],
            "scores": out_scores, "valid": valid[out_idx]}


def network(model: SOLOv2, image: torch.Tensor):
    """image [B, 3, Hp, Wp] normalised + padded -> head_forward's outputs."""
    with span("prisma.model.mask_backbone"):
        fpn_feats = fpn_forward(model.neck,
                                resnet.forward(model.backbone, image))
    with span("prisma.model.mask_head"):
        return head_forward(model.mask_head, fpn_feats, model.cfg)


def forward(model: SOLOv2, image: torch.Tensor, img_hw, ori_hw) -> list:
    """image [B, 3, Hp, Wp] -> one instance slab (see get_results) a frame."""
    kernel_preds, cls_preds, mask_feats = network(model, image)
    with span("prisma.model.mask_results"):
        return [get_results([k[b:b + 1] for k in kernel_preds],
                            [c[b:b + 1] for c in cls_preds],
                            mask_feats[b:b + 1], img_hw, ori_hw, model.cfg)
                for b in range(image.shape[0])]


# ---------------------------------------------------------------------------
# Preprocessing (the mmdet test pipeline), build and random init
# ---------------------------------------------------------------------------

IMG_MEAN = (123.675, 116.28, 103.53)
IMG_STD = (58.395, 57.12, 57.375)


def test_scale(ori_h: int, ori_w: int, long_edge: int = 1333,
               short_edge: int = 800):
    """mmdet keep-ratio rescale: (new_h, new_w) = round(dim * factor)."""
    factor = min(long_edge / max(ori_h, ori_w), short_edge / min(ori_h, ori_w))
    return int(ori_h * factor + 0.5), int(ori_w * factor + 0.5)


def preprocess(frames_u8: torch.Tensor, dtype=None, scale=None):
    """uint8 RGB frames [B, H, W, 3] -> (normalised image [B, 3, Hp, Wp],
    (h, w) resized): a linear resize and the normalisation in f32, a cast to
    dtype (the model's), zeros padded at the bottom and right to multiples
    of 32. scale: the (long_edge, short_edge) budget; None = (1333, 800)."""
    H, W = frames_u8.shape[1:3]
    h, w = test_scale(H, W) if scale is None else test_scale(H, W, *scale)
    img = resize2d_nchw(frames_u8.permute(0, 3, 1, 2).float(), (h, w),
                        method="linear")
    mean = torch.tensor(IMG_MEAN, device=img.device)[:, None, None]
    std = torch.tensor(IMG_STD, device=img.device)[:, None, None]
    img = (img - mean) / std
    if dtype is not None:
        img = img.to(dtype)
    return F.pad(img, (0, -w % 32, 0, -h % 32)), (h, w)


def build(cfg: SOLOv2Config = SOLOv2Config(),
          device: str | torch.device = "cpu") -> SOLOv2:
    """A model with uninitialised storage on `device` (filled by init_params
    or load_state_dict)."""
    with torch.device("meta"):
        model = SOLOv2(cfg)
    return model.to_empty(device=device).eval()


@torch.no_grad()
def init_params(model: SOLOv2, generator: torch.Generator) -> SOLOv2:
    """Random init in place with the JAX package's distributions (its
    weights differ: they come from jax.random): conv weights normal ·
    fan_in^-0.5, biases zero, group norms the identity, batch norms the
    identity (variance 1 - eps, so that the folded scale is 1)."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            m.weight.normal_(generator=generator).mul_(m.weight[0].numel() ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0 - BN_EPS)
            m.num_batches_tracked.zero_()
    return model
