"""MiDaS: the DPT decoder over hooked backbone features, DPT_Large (ViT-L/16)
and MiDaS v2.1 (ResNeXt-101), counterpart of prisma_tpu/models/midas.py.

The DPT decoder (`_readout_project`, `decoder_forward`) serves DPT_Large
and the BEiT-L core that ZoeD_N and PatchFusion share. Parameter names are
the MiDaS checkpoints' (the hub's DPTDepthModel): `pretrained.model` (the
backbone: timm's ViT-L/16 for DPT_Large), `pretrained.act_postprocess{1-4}`
(the 'project' readout at `.0.project.0`, the 1x1 projection at `.3`, the
x4 and x2 transposed convs and the stride-2 conv at `.4`),
`scratch.layer{1-4}_rn`, `scratch.refinenet{1-4}` and
`scratch.output_conv.{0,2,4}`. MiDaS v2.1 (the hub's MidasNet, the
`midas2` and `midas2-small` model versions) keeps `pretrained.layer1` =
(conv1, bn1, ReLU, max pool, the first ResNeXt stage), `pretrained.layer
{2-4}`, bias-free `scratch.layer{1-4}_rn` and fusion blocks of two residual
units without an out conv. NCHW throughout.

Both `infer`s take uint8 frames: the hub transform's upper-bound resize to
a multiple of 32 (bicubic) and ImageNet normalisation in f32, the model in
the compute dtype, the disparity resized back bicubic with align_corners.
DPT_Large's ViT attention runs through `ops.nn.attention` (K1 on the card).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from prisma_tpu_torch.models import dpt, resnet, vit
from prisma_tpu_torch.ops import nn as pnn
from prisma_tpu_torch.ops.resize import dpt_input_size, resize2d_nchw

OUT_CHANNELS = (256, 512, 1024, 1024)
HOOKS = (5, 11, 17, 23)
VIT_CONFIG = vit.ViTConfig(embed_dim=1024, depth=24, num_heads=16,
                           patch_size=16, base_img_size=384, layerscale=False)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class ProjectReadout(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())


def _act_postprocess(i: int, dim: int, oc: int) -> nn.Sequential:
    """`pretrained.act_postprocess{i+1}`: readout, (transpose, unflatten),
    1x1 projection, then the level's resize."""
    layers = [ProjectReadout(dim), nn.Identity(), nn.Identity(),
              nn.Conv2d(dim, oc, 1)]
    if i == 0:
        layers.append(nn.ConvTranspose2d(oc, oc, 4, stride=4))
    elif i == 1:
        layers.append(nn.ConvTranspose2d(oc, oc, 2, stride=2))
    elif i == 3:
        layers.append(nn.Conv2d(oc, oc, 3, stride=2, padding=1))
    return nn.Sequential(*layers)


class FusionBlockV2(nn.Module):
    """MiDaS v2.1's FeatureFusionBlock: two residual units, no out conv."""

    def __init__(self, features: int):
        super().__init__()
        self.resConfUnit1 = dpt.ResidualConvUnit(features)
        self.resConfUnit2 = dpt.ResidualConvUnit(features)


class Scratch(nn.Module):
    def __init__(self, features: int, out_channels,
                 fusion=dpt.FeatureFusionBlock):
        super().__init__()
        for i, oc in enumerate(out_channels):
            setattr(self, f"layer{i + 1}_rn",
                    nn.Conv2d(oc, features, 3, padding=1, bias=False))
        for i in range(4):
            setattr(self, f"refinenet{i + 1}", fusion(features))
        self.output_conv = nn.Sequential(
            nn.Conv2d(features, features // 2, 3, padding=1), nn.Identity(),
            nn.Conv2d(features // 2, 32, 3, padding=1), nn.ReLU(),
            nn.Conv2d(32, 1, 1), nn.ReLU())


class Pretrained(nn.Module):
    """`pretrained`: the backbone at `model` and the four readouts."""

    def __init__(self, backbone: nn.Module, dim: int, out_channels):
        super().__init__()
        self.model = backbone
        for i, oc in enumerate(out_channels):
            setattr(self, f"act_postprocess{i + 1}", _act_postprocess(i, dim, oc))


class MidasDPT(nn.Module):
    """The hub's DPTDepthModel: `pretrained` (backbone + readouts) and
    `scratch` (the decoder)."""

    def __init__(self, backbone: nn.Module, dim: int, features: int = 256,
                 out_channels=OUT_CHANNELS):
        super().__init__()
        self.pretrained = Pretrained(backbone, dim, out_channels)
        self.scratch = Scratch(features, out_channels)


class ResNeXtBackbone(nn.Module):
    """MiDaS v2.1's `pretrained`: resnext101_32x8d_wsl in the hub layout,
    `layer1` = (conv1, bn1, ReLU, max pool, the first stage)."""

    def __init__(self, depth: int = 101, groups: int = 32,
                 width_per_group: int = 8, width: int = 64):
        super().__init__()
        r = resnet.ResNet(depth, groups, width_per_group, width)
        self.layer1 = nn.Sequential(r.conv1, r.bn1, nn.ReLU(),
                                    nn.MaxPool2d(3, 2, 1), r.layer1)
        self.layer2, self.layer3, self.layer4 = r.layer2, r.layer3, r.layer4


class MidasNet(nn.Module):
    """The hub's MidasNet (MiDaS v2.1): `pretrained` and `scratch`."""

    def __init__(self, features: int = 256, width: int = 64):
        super().__init__()
        self.pretrained = ResNeXtBackbone(width=width)
        self.scratch = Scratch(features, tuple(4 * width << i for i in range(4)),
                               fusion=FusionBlockV2)


def _readout_project(p: ProjectReadout, tokens: torch.Tensor,
                     cls: torch.Tensor) -> torch.Tensor:
    """'project' readout: cat(token, cls) -> Linear(2D, D) -> GELU."""
    cls_exp = cls[:, None, :].expand_as(tokens)
    return pnn.gelu(pnn.linear(p.project[0], torch.cat([tokens, cls_exp], -1)))


def decoder_forward(model: MidasDPT, feats: list, ph: int, pw: int,
                    return_features: bool = False):
    """feats: [(tokens [B, ph*pw, D], cls [B, D])] x4 from the backbone's
    hooks -> relative depth [B, 16*ph, 16*pw]; with return_features also
    the MidasCore hooks (out_conv, l4_rn, r4..r1; NCHW)."""
    maps = []
    for i, (tokens, cls) in enumerate(feats):
        post = getattr(model.pretrained, f"act_postprocess{i + 1}")
        y = _readout_project(post[0], tokens, cls)
        B, N, D = y.shape
        y = pnn.conv2d(post[3], y.transpose(1, 2).reshape(B, D, ph, pw))
        if i in (0, 1):
            y = pnn.conv_transpose_blocky(post[4], y)
        elif i == 3:
            y = pnn.conv2d(post[4], y, stride=2, padding=1)
        maps.append(y)

    s = model.scratch
    l1, l2, l3, l4 = [pnn.conv2d(getattr(s, f"layer{i + 1}_rn"), m, padding=1)
                      for i, m in enumerate(maps)]
    path4 = dpt._fusion(s.refinenet4, l4)
    path3 = dpt._fusion(s.refinenet3, path4, l3)
    path2 = dpt._fusion(s.refinenet2, path3, l2)
    path1 = dpt._fusion(s.refinenet1, path2, l1)

    head = s.output_conv
    out = pnn.conv2d(head[0], path1, padding=1)
    out = resize2d_nchw(out, (out.shape[-2] * 2, out.shape[-1] * 2),
                        method="linear", align_corners=True)
    out_conv_act = F.relu(pnn.conv2d(head[2], out, padding=1))
    out = F.relu(pnn.conv2d(head[4], out_conv_act))
    if return_features:
        return out[:, 0], {"out_conv": out_conv_act, "l4_rn": l4,
                           "r4": path4, "r3": path3, "r2": path2,
                           "r1": path1}
    return out[:, 0]


def hooks(model: MidasDPT) -> tuple:
    """The ViT blocks DPT_Large hooks: (5, 11, 17, 23); a model shallower
    than 24 blocks hooks its last four."""
    depth = len(model.pretrained.model.blocks)
    return HOOKS if depth >= 24 else tuple(range(depth - 4, depth))


def forward(model: MidasDPT, x: torch.Tensor) -> torch.Tensor:
    """DPT_Large: x [B, 3, H, W] normalised, H and W multiples of 32 ->
    disparity [B, H, W]."""
    vit_model = model.pretrained.model
    P = vit_model.cfg.patch_size
    feats = vit.get_intermediate_layers(vit_model, x, indices=hooks(model),
                                        norm=False, pos_embed_method="linear")
    return decoder_forward(model, feats, x.shape[-2] // P, x.shape[-1] // P)


def _fusion_v2(p: FusionBlockV2, x: torch.Tensor,
               skip: torch.Tensor | None = None) -> torch.Tensor:
    if skip is not None:
        x = x + dpt._rcu(p.resConfUnit1, skip)
    x = dpt._rcu(p.resConfUnit2, x)
    return resize2d_nchw(x, (x.shape[-2] * 2, x.shape[-1] * 2),
                         method="linear", align_corners=True)


def midas2_forward(model: MidasNet, x: torch.Tensor) -> torch.Tensor:
    """MiDaS v2.1: x [B, 3, H, W] normalised, H and W multiples of 32 ->
    disparity [B, H, W]. The head's x2 upsample has align_corners False."""
    bb = model.pretrained
    stem = bb.layer1
    feats = resnet.features(stem[0], stem[1],
                            (stem[4], bb.layer2, bb.layer3, bb.layer4), x)
    s = model.scratch
    l1, l2, l3, l4 = [pnn.conv2d(getattr(s, f"layer{i + 1}_rn"), c, padding=1)
                      for i, c in enumerate(feats)]
    path4 = _fusion_v2(s.refinenet4, l4)
    path3 = _fusion_v2(s.refinenet3, path4, l3)
    path2 = _fusion_v2(s.refinenet2, path3, l2)
    path1 = _fusion_v2(s.refinenet1, path2, l1)

    head = s.output_conv
    out = pnn.conv2d(head[0], path1, padding=1)
    out = resize2d_nchw(out, (out.shape[-2] * 2, out.shape[-1] * 2),
                        method="linear", align_corners=False)
    out = F.relu(pnn.conv2d(head[2], out, padding=1))
    return F.relu(pnn.conv2d(head[4], out))[:, 0]


def prepare(frames_u8: torch.Tensor, compute_dtype: torch.dtype,
            target: int = 384) -> torch.Tensor:
    """The hub transform: uint8 [B, H, W, 3] -> the normalised input
    [B, 3, h', w'] in compute_dtype, h' and w' the upper-bound resize to
    target at multiples of 32 (bicubic in f32, then ImageNet's statistics)."""
    H, W = frames_u8.shape[1:3]
    w2, h2 = dpt_input_size(W, H, target=target, multiple=32,
                            method="upper_bound")
    img = frames_u8.permute(0, 3, 1, 2).float() / 255.0
    img = resize2d_nchw(img, (h2, w2), method="cubic")
    mean = torch.tensor(IMAGENET_MEAN, device=img.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=img.device)[:, None, None]
    return ((img - mean) / std).to(compute_dtype)


def _resize_back(pred: torch.Tensor, H: int, W: int) -> torch.Tensor:
    return resize2d_nchw(pred.float()[:, None], (H, W), method="cubic",
                         align_corners=True)[:, 0]


def infer(model: MidasDPT, frames_u8: torch.Tensor,
          compute_dtype: torch.dtype = torch.float32,
          target: int = 384) -> torch.Tensor:
    """DPT_Large as the reference band runs it: uint8 frames [B, H, W, 3]
    -> disparity [B, H, W] f32. The model must already be in compute_dtype."""
    H, W = frames_u8.shape[1:3]
    return _resize_back(forward(model, prepare(frames_u8, compute_dtype,
                                               target)), H, W)


def infer_v2(model: MidasNet, frames_u8: torch.Tensor,
             compute_dtype: torch.dtype = torch.float32,
             target: int = 384) -> torch.Tensor:
    """MiDaS v2.1 as the reference band runs it (target 384, or 256 for
    midas2-small): uint8 frames [B, H, W, 3] -> disparity [B, H, W] f32."""
    H, W = frames_u8.shape[1:3]
    return _resize_back(midas2_forward(model, prepare(frames_u8, compute_dtype,
                                                      target)), H, W)


def build_dpt(cfg: vit.ViTConfig = VIT_CONFIG, features: int = 256,
              out_channels=OUT_CHANNELS,
              device: str | torch.device = "cpu") -> MidasDPT:
    """DPT_Large with uninitialised storage on `device` (filled by
    init_params or load_state_dict)."""
    with torch.device("meta"):
        model = MidasDPT(vit.VisionTransformer(cfg), cfg.embed_dim, features,
                         out_channels)
    return model.to_empty(device=device).eval()


def build_v2(features: int = 256, width: int = 64,
             device: str | torch.device = "cpu") -> MidasNet:
    """MiDaS v2.1 with uninitialised storage on `device` (width: the
    ResNeXt's stem width, 64 in the published model)."""
    with torch.device("meta"):
        model = MidasNet(features, width)
    return model.to_empty(device=device).eval()


@torch.no_grad()
def _init_weights(model: nn.Module, generator: torch.Generator,
                  skip: str = "") -> None:
    """The JAX package's distributions in place: conv and linear weights
    normal * fan_in^-0.5 (a transposed conv's fan-in is in * k * k), biases
    zero; batch norms the identity (weight 1, bias 0, mean 0, var 1 - eps,
    as the JAX package's folded scale 1 and shift 0 unfold). Modules under
    `skip` are left as they are."""
    for name, m in model.named_modules():
        if skip and name.startswith(skip):
            continue
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            fan_in = w.shape[0] * w.shape[2] * w.shape[3] \
                if isinstance(m, nn.ConvTranspose2d) else w[0].numel()
            w.normal_(generator=generator).mul_(fan_in ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0 - m.eps)
            m.num_batches_tracked.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()


@torch.no_grad()
def init_params(model: MidasDPT, generator: torch.Generator) -> MidasDPT:
    """DPT_Large at random with the JAX package's distributions (its weights
    differ: they come from jax.random): cls token normal * 1e-6, pos embed
    normal * 0.02, the rest as `_init_weights`."""
    _init_weights(model, generator)
    v = model.pretrained.model
    v.cls_token.normal_(generator=generator).mul_(1e-6)
    v.pos_embed.normal_(generator=generator).mul_(0.02)
    return model


@torch.no_grad()
def init_params_v2(model: MidasNet, generator: torch.Generator) -> MidasNet:
    """MiDaS v2.1 at random, as `_init_weights`."""
    _init_weights(model, generator)
    return model


@torch.no_grad()
def init_decoder(model: MidasDPT, generator: torch.Generator) -> MidasDPT:
    """Random init in place of everything but the backbone, with the JAX
    package's distributions: weights normal * fan_in^-0.5 (a transposed
    conv's fan-in is in * k * k), biases zero."""
    _init_weights(model, generator, skip="pretrained.model")
    return model
