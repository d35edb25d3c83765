"""The MiDaS DPT decoder over hooked backbone features (counterpart of the
decoder half of prisma_tpu/models/midas.py: `_readout_project` and
`decoder_forward`).

It is the decoder of MiDaS's DPT models and of the BEiT-L core that ZoeD_N
and PatchFusion share. Parameter names are the MiDaS checkpoint's (the
hub's DPTDepthModel): `pretrained.act_postprocess{1-4}` (the 'project'
readout at `.0.project.0`, the 1x1 projection at `.3`, the x4 and x2
transposed convs and the stride-2 conv at `.4`), `scratch.layer{1-4}_rn`,
`scratch.refinenet{1-4}` and `scratch.output_conv.{0,2,4}`. The backbone
sits beside them at `pretrained.model`. NCHW throughout.

DPT_Large's ViT-L backbone and MiDaS v2.1 are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from prisma_tpu_torch.models import dpt
from prisma_tpu_torch.ops import nn as pnn
from prisma_tpu_torch.ops.resize import resize2d_nchw

OUT_CHANNELS = (256, 512, 1024, 1024)


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


class Scratch(nn.Module):
    def __init__(self, features: int, out_channels):
        super().__init__()
        for i, oc in enumerate(out_channels):
            setattr(self, f"layer{i + 1}_rn",
                    nn.Conv2d(oc, features, 3, padding=1, bias=False))
        for i in range(4):
            setattr(self, f"refinenet{i + 1}", dpt.FeatureFusionBlock(features))
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


@torch.no_grad()
def init_decoder(model: MidasDPT, generator: torch.Generator) -> MidasDPT:
    """Random init in place of everything but the backbone, with the JAX
    package's distributions: weights normal * fan_in^-0.5 (a transposed
    conv's fan-in is in * k * k), biases zero."""
    for name, m in model.named_modules():
        if name.startswith("pretrained.model"):
            continue
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            fan_in = w.shape[0] * w.shape[2] * w.shape[3] \
                if isinstance(m, nn.ConvTranspose2d) else w[0].numel()
            w.normal_(generator=generator).mul_(fan_in ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
    return model
