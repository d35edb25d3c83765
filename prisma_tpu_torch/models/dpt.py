"""DPT decoder head over ViT intermediate features (counterpart of
prisma_tpu/models/dpt.py, the relative path).

Parameter names are the Depth-Anything checkpoint's `depth_head.*` keys:
`projects.{0-3}`, `resize_layers.{0,1,3}` (x4 and x2 transposed convs, the
identity, a stride-2 conv), `scratch.layer{1-4}_rn`, `scratch.refinenet{1-4}`
(`out_conv`, `resConfUnit{1,2}.conv{1,2}`), `scratch.output_conv1` and
`scratch.output_conv2.{0,2}`. NCHW throughout; the x4/x2 transposed
convolutions are non-overlapping and run as one einsum each.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from prisma_tpu_torch.ops import nn as pnn
from prisma_tpu_torch.ops.resize import resize2d_nchw

DPT_OUT_CHANNELS = (256, 512, 1024, 1024)


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)


class FeatureFusionBlock(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.out_conv = nn.Conv2d(features, features, 1)
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)


class Scratch(nn.Module):
    def __init__(self, features: int, out_channels):
        super().__init__()
        for i, oc in enumerate(out_channels):
            setattr(self, f"layer{i + 1}_rn",
                    nn.Conv2d(oc, features, 3, padding=1, bias=False))
        for i in range(4):
            setattr(self, f"refinenet{i + 1}", FeatureFusionBlock(features))
        self.output_conv1 = nn.Conv2d(features, features // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(
            nn.Conv2d(features // 2, 32, 3, padding=1), nn.ReLU(),
            nn.Conv2d(32, 1, 1), nn.ReLU(), nn.Identity())


class DPTHead(nn.Module):
    def __init__(self, in_dim: int, features: int = 256,
                 out_channels=DPT_OUT_CHANNELS):
        super().__init__()
        oc = out_channels
        self.projects = nn.ModuleList(nn.Conv2d(in_dim, c, 1) for c in oc)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4),
            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1)])
        self.scratch = Scratch(features, oc)


def _rcu(p: ResidualConvUnit, x: torch.Tensor) -> torch.Tensor:
    y = pnn.conv2d(p.conv1, F.relu(x), padding=1)
    y = pnn.conv2d(p.conv2, F.relu(y), padding=1)
    return x + y


def _fusion(p: FeatureFusionBlock, x, skip=None, size=None):
    if skip is not None:
        x = x + _rcu(p.resConfUnit1, skip)
    x = _rcu(p.resConfUnit2, x)
    if size is None:
        size = (x.shape[-2] * 2, x.shape[-1] * 2)
    x = resize2d_nchw(x, size, method="linear", align_corners=True)
    return pnn.conv2d(p.out_conv, x)


def dpt_head(head: DPTHead, features: list, ph: int, pw: int) -> torch.Tensor:
    """features: [(patch_tokens [B, N, D], cls)] x4, shallow -> deep.

    Returns relative depth/disparity [B, 14*ph, 14*pw] (before the final
    resize)."""
    maps = []
    for i, (tokens, _cls) in enumerate(features):
        B, N, D = tokens.shape
        x = tokens.permute(0, 2, 1).reshape(B, D, ph, pw)
        x = pnn.conv2d(head.projects[i], x)
        if i in (0, 1):
            x = pnn.conv_transpose_blocky(head.resize_layers[i], x)
        elif i == 3:
            x = pnn.conv2d(head.resize_layers[3], x, stride=2, padding=1)
        maps.append(x)

    s = head.scratch
    l1, l2, l3, l4 = [pnn.conv2d(getattr(s, f"layer{i + 1}_rn"), m, padding=1)
                      for i, m in enumerate(maps)]
    path4 = _fusion(s.refinenet4, l4, size=l3.shape[-2:])
    path3 = _fusion(s.refinenet3, path4, l3, size=l2.shape[-2:])
    path2 = _fusion(s.refinenet2, path3, l2, size=l1.shape[-2:])
    path1 = _fusion(s.refinenet1, path2, l1)

    out = pnn.conv2d(s.output_conv1, path1, padding=1)
    out = resize2d_nchw(out, (ph * 14, pw * 14), method="linear",
                        align_corners=True)
    out = F.relu(pnn.conv2d(s.output_conv2[0], out, padding=1))
    out = F.relu(pnn.conv2d(s.output_conv2[2], out))
    return out[:, 0]
