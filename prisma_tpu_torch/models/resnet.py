"""ResNet backbone in eval mode (counterpart of prisma_tpu/models/resnet.py).

mmdet's pytorch-style ResNet-101 as SOLOv2 uses it, identical to
torchvision's resnet101: a 7x7/2 stem + BN + ReLU + 3x3/2 max pool, then
bottleneck stages [3, 4, 23, 3] with the stride on the 3x3 conv, returning
C2..C5. With groups > 1 the bottleneck is ResNeXt's (a grouped 3x3 of
int(width * width_per_group / 64) * groups channels), e.g. MiDaS v2.1's
resnext101_32x8d_wsl. Parameter names are torchvision's (`conv1`, `bn1`,
`layer{1-4}.{i}.conv{1-3}` / `bn{1-3}` / `downsample.{0,1}`); the batch
norms keep their running statistics and are applied as the JAX package's
folded affines (`ops.nn.batch_norm`). NCHW throughout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from prisma_tpu_torch.ops import nn as pnn

RESNET_STAGES = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, stride: int, down: bool,
                 groups: int = 1, width_per_group: int = 64):
        super().__init__()
        cout = width * 4
        inner = int(width * (width_per_group / 64.0)) * groups
        self.stride = stride
        self.groups = groups
        self.conv1 = nn.Conv2d(cin, inner, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(inner)
        self.conv2 = nn.Conv2d(inner, inner, 3, stride=stride, padding=1,
                               groups=groups, bias=False)
        self.bn2 = nn.BatchNorm2d(inner)
        self.conv3 = nn.Conv2d(inner, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.downsample = nn.Sequential(
            nn.Conv2d(cin, cout, 1, stride=stride, bias=False),
            nn.BatchNorm2d(cout)) if down else None


class ResNet(nn.Module):
    """width: the stem's channels and the first stage's bottleneck width
    (64 in every published ResNet; narrower only in tests)."""

    def __init__(self, depth: int = 101, groups: int = 1,
                 width_per_group: int = 64, width: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(3, width, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        cin = width
        for si, nblocks in enumerate(RESNET_STAGES[depth]):
            blocks = []
            for bi in range(nblocks):
                stride = 2 if (si > 0 and bi == 0) else 1
                blocks.append(Bottleneck(cin, width, stride, bi == 0, groups,
                                         width_per_group))
                cin = width * 4
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))
            width *= 2


def _bottleneck(b: Bottleneck, x: torch.Tensor) -> torch.Tensor:
    y = F.relu(pnn.batch_norm(b.bn1, pnn.conv2d(b.conv1, x)))
    y = F.relu(pnn.batch_norm(b.bn2, pnn.conv2d(b.conv2, y, stride=b.stride,
                                                padding=1, groups=b.groups)))
    y = pnn.batch_norm(b.bn3, pnn.conv2d(b.conv3, y))
    if b.downsample is not None:
        x = pnn.batch_norm(b.downsample[1],
                           pnn.conv2d(b.downsample[0], x, stride=b.stride))
    return F.relu(x + y)


def features(conv1: nn.Conv2d, bn1: nn.BatchNorm2d, layers,
             x: torch.Tensor) -> tuple:
    """The stem (conv1, bn1, ReLU, 3x3/2 max pool), then each stage of
    `layers` in turn: x [B, 3, H, W] normalised -> (C2, C3, C4, C5), NCHW."""
    x = F.relu(pnn.batch_norm(bn1, pnn.conv2d(conv1, x, stride=2, padding=3)))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    outs = []
    for layer in layers:
        for block in layer:
            x = _bottleneck(block, x)
        outs.append(x)
    return tuple(outs)


def forward(model: ResNet, x: torch.Tensor) -> tuple:
    """x [B, 3, H, W] normalised -> (C2, C3, C4, C5), NCHW."""
    return features(model.conv1, model.bn1, (model.layer1, model.layer2,
                                             model.layer3, model.layer4), x)
