"""ResNet backbone in eval mode (counterpart of prisma_tpu/models/resnet.py).

mmdet's pytorch-style ResNet-101 as SOLOv2 uses it, identical to
torchvision's resnet101: a 7x7/2 stem + BN + ReLU + 3x3/2 max pool, then
bottleneck stages [3, 4, 23, 3] with the stride on the 3x3 conv, returning
C2..C5. Parameter names are torchvision's (`conv1`, `bn1`,
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
    def __init__(self, cin: int, width: int, stride: int, down: bool):
        super().__init__()
        cout = width * 4
        self.stride = stride
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.downsample = nn.Sequential(
            nn.Conv2d(cin, cout, 1, stride=stride, bias=False),
            nn.BatchNorm2d(cout)) if down else None


class ResNet(nn.Module):
    def __init__(self, depth: int = 101):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin, width = 64, 64
        for si, nblocks in enumerate(RESNET_STAGES[depth]):
            blocks = []
            for bi in range(nblocks):
                stride = 2 if (si > 0 and bi == 0) else 1
                blocks.append(Bottleneck(cin, width, stride, down=bi == 0))
                cin = width * 4
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))
            width *= 2


def _bottleneck(b: Bottleneck, x: torch.Tensor) -> torch.Tensor:
    y = F.relu(pnn.batch_norm(b.bn1, pnn.conv2d(b.conv1, x)))
    y = F.relu(pnn.batch_norm(b.bn2, pnn.conv2d(b.conv2, y, stride=b.stride,
                                                padding=1)))
    y = pnn.batch_norm(b.bn3, pnn.conv2d(b.conv3, y))
    if b.downsample is not None:
        x = pnn.batch_norm(b.downsample[1],
                           pnn.conv2d(b.downsample[0], x, stride=b.stride))
    return F.relu(x + y)


def forward(model: ResNet, x: torch.Tensor) -> tuple:
    """x [B, 3, H, W] normalised -> (C2, C3, C4, C5), NCHW."""
    x = F.relu(pnn.batch_norm(model.bn1, pnn.conv2d(model.conv1, x, stride=2,
                                                    padding=3)))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    outs = []
    for layer in (model.layer1, model.layer2, model.layer3, model.layer4):
        for block in layer:
            x = _bottleneck(block, x)
        outs.append(x)
    return tuple(outs)
