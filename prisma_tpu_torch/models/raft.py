"""The RAFT helpers GMFlow shares (counterpart of convex_upsample,
pad_to_multiple and unpad in prisma_tpu/models/raft.py). The RAFT model
itself is not ported yet. Layouts are the JAX package's: [B, H, W, C].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor,
                    factor: int = 8) -> torch.Tensor:
    """flow [B, H, W, 2], mask [B, H, W, 9·f²] -> [B, f·H, f·W, 2].

    The mask channel layout follows the reference's view(N, 1, 9, f, f, H,
    W): channel c = (k·f + i)·f + j with k the 3x3 neighbour (row-major) and
    (i, j) the subpixel; a softmax over the 9 neighbours weighs f·flow at
    each of them (zero outside the image)."""
    B, H, W, _ = flow.shape
    f = factor
    m = mask.reshape(B, H, W, 9, f, f)
    m = torch.exp(m - m.amax(dim=3, keepdim=True))
    m = m / m.sum(dim=3, keepdim=True)
    fp = F.pad(float(f) * flow, (0, 0, 1, 1, 1, 1))
    neighbors = torch.stack([fp[:, ky:ky + H, kx:kx + W] for ky in range(3)
                             for kx in range(3)], dim=3)  # [B, H, W, 9, 2]
    up = torch.einsum("bhwkij,bhwkc->bhwijc", m, neighbors)
    up = up.permute(0, 1, 3, 2, 4, 5)  # (b, h, i, w, j, c)
    return up.reshape(B, f * H, f * W, 2)


def pad_to_multiple(x: torch.Tensor, multiple: int = 8):
    """Sintel-mode InputPadder (reference common/flow.py:43-61): pad
    [B, H, W, C] to multiples of `multiple`, centred, replicating the edge.
    -> (padded, (top, bottom, left, right))."""
    H, W = x.shape[1], x.shape[2]
    ph = (-H) % multiple
    pw = (-W) % multiple
    top, bottom = ph // 2, ph - ph // 2
    left, right = pw // 2, pw - pw // 2
    x = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom),
              mode="replicate").permute(0, 2, 3, 1)
    return x, (top, bottom, left, right)


def unpad(x: torch.Tensor, pads) -> torch.Tensor:
    top, bottom, left, right = pads
    return x[:, top:x.shape[1] - bottom, left:x.shape[2] - right]
