"""Signed distance field for the mask band's green channel, on the model's
device (counterpart of prisma_tpu/ops/sdf.py).

Reference: the snowy-based SDF of `bands/mask_mmdet.py:64-69`:
``sdf = generate_sdf(mask != 0); sdf = (sdf + 127) / 255;
sdf = (sdf - 0.25) * 2; 1 - clip(sdf, 0, 1)`` — a signed Euclidean distance
in pixels (positive outside the mask, negative inside), window-clamped.

The green mapping clamps beyond +64.25 px and saturates below -63.25 px, so
only distances within +-CAP matter, and there the EDT is exact: a vertical
1-D distance per column by min-plus relaxation over descending powers of two
(log2(CAP) passes), then D^2[y, x] = min over |dx| <= CAP of
g[y, x + dx]^2 + dx^2, a loop over the 133 offsets. All values are integers
or their square roots in f32, so the result equals the JAX package's.

The scipy host version is kept as the test oracle.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# every |signed distance| > 64.25 px clamps in the green mapping; 66 keeps
# every contributing distance exact
CAP = 66
_POW2 = (64, 32, 16, 8, 4, 2, 1)


def _dist1d_vertical(seed: torch.Tensor) -> torch.Tensor:
    """seed [..., H, W] bool -> each pixel's vertical distance to the nearest
    seed of its column, exact up to CAP (capped there)."""
    cap = float(CAP)
    d = torch.where(seed, 0.0, cap)
    H = d.shape[-2]
    for k in _POW2:
        if k >= H:
            continue
        up = F.pad(d[..., k:, :], (0, 0, 0, k), value=cap)
        down = F.pad(d[..., :-k, :], (0, 0, k, 0), value=cap)
        d = torch.minimum(d, torch.minimum(up, down) + float(k))
    return d.clamp(max=cap)


def _edt_capped(seed: torch.Tensor) -> torch.Tensor:
    """Euclidean distance from every pixel to the nearest True pixel of
    seed [..., H, W], exact within CAP."""
    g = _dist1d_vertical(seed)
    W = g.shape[-1]
    big = float(CAP) * float(CAP)
    g2p = F.pad(g * g, (CAP, CAP), value=big)
    d2 = torch.full_like(g, big)
    for dx in range(-CAP, CAP + 1):
        torch.minimum(d2, g2p[..., CAP + dx:CAP + dx + W] + float(dx * dx),
                      out=d2)
    return torch.sqrt(d2)


def signed_distance_device(mask: torch.Tensor) -> torch.Tensor:
    """Signed EDT in pixels (positive outside the mask, negative inside),
    exact within +-CAP and clamped beyond. mask [..., H, W] bool."""
    both = _edt_capped(torch.stack([mask, ~mask]))  # outside, then inside
    return both[0] - both[1]


def sdf_green_device(mask: torch.Tensor) -> torch.Tensor:
    """The reference getSDF green channel from a boolean mask [..., H, W]:
    f32 in [0, 1], 1 at and inside the mask, fading to 0 by ~64 px."""
    sdf = signed_distance_device(mask.bool())
    # a divisor on the device keeps this a true division on CUDA: there a
    # Python-scalar divisor becomes a product with its reciprocal, an ulp
    # away from the CPU's and the JAX package's quotient
    sdf = (sdf + 127.0) / torch.tensor(255.0, device=sdf.device)
    sdf = (sdf - 0.25) * 2.0
    return 1.0 - sdf.clamp(0.0, 1.0)


# ---------------------------------------------------------------------------
# Host (scipy) version: the test oracle.
# ---------------------------------------------------------------------------

def signed_distance(mask: np.ndarray) -> np.ndarray:
    """Signed EDT in pixels: positive outside mask, negative inside."""
    from scipy import ndimage
    mask = np.asarray(mask, bool)
    if not mask.any():
        return np.full(mask.shape, np.inf, np.float64)
    if mask.all():
        return np.full(mask.shape, -np.inf, np.float64)
    outside = ndimage.distance_transform_edt(~mask)
    inside = ndimage.distance_transform_edt(mask)
    return outside - inside


def mask_sdf_channel(mask_rgb: np.ndarray) -> np.ndarray:
    """Reference getSDF: white-on-black mask RGB -> green-channel SDF [H, W]
    in [0, 1] (1 at/inside the mask, fading to 0 by ~64px outside)."""
    lum = np.asarray(mask_rgb[..., :3], np.float64).mean(axis=-1)
    sdf = signed_distance(lum != 0.0)
    sdf = (sdf + 127.0) / 255.0
    sdf = (sdf - 0.25) * 2.0
    return 1.0 - np.clip(sdf, 0.0, 1.0)
