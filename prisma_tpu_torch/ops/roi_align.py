"""ROI Align (counterpart of `roi_align` in prisma_tpu/ops/roi_align.py).

torchvision's `roi_align` arguments and sampling: boxes (x1, y1, x2, y2)
scaled by `spatial_scale`, shifted by -0.5 when `aligned`; each of the
ph x pw bins averages sampling_ratio x sampling_ratio bilinear taps at
y1 + (i + (t + 0.5) / sr) * bin_h. The tap count is fixed (a
sampling_ratio below 1 counts as 1), not torchvision's adaptive
ceil(roi / out). At the border the JAX package's rule holds: a tap's
neighbour outside the map contributes zero (torchvision instead clamps taps
in (-1, 0] to the edge row).

Separable: the rows of every tap are gathered and blended, the taps of a
bin averaged along y, then the columns gathered, blended and averaged. The
interpolation runs in f32; the result is cast back to the features' dtype.
"""

from __future__ import annotations

import torch


def _taps(lo: torch.Tensor, bin_sz: torch.Tensor, n_out: int, sr: int):
    """Tap positions [N, n_out * sr] of each ROI along one axis."""
    t = (torch.arange(sr, device=lo.device, dtype=torch.float32) + 0.5) / sr
    pos = torch.arange(n_out, device=lo.device, dtype=torch.float32)[:, None] + t
    return lo[:, None] + pos.reshape(1, -1) * bin_sz[:, None]


def _blend(feats: torch.Tensor, pos: torch.Tensor, dim: int) -> torch.Tensor:
    """Linear interpolation of feats [N, C, A, B] along `dim` (2 or 3) at
    positions pos [N, P]; a neighbour outside the axis contributes zero."""
    size = feats.shape[dim]
    p0 = torch.floor(pos)
    frac = pos - p0
    i0 = p0.long()
    out = 0
    for idx, w in ((i0, 1.0 - frac), (i0 + 1, frac)):
        w = w * ((idx >= 0) & (idx < size))
        idx = idx.clamp(0, size - 1)
        shape = [feats.shape[0], feats.shape[1], feats.shape[2], feats.shape[3]]
        shape[dim] = idx.shape[1]
        view = (idx.shape[0], 1, -1, 1) if dim == 2 else (idx.shape[0], 1, 1, -1)
        g = torch.gather(feats, dim, idx.view(view).expand(shape))
        out = out + g * w.view(view)
    return out


def roi_align(features: torch.Tensor, boxes: torch.Tensor,
              box_indices: torch.Tensor, output_size: tuple[int, int],
              spatial_scale: float = 1.0, sampling_ratio: int = 2,
              aligned: bool = True) -> torch.Tensor:
    """features [B, C, H, W]; boxes [N, 4] (x1, y1, x2, y2); box_indices [N]
    -> [N, C, ph, pw] in the features' dtype."""
    ph, pw = output_size
    sr = max(int(sampling_ratio), 1)
    b = boxes.float() * spatial_scale - (0.5 if aligned else 0.0)
    x1, y1, x2, y2 = b.unbind(-1)
    roi_w, roi_h = x2 - x1, y2 - y1
    if not aligned:
        roi_w = roi_w.clamp_min(1.0)
        roi_h = roi_h.clamp_min(1.0)
    gy = _taps(y1, roi_h / ph, ph, sr)
    gx = _taps(x1, roi_w / pw, pw, sr)

    N = boxes.shape[0]
    feats = features.float()
    if feats.shape[0] == 1:
        feats = feats.expand(N, *feats.shape[1:])
    else:
        feats = feats[box_indices.long()]
    C, W = feats.shape[1], feats.shape[3]
    rows = _blend(feats, gy, 2).view(N, C, ph, sr, W).mean(dim=3)
    vals = _blend(rows, gx, 3).view(N, C, ph, pw, sr).mean(dim=4)
    return vals.to(features.dtype)
