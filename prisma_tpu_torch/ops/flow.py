"""Flow post-processing ops on the model's device, batched over frame pairs
(counterpart of prisma_tpu/ops/flow.py, which vmaps per-pair functions).

Parity targets in the reference's `bands/common/flow.py`:
- `warp_flow` (flow.py:19-26): cv2.remap INTER_LINEAR + BORDER_CONSTANT(0)
  backward warp of one flow field by another;
- `compute_fwdbwd_mask` (flow.py:28-40): forward-backward consistency with
  alpha_1=0.05, alpha_2=0.5.
"""

from __future__ import annotations

import torch


def bilinear_sample_zero(img: torch.Tensor, x: torch.Tensor,
                         y: torch.Tensor) -> torch.Tensor:
    """Sample img [B, H, W, C] at real pixel coords x, y [B, H', W'], zero
    outside the image -> [B, H', W', C]. The indices are clipped before the
    gather and the out-of-image corners weighted by zero."""
    B, H, W, C = img.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    flat = img.reshape(B, H * W, C)

    def corner(xi, yi, w):
        valid = ((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H))[..., None]
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        got = torch.gather(flat, 1, idx.reshape(B, -1, 1).expand(-1, -1, C))
        return got.reshape(*idx.shape, C) * w * valid

    x0i = x0.long()
    y0i = y0.long()
    return (corner(x0i, y0i, (1 - fx) * (1 - fy))
            + corner(x0i + 1, y0i, fx * (1 - fy))
            + corner(x0i, y0i + 1, (1 - fx) * fy)
            + corner(x0i + 1, y0i + 1, fx * fy))


def warp_flow(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp img [B, H, W, C] by flow [B, H, W, 2] (sample at
    p + flow(p))."""
    H, W = flow.shape[1:3]
    gx = torch.arange(W, dtype=flow.dtype, device=flow.device)[None, :]
    gy = torch.arange(H, dtype=flow.dtype, device=flow.device)[:, None]
    return bilinear_sample_zero(img, flow[..., 0] + gx, flow[..., 1] + gy)


def compute_fwdbwd_mask(fwd_flow: torch.Tensor, bwd_flow: torch.Tensor,
                        alpha_1: float = 0.05, alpha_2: float = 0.5):
    """Forward-backward consistency masks of a batch of pairs ([B, H, W, 2]
    each) -> (fwd_mask, bwd_mask) [B, H, W] bool."""
    def norm(v):
        return torch.sqrt(torch.sum(v * v, dim=-1))

    bwd2fwd = warp_flow(bwd_flow, fwd_flow)
    fwd_err = norm(fwd_flow + bwd2fwd)
    fwd_mask = fwd_err < alpha_1 * (norm(fwd_flow) + norm(bwd2fwd)) + alpha_2

    fwd2bwd = warp_flow(fwd_flow, bwd_flow)
    bwd_err = norm(bwd_flow + fwd2bwd)
    bwd_mask = bwd_err < alpha_1 * (norm(bwd_flow) + norm(fwd2bwd)) + alpha_2
    return fwd_mask, bwd_mask
