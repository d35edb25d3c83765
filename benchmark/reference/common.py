"""Plain float32 primitives shared by the benchmark's reference models.

The reference is the yardstick that decides `correct`: it imports nothing of
the program (`prisma_tpu_torch`) and follows the published equations with
plain torch operations. Every product of two tensors (linear, convolution,
matmul) goes through an `Ops` object, so the same forward runs in float32
(`Ops()`) or as the control (`Ops(fp8_round)`): each operand rounded to fp8
e4m3 with a per-tensor scale, the step below the bfloat16 the configurations
state, accumulated in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one per-tensor scale (amax -> 448),
    returned in t's dtype: what an fp8 GEMM with f32 accumulation reads."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bfloat16, returned in t's dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


class Ops:
    """The products of a forward pass; `quant` rounds every operand."""

    def __init__(self, quant=None):
        self.q = quant if quant is not None else (lambda t: t)

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)

    def conv2d(self, x, w, b=None, stride=1, padding=0):
        return F.conv2d(self.q(x), self.q(w), b, stride=stride,
                        padding=padding)

    def conv_transpose2d(self, x, w, b=None, stride=1):
        return F.conv_transpose2d(self.q(x), self.q(w), b, stride=stride)

    def matmul(self, a, b):
        return torch.matmul(self.q(a), self.q(b))


def no_tf32():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# Band epilogues (the published `bands/common` encodings)
# ---------------------------------------------------------------------------

def hue_to_rgb(hue: torch.Tensor) -> torch.Tensor:
    """LYGIA's hue ramp: hue in [0, 1] -> RGB in [0, 1], channels last."""
    offs = torch.tensor([0.0, 4.0, 2.0], dtype=hue.dtype, device=hue.device)
    k = hue[..., None] * 6.0 + offs
    return torch.clamp(torch.abs(torch.remainder(k, 6.0) - 3.0) - 1.0,
                       0.0, 1.0)


def depth_heat(depth: torch.Tensor, flip: bool):
    """depth [B, H, W] -> (heat [B, H, W, 3] uint8, min [B], max [B]): each
    frame min/max normalised, flipped for relative depth, heat-mapped as
    hue_to_rgb((1 - v) * 0.65) and floored to uint8."""
    dmin = depth.amin(dim=(1, 2))
    dmax = depth.amax(dim=(1, 2))
    v = (depth - dmin[:, None, None]) / (dmax - dmin)[:, None, None]
    if flip:
        v = 1.0 - v
    heat = torch.floor(hue_to_rgb((1.0 - v) * 0.65) * 255.0).to(torch.uint8)
    return heat, dmin, dmax


def flow_to_rgb(flow: torch.Tensor):
    """flow [B, H, W, 2] -> (rgb [B, H, W, 3] uint8, max distance [B]): the
    angle as hue, the radius over the field's own maximum as saturation."""
    dist = torch.sqrt(flow[..., 0] ** 2 + flow[..., 1] ** 2)
    md = dist.amax(dim=(1, 2))
    dx = flow[..., 0] / md[:, None, None]
    dy = flow[..., 1] / md[:, None, None]
    rad = torch.sqrt(dx * dx + dy * dy)
    ang = (torch.atan2(dy, dx) / math.pi + 1.0) * 0.5
    rgb = hue_to_rgb(ang) * rad[..., None] + (1.0 - rad[..., None])
    return torch.floor(rgb * 255.0).to(torch.uint8), md


def warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """cv2.remap(img, p + flow(p), INTER_LINEAR, BORDER_CONSTANT 0) of img
    [B, H, W, C] by flow [B, H, W, 2], as grid_sample over pixel centres."""
    B, H, W, _ = flow.shape
    gx = torch.arange(W, dtype=flow.dtype, device=flow.device)
    gy = torch.arange(H, dtype=flow.dtype, device=flow.device)[:, None]
    x = (flow[..., 0] + gx) * (2.0 / (W - 1)) - 1.0
    y = (flow[..., 1] + gy) * (2.0 / (H - 1)) - 1.0
    out = F.grid_sample(img.permute(0, 3, 1, 2), torch.stack([x, y], -1),
                        mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    return out.permute(0, 2, 3, 1)


def fwdbwd_masks(fwd: torch.Tensor, bwd: torch.Tensor,
                 alpha_1: float = 0.05, alpha_2: float = 0.5):
    """Forward-backward consistency (published `bands/common/flow.py`):
    |f + warp(b, f)| < alpha_1 (|f| + |warp(b, f)|) + alpha_2, both ways."""
    def norm(v):
        return torch.sqrt((v * v).sum(-1))

    b2f = warp(bwd, fwd)
    fmask = norm(fwd + b2f) < alpha_1 * (norm(fwd) + norm(b2f)) + alpha_2
    f2b = warp(fwd, bwd)
    bmask = norm(bwd + f2b) < alpha_1 * (norm(bwd) + norm(f2b)) + alpha_2
    return fmask, bmask


def cubic_resize(img: torch.Tensor, hw) -> torch.Tensor:
    """cv2.resize(..., INTER_CUBIC) of float images [B, C, H, W]: Keys cubic
    with a = -0.75, half-pixel centres, edges clamped, no antialiasing,
    which is torch's bicubic without align_corners."""
    return F.interpolate(img, size=tuple(hw), mode="bicubic",
                         align_corners=False)
