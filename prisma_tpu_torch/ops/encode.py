"""Band-encoding ops in torch (counterpart of prisma_tpu/ops/encode.py), run on
the model's device as epilogues of the video step.

- ``hue_to_rgb`` / ``heat_to_rgb``: LYGIA-compatible hue ramp; depth heatmaps
  are ``hue_to_rgb((1 - heat) * 0.65)``.
- ``rgb_to_heat``: inverse via HSV hue, ``clip(1 - hue * 1.538461538, 0, 1)``.
- ``sobel_edge``: |Sobel| of the uint8-quantized map with a ksize=1 (pure
  central difference) kernel and REFLECT_101 borders, normalized by its max.
- ``depth_to_heatmap``: the write_depth(heatmap=True) pipeline.
- ``depth_heat``: the per-frame normalize/flip/heatmap epilogue of the depth
  video step.
- ``process_flow`` / ``encode_flow``: flow visualisation and 16-bit packing.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

_F32_EPS = torch.finfo(torch.float32).eps


def hue_to_rgb(hue: torch.Tensor) -> torch.Tensor:
    """Map hue in [0,1] to an RGB ramp. Channels stacked on a new trailing axis."""
    offs = torch.tensor([0.0, 4.0, 2.0], dtype=hue.dtype, device=hue.device)
    k = hue[..., None] * 6.0 + offs
    return torch.clamp(torch.abs(torch.remainder(k, 6.0) - 3.0) - 1.0, 0.0, 1.0)


def heat_to_rgb(heat: torch.Tensor) -> torch.Tensor:
    """Depth heatmap encoding: blue = near (heat 0), red = far (heat 1)."""
    return hue_to_rgb((1.0 - heat) * 0.65)


def rgb_hue(rgb: torch.Tensor) -> torch.Tensor:
    """HSV hue in degrees [0, 360) from float RGB, matching the reference's
    argmax-channel formulation (first-max wins on ties)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxv = rgb.amax(dim=-1)
    minv = rgb.amin(dim=-1)
    maxc = torch.argmax(rgb, dim=-1)
    minc = torch.argmin(rgb, dim=-1)
    span = maxv - minv + _F32_EPS
    h0 = torch.remainder((g - b) * 60.0 / span, 360.0)
    h1 = (b - r) * 60.0 / span + 120.0
    h2 = (r - g) * 60.0 / span + 240.0
    hue = torch.where(maxc == 0, h0, torch.where(maxc == 1, h1, h2))
    return torch.where(maxc == minc, torch.zeros_like(hue), hue)


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """Full HSV from float RGB: H in degrees [0, 360), S = 1 - min/max, V = max."""
    maxv = rgb.amax(dim=-1)
    minv = rgb.amin(dim=-1)
    s = torch.where(maxv == 0, torch.zeros_like(maxv),
                    1.0 - minv / (maxv + _F32_EPS))
    return torch.stack([rgb_hue(rgb), s, maxv], dim=-1)


def encode_polar(a: torch.Tensor, rad: torch.Tensor) -> torch.Tensor:
    """Angle [0,1] -> hue, radius [0,1] -> saturation."""
    return saturation(hue_to_rgb(a), rad)


def rgb_to_heat(rgb: torch.Tensor) -> torch.Tensor:
    """Decode a heatmap RGB back to heat in [0,1] (inverse of heat_to_rgb)."""
    hue = rgb_hue(rgb) / 360.0
    return torch.clamp(1.0 - hue * 1.538461538, 0.0, 1.0)


def saturation(rgb: torch.Tensor, sat) -> torch.Tensor:
    """Blend toward white by (1 - sat); sat broadcasts over the channel axis."""
    sat = torch.as_tensor(sat, dtype=rgb.dtype, device=rgb.device)[..., None]
    return rgb * sat + (1.0 - sat)


def sobel_edge(channel: torch.Tensor) -> torch.Tensor:
    """|Sobel| edge magnitude of a [0,1] map [H, W], max-normalized to [0,1].

    Matches cv2.Sobel(ksize=1) on the uint8 quantization of the input: a pure
    [-1, 0, 1] central difference per axis with REFLECT_101 borders.
    """
    q = torch.floor(channel * 255.0)
    p = F.pad(q[None], (1, 1, 1, 1), mode="reflect")[0]
    gx = p[1:-1, 2:] - p[1:-1, :-2]
    gy = p[2:, 1:-1] - p[:-2, 1:-1]
    mag = torch.sqrt(gx * gx + gy * gy)
    peak = mag.max()
    return torch.where(peak > 0, mag / peak, torch.zeros_like(mag))


def float_to_rgb(value, min_value=0.0, max_value=1.0,
                 base: int = 256) -> torch.Tensor:
    """Pack a float into 3 channels of [0,1] with 24-bit fixed-point precision."""
    value = torch.as_tensor(value, dtype=torch.float32)
    span = float(base) ** 3 - 1.0
    L = torch.clamp((value - min_value) / (max_value - min_value), 0.0, 1.0) * span
    lo = torch.floor(torch.remainder(L, base))
    mid = torch.remainder(torch.floor(L / base), base)
    hi = torch.remainder(torch.floor(L / (base * base)), base)
    return torch.stack([lo, mid, hi], dim=-1) / (base - 1.0)


def nearest_power_of_two(x: float) -> int:
    """Smallest power of two >= x."""
    return int(2 ** math.ceil(math.log(x) / math.log(2)))


def encode_data_into_img(data, min_value=0.0, max_value=1.0, base: int = 256,
                         gain: float = 1.0):
    """Pack an [N] or [N, 1|3|4] data array into a square power-of-two
    data-texture image (host numpy, as in the JAX package).

    Scalar data packs each value into 24-bit RGB fixed point via
    `float_to_rgb(value*gain, 0, max_value)`; 3/4-vector data min/max
    normalizes per channel. Reference quirks preserved: scalar values land
    at img[x, y] (transposed) while vectors land at img[y, x], and the
    scalar path ignores min_value (packs against [0, max_value]).
    """
    data = np.asarray(data)
    n = data.shape[0]
    k = 1 if data.ndim == 1 else data.shape[1]
    size = nearest_power_of_two(math.sqrt(n)) if n > 1 else 1
    img = np.zeros((size, size, max(3, k)), np.float64)
    idx = np.arange(n)
    xs, ys = idx % size, idx // size
    if k == 1:
        # float64 numpy: f32 rounding flips floor boundaries by 1/255 vs the
        # reference's float64 packing
        vals = data.reshape(-1).astype(np.float64) * gain
        span = float(base) ** 3 - 1.0
        L = np.clip(vals / float(max_value), 0.0, 1.0) * span
        img[xs, ys] = np.stack([np.floor(L % base),
                                np.floor(L / base) % base,
                                np.floor(L / (base * base)) % base],
                               axis=-1) / (base - 1.0)
    else:
        lo = np.broadcast_to(np.asarray(min_value, np.float64), (k,))
        hi = np.broadcast_to(np.asarray(max_value, np.float64), (k,))
        img[ys, xs] = (data - lo) / (hi - lo)
    return img


def depth_to_heatmap(depth: torch.Tensor, normalize: bool = True,
                     flip: bool = False, encode_range: bool = True):
    """Full write_depth(heatmap=True) pipeline.

    Args:
      depth: [H, W] float depth/disparity map.
    Returns:
      (rgb_u8 [H, W, 3] uint8, depth_min scalar, depth_max scalar)
    """
    depth = depth.float()
    depth_min = depth.min()
    depth_max = depth.max()
    if normalize:
        depth = (depth - depth_min) / (depth_max - depth_min)
    if flip:
        depth = 1.0 - depth
    edge = sobel_edge(depth)
    rgb = saturation(heat_to_rgb(depth), 1.0 - edge)
    if encode_range:
        rgb = rgb.clone()
        rgb[0, 0] = float_to_rgb(depth_min, 0.0, 1000.0)
        rgb[0, 1] = float_to_rgb(depth_max, 0.0, 1000.0)
    rgb_u8 = torch.floor(rgb * 255.0).to(torch.uint8)
    return rgb_u8, depth_min, depth_max


def depth_heat(depth: torch.Tensor, flip: bool):
    """Per-frame epilogue of a depth video step: depth [B, H, W] ->
    (heat [B, H, W, 3] uint8, min [B], max [B]); each frame is min/max
    normalized, optionally flipped, and heat-mapped without edge desaturation."""
    dmin = depth.amin(dim=(1, 2))
    dmax = depth.amax(dim=(1, 2))
    norm = (depth - dmin[:, None, None]) / (dmax - dmin)[:, None, None]
    if flip:
        norm = 1.0 - norm
    heat = torch.floor(heat_to_rgb(norm) * 255.0).to(torch.uint8)
    return heat, dmin, dmax


def process_flow(flow: torch.Tensor):
    """HSV-encode a flow field [..., H, W, 2] -> (rgb_u8 [..., H, W, 3],
    max_distance [...]). Each field is normalised by its own maximum
    distance: over (H, W), per pair of a batch, as the JAX package vmaps it."""
    flow = flow.float()
    dist = torch.sqrt(flow[..., 0] ** 2 + flow[..., 1] ** 2)
    max_distance = dist.amax(dim=(-2, -1))
    dx = flow[..., 0] / max_distance[..., None, None]
    dy = flow[..., 1] / max_distance[..., None, None]
    rad = torch.sqrt(dx * dx + dy * dy)
    ang = (torch.atan2(dy, dx) / math.pi + 1.0) * 0.5
    rgb = saturation(hue_to_rgb(ang), rad)
    rgb_u8 = torch.floor(rgb * 255.0).to(torch.uint8)
    return rgb_u8, max_distance


def encode_flow(flow: torch.Tensor, mask: torch.Tensor) -> np.ndarray:
    """Pack flow + validity mask into a 3-channel uint16 image (host numpy).

    Flow is biased to 2**15 and scaled by 2**8; pixels that over/underflow the
    16-bit range are invalidated in the mask channel, and their values
    saturate at 0 and 2**16 - 1, as the JAX package's uint16 cast does.
    """
    f = 2.0 ** 15 + flow.float() * (2.0 ** 8)
    valid = mask.bool()
    valid &= f.amax(dim=-1) < (2 ** 16 - 1)
    valid &= f.amin(dim=-1) > 0
    packed = torch.cat([f.clamp(0, 2 ** 16 - 1).to(torch.int32),
                        valid[..., None].to(torch.int32) * (2 ** 16 - 1)], dim=-1)
    return packed.cpu().numpy().astype(np.uint16)


def mask_to_rgb(mask: torch.Tensor) -> torch.Tensor:
    """Binary/uint mask -> white-on-black RGB uint8 (1 -> 255, else value)."""
    m = torch.where(mask == 1, torch.full_like(mask, 255), mask).to(torch.uint8)
    return torch.stack([m, m, m], dim=-1)
