"""The one generator of traffic: host video frames from a seed and a
traffic file's parameters.

A smooth random texture (a few octaves of bicubic-upsampled noise plus a
fine grain) is made on the device and panned a few pixels a frame, so that
neighbouring frames share content as video does. The frames come back as
uint8 [T, H, W, 3] host arrays, the form a band's decode thread hands to
its step. A pool of inputs is cut from one stream of frames: consecutive
inputs share `overlap` frames (a flow window shares its last frame with the
next one's first); the run cycles through the pool."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def texture(gen: torch.Generator, h: int, w: int, cell: int, octaves: int,
            grain: float, device) -> torch.Tensor:
    """uint8 [3, h, w]: octaves of noise on a grid of `cell` px (halved each
    octave, amplitude halved), stretched to [0, 255], plus uniform grain of
    +-grain levels."""
    img = torch.zeros(3, h, w, device=device)
    for o in range(octaves):
        c = max(2, cell >> o)
        low = torch.rand(1, 3, h // c + 4, w // c + 4, generator=gen,
                         device=device)
        up = F.interpolate(low, scale_factor=c, mode="bicubic",
                           align_corners=False)[0]
        img += up[:, c:c + h, c:c + w] * 0.5 ** o
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    img = (img - lo) / (hi - lo) * 255.0
    noise = torch.rand(img.shape, generator=gen, device=device)
    img += (noise * 2 - 1) * grain
    return img.round().clamp(0, 255).to(torch.uint8)


def make_pool(traffic: dict, seed: int, overlap: int, device) -> list:
    """[np.ndarray uint8 [frames_per_input, H, W, 3]] x traffic['pool']."""
    W, H = traffic["width"], traffic["height"]
    T, pool = traffic["frames_per_input"], traffic["pool"]
    px, py = traffic["pan_px_per_frame"]
    tex = traffic["texture"]
    stride = T - overlap
    n = pool * stride + overlap
    gen = torch.Generator(device=device).manual_seed(seed)
    canvas = texture(gen, H + py * (n - 1), W + px * (n - 1), tex["cell_px"],
                     tex["octaves"], tex["grain"], device)
    frames = torch.stack([canvas[:, k * py:k * py + H, k * px:k * px + W]
                          for k in range(n)]).permute(0, 2, 3, 1)
    frames = np.ascontiguousarray(frames.cpu().numpy())
    return [frames[i * stride:i * stride + T] for i in range(pool)]
