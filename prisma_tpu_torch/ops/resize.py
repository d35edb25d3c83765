"""Exact separable image resizing as weight-matrix contractions (counterpart
of prisma_tpu/ops/resize.py).

Each 1-D resampling (torch `interpolate` bilinear/bicubic with or without
align_corners or a scale factor, cv2 INTER_LINEAR/INTER_CUBIC/INTER_AREA, PIL
antialiased) is a dense [out, in] matrix built in numpy float64 and stored as
float32 — the JAX package's `_resize_weights`, kept verbatim — applied per
axis as a matmul in the input's dtype, the H axis first.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel with a=-0.75 (torch & cv2 convention)."""
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    w = np.where(ax <= 1, (a + 2) * ax3 - (a + 3) * ax2 + 1,
                 np.where(ax < 2, a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a, 0.0))
    return w


@functools.lru_cache(maxsize=None)
def _resize_weights(in_size: int, out_size: int, method: str,
                    align_corners: bool, scale: float | None) -> np.ndarray:
    """[out, in] float32 resampling matrix.

    method: 'linear' | 'cubic' | 'area' | 'nearest' | 'linear_aa' | 'cubic_aa'
    (the _aa forms are PIL / torch antialias=True resampling).
    scale: explicit scale factor (torch interpolate(scale_factor=...) semantics,
    where the coordinate map uses the given factor, not out/in). None -> out/in.
    """
    if in_size == out_size and method in ("linear", "cubic", "nearest"):
        return np.eye(out_size, dtype=np.float32)
    W = np.zeros((out_size, in_size), dtype=np.float64)
    out_idx = np.arange(out_size, dtype=np.float64)

    if method == "nearest":
        src = np.floor(out_idx * (in_size / out_size)).astype(int)
        W[np.arange(out_size), np.clip(src, 0, in_size - 1)] = 1.0
        return W.astype(np.float32)

    if method in ("linear_aa", "cubic_aa"):
        # PIL.Image.resize / torch interpolate(antialias=True) semantics
        # (PIL Resample.c ImagingResampleHorizontal_8): kernel stretched by
        # the downscale factor, taps windowed (not edge-clamped) and each
        # row normalized. Bicubic uses PIL's a=-0.5, not torch/cv2's -0.75.
        if method == "linear_aa":
            support, kern = 1.0, lambda t: np.maximum(0.0, 1.0 - np.abs(t))
        else:
            support, kern = 2.0, lambda t: _cubic_kernel(t, a=-0.5)
        ratio = in_size / out_size if scale is None else 1.0 / scale
        fscale = max(ratio, 1.0)
        radius = support * fscale
        for o in range(out_size):
            center = (o + 0.5) * ratio
            i0 = max(int(center - radius + 0.5), 0)
            i1 = min(int(center + radius + 0.5), in_size)
            taps = kern((np.arange(i0, i1) - center + 0.5) / fscale)
            W[o, i0:i1] = taps / taps.sum()
        return W.astype(np.float32)

    if method == "area":
        # cv2 INTER_AREA for downscale: box filter over the source span.
        scale_f = in_size / out_size
        for o in range(out_size):
            lo = o * scale_f
            hi = (o + 1) * scale_f
            i0 = int(np.floor(lo))
            i1 = int(np.ceil(hi))
            for i in range(i0, min(i1, in_size)):
                W[o, i] = min(hi, i + 1) - max(lo, i)
        W /= W.sum(axis=1, keepdims=True)
        return W.astype(np.float32)

    if align_corners:
        if out_size == 1:
            src = np.zeros(1)
        else:
            src = out_idx * ((in_size - 1) / (out_size - 1))
    else:
        s = (out_size / in_size) if scale is None else scale
        src = (out_idx + 0.5) / s - 0.5

    if method == "linear":
        i0 = np.floor(src).astype(int)
        frac = src - i0
        for o in range(out_size):
            a_, b_ = np.clip(i0[o], 0, in_size - 1), np.clip(i0[o] + 1, 0, in_size - 1)
            W[o, a_] += 1.0 - frac[o]
            W[o, b_] += frac[o]
    elif method == "cubic":
        i0 = np.floor(src).astype(int)
        frac = src - i0
        for o in range(out_size):
            taps = _cubic_kernel(frac[o] - np.array([-1.0, 0.0, 1.0, 2.0]))
            # torch/cv2 normalize the 4 taps only implicitly (they sum to 1);
            # edge clamping accumulates weight onto border pixels.
            for t, widx in zip(taps, range(i0[o] - 1, i0[o] + 3)):
                W[o, np.clip(widx, 0, in_size - 1)] += t
    else:
        raise ValueError(f"unknown resize method {method}")
    return W.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _weights(in_size: int, out_size: int, method: str, align_corners: bool,
             scale: float | None, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """The resampling matrix on `device`, cast to `dtype` (kept: the band
    resizes every batch with the same few matrices). Made outside inference
    mode whoever asks first: a cached inference tensor would refuse a later
    caller whose input tracks gradients."""
    w = _resize_weights(in_size, out_size, method, align_corners, scale)
    with torch.inference_mode(False):
        return torch.from_numpy(w).to(device=device, dtype=dtype)


def _axis_weights(x, in_hw, out_hw, method, align_corners, scale):
    sh, sw = scale if scale is not None else (None, None)
    Wh = _weights(in_hw[0], out_hw[0], method, align_corners, sh, x.dtype,
                  x.device)
    Ww = _weights(in_hw[1], out_hw[1], method, align_corners, sw, x.dtype,
                  x.device)
    return Wh, Ww


def resize2d(x: torch.Tensor, out_hw: tuple[int, int], method: str = "linear",
             align_corners: bool = False,
             scale: tuple[float, float] | None = None) -> torch.Tensor:
    """Resize [..., H, W, C] to [..., H', W', C] with exact reference semantics."""
    Wh, Ww = _axis_weights(x, (x.shape[-3], x.shape[-2]), out_hw, method,
                           align_corners, scale)
    x = torch.einsum("oh,...hwc->...owc", Wh, x)
    return torch.einsum("pw,...owc->...opc", Ww, x)


def resize2d_nchw(x: torch.Tensor, out_hw: tuple[int, int],
                  method: str = "linear", align_corners: bool = False,
                  scale: tuple[float, float] | None = None) -> torch.Tensor:
    """Same, for [..., C, H, W] layouts."""
    Wh, Ww = _axis_weights(x, (x.shape[-2], x.shape[-1]), out_hw, method,
                           align_corners, scale)
    return torch.matmul(torch.matmul(Wh, x), Ww.T)


def constrain_to_multiple_of(x: float, multiple: int, min_val: int = 0,
                             max_val: int | None = None) -> int:
    """Round to nearest multiple (reference transform.py:100-110 semantics)."""
    y = int(round(x / multiple) * multiple)
    if max_val is not None and y > max_val:
        y = int(np.floor(x / multiple) * multiple)
    if y < min_val:
        y = int(np.ceil(x / multiple) * multiple)
    return y


def dpt_input_size(width: int, height: int, target: int = 518,
                   multiple: int = 14, method: str = "lower_bound") -> tuple[int, int]:
    """(new_width, new_height) for the keep-aspect-ratio DPT-style input resize."""
    scale_h = target / height
    scale_w = target / width
    if method == "lower_bound":
        s = max(scale_w, scale_h)
        return (constrain_to_multiple_of(s * width, multiple, min_val=target),
                constrain_to_multiple_of(s * height, multiple, min_val=target))
    if method == "upper_bound":
        s = min(scale_w, scale_h)
        return (constrain_to_multiple_of(s * width, multiple, max_val=target),
                constrain_to_multiple_of(s * height, multiple, max_val=target))
    if method == "minimal":
        s = scale_w if abs(1 - scale_w) < abs(1 - scale_h) else scale_h
        return (constrain_to_multiple_of(s * width, multiple),
                constrain_to_multiple_of(s * height, multiple))
    raise ValueError(method)
