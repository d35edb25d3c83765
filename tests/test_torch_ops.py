"""The port's ops against the JAX package's, on the same numpy-seeded inputs.

ops/nn: layer_norm, gelu, linear, conv2d, conv_transpose_blocky (the port is
NCHW with torch weight layouts; the JAX ops NHWC with HWIO). ops/resize:
the cases of tests/test_resize.py. ops/encode: the cases of
tests/test_encode.py. f32 unless stated; tolerances are float32 rounding
of sums taken in another order.
"""

import numpy as np
import pytest
import torch
from types import SimpleNamespace

import jax.numpy as jnp

from prisma_tpu.ops import encode as jenc
from prisma_tpu.ops import nn as jnn
from prisma_tpu.ops import resize as jresize
from prisma_tpu_torch.ops import encode as enc
from prisma_tpu_torch.ops import nn as pnn
from prisma_tpu_torch.ops import resize

RNG = np.random.default_rng(7)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, dtype=np.float32)


# --------------------------------------------------------------------- ops/nn

def test_layer_norm():
    x = (RNG.normal(size=(2, 5, 48)) * 3 + 2).astype(np.float32)
    scale = RNG.normal(size=48).astype(np.float32)
    bias = RNG.normal(size=48).astype(np.float32)
    theirs = jnn.layer_norm({"scale": scale, "bias": bias}, jnp.asarray(x))
    ours = pnn.layer_norm(SimpleNamespace(weight=_t(scale), bias=_t(bias)),
                          _t(x))
    np.testing.assert_allclose(_np(ours), _np(theirs), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu(dtype):
    """Exact erf on f32 (atol 1e-6); tanh-approximate on bf16 in both, where
    the two may round the last bf16 bit differently (rtol 2^-7)."""
    x = RNG.normal(size=(64, 33)).astype(np.float32) * 3
    theirs = jnn.gelu(jnp.asarray(x, dtype=getattr(jnp, dtype)))
    ours = pnn.gelu(_t(x).to(getattr(torch, dtype)))
    assert str(ours.dtype) == f"torch.{dtype}"
    tol = dict(atol=1e-6, rtol=0) if dtype == "float32" \
        else dict(atol=1e-2, rtol=2 ** -7)
    np.testing.assert_allclose(_np(ours), _np(theirs), **tol)


def test_linear():
    x = RNG.normal(size=(3, 7, 16)).astype(np.float32)
    w = RNG.normal(size=(16, 24)).astype(np.float32)
    b = RNG.normal(size=24).astype(np.float32)
    theirs = jnn.linear({"w": w, "b": b}, jnp.asarray(x))
    ours = pnn.linear(SimpleNamespace(weight=_t(w.T), bias=_t(b)), _t(x))
    np.testing.assert_allclose(_np(ours), _np(theirs), atol=1e-5)


@pytest.mark.parametrize("k,stride,padding,groups", [
    (1, 1, 0, 1), (3, 1, 1, 1), (3, 2, 1, 1), (3, 1, 1, 2)])
def test_conv2d(k, stride, padding, groups):
    x = RNG.normal(size=(2, 11, 13, 8)).astype(np.float32)         # NHWC
    w = RNG.normal(size=(k, k, 8 // groups, 12)).astype(np.float32)  # HWIO
    b = RNG.normal(size=12).astype(np.float32)
    theirs = jnn.conv2d({"w": w, "b": b}, jnp.asarray(x), stride=stride,
                        padding=padding, groups=groups)
    ours = pnn.conv2d(SimpleNamespace(weight=_t(w.transpose(3, 2, 0, 1)),
                                      bias=_t(b)),
                      _t(x.transpose(0, 3, 1, 2)), stride=stride,
                      padding=padding, groups=groups)
    np.testing.assert_allclose(_np(ours).transpose(0, 2, 3, 1), _np(theirs),
                               atol=1e-4)


@pytest.mark.parametrize("k", [2, 4])
def test_conv_transpose_blocky(k):
    x = RNG.normal(size=(2, 5, 6, 8)).astype(np.float32)
    w = RNG.normal(size=(k, k, 8, 12)).astype(np.float32)   # [k, k, in, out]
    b = RNG.normal(size=12).astype(np.float32)
    theirs = jnn.conv_transpose_blocky({"w": w, "b": b}, jnp.asarray(x))
    ours = pnn.conv_transpose_blocky(
        SimpleNamespace(weight=_t(w.transpose(2, 3, 0, 1)), bias=_t(b)),
        _t(x.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(_np(ours).transpose(0, 2, 3, 1), _np(theirs),
                               atol=1e-5)
    # and equal to torch's own ConvTranspose2d under the reference layout
    ref = torch.nn.functional.conv_transpose2d(
        _t(x.transpose(0, 3, 1, 2)), _t(w.transpose(2, 3, 0, 1)), _t(b),
        stride=k)
    torch.testing.assert_close(ours, ref, atol=1e-5, rtol=0)


# ----------------------------------------------------------------- ops/resize

RESIZE_CASES = [
    # (in_hw, out_hw, method, align_corners): the torch-interpolate grid ...
    *[(i, o, m, ac) for (i, o) in [((17, 23), (34, 46)), ((32, 32), (9, 13)),
                                   ((7, 9), (140, 90))]
      for m in ("linear", "cubic") for ac in (False, True)],
    # ... the cv2 cases ...
    *[((30, 44), o, m, False) for m in ("linear", "cubic", "area")
      for o in [(61, 89), (15, 22)] if not (m == "area" and o[0] > 30)],
    # ... and the antialiased ones
    *[((24, 36), o, m, False) for m in ("linear_aa", "cubic_aa")
      for o in [(11, 17), (7, 9), (48, 72), (24, 36)]],
]


@pytest.mark.parametrize("in_hw,out_hw,method,ac", RESIZE_CASES)
def test_resize2d(in_hw, out_hw, method, ac):
    x = RNG.uniform(0, 1, size=(2, *in_hw, 3)).astype(np.float32)
    theirs = jresize.resize2d(jnp.asarray(x), out_hw, method=method,
                              align_corners=ac)
    ours = resize.resize2d(_t(x), out_hw, method=method, align_corners=ac)
    np.testing.assert_allclose(_np(ours), _np(theirs), atol=2e-6)
    ours_nchw = resize.resize2d_nchw(_t(x.transpose(0, 3, 1, 2)), out_hw,
                                     method=method, align_corners=ac)
    np.testing.assert_allclose(_np(ours_nchw).transpose(0, 2, 3, 1),
                               _np(theirs), atol=2e-6)


def test_resize2d_nchw_scale_factor():
    """DINOv2's pos-embed scale factor, (w0 + 0.1) / sqrt(N)."""
    x = RNG.normal(size=(1, 4, 37, 37)).astype(np.float32)
    s = (5 + 0.1) / 37.0
    theirs = jresize.resize2d_nchw(jnp.asarray(x), (5, 5), method="cubic",
                                   scale=(s, s))
    ours = resize.resize2d_nchw(_t(x), (5, 5), method="cubic", scale=(s, s))
    np.testing.assert_allclose(_np(ours), _np(theirs), atol=2e-6)


def test_resize_matrices_cached_in_inference_mode_serve_autograd():
    """A resampling matrix first made under inference mode (a band's step)
    and cached still serves a later caller whose input tracks gradients (a
    position-embedding resample of a module's parameter)."""
    out_hw = (3, 7)  # a size no other test here asks for
    with torch.inference_mode():
        resize.resize2d_nchw(torch.zeros(1, 2, 11, 13), out_hw)
    x = torch.from_numpy(RNG.normal(size=(1, 2, 11, 13)).astype(np.float32))
    x.requires_grad_(True)
    ours = resize.resize2d_nchw(x, out_hw)
    ours.sum().backward()
    theirs = jresize.resize2d_nchw(jnp.asarray(x.detach().numpy()), out_hw)
    np.testing.assert_allclose(_np(ours.detach()), _np(theirs), atol=2e-6)
    assert x.grad is not None and torch.isfinite(x.grad).all()


@pytest.mark.parametrize("wh", [(1920, 1080), (518, 518), (100, 200),
                                (96, 64)])
def test_dpt_input_size(wh):
    assert resize.dpt_input_size(*wh) == jresize.dpt_input_size(*wh)
    assert resize.dpt_input_size(*wh, target=126) == \
        jresize.dpt_input_size(*wh, target=126)


# ----------------------------------------------------------------- ops/encode

def _enc_case(name):
    r = np.random.default_rng(0)
    u = lambda *s: r.uniform(0, 1, size=s).astype(np.float32)  # noqa: E731
    return {
        "hue_to_rgb": ("hue_to_rgb", (u(17, 23),)),
        "heat_to_rgb": ("heat_to_rgb", (u(9, 11),)),
        "rgb_to_heat": ("rgb_to_heat", (u(16, 16, 3),)),
        "rgb_hue": ("rgb_hue", (u(16, 16, 3),)),
        "rgb_to_hsv": ("rgb_to_hsv", (u(9, 7, 3),)),
        "encode_polar": ("encode_polar", (u(6, 8), u(6, 8))),
        "saturation": ("saturation", (u(7, 5, 3), u(7, 5))),
        "sobel_edge": ("sobel_edge", (u(32, 48),)),
        "float_to_rgb": ("float_to_rgb", (np.float32(3.25), 0.0, 1000.0)),
        "mask_to_rgb": ("mask_to_rgb",
                        (np.array([[0, 1], [1, 0], [3, 1]], np.uint8),)),
    }[name]


@pytest.mark.parametrize("name", ["hue_to_rgb", "heat_to_rgb", "rgb_to_heat",
                                  "rgb_hue", "rgb_to_hsv", "encode_polar",
                                  "saturation", "sobel_edge", "float_to_rgb",
                                  "mask_to_rgb"])
def test_encode_elementwise(name):
    fn, args = _enc_case(name)
    theirs = getattr(jenc, fn)(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                                 else a for a in args])
    ours = getattr(enc, fn)(*[_t(a) if isinstance(a, np.ndarray) and a.ndim
                              else a for a in args])
    np.testing.assert_allclose(_np(ours), _np(theirs), atol=1e-5)


def test_depth_to_heatmap():
    depth = RNG.uniform(0.5, 9.0, size=(40, 64)).astype(np.float32)
    j_rgb, j_min, j_max = jenc.depth_to_heatmap(jnp.asarray(depth), flip=True)
    rgb, dmin, dmax = enc.depth_to_heatmap(_t(depth), flip=True)
    assert rgb.dtype == torch.uint8 and rgb.shape == (40, 64, 3)
    assert float(dmin) == float(j_min) and float(dmax) == float(j_max)
    diff = np.abs(rgb.numpy().astype(int) - np.asarray(j_rgb).astype(int))
    assert diff.max() <= 1  # floor at float bin edges


def test_depth_heat_matches_infer_video_batch_epilogue():
    """The video-step epilogue (per-frame normalize, flip, heatmap) as the
    JAX infer_video_batch computes it."""
    depth = RNG.uniform(0.1, 5.0, size=(3, 20, 30)).astype(np.float32)
    heat, dmin, dmax = enc.depth_heat(_t(depth), flip=True)
    d = jnp.asarray(depth)
    jmin, jmax = d.min(axis=(1, 2)), d.max(axis=(1, 2))
    norm = 1.0 - (d - jmin[:, None, None]) / (jmax - jmin)[:, None, None]
    jheat = jnp.floor(jenc.heat_to_rgb(norm) * 255.0).astype(jnp.uint8)
    np.testing.assert_array_equal(dmin.numpy(), np.asarray(jmin))
    np.testing.assert_array_equal(dmax.numpy(), np.asarray(jmax))
    diff = np.abs(heat.numpy().astype(int) - np.asarray(jheat).astype(int))
    assert diff.max() <= 1


def test_process_flow():
    flow = RNG.normal(0, 4, size=(24, 36, 2)).astype(np.float32)
    j_rgb, j_max = jenc.process_flow(jnp.asarray(flow))
    rgb, mx = enc.process_flow(_t(flow))
    np.testing.assert_allclose(float(mx), float(j_max), rtol=1e-6)
    diff = np.abs(rgb.numpy().astype(int) - np.asarray(j_rgb).astype(int))
    assert diff.max() <= 1


def test_encode_flow():
    flow = RNG.normal(0, 10, size=(16, 16, 2)).astype(np.float32)
    mask = RNG.uniform(size=(16, 16)) > 0.3
    theirs = np.asarray(jenc.encode_flow(jnp.asarray(flow), jnp.asarray(mask)))
    ours = enc.encode_flow(_t(flow), _t(mask))
    assert ours.dtype == np.uint16
    np.testing.assert_array_equal(ours, theirs)


def test_encode_data_into_img():
    scal = RNG.uniform(0, 5, size=(10,))
    np.testing.assert_array_equal(
        enc.encode_data_into_img(scal, max_value=5.0, gain=0.9),
        jenc.encode_data_into_img(scal, max_value=5.0, gain=0.9))
    vec3 = RNG.uniform(-2, 2, size=(21, 3))
    np.testing.assert_array_equal(
        enc.encode_data_into_img(vec3, min_value=-2.0, max_value=2.0),
        jenc.encode_data_into_img(vec3, min_value=-2.0, max_value=2.0))
