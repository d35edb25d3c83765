"""The port's roi_align against the JAX package's, in f32 on the CPU.

Oracles: the JAX package's gather form `roi_align` and its matmul form
`roi_align_mm` (one is the function ported, the other the same sampling as
two matmuls), on random, out-of-bounds and sub-pixel boxes, aligned and
not. Tolerance: 1e-6 of the output's scale (f32 on both sides; the port
averages a bin's taps along y before x, so its sums run in another order).
PatchFusion's whole-image depth ROI: the port upsamples the coarse depth
(bilinear, align_corners) and runs roi_align on the map; the JAX package
folds the upsample into `roi_align_mm_resized`'s weights. The two agree
within 1e-5 of the scale.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prisma_tpu.ops import roi_align as jroi
from prisma_tpu_torch.ops.resize import resize2d_nchw
from prisma_tpu_torch.ops.roi_align import roi_align

BOXES = {
    "random": [[2.0, 1.0, 14.0, 9.0], [0.5, 0.5, 8.0, 11.5],
               [4.25, 3.5, 12.75, 7.0], [1.0, 6.0, 15.5, 11.0]],
    # boxes over the border and wholly outside: a tap's neighbour off the
    # map contributes zero
    "out_of_bounds": [[-3.0, -2.0, 20.0, 15.0], [10.0, 8.0, 19.0, 14.0],
                      [-6.0, -5.0, -1.0, -0.5], [15.2, -1.3, 17.9, 12.4]],
    # boxes narrower than a pixel (unaligned: clamped to one)
    "subpixel": [[4.2, 3.3, 4.9, 3.8], [0.1, 0.1, 0.3, 0.6],
                 [7.75, 5.5, 8.25, 6.0], [15.6, 11.6, 15.9, 11.95]],
}


def _case(kind):
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(2, 12, 16, 5)).astype(np.float32)
    boxes = np.array(BOXES[kind], np.float32) * 2  # spatial_scale 0.5 below
    idx = np.array([0, 1, 0, 1], np.int32)
    return feats, boxes, idx


def _ours(feats, boxes, idx, out_hw, scale, sr, aligned):
    out = roi_align(torch.from_numpy(feats).permute(0, 3, 1, 2),
                    torch.from_numpy(boxes), torch.from_numpy(idx), out_hw,
                    spatial_scale=scale, sampling_ratio=sr, aligned=aligned)
    return out.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("oracle", ["roi_align", "roi_align_mm"])
@pytest.mark.parametrize("kind", sorted(BOXES))
@pytest.mark.parametrize("aligned", [True, False])
def test_matches_jax(oracle, kind, aligned):
    feats, boxes, idx = _case(kind)
    fn = getattr(jroi, oracle)
    for out_hw, sr in (((4, 6), 2), ((3, 5), 1), ((5, 4), 3)):
        theirs = np.asarray(fn(jnp.asarray(feats), jnp.asarray(boxes),
                               jnp.asarray(idx), out_hw, 0.5, sr, aligned))
        ours = _ours(feats, boxes, idx, out_hw, 0.5, sr, aligned)
        assert ours.shape == theirs.shape == (4, *out_hw, 5)
        np.testing.assert_allclose(ours, theirs, rtol=0,
                                   atol=1e-6 * np.abs(theirs).max())


def test_bf16_interpolates_in_f32():
    """bf16 features: the f32 interpolation of their values, cast back."""
    feats, boxes, idx = _case("random")
    x = torch.from_numpy(feats).permute(0, 3, 1, 2).to(torch.bfloat16)
    b, i = torch.from_numpy(boxes), torch.from_numpy(idx)
    half = roi_align(x, b, i, (4, 6), 0.5, 2)
    assert half.dtype == torch.bfloat16
    assert torch.equal(half, roi_align(x.float(), b, i, (4, 6), 0.5, 2)
                       .to(torch.bfloat16))


@pytest.mark.parametrize("aligned", [True, False])
def test_materialised_upsample_matches_folded(aligned):
    """The coarse depth [1, 24, 32] upsampled to (135, 240) (hr_hw of a
    24x32 model) and cut to four tile boxes at sampling ratio 5."""
    rng = np.random.default_rng(1)
    depth = rng.uniform(0.5, 10.0, size=(1, 24, 32, 1)).astype(np.float32)
    src_hw, out_hw = (135, 240), (24, 32)
    boxes = np.array([[0.0, 0.0, 60.0, 33.75], [60.0, 33.75, 120.0, 67.5],
                      [30.0, 16.875, 90.0, 50.625],
                      [173.4, 91.2, 233.4, 124.95]], np.float32)
    idx = np.zeros(4, np.int32)
    theirs = np.asarray(jroi.roi_align_mm_resized(
        jnp.asarray(depth), jnp.asarray(boxes), jnp.asarray(idx), out_hw,
        src_hw, 1.0, 5, aligned))
    hr = resize2d_nchw(torch.from_numpy(depth).permute(0, 3, 1, 2), src_hw,
                       method="linear", align_corners=True)
    ours = roi_align(hr, torch.from_numpy(boxes), torch.from_numpy(idx),
                     out_hw, 1.0, 5, aligned).permute(0, 2, 3, 1).numpy()
    assert ours.shape == theirs.shape == (4, *out_hw, 1)
    np.testing.assert_allclose(ours, theirs, rtol=0,
                               atol=1e-5 * np.abs(theirs).max())
