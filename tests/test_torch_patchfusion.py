"""The port's PatchFusion against the JAX package's, in f32 on the CPU.

Weights: a narrow PatchFusion at model size (64, 96) (BEiT 64 wide, 4
heads, 4 blocks; 32 features; the UNet, the six G2L levels and the bins
heads at those widths), the port's seeded init converted for the JAX
package by its own `convert_patchfusion`, and loaded back into the port
through `weights.from_jax`; the tiling engine's tests at model size
(32, 64). Images seeded with numpy, 128x192, so the ladder gives 480x640
and 120x160 crops.

Tolerances: the ladder, the tile grids, the pass areas and boxes, and the
random tile positions equal; the blend mask within 1e-6 of the JAX
package's cv2.GaussianBlur; `patchfusion_tiles` and `infer` within 1e-5 of
the depth's scale (f32 on both sides, sums in another order; the JAX
package holds its own two tile paths to each other at 1e-5). The port's
tiles run in batches of 2, 3 and 8, the JAX package's (fused for p16, per
sub-batch for r3 and p49) in batches of 3: the width changes how a pass is
batched, not what it computes.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prisma_tpu import parallel
from prisma_tpu.models import patchfusion as jpf
from prisma_tpu.weights.torch_convert import convert_checked, convert_patchfusion
from prisma_tpu_torch.models import beit
from prisma_tpu_torch.models import patchfusion as pf
from prisma_tpu_torch.weights import store
from prisma_tpu_torch.weights.from_jax import patchfusion_state_dict

RTOL = 1e-5
MODEL_HW = (64, 96)
NARROW = dict(beit_cfg=beit.BEiTConfig(embed_dim=64, depth=4, num_heads=4),
              features=32, out_channels=(16, 32, 64, 64))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for the module, its module-scoped fixtures
    included: the suite runs in several worker processes at once, and each
    torch op spreading over every core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def narrow_pair(model_hw=MODEL_HW, seed=0):
    """-> (the JAX tree, the port's model loaded from it)."""
    model = pf.init_params(pf.build(**NARROW, model_hw=model_hw),
                           torch.Generator().manual_seed(seed))
    params = convert_checked(convert_patchfusion,
                             {k: v.numpy() for k, v in model.state_dict().items()})
    params = jax.tree.map(np.asarray, params)
    return params, store.patchfusion_from_state_dict(
        patchfusion_state_dict(params), model_hw)


def _close(ours, theirs, rtol=RTOL):
    theirs = np.asarray(theirs)
    assert ours.shape == theirs.shape, (ours.shape, theirs.shape)
    np.testing.assert_allclose(np.asarray(ours), theirs, rtol=0,
                               atol=rtol * np.abs(theirs).max())


@pytest.mark.parametrize("h,w", [(64, 96), (480, 640), (481, 640), (720, 1280),
                                 (1080, 1920), (1081, 1920), (2000, 3000)])
def test_resolution_ladder(h, w):
    assert pf.pick_resolution(h, w) == jpf.pick_resolution(h, w)


@pytest.mark.parametrize("res", [(480, 640), (1080, 1920), (2160, 3840)])
def test_tile_grids_and_pass_areas(res):
    crop = (res[0] // 4, res[1] // 4)
    counts = []
    for off_x, off_y in ((0, 0), (crop[1] // 2, 0), (0, crop[0] // 2),
                         (crop[1] // 2, crop[0] // 2)):
        tiles = pf._tile_grid(res, crop, off_x, off_y)
        assert tiles == jpf._tile_grid(res, crop, off_x, off_y)
        counts.append(len(tiles))
        for model_hw in ((64, 96), (384, 512)):
            areas, boxes = pf._pass_areas(tuple(tiles), res, crop, model_hw)
            j_areas, j_boxes = jpf._pass_areas(tuple(tiles), res, crop, model_hw)
            np.testing.assert_array_equal(areas, np.asarray(j_areas)[..., 0])
            np.testing.assert_array_equal(boxes, j_boxes)
    assert counts == [16, 12, 12, 9]  # p49
    assert [len(p) for p in pf.tile_passes("p49", res, crop)] == counts
    assert [len(p) for p in pf.tile_passes("p16", res, crop)] == [16]


def test_random_tile_positions(monkeypatch):
    """r128's tiles, as the JAX package's infer places them: its device
    passes stubbed, its pass geometry recorded."""
    seen = []

    def geometry(tiles_key, resolution, crop, model_hw, tile_batch):
        seen.append(list(tiles_key))
        return (None,) * 4

    monkeypatch.setattr(parallel, "data_mesh_or_none", lambda: None)
    monkeypatch.setattr(jpf, "_tile_runner",
                        lambda *a: (lambda params, img: (None, None), None))
    monkeypatch.setattr(jpf, "_fused_pass_runner",
                        lambda *a: lambda params, img_t, img_lr, avg, cnt,
                        *rest, use_prior: (avg, cnt))
    monkeypatch.setattr(jpf, "_pass_geometry", geometry)
    img = np.zeros((600, 800, 3), np.float32)  # the 1080x1920 rung
    jpf.infer(None, img, mode="r128", model_hw=(384, 512))
    ours = pf.tile_passes("r128", (1080, 1920), (270, 480))
    assert ours == seen
    assert [len(p) for p in ours] == [16, 12, 12, 9] + [8] * 16


@pytest.mark.parametrize("size", [(120, 160), (270, 480), (540, 960)])
def test_blur_mask(size):
    ours = pf.generate_blur_mask(size)
    theirs = jpf.generate_blur_mask(size)
    assert ours.dtype == np.float32 and ours.shape == size
    assert ours.min() == 0.0 and ours.max() == 1.0
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def pair():
    return narrow_pair()


def _tile_inputs(seed):
    """Three tiles of a 480x640 image at the model size, their areas and
    boxes, and a prior."""
    rng = np.random.default_rng(seed)
    res, crop = (480, 640), (120, 160)
    tiles = ((0, 0), (60, 80), (360, 480))
    areas, boxes = pf._pass_areas(tiles, res, crop, MODEL_HW)
    crops = rng.uniform(0, 1, size=(3, *MODEL_HW, 3)).astype(np.float32)
    img_lr = rng.uniform(0, 1, size=(1, *MODEL_HW, 3)).astype(np.float32)
    prior = rng.uniform(1, 5, size=(3, *MODEL_HW, 1)).astype(np.float32)
    return crops, img_lr, boxes, areas[..., None], prior


def _nchw(a):
    return torch.tensor(a.transpose(0, 3, 1, 2))


def test_patchfusion_tiles(pair):
    """One batch of three tiles with a prior (the first pass's, from the
    fine depth, runs in every infer test below)."""
    params, model = pair
    crops, img_lr, boxes, areas, prior = _tile_inputs(1)
    theirs, _ = jax.jit(jpf.patchfusion_tiles, static_argnames="model_hw")(
        params, jnp.asarray(crops), jnp.asarray(img_lr), jnp.asarray(boxes),
        jnp.asarray(areas), jnp.asarray(prior), model_hw=MODEL_HW)
    with torch.inference_mode():
        coarse = pf.coarse_pass(model, _nchw(img_lr))
        ours = pf.patchfusion_tiles(model, _nchw(crops), torch.tensor(boxes),
                                    _nchw(areas), _nchw(prior), coarse)
    assert ours.dtype == torch.float32
    _close(ours, theirs)


IMAGE = np.random.default_rng(2).integers(0, 256, (128, 192, 3), dtype=np.uint8)
INFER_HW = (32, 64)  # the tiling engine's tests: a smaller model, fewer windows
# the JAX package's runs: (mode, its tile batch (the fused path's cap on
# the widths it plans), fused or per sub-batch); each of its tile graphs
# compiles once (the fused pass without a prior, the sub-batch tiles with
# and without)
JAX_RUNS = [("p16", 3, True), ("r3", 3, False), ("p49", 3, False)]


@pytest.fixture(scope="module")
def infer_pair():
    return narrow_pair(INFER_HW, seed=1)


@pytest.fixture(scope="module")
def jax_depths(infer_pair):
    """Each JAX run once, on one device (the fused path's condition)."""
    params, _ = infer_pair
    mp = pytest.MonkeyPatch()
    mp.setattr(parallel, "data_mesh_or_none", lambda: None)
    try:
        return {run: np.asarray(jpf.infer(params, IMAGE, mode=run[0],
                                          model_hw=INFER_HW, tile_batch=run[1],
                                          fused=run[2]))
                for run in JAX_RUNS}
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def port_depths(infer_pair):
    """Each of the port's runs once: {(mode, tile_batch): depth}."""
    _, model = infer_pair
    img = torch.from_numpy(IMAGE)
    return {(mode, tb): pf.infer(model, img, mode=mode, tile_batch=tb).numpy()
            for mode, tb in (("p16", 8), ("p16", 2), ("r3", 3), ("p49", 2))}


@pytest.mark.parametrize("mode,tile_batch,fused", [
    ("p16", 8, True), ("p16", 2, True), ("r3", 3, False), ("p49", 2, False)])
def test_infer_matches_jax(jax_depths, port_depths, mode, tile_batch, fused):
    """fused: which of the JAX package's two tile paths is the oracle."""
    ours = port_depths[(mode, tile_batch)]
    assert ours.dtype == np.float32 and ours.shape == IMAGE.shape[:2]
    _close(ours, jax_depths[(mode, 3, fused)])


def test_tile_batch_does_not_change_the_result(port_depths):
    _close(port_depths[("p16", 2)], port_depths[("p16", 8)], rtol=1e-6)


def test_bf16_keeps_heads_norms_and_bias_tables_f32(infer_pair, port_depths):
    _params, model = infer_pair
    half = store.patchfusion_from_state_dict(model.state_dict(), INFER_HW)
    half.cast(torch.bfloat16)
    dtypes = {n: p.dtype for n, p in half.named_parameters()}
    assert dtypes["conv2.weight"] == torch.float32
    assert dtypes["coarse_model.attractors.0._net.0.weight"] == torch.float32
    assert dtypes["fusion_extractor.inc.double_conv.1.weight"] == torch.float32
    assert dtypes["fine_model.core.core.pretrained.model.blocks.0.attn."
                  "relative_position_bias_table"] == torch.float32
    assert dtypes["fusion_extractor.g2l0.g2l_layer.blocks.0.attn."
                  "relative_position_bias_table"] == torch.bfloat16
    assert dtypes["fine_model.core.core.pretrained.model.blocks.0.attn."
                  "qkv.weight"] == torch.bfloat16
    assert dtypes["fusion_extractor.up5.conv.double_conv.0.weight"] == torch.bfloat16
    ref = port_depths[("p16", 8)]
    out = pf.infer(half, torch.from_numpy(IMAGE), mode="p16",
                   compute_dtype=torch.bfloat16).numpy()
    assert out.dtype == np.float32 and np.isfinite(out).all()
    assert np.abs(out - ref).max() < 0.05 * np.abs(ref).max()


def test_video_band_runs_the_non_fused_step(tmp_path, monkeypatch, infer_pair):
    """`-d depth_patchfusion` on a video: the non-fused step hands infer the
    global index of each batch's first frame (batches of 2 over 3 frames:
    0, 2, the last padded), and a frame's depth is pf.infer's on that
    decoded frame."""
    from prisma_tpu_torch.bands import depth_patchfusion_band as band
    from prisma_tpu_torch.io.video import VideoReader
    from prisma_tpu_torch.runtime.config import RuntimeConfig
    from tests.test_multiband import _make_video

    _, model = infer_pair
    monkeypatch.setattr(band, "load_patchfusion", lambda rt: (model, INFER_HW))
    seen = []
    real = band.infer_frames

    def spy(model, frames, idx0=0, **kw):
        seen.append((idx0, frames.shape[0]))
        return real(model, frames, idx0, **kw)

    monkeypatch.setattr(band, "infer_frames", spy)
    clip = str(tmp_path / "clip.mp4")
    _make_video(clip, frames=3, w=96, h=64)
    io = band.run(clip, subpath="pf", mode="p16", npy=True, runtime=RuntimeConfig(
        compute_dtype="float32", batch_size=2, segment_frames=0, device="cpu"))
    assert seen == [(0, 2), (2, 2)]
    reader = VideoReader(clip)
    frames = np.concatenate([f[:v] for f, v in reader.batches(3)])
    reader.close()
    mins = np.loadtxt(tmp_path / "depth_patchfusion_min.csv", ndmin=1)
    assert len(frames) == len(mins) == 3
    for i in (0, 2):
        frame = frames[i]
        ours = np.load(os.path.join(io.subpath, f"{i:05d}.npy"))
        ref = pf.infer(model, torch.from_numpy(frame), mode="p16").numpy()
        np.testing.assert_array_equal(ours, ref)
        assert mins[i] == pytest.approx(float(ref.min()), rel=1e-6)
    assert os.path.exists(tmp_path / "depth_patchfusion.mp4")
