"""The port's ZoeD_N against the JAX package's, in f32 on the CPU.

Weights: the JAX package's random init of a narrow ZoeD_N (a BEiT 128
wide, 4 heads, 4 blocks; a decoder of 32 features; the full bins head),
every leaf shifted by seeded noise, carried across with `weights.from_jax`;
frames seeded with numpy. Tolerances: `infer` (reflect pad, the flipped
pass averaged in) within 1e-5 of the depth's scale (f32 on both sides,
sums in another order; the JAX package's own bar against the reference is
1e-3 of the scale). The band on an image: each package's band loads the
same `ZoeD_M12_N.pt` (its 'model' layout) from disk; the file inventory
equal, the .npy depth within 1e-5 of its scale, the heatmap PNGs at most 2
levels apart outside the two range pixels (a float bin edge moves the heat
and the Sobel edge term by one level each).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prisma_tpu.models import beit as jbeit
from prisma_tpu.models import zoed as jzoed
from prisma_tpu.models import zoedepth as jzoe
from prisma_tpu_torch.io.writers import write_depth
from prisma_tpu_torch.models import zoed
from prisma_tpu_torch.runtime.config import RuntimeConfig
from prisma_tpu_torch.weights import store
from prisma_tpu_torch.weights.from_jax import zoed_state_dict
from tests.test_torch_beit import DECODER, NARROW, jax_decoder, noisy

RTOL = 1e-5
IMG_SIZE = (64, 96)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for the module, its module-scoped fixtures
    included: the suite runs in several worker processes at once, and each
    torch op spreading over every core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_zoed(seed: int) -> dict:
    """A narrow ZoeD_N tree (numpy leaves, noisy)."""
    k1, k2, k3 = jax.random.split(jax.random.key(seed), 3)
    tree = {"core": {"beit": jbeit.init_params(k1, **NARROW),
                     "decoder": jax_decoder(k2, NARROW["embed"], **DECODER)},
            "head": jzoe.init_head_params(k3, DECODER["features"])}
    return noisy(tree, seed + 1)


@pytest.fixture(scope="module")
def zoed_pair():
    params = jax_zoed(0)
    return params, store.zoed_from_state_dict(zoed_state_dict(params))


_jit_infer = jax.jit(jzoed.infer, static_argnames=("img_size", "pad_input",
                                                   "with_flip_aug"))


@pytest.mark.parametrize("pad,flip", [(True, True), (False, False)])
def test_infer(zoed_pair, pad, flip):
    params, model = zoed_pair
    frames = np.random.default_rng(6).integers(0, 256, size=(2, 40, 56, 3),
                                               dtype=np.uint8)
    theirs = _jit_infer(params, jnp.asarray(frames), img_size=IMG_SIZE,
                        pad_input=pad, with_flip_aug=flip)
    with torch.inference_mode():
        ours = zoed.infer(model, torch.from_numpy(frames), img_size=IMG_SIZE,
                          pad_input=pad, with_flip_aug=flip)
    theirs = np.asarray(theirs)
    assert ours.dtype == torch.float32 and ours.shape == theirs.shape == (2, 40, 56)
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0,
                               atol=RTOL * np.abs(theirs).max())


def test_cast_core_keeps_head_and_bias_tables_f32(zoed_pair):
    _params, model = zoed_pair
    half = store.zoed_from_state_dict(model.state_dict()).cast_core(torch.bfloat16)
    for name, p in half.named_parameters():
        f32 = (not name.startswith("core.")
               or name.endswith("relative_position_bias_table"))
        assert p.dtype == (torch.float32 if f32 else torch.bfloat16), name
    frames = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, size=(1, 40, 56, 3), dtype=np.uint8))
    with torch.inference_mode():
        ref = zoed.infer(model, frames, img_size=IMG_SIZE)
        out = zoed.infer(half, frames, img_size=IMG_SIZE,
                         compute_dtype=torch.bfloat16)
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) < 0.05 * float(ref.abs().max())


def test_band_on_an_image_matches_jax_band(tmp_path, zoed_pair):
    import cv2

    from prisma_tpu.bands import depth_zoedepth_band as jband
    from prisma_tpu.runtime.config import RuntimeConfig as JaxRuntimeConfig
    from prisma_tpu_torch.bands import depth_zoedepth_band as band

    params, _model = zoed_pair
    models = tmp_path / "models"
    models.mkdir()
    torch.save({"model": zoed_state_dict(params)}, models / "ZoeD_M12_N.pt")
    img = np.random.default_rng(8).integers(0, 256, (40, 56, 3), dtype=np.uint8)
    for name in ("jax", "port"):
        os.makedirs(tmp_path / name)
        cv2.imwrite(str(tmp_path / name / "photo.png"), img)
    run = dict(img_size=IMG_SIZE, npy=True, ply=True)
    jband.run(str(tmp_path / "jax" / "photo.png"), runtime=JaxRuntimeConfig(
        models_dir=str(models), weight_cache=False, compute_dtype="float32"),
        **run)
    band.run(str(tmp_path / "port" / "photo.png"), runtime=RuntimeConfig(
        models_dir=str(models), compute_dtype="float32", device="cpu"), **run)

    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir)) == [
        "depth_zoedepth.npy", "depth_zoedepth.ply", "depth_zoedepth.png",
        "photo.png"]
    ours = np.load(pdir / "depth_zoedepth.npy")
    theirs = np.load(jdir / "depth_zoedepth.npy")
    assert ours.shape == theirs.shape == (40, 56)
    np.testing.assert_allclose(ours, theirs, rtol=0,
                               atol=RTOL * np.abs(theirs).max())
    # the heatmap PNG: the port's writer on the JAX depth gives the JAX
    # package's bytes; the two bands' PNGs then differ only where a float
    # bin edge moves a pixel's uint8 level, which with this smooth random
    # depth also moves the max-normalised Sobel term of its neighbours
    write_depth(str(tmp_path / "theirs.png"), theirs, normalize=True,
                heatmap=True, encode_range=True, flip=False)
    b = cv2.imread(str(jdir / "depth_zoedepth.png")).astype(int)
    assert np.array_equal(cv2.imread(str(tmp_path / "theirs.png")), b)
    a = cv2.imread(str(pdir / "depth_zoedepth.png")).astype(int)
    assert a.shape == b.shape == (40, 56, 3)
    assert np.any(a != b, axis=-1).mean() <= 0.01


def test_fused_video_run(tmp_path, monkeypatch, zoed_pair):
    """`-d depth_zoedepth` on a video runs in the fused pipeline: one model
    call a batch; the per-frame min and max are zoed.infer's on the decoded
    frames (the same f32 arithmetic, batched alike: equal)."""
    from prisma_tpu_torch.bands import depth_zoedepth_band as band
    from prisma_tpu_torch.bands import multiband
    from prisma_tpu_torch.io.video import VideoReader
    from tests.test_multiband import _make_video

    _, model = zoed_pair
    assert "depth_zoedepth" in multiband.FUSED_DEPTH_BANDS
    monkeypatch.setattr(band, "load_zoed", lambda runtime: model)
    clip = str(tmp_path / "clip.mp4")
    _make_video(clip, frames=3, w=56, h=40)
    ran = multiband.run_fused(
        clip, RuntimeConfig(compute_dtype="float32", batch_size=2,
                            segment_frames=0, device="cpu"),
        mask_on=False, depth_band="depth_zoedepth",
        depth_build={"img_size": IMG_SIZE}, flow_band=None)
    assert ran == {"depth_zoedepth": True}
    reader = VideoReader(clip)
    batches = [(f, v) for f, v in reader.batches(2, pad_to_full=True)]
    reader.close()
    with torch.inference_mode():
        ref = torch.cat([zoed.infer(model, torch.from_numpy(f), IMG_SIZE)[:v]
                         for f, v in batches])
    for name, fn in (("min", torch.amin), ("max", torch.amax)):
        got = np.loadtxt(tmp_path / f"depth_zoedepth_{name}.csv", ndmin=1)
        np.testing.assert_array_equal(got.astype(np.float32),
                                      fn(ref, dim=(1, 2)).numpy())
    assert os.path.exists(tmp_path / "depth_zoedepth.mp4")
