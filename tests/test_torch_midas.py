"""The port's MiDaS (DPT_Large on timm's ViT-L/16, MiDaS v2.1 on
ResNeXt-101) against the JAX package's, in f32 on the CPU.

DPT_Large: the JAX package's random init of a narrow model (a ViT 128 wide,
2 heads of 64, 4 blocks, patch 16 on the 24x24 position grid; a decoder of
32 features), every leaf shifted by seeded noise, carried across with
`weights.from_jax`; the JAX package's config and hooks narrowed to match
(monkeypatched). MiDaS v2.1: the port's seeded random ResNeXt-101 32x8d at a
stem width of 16 (its batch norms' statistics drawn too) and 32 features,
converted for the JAX package by its own `convert_midas2`. Frames and
inputs are seeded with numpy.

Tolerances: the position-embedding resample within 1e-6 (the same f32
matrices); hooked tokens, ResNeXt features, `infer` and the band's CSVs
within 1e-5 of each output's scale (f32 on both sides, sums in another
order; the JAX package's own bar for its MiDaS v2.1 against a torch replica
is 2e-3 absolute).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prisma_tpu.models import midas as jmidas
from prisma_tpu.models import resnet as jresnet
from prisma_tpu.models import vit as jvit
from prisma_tpu.weights.torch_convert import (convert_checked, convert_midas2,
                                              convert_resnet)
from prisma_tpu_torch.models import midas, resnet, vit
from prisma_tpu_torch.runtime.config import RuntimeConfig
from prisma_tpu_torch.weights import store
from prisma_tpu_torch.weights.from_jax import midas_dpt_state_dict
from tests.test_torch_beit import DECODER, jax_decoder, noisy

RTOL = 1e-5
CFG = dict(embed_dim=128, depth=4, num_heads=2, patch_size=16,
           base_img_size=384, layerscale=False)
J_CFG = jvit.ViTConfig(**CFG)
V2 = dict(features=32, width=16)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for the module, its module-scoped fixtures
    included: the suite runs in several worker processes at once, and each
    torch op spreading over every core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def narrow_jax(monkeypatch):
    """The JAX package's DPT_Large config and hooks, narrowed to the test
    model (its forward reads both at call time)."""
    monkeypatch.setattr(jmidas, "MIDAS_VIT_CONFIG", J_CFG)
    monkeypatch.setattr(jmidas, "HOOKS", (0, 1, 2, 3))


def _close(ours, theirs, rtol=RTOL):
    theirs = np.asarray(theirs)
    assert tuple(ours.shape) == theirs.shape, (ours.shape, theirs.shape)
    np.testing.assert_allclose(ours.detach().numpy(), theirs, rtol=0,
                               atol=rtol * np.abs(theirs).max())


def jax_dpt(seed: int) -> dict:
    """A narrow DPT_Large tree (numpy leaves, noisy)."""
    k1, k2 = jax.random.split(jax.random.key(seed))
    v = jvit.init_params(k1, J_CFG)
    for b in v["blocks"]:
        b.pop("ls1")
        b.pop("ls2")
    return noisy({"vit": v, **jax_decoder(k2, CFG["embed_dim"], **DECODER)},
                 seed + 1)


@pytest.fixture(scope="module")
def dpt_pair():
    params = jax_dpt(0)
    return params, store.midas_dpt_from_state_dict(midas_dpt_state_dict(params))


@pytest.fixture(scope="module")
def v2_pair():
    """The port's narrow MiDaS v2.1 and the JAX tree of the same weights."""
    gen = torch.Generator().manual_seed(1)
    model = midas.init_params_v2(midas.build_v2(**V2), gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0, 0.1, generator=gen)
                m.running_mean.normal_(0, 0.1, generator=gen)
                m.running_var.uniform_(0.6, 1.4, generator=gen)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return convert_checked(convert_midas2, sd), model


@pytest.mark.parametrize("hw", [(4, 6), (14, 24), (24, 24)])
def test_linear_pos_embed(dpt_pair, hw):
    """MiDaS's `_resize_pos_embed`: bilinear, align_corners False, in f32;
    the 24x24 grid passes through."""
    params, model = dpt_pair
    pe = model.pretrained.model.pos_embed
    ours = vit.interpolated_pos_embed(pe, *hw, model.pretrained.model.cfg,
                                      method="linear")
    theirs = jvit.interpolated_pos_embed(jnp.asarray(params["vit"]["pos_embed"]),
                                         *hw, J_CFG, method="linear")
    assert ours.shape == (1, hw[0] * hw[1] + 1, CFG["embed_dim"])
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("indices,norm", [((0, 1, 2, 3), False), ((1, 3), True)])
def test_vit_hooks(dpt_pair, indices, norm):
    """timm's ViT-L/16 blocks (no LayerScale) hooked raw at fixed indices,
    or through the final norm."""
    params, model = dpt_pair
    x = np.random.default_rng(2).normal(size=(2, 64, 96, 3)).astype(np.float32)
    theirs = jax.jit(jvit.get_intermediate_layers, static_argnums=(2,),
                     static_argnames=("indices", "norm", "pos_embed_method"))(
        params["vit"], jnp.asarray(x), J_CFG, indices=indices, norm=norm,
        pos_embed_method="linear")
    with torch.inference_mode():
        ours = vit.get_intermediate_layers(
            model.pretrained.model, torch.from_numpy(x).permute(0, 3, 1, 2),
            indices=indices, norm=norm, pos_embed_method="linear")
    assert len(ours) == len(theirs) == len(indices)
    for (tok, cls), (jtok, jcls) in zip(ours, theirs):
        assert tok.shape == (2, 4 * 6, CFG["embed_dim"])
        _close(tok, jtok)
        _close(cls, jcls)


def test_resnext_features():
    """ResNeXt-101 32x8d (grouped 3x3 of int(w * 8 / 64) * 32 channels) at a
    stem width of 16: C2..C5 against the JAX package's `forward(groups=32)`
    on `convert_resnet`'s folded batch norms."""
    gen = torch.Generator().manual_seed(2)
    model = midas.init_params_v2(midas.build_v2(**V2), gen)
    r = resnet.ResNet(101, groups=32, width_per_group=8, width=16)
    stem = model.pretrained.layer1
    r.conv1, r.bn1, r.layer1 = stem[0], stem[1], stem[4]
    r.layer2, r.layer3, r.layer4 = (model.pretrained.layer2,
                                    model.pretrained.layer3,
                                    model.pretrained.layer4)
    with torch.no_grad():
        for m in r.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1, generator=gen)
                m.running_var.uniform_(0.6, 1.4, generator=gen)
    params = convert_resnet({k: v.numpy() for k, v in r.state_dict().items()},
                            "", 101)
    assert r.layer1[0].conv2.weight.shape == (64, 2, 3, 3)
    x = np.random.default_rng(3).normal(size=(1, 64, 96, 3)).astype(np.float32)
    theirs = jax.jit(jresnet.forward, static_argnames=("groups",))(
        params, jnp.asarray(x), groups=32)
    with torch.inference_mode():
        ours = resnet.forward(r, torch.from_numpy(x).permute(0, 3, 1, 2))
    for c, (o, t) in enumerate(zip(ours, theirs)):
        assert o.shape[1] == 64 * 2 ** c
        _close(o, np.asarray(t).transpose(0, 3, 1, 2))


_jit_infer = jax.jit(jmidas.infer, static_argnames=("target",))
_jit_infer_v2 = jax.jit(jmidas.infer_v2, static_argnames=("target",))


@pytest.mark.parametrize("target", [96, 128])
def test_dpt_large_infer(dpt_pair, narrow_jax, target):
    """uint8 frames -> the upper-bound /32 resize, DPT_Large, the bicubic
    (align_corners) resize back: 40x56 -> 64x96 at 96, 96x128 at 128."""
    params, model = dpt_pair
    frames = np.random.default_rng(4).integers(0, 256, size=(2, 40, 56, 3),
                                               dtype=np.uint8)
    theirs = _jit_infer(params, jnp.asarray(frames), target=target)
    with torch.inference_mode():
        ours = midas.infer(model, torch.from_numpy(frames), target=target)
    assert ours.dtype == torch.float32
    _close(ours, theirs)


@pytest.mark.parametrize("target", [96, 128])
def test_midas2_infer(v2_pair, target):
    """MiDaS v2.1: the same prep, ResNeXt, fusion blocks without an out
    conv, the head's x2 upsample with align_corners False."""
    params, model = v2_pair
    frames = np.random.default_rng(5).integers(0, 256, size=(2, 40, 56, 3),
                                               dtype=np.uint8)
    theirs = _jit_infer_v2(params, jnp.asarray(frames), target=target)
    with torch.inference_mode():
        ours = midas.infer_v2(model, torch.from_numpy(frames), target=target)
    _close(ours, theirs)


def test_band_versions_and_targets(tmp_path, monkeypatch, dpt_pair, v2_pair):
    """The band's four model versions load their architecture, the -small
    ones at target 256, and --img_size overrides it; an image's heatmap is
    written with flip=True (near is 1)."""
    import cv2

    from prisma_tpu_torch.bands import depth_midas_band as band

    _, dpt = dpt_pair
    _, v2 = v2_pair
    seen = []

    def load(runtime, model_version="midas3"):
        seen.append(model_version)
        return ("v2", v2) if model_version.startswith("midas2") else ("dpt", dpt)

    monkeypatch.setattr(band, "load_midas", load)
    rt = RuntimeConfig(compute_dtype="float32", device="cpu")
    for version, target, want in (("midas2-small", None, 256),
                                  ("midas3", None, 384),
                                  ("midas3-small", 96, 96)):
        _model, infer, flip = band.build_infer(rt, version, target)
        assert infer.keywords["target"] == want and flip
        assert infer.func is (midas.infer_v2 if version.startswith("midas2")
                              else midas.infer)
    assert seen == ["midas2-small", "midas3", "midas3-small"]
    img = np.random.default_rng(6).integers(0, 256, (40, 56, 3), dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "photo.png"), img)
    band.main(["-i", str(tmp_path / "photo.png"), "--model", "midas2",
               "--img_size", "96", "--dtype", "float32", "--device", "cpu",
               "-n", "--force"])
    assert sorted(os.listdir(tmp_path)) == ["depth_midas.npy", "depth_midas.png",
                                            "photo.png"]
    rgb = np.ascontiguousarray(img[..., ::-1])  # cv2 wrote it as BGR
    with torch.inference_mode():
        ref = midas.infer_v2(v2, torch.from_numpy(rgb[None]), target=96)[0]
    np.testing.assert_array_equal(np.load(tmp_path / "depth_midas.npy"),
                                  ref.numpy())


def test_fused_video_run(tmp_path, monkeypatch, dpt_pair):
    """`-d depth_midas` on a video runs in the fused pipeline: one model
    call a batch; the per-frame min and max are midas.infer's on the decoded
    frames (the same f32 arithmetic, batched alike: equal)."""
    from prisma_tpu_torch.bands import depth_midas_band as band
    from prisma_tpu_torch.bands import multiband
    from prisma_tpu_torch.io.video import VideoReader
    from tests.test_multiband import _make_video

    _, model = dpt_pair
    assert "depth_midas" in multiband.FUSED_DEPTH_BANDS
    monkeypatch.setattr(band, "load_midas",
                        lambda runtime, model_version: ("dpt", model))
    clip = str(tmp_path / "clip.mp4")
    _make_video(clip, frames=3, w=56, h=40)
    ran = multiband.run_fused(
        clip, RuntimeConfig(compute_dtype="float32", batch_size=2,
                            segment_frames=0, device="cpu"),
        mask_on=False, depth_band="depth_midas", depth_build={"target": 96},
        flow_band=None)
    assert ran == {"depth_midas": True}
    reader = VideoReader(clip)
    batches = [(f, v) for f, v in reader.batches(2, pad_to_full=True)]
    reader.close()
    with torch.inference_mode():
        ref = torch.cat([midas.infer(model, torch.from_numpy(f), target=96)[:v]
                         for f, v in batches])
    for name, fn in (("min", torch.amin), ("max", torch.amax)):
        got = np.loadtxt(tmp_path / f"depth_midas_{name}.csv", ndmin=1)
        np.testing.assert_array_equal(got.astype(np.float32),
                                      fn(ref, dim=(1, 2)).numpy())
    assert os.path.exists(tmp_path / "depth_midas.mp4")
