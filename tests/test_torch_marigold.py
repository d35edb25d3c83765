"""The port's Marigold (SD2 UNet and VAE, CLIP text tower, DDIM, the
ensembling, the pipeline and its band) against the JAX package's, in f32 on
the CPU.

Weights: the port's seeded random init of a narrow four-block UNet (64,
64, 128, 128; heads of 32; 8 groups; a 64-wide context) and VAE (32, 32,
64, 64), and of the JAX package's tiny two-block config for the pipeline
(its VAE at 32 groups: the JAX package's pipeline runs its VAE at the
default groups), every weight shifted by seeded noise, converted for the
JAX package by its own `convert_sd2_unet`, `convert_sd_vae` and
`convert_clip_text` (the CLIP tower: the port's, 2 layers, 64 wide; the JAX
package's random init of these widths takes ~26 s on the CPU, op by op;
tests/test_torch_weights.py holds `weights.from_jax` against the
converters). Inputs are seeded with numpy.

The UNet and VAE run at odd sizes: a 27x40 latent (27 -> 14 -> 7 -> 4 and
back, each nearest-2x map cropped to the next skip before its conv; 1080
tokens at the first level, so its self-attention takes `flash_attention`'s
route, the plain version on the CPU), a 72x104 image (latent 9x13).

jax.random cannot be reproduced without JAX, so the port draws its member
latents from a seeded torch.Generator; the pipeline is compared here with
the JAX package's latents injected into the port.

Tolerances: group norm, CLIP and DDIM within 1e-6 of the output's scale;
the timestep embedding within 1e-4 (one f32 ulp of its largest argument,
901 radians: sin and cos of the same f32 argument part by that much);
UNet and VAE within 1e-5 of it (f32 both sides, sums in another order); the device BFGS within 2e-2 of the host scipy
ensembling and of the JAX package's device solver (the JAX package's own
bar between its two, tests/test_marigold.py); the pipeline's member
depths and epilogue within 1e-5 of their scale, the whole pipeline within
1e-4 of it.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prisma_tpu.models import marigold as jmar
from prisma_tpu.models import sd2 as jsd2
from prisma_tpu.ops.resize import resize2d as jresize
from prisma_tpu.weights.torch_convert import (convert_checked,
                                              convert_clip_text,
                                              convert_sd2_unet, convert_sd_vae)
from prisma_tpu_torch.models import marigold as mg
from prisma_tpu_torch.models import sd2
from prisma_tpu_torch.weights import store
from prisma_tpu_torch.weights.from_jax import clip_text_state_dict

UNET = dict(block_channels=(64, 64, 128, 128), cross_attention_dim=64,
            head_dim=32, norm_groups=8)
VAE = dict(block_channels=(32, 32, 64, 64), norm_groups=8)
TINY_UNET = dict(block_channels=(32, 64), cross_attention_dim=64,
                 head_dim=16, norm_groups=8)
# the JAX package's pipeline runs its VAE at the default 32 groups whatever
# the tree (single_infer passes no VAE config), so the pipeline's VAE has 32
TINY_VAE = dict(block_channels=(32, 64), norm_groups=32)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for the module, its module-scoped fixtures
    included: the suite runs in several worker processes at once, and each
    torch op spreading over every core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(ours, theirs, rtol):
    theirs = np.asarray(theirs)
    assert tuple(ours.shape) == theirs.shape, (ours.shape, theirs.shape)
    np.testing.assert_allclose(ours.detach().numpy(), theirs, rtol=0,
                               atol=rtol * np.abs(theirs).max())


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _pair(unet, vae, seed):
    """(JAX tree, port Marigold) of the same weights: the port's seeded
    random init, every weight shifted by N(0, 0.02) noise, converted for the
    JAX package by its own converters; the port's CLIP embedding in both."""
    gen = torch.Generator().manual_seed(seed)
    model = mg.init_params(mg.build(sd2.UNetConfig(**unet), sd2.VAEConfig(**vae)),
                           gen)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    text = mg.init_text(mg.build_text(store.TINY_TEXT), gen)
    mg.set_text_embed(model, text)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params = {"unet": convert_checked(convert_sd2_unet, {
                  k[5:]: v for k, v in sd.items() if k.startswith("unet.")}),
              "vae": convert_checked(convert_sd_vae, {
                  k[4:]: v for k, v in sd.items() if k.startswith("vae.")}),
              "empty_text_embed": model.empty_text_embed.numpy()}
    return params, model, jsd2.UNetConfig(**unet), jsd2.VAEConfig(**vae)


@pytest.fixture(scope="module")
def narrow():
    return _pair(UNET, VAE, 0)


@pytest.fixture(scope="module")
def tiny():
    return _pair(TINY_UNET, TINY_VAE, 2)


def test_group_norm_and_timestep_embedding():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 9, 13, 64)) * 3 + 5).astype(np.float32)
    scale = rng.normal(size=64).astype(np.float32)
    bias = rng.normal(size=64).astype(np.float32)
    theirs = jsd2.group_norm({"scale": scale, "bias": bias}, jnp.asarray(x), 8)
    p = torch.nn.GroupNorm(8, 64, eps=1e-6)
    with torch.no_grad():
        p.weight.copy_(torch.from_numpy(scale))
        p.bias.copy_(torch.from_numpy(bias))
    _close(sd2.group_norm(p, _nchw(x)), np.asarray(theirs).transpose(0, 3, 1, 2),
           1e-6)
    t = np.array([1, 101, 501, 901], np.int32)
    for dim in (32, 320):
        _close(sd2.timestep_embedding(torch.from_numpy(t), dim),
               jsd2.timestep_embedding(jnp.asarray(t), dim), 1e-4)


def test_unet_at_an_odd_latent(narrow, monkeypatch):
    """A 27x40 latent: the long self-attentions (1080 tokens, heads of 32:
    two in the first down block, three in the last up block) go through
    flash_attention, the rest dense; the output within 1e-5 of its scale."""
    params, model, ucfg, _ = narrow
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 27, 40, 8)).astype(np.float32)
    t = np.array([501, 101], np.int32)
    ctx = np.broadcast_to(params["empty_text_embed"], (2, 2, 64)).copy()
    theirs = jax.jit(jsd2.unet_forward, static_argnums=(4,))(
        params["unet"], jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), ucfg)
    calls = []
    flash = sd2.flash_attention
    monkeypatch.setattr(sd2, "flash_attention",
                        lambda q, k, v: calls.append(q.shape) or flash(q, k, v))
    with torch.inference_mode():
        ours = sd2.unet_forward(model.unet, _nchw(x), torch.from_numpy(t),
                                torch.from_numpy(ctx))
    assert calls == [(4, 1080, 32)] * 5
    _close(ours, np.asarray(theirs).transpose(0, 3, 1, 2), 1e-5)


def test_vae_at_an_odd_latent(narrow):
    """Encode a 72x104 image (the (0, 1, 0, 1) padded stride-2 convs: 9x13
    latent), decode a 9x13 latent (nearest 2x, no crop)."""
    params, model, _, vcfg = narrow
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, size=(1, 72, 104, 3)).astype(np.float32)
    z = rng.normal(size=(2, 9, 13, 4)).astype(np.float32)
    enc = jax.jit(jsd2.vae_encode, static_argnums=(2,))(params["vae"],
                                                       jnp.asarray(x), vcfg)
    dec = jax.jit(jsd2.vae_decode, static_argnums=(2,))(params["vae"],
                                                       jnp.asarray(z), vcfg)
    with torch.inference_mode():
        ours_enc = sd2.vae_encode(model.vae, _nchw(x))
        ours_dec = sd2.vae_decode(model.vae, _nchw(z))
    assert ours_enc.shape == (1, 4, 9, 13) and ours_dec.shape == (2, 3, 72, 104)
    _close(ours_enc, np.asarray(enc).transpose(0, 3, 1, 2), 1e-5)
    _close(ours_dec, np.asarray(dec).transpose(0, 3, 1, 2), 1e-5)


def test_clip_text_tower():
    """Quick-gelu, the causal mask and the final norm, on random ids and on
    the empty prompt [BOS, EOS]; the carry-across inverts the JAX
    converter."""
    text = mg.init_text(mg.build_text(store.TINY_TEXT),
                        torch.Generator().manual_seed(4))
    sd = text.state_dict()
    params = convert_clip_text({k: v.numpy() for k, v in sd.items()})
    back = clip_text_state_dict(jax.tree.map(np.asarray, params))
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    jcfg = jmar.CLIPTextConfig(width=64, heads=2, layers=2)
    ids = np.random.default_rng(5).integers(0, 49408, size=(2, 7))
    with torch.inference_mode():
        _close(mg.clip_text_forward(text, torch.from_numpy(ids)),
               jmar.clip_text_forward(params, jnp.asarray(ids), jcfg), 1e-6)
        _close(mg.empty_text_embed(text),
               jmar.empty_text_embed(params, jcfg), 1e-6)


def test_ddim():
    cfg = mg.DDIMConfig()
    np.testing.assert_array_equal(mg.ddim_alphas(), jmar.ddim_alphas())
    np.testing.assert_array_equal(mg.ddim_timesteps(10), jmar.ddim_timesteps(10))
    assert list(mg.ddim_timesteps(10)) == [901, 801, 701, 601, 501, 401, 301,
                                           201, 101, 1]
    alphas = mg.ddim_alphas().astype(np.float32)
    rng = np.random.default_rng(6)
    out, sample = (rng.normal(size=(2, 4, 5, 7)).astype(np.float32)
                   for _ in range(2))
    for pred in ("v_prediction", "epsilon"):
        c = mg.DDIMConfig(prediction_type=pred)
        for t, t_prev in ((901, 801), (1, -1)):
            ours = mg.ddim_step(torch.from_numpy(out), t, t_prev,
                                torch.from_numpy(sample),
                                torch.from_numpy(alphas), c)
            theirs = jmar.ddim_step(jnp.asarray(out), t, t_prev,
                                    jnp.asarray(sample), jnp.asarray(alphas),
                                    jmar.DDIMConfig(prediction_type=pred))
            _close(ours, theirs, 1e-6)
    assert cfg.prediction_type == "v_prediction"


def _members(n, seed, hw=(24, 32)):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, size=hw).astype(np.float32)
    return np.stack([base * rng.uniform(0.7, 1.3) + rng.uniform(-0.2, 0.2)
                     + rng.normal(0, 0.005, size=hw).astype(np.float32)
                     for _ in range(n)]).astype(np.float32)


@pytest.mark.parametrize("n", [10, 6, 5])
def test_device_bfgs_ensembling(n):
    """The port's device BFGS against the host scipy ensembling and the JAX
    package's device solver, both within 2e-2 (the distances seen are
    printed: ~2e-3 to the host's, ~1e-7 to the JAX solver's at 6 and 10
    members)."""
    preds = _members(n, 7 + n)
    host, h_mad = mg.ensemble_depths(preds.copy())
    jhost, _ = jmar.ensemble_depths(preds.copy())
    np.testing.assert_array_equal(host, jhost)  # the oracle copied
    dev, d_mad = jmar.ensemble_depths_device(preds.copy())
    ours, o_mad = mg.ensemble_depths_device(torch.from_numpy(preds))
    for name, ref, ref_mad in (("host", host, h_mad), ("jax", dev, d_mad)):
        d = float(np.abs(ours.numpy() - ref).max())
        print(f"{n} members, |ours - {name}| max {d:.3e}")
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=2e-2)
        np.testing.assert_allclose(o_mad.numpy(), ref_mad, rtol=0, atol=2e-2)


def test_even_count_median_is_the_mean_of_the_middle_two(monkeypatch):
    """Two members far apart: numpy's median (the mean of the two) and
    torch.median's lower value part by more than the bound, so the port
    must take the former to stay within it of the JAX solver."""
    rng = np.random.default_rng(9)
    base = rng.uniform(0, 1, size=(16, 24)).astype(np.float32)
    preds = np.stack([base, 0.2 + 0.1 * base ** 2]).astype(np.float32)
    dev, mad = jmar.ensemble_depths_device(preds.copy())
    ours, o_mad = mg.ensemble_depths_device(torch.from_numpy(preds))
    np.testing.assert_allclose(ours.numpy(), dev, rtol=0, atol=2e-2)
    np.testing.assert_allclose(o_mad.numpy(), mad, rtol=0, atol=2e-2)
    monkeypatch.setattr(mg, "median0", lambda x: x.median(dim=0).values)
    lower, l_mad = mg.ensemble_depths_device(torch.from_numpy(preds))
    assert float(np.abs(l_mad.numpy() - mad).max()) > 2e-2 or \
        float(np.abs(lower.numpy() - dev).max()) > 2e-2


def jax_latents(seed, n, shape, device="cpu"):
    """The JAX package's member latents (fold_in(key(seed), i) normals,
    NHWC), as the port's NCHW: injected into the port's pipeline."""
    c, h, w = shape
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed), i))(
        jnp.arange(n))
    z = jax.vmap(lambda k: jax.random.normal(k, (h, w, c), jnp.float32))(keys)
    return torch.from_numpy(np.asarray(z).transpose(0, 3, 1, 2).copy()).to(device)


@pytest.mark.parametrize("ensemble", [2, 3])
def test_pipeline_with_injected_latents(tiny, ensemble, monkeypatch):
    """single_infer -> the device BFGS -> the epilogue against the JAX
    package's on the same frame, weights and member latents: the members'
    depths within 1e-5 of their scale, the epilogue on the same aligned map
    within 1e-5, the whole `infer` within 1e-4 (the two BFGS take the same
    steps: the objective's |.| has jax.numpy's derivative at 0)."""
    params, model, ucfg, _ = tiny
    frame = np.random.default_rng(10).integers(0, 256, (40, 56, 3),
                                               dtype=np.uint8)
    lat = jax_latents(3, ensemble, (4, 16, 24))
    rgb = jresize(jnp.asarray(frame, jnp.float32)[None] / 255.0, (32, 48),
                  method="cubic_aa")
    preds = jax.jit(jmar.single_infer, static_argnames=("num_steps", "unet_cfg"))(
        params, rgb, num_steps=2, unet_cfg=ucfg,
        depth_latent=jnp.asarray(lat.numpy().transpose(0, 2, 3, 1)))
    with torch.inference_mode():
        ours = mg.single_infer(model, _nchw(rgb), lat, 2)
    _close(ours, preds, 1e-5)
    aligned, _ = jmar._ensemble_solver(ensemble, 0.02, 2, 1e-3)(preds)
    with torch.inference_mode():
        _close(mg.epilogue(torch.from_numpy(np.array(aligned)), (40, 56)),
               jmar._epilogue_fn((40, 56))(aligned), 1e-5)
    theirs = jmar.infer(params, frame, denoising_steps=2,
                        ensemble_size=ensemble, processing_res=48, seed=3,
                        unet_cfg=ucfg)
    monkeypatch.setattr(mg, "member_latents", jax_latents)
    with torch.inference_mode():
        ours = mg.infer(model, torch.from_numpy(frame), denoising_steps=2,
                        ensemble_size=ensemble, processing_res=48, seed=3)
    assert ours.shape == (40, 56) and ours.dtype == torch.float32
    print(f"{ensemble} members: |infer - JAX infer| max "
          f"{float(np.abs(ours.numpy() - theirs).max()):.3e}")
    _close(ours, theirs, 1e-4)


def test_seed_is_the_global_frame_index(tiny):
    """A frame's depth does not depend on how the frames are batched (a
    resume regroups them): frame k is seeded by idx0 + its offset."""
    from prisma_tpu_torch.bands import depth_marigold_band as band

    _, model, _, _ = tiny
    frames = torch.from_numpy(np.random.default_rng(11).integers(
        0, 256, size=(3, 40, 56, 3), dtype=np.uint8))
    kw = dict(steps=2, ensemble=2, res=24, dtype=torch.float32)
    with torch.inference_mode():
        all_at_once = band.infer_frames(model, frames, 0, **kw)
        first = band.infer_frames(model, frames[:1], 0, **kw)
        rest = band.infer_frames(model, frames[1:], 1, **kw)
    assert torch.equal(all_at_once[0], first[0])
    assert torch.equal(all_at_once[1:], rest)
    a = mg.member_latents(5, 2, (4, 3, 3))
    assert torch.equal(a, mg.member_latents(5, 2, (4, 3, 3)))
    assert not torch.equal(a, mg.member_latents(6, 2, (4, 3, 3)))


def test_band_on_a_video(tmp_path, monkeypatch, tiny):
    """A video runs through the non-fused step, one frame at a time, each
    seeded by its global index: the CSVs equal infer_frames' on the decoded
    frames."""
    from prisma_tpu_torch.bands import depth_marigold_band as band
    from prisma_tpu_torch.io.video import VideoReader
    from prisma_tpu_torch.runtime.config import RuntimeConfig
    from tests.test_multiband import _make_video

    _, model, _, _ = tiny
    monkeypatch.setattr(band, "load_marigold", lambda runtime, device: model)
    clip = str(tmp_path / "clip.mp4")
    _make_video(clip, frames=3, w=56, h=40)
    band.run(clip, denoise_steps=2, ensemble_size=2, processing_res=24,
             runtime=RuntimeConfig(compute_dtype="float32", batch_size=2,
                                   segment_frames=0, device="cpu"))
    reader = VideoReader(clip)
    frames = np.concatenate([f[:v] for f, v in reader.batches(2)])
    reader.close()
    with torch.inference_mode():
        ref = band.infer_frames(model, torch.from_numpy(frames), 0, steps=2,
                                ensemble=2, res=24, dtype=torch.float32)
    for name, fn in (("min", torch.amin), ("max", torch.amax)):
        got = np.loadtxt(tmp_path / f"depth_marigold_{name}.csv", ndmin=1)
        np.testing.assert_array_equal(got.astype(np.float32),
                                      fn(ref, dim=(1, 2)).numpy())
    assert os.path.exists(tmp_path / "depth_marigold.mp4")
