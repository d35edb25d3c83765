"""The port's GMFlow (1-scale) against the JAX package's, on the CPU.

Both run the JAX package's random init (jax.random), carried to the port with
`from_jax.gmflow_state_dict` and loaded with strict=True, in f32 on the same
numpy-seeded images. The JAX side runs its CPU path: dense XLA window
attention and the blockwise-scan global softmax; the port runs the kernels'
plain versions. Also: the RAFT helpers GMFlow imports, the flow ops, the
per-pair HSV encoding, and the weight round trip and checkpoint files.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prisma_tpu.models import gmflow as jgm
from prisma_tpu.models import raft as jraft
from prisma_tpu.ops import encode as jenc
from prisma_tpu.ops import flow as jflow
from prisma_tpu.weights.torch_convert import convert_gmflow
from prisma_tpu_torch.models import gmflow as gm
from prisma_tpu_torch.models import raft
from prisma_tpu_torch.ops import encode as enc
from prisma_tpu_torch.ops import flow as pflow
from prisma_tpu_torch.runtime.config import RuntimeConfig
from prisma_tpu_torch.weights import store
from prisma_tpu_torch.weights.from_jax import gmflow_state_dict

# f32 on both sides through 6 transformer layers and two global softmaxes:
# the flows (pixels, |flow| up to ~40 at these sizes) agree to sums taken in
# another order, far inside the JAX package's 5e-3 bar against the reference
FLOW_ATOL = 2e-3


@functools.lru_cache(maxsize=None)
def _jax_params():
    return jax.tree.map(np.asarray, jax.jit(jgm.init_params)(jax.random.key(0)))


@pytest.fixture(scope="module")
def models():
    params = _jax_params()
    model = gm.build()
    model.load_state_dict(gmflow_state_dict(params), strict=True)
    return params, model


def _images(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 255, shape).astype(np.float32),
            rng.uniform(0, 255, shape).astype(np.float32))


def test_backbone_matches_jax(models):
    params, model = models
    x = np.random.default_rng(0).normal(size=(2, 64, 96, 3)).astype(np.float32)
    theirs = jax.jit(jgm.backbone_forward)(params["backbone"], jnp.asarray(x))
    with torch.inference_mode():
        ours = gm.backbone_forward(model.backbone, torch.from_numpy(
            x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(ours.numpy().transpose(0, 2, 3, 1),
                               np.asarray(theirs), atol=1e-4, rtol=1e-4)


def test_forward_bidir_matches_jax(models):
    """forward at 64x96 with the full 128 channels and 6 layers, bidir:
    [fwd; bwd] flows of 2 pairs."""
    params, model = models
    a, b = _images(1, (2, 64, 96, 3))
    theirs = jax.jit(jgm.forward)(params, jnp.asarray(a), jnp.asarray(b))
    with torch.inference_mode():
        ours = gm.forward(model, torch.from_numpy(a), torch.from_numpy(b))
    assert ours.shape == (4, 64, 96, 2) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=FLOW_ATOL)


def test_infer_pairs_pads_and_matches_jax(models):
    """infer_pairs at 60x90: centred replicate padding to 64x96 and back."""
    params, model = models
    a, b = _images(2, (2, 60, 90, 3))
    jf, jb = jax.jit(jgm.infer_pairs)(params, jnp.asarray(a), jnp.asarray(b))
    with torch.inference_mode():
        f, bw = gm.infer_pairs(model, torch.from_numpy(a), torch.from_numpy(b))
    assert f.shape == bw.shape == (2, 60, 90, 2)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=FLOW_ATOL)
    np.testing.assert_allclose(bw.numpy(), np.asarray(jb), atol=FLOW_ATOL)


def test_inference_size_identity(models):
    """inference_size == the input size: the align_corners resize is an
    identity, so the resize path reproduces the padding path."""
    _, model = models
    a, b = (torch.from_numpy(x) for x in _images(3, (1, 32, 48, 3)))
    with torch.inference_mode():
        f1, b1 = gm.infer_pairs(model, a, b)
        f2, b2 = gm.infer_pairs(model, a, b, inference_size=(32, 48))
    torch.testing.assert_close(f1, f2, rtol=0, atol=1e-5)
    torch.testing.assert_close(b1, b2, rtol=0, atol=1e-5)


def test_config_refuses_refinement():
    with pytest.raises(NotImplementedError, match="item 11"):
        gm.GMFlowConfig(num_scales=2)


# ------------------------------------------------------------- RAFT helpers

@pytest.mark.parametrize("factor", [8, 4])
def test_convex_upsample(factor):
    rng = np.random.default_rng(4)
    flow = rng.normal(0, 3, (2, 5, 7, 2)).astype(np.float32)
    mask = rng.normal(0, 1, (2, 5, 7, 9 * factor * factor)).astype(np.float32)
    theirs = jraft.convex_upsample(jnp.asarray(flow), jnp.asarray(mask), factor)
    ours = raft.convex_upsample(torch.from_numpy(flow), torch.from_numpy(mask),
                                factor)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-5)


@pytest.mark.parametrize("hw,multiple", [((60, 90), 16), ((64, 96), 16),
                                         ((37, 50), 8)])
def test_pad_to_multiple_and_unpad(hw, multiple):
    x = np.random.default_rng(5).normal(size=(2, *hw, 3)).astype(np.float32)
    jp, jpads = jraft.pad_to_multiple(jnp.asarray(x), multiple)
    p, pads = raft.pad_to_multiple(torch.from_numpy(x), multiple)
    assert pads == tuple(jpads)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(raft.unpad(p, pads).numpy(), x)


# ------------------------------------------------------- flow ops, encoding

def test_compute_fwdbwd_mask_matches_jax():
    """A smooth flow and its near-inverse, so both sides of the threshold
    occur; warps reach outside the image."""
    rng = np.random.default_rng(6)
    H, W = 24, 36
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    base = np.stack([3 * np.sin(xx / 5), 2 * np.cos(yy / 4)], -1)
    fwd = (base[None] + rng.normal(0, 0.4, (3, H, W, 2))).astype(np.float32)
    bwd = (-base[None] + rng.normal(0, 0.4, (3, H, W, 2))).astype(np.float32)
    jm = jflow.compute_fwdbwd_mask_batch(jnp.asarray(fwd), jnp.asarray(bwd))
    fm, bm = pflow.compute_fwdbwd_mask(torch.from_numpy(fwd),
                                       torch.from_numpy(bwd))
    assert fm.dtype == torch.bool and fm.shape == (3, H, W)
    assert 0.1 < float(fm.float().mean()) < 0.9
    np.testing.assert_array_equal(fm.numpy(), np.asarray(jm[0]))
    np.testing.assert_array_equal(bm.numpy(), np.asarray(jm[1]))
    warped = pflow.warp_flow(torch.from_numpy(bwd), torch.from_numpy(fwd))
    theirs = jax.vmap(jflow.warp_flow)(jnp.asarray(bwd), jnp.asarray(fwd))
    np.testing.assert_allclose(warped.numpy(), np.asarray(theirs), atol=1e-5)


def test_process_flow_is_per_pair():
    """A batch of pairs of very different magnitudes: each pair is
    normalised by its own maximum distance, as the JAX step vmaps it."""
    rng = np.random.default_rng(7)
    flow = rng.normal(0, 1, (3, 16, 20, 2)).astype(np.float32)
    flow *= np.array([0.5, 40.0, 3.0], np.float32)[:, None, None, None]
    rgb, mx = enc.process_flow(torch.from_numpy(flow))
    j_rgb, j_max = jax.vmap(jenc.process_flow)(jnp.asarray(flow))
    assert mx.shape == (3,) and rgb.shape == (3, 16, 20, 3)
    np.testing.assert_allclose(mx.numpy(), np.asarray(j_max), rtol=1e-6)
    assert float(mx[1]) > 20 * float(mx[0])
    diff = np.abs(rgb.numpy().astype(int) - np.asarray(j_rgb).astype(int))
    assert diff.max() <= 1  # floor at float bin edges
    for i in range(3):  # and each pair alone gives the same
        one_rgb, one_max = enc.process_flow(torch.from_numpy(flow[i]))
        assert float(one_max) == float(mx[i])
        assert torch.equal(one_rgb, rgb[i])


def test_encode_flow_batch_matches_jax():
    rng = np.random.default_rng(8)
    flow = rng.normal(0, 30, (2, 12, 14, 2)).astype(np.float32)
    flow[0, 0, 0] = 200.0  # overflows the 16-bit range: invalid
    mask = rng.uniform(size=(2, 12, 14)) > 0.3
    theirs = jax.vmap(jenc.encode_flow)(jnp.asarray(flow), jnp.asarray(mask))
    ours = enc.encode_flow(torch.from_numpy(flow), torch.from_numpy(mask))
    np.testing.assert_array_equal(ours, np.asarray(theirs))


# ------------------------------------------------------------------ weights

def test_state_dict_is_the_reference_checkpoints(models):
    _, model = models
    keys = set(model.state_dict())
    for k in ("backbone.conv1.weight", "backbone.layer1.0.conv2.weight",
              "backbone.layer2.0.downsample.0.bias",
              "backbone.layer3.1.conv1.weight", "backbone.conv2.bias",
              "transformer.layers.5.self_attn.v_proj.weight",
              "transformer.layers.0.cross_attn_ffn.mlp.2.weight",
              "transformer.layers.3.cross_attn_ffn.norm2.bias",
              "feature_flow_attn.k_proj.bias", "upsampler.2.weight"):
        assert k in keys, k
    assert not any("backbone.conv1.bias" == k or "self_attn.mlp" in k
                   or "layer1.0.downsample" in k for k in keys)


def test_convert_then_from_jax_round_trip_is_exact(models):
    _, model = models
    sd = model.state_dict()
    back = gmflow_state_dict(jax.tree.map(
        np.asarray, convert_gmflow({k: v.numpy() for k, v in sd.items()})))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    model2 = gm.build()
    model2.load_state_dict(back, strict=True)
    del back["upsampler.0.bias"]
    with pytest.raises(RuntimeError, match="Missing key"):
        gm.build().load_state_dict(back, strict=True)


@pytest.mark.parametrize("layout", ["model", "module", "raw"])
def test_checkpoint_file_layouts_load(tmp_path, models, layout):
    """The reference file wraps its state_dict under 'model'; DataParallel
    prefixes and a bare state_dict load too."""
    _, model = models
    sd = model.state_dict()
    payload = {"model": {"model": sd, "epoch": 100},
               "module": {"model": {"module." + k: v for k, v in sd.items()}},
               "raw": sd}[layout]
    torch.save(payload, tmp_path / "gmflow_sintel-0c07dcb3.pth")
    runtime = RuntimeConfig(models_dir=str(tmp_path), device="cpu")
    loaded = store.load_gmflow(runtime)
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_random_init_is_seeded_and_missing_file_raises(tmp_path):
    runtime = RuntimeConfig(random_weights=True, device="cpu")
    a = store.load_gmflow(runtime).state_dict()
    b = store.load_gmflow(runtime).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["transformer.layers.0.self_attn.q_proj.weight"]
    assert float(w.std()) == pytest.approx(128 ** -0.5, rel=0.05)
    with pytest.raises(FileNotFoundError):
        store.load_gmflow(RuntimeConfig(models_dir=str(tmp_path), device="cpu"))
