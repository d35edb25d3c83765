"""The port's Depth-Anything against the JAX package's, in f32 on the CPU.

The JAX parameters (the JAX package's own random init) are carried into the
port's state_dict with `weights.from_jax`, so both run the same weights.
Configurations: a tiny ViT (embed 64, depth 4, 2 heads, DPT features 32) and
vits at a 126-pixel budget. Tolerances: depth within 1e-4 of its scale
(float32 sums over 12 blocks taken in another order); heat within 1 LSB
(floor at float bin edges); per-frame min/max at rtol 1e-5.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prisma_tpu.models import depth_anything as jda
from prisma_tpu.models import dpt as jdpt
from prisma_tpu.models import vit as jvit
from prisma_tpu_torch.models import depth_anything as da
from prisma_tpu_torch.models import vit
from prisma_tpu_torch.weights.from_jax import depth_anything_state_dict
from prisma_tpu_torch.weights.store import depth_anything_from_state_dict

# the JAX side runs jitted: op-by-op dispatch of these graphs costs seconds
_jit_forward = jax.jit(jda.forward, static_argnames=("encoder",))
_jit_infer = jax.jit(jda.infer, static_argnames=("encoder", "target"))

TINY = dict(embed_dim=64, depth=4, num_heads=2)
TINY_DPT = dict(features=32, out_channels=(32, 64, 128, 128))
TARGET = 126


@functools.partial(jax.jit, static_argnums=1)
def _jit_tiny_init(key, jcfg):
    k1, k2 = jax.random.split(key)
    return {"vit": jvit.init_params(k1, jcfg),
            "dpt": jdpt.init_params(k2, jcfg.embed_dim, **TINY_DPT)}


@pytest.fixture(scope="module", params=["tiny", "vits"])
def pair(request):
    """(encoder name, JAX params, port model on the same weights)."""
    name = request.param
    with pytest.MonkeyPatch.context() as mp:
        if name == "tiny":
            jcfg = jvit.ViTConfig(**TINY)
            mp.setitem(jvit.VIT_CONFIGS, "tiny", jcfg)
            params = _jit_tiny_init(jax.random.key(0), jcfg)
            cfg = vit.ViTConfig(**TINY)
        else:
            params = jax.jit(jda.init_params, static_argnums=1)(
                jax.random.key(0), name)
            cfg = vit.VIT_CONFIGS[name]
        sd = depth_anything_state_dict(jax.tree.map(np.asarray, params))
        yield name, params, depth_anything_from_state_dict(sd, cfg)


def _close_depth(ours, theirs):
    theirs = np.asarray(theirs)
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0,
                               atol=1e-4 * np.abs(theirs).max())


def test_forward(pair):
    name, params, model = pair
    x = np.random.default_rng(1).normal(size=(2, 126, 182, 3)).astype(np.float32)
    theirs = _jit_forward(params, jnp.asarray(x), encoder=name)
    with torch.inference_mode():
        ours = da.forward(model, torch.from_numpy(x))
    _close_depth(ours, theirs)


def test_infer_video_batch(pair):
    name, params, model = pair
    frames = np.random.default_rng(2).integers(0, 256, size=(2, 48, 64, 3),
                                               dtype=np.uint8)
    j_heat, j_min, j_max = jda.infer_video_batch(
        params, jnp.asarray(frames), encoder=name, compute_dtype=jnp.float32,
        target=TARGET)
    j_depth = _jit_infer(params, jnp.asarray(frames), encoder=name,
                         target=TARGET)
    x = torch.from_numpy(frames)
    with torch.inference_mode():
        heat, dmin, dmax = da.infer_video_batch(model, x, target=TARGET)
        depth = da.infer(model, x, target=TARGET)
    _close_depth(depth, j_depth)
    assert heat.dtype == torch.uint8 and heat.shape == (2, 48, 64, 3)
    diff = np.abs(heat.numpy().astype(int) - np.asarray(j_heat).astype(int))
    assert diff.max() <= 1
    np.testing.assert_allclose(dmin.numpy(), np.asarray(j_min), rtol=1e-5)
    np.testing.assert_allclose(dmax.numpy(), np.asarray(j_max), rtol=1e-5)
