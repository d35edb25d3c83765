"""The port's metric Depth-Anything (ZoeDepth head over the DPT core) against
the JAX package's, in f32 on the CPU.

Weights are the JAX package's random init, carried across with
`weights.from_jax`; inputs are seeded with numpy. Tolerances: each bins-head
function and the whole metric model within 1e-5 relative to the output's
scale (f32 on both sides, sums in another order; the JAX package's own bar
against the reference is 1e-3 of the scale); the DPT features within 1e-5
of their scale.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prisma_tpu.models import dpt as jdpt
from prisma_tpu.models import vit as jvit
from prisma_tpu.models import zoedepth as jzoe
from prisma_tpu_torch.models import dpt, vit
from prisma_tpu_torch.models import zoedepth as zoe
from prisma_tpu_torch.weights.from_jax import (dpt_head_state_dict,
                                               metric_depth_anything_state_dict)
from prisma_tpu_torch.weights.store import metric_depth_anything_from_state_dict

RTOL = 1e-5
SIZE = (126, 168)  # the core size: 9 x 12 patches


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two intra-op threads a test: the suite runs in several worker
    processes at once, and each torch op spreading over every core of the
    machine oversubscribes it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(ours, theirs, rtol=RTOL):
    theirs = np.asarray(theirs)
    assert ours.shape == theirs.shape, (ours.shape, theirs.shape)
    np.testing.assert_allclose(ours.detach().numpy(), theirs, rtol=0,
                               atol=rtol * np.abs(theirs).max())


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def _rand_mlp(rng, cin, mid, cout):
    def conv(ci, co):
        return {"w": (rng.normal(size=(1, 1, ci, co)) * ci ** -0.5).astype(np.float32),
                "b": (rng.normal(size=(co,)) * 0.1).astype(np.float32)}
    return {"fc1": conv(cin, mid), "fc2": conv(mid, cout)}


def _net(p, module_cls=zoe._Net):
    """A port layer holding the JAX {fc1, fc2} weights."""
    cin, mid = p["fc1"]["w"].shape[2:]
    cout = p["fc2"]["w"].shape[3]
    m = module_cls(cin, mid, cout) if module_cls is zoe._Net \
        else module_cls(cin, cout)
    seq = m._net if module_cls is zoe._Net else m.mlp
    with torch.no_grad():
        for i, fc in ((0, "fc1"), (2, "fc2")):
            seq[i].weight.copy_(torch.from_numpy(p[fc]["w"].transpose(3, 2, 0, 1)))
            seq[i].bias.copy_(torch.from_numpy(p[fc]["b"]))
    return m


@pytest.mark.parametrize("kind", ["softplus", "normed"])
def test_seed_bin_regressor(kind):
    cfg = jzoe.ZoeDepthConfig(bin_centers_type=kind)
    rng = np.random.default_rng(0)
    p = _rand_mlp(rng, 32, 256, cfg.n_bins)
    x = rng.normal(size=(2, 5, 7, 32)).astype(np.float32)
    j_prev, j_centers = jzoe.seed_bin_regressor(p, jnp.asarray(x), cfg)
    with torch.inference_mode():
        prev, centers = zoe.seed_bin_regressor(_net(p), _nchw(x), cfg)
    _close(_nhwc(prev), j_prev)
    _close(_nhwc(centers), j_centers)


@pytest.mark.parametrize("kind,attractor_type,n", [
    ("softplus", "inv", 16), ("softplus", "exp", 4), ("normed", "inv", 8)])
def test_attractor_layer(kind, attractor_type, n):
    cfg = jzoe.ZoeDepthConfig(bin_centers_type=kind,
                              attractor_type=attractor_type)
    rng = np.random.default_rng(1)
    e = cfg.bin_embedding_dim
    p = _rand_mlp(rng, e, 128, 2 * n if kind == "normed" else n)
    x = rng.normal(size=(2, 10, 14, e)).astype(np.float32)
    b_prev = rng.uniform(0.0, 1.0, size=(2, 5, 7, cfg.n_bins)).astype(np.float32)
    prev_emb = rng.normal(size=(2, 5, 7, e)).astype(np.float32)
    j_new, j_centers = jzoe.attractor_layer(p, jnp.asarray(x), jnp.asarray(b_prev),
                                            jnp.asarray(prev_emb), cfg)
    with torch.inference_mode():
        new, centers = zoe.attractor_layer(_net(p), _nchw(x), _nchw(b_prev),
                                           _nchw(prev_emb), cfg)
    _close(_nhwc(new), j_new)
    _close(_nhwc(centers), j_centers)


def test_conditional_log_binomial():
    cfg = jzoe.ZoeDepthConfig()
    rng = np.random.default_rng(2)
    cin = cfg.midas_out_channels + 1 + cfg.bin_embedding_dim
    p = _rand_mlp(rng, cin, cin // 2, 4)
    x = rng.normal(size=(2, 9, 11, cfg.midas_out_channels + 1)).astype(np.float32)
    cond = rng.normal(size=(2, 9, 11, cfg.bin_embedding_dim)).astype(np.float32)
    theirs = jzoe.conditional_log_binomial(p, jnp.asarray(x), jnp.asarray(cond), cfg)
    with torch.inference_mode():
        ours = zoe.conditional_log_binomial(
            _net(p, zoe.ConditionalLogBinomial), _nchw(x), _nchw(cond), cfg)
    _close(_nhwc(ours), theirs)
    np.testing.assert_allclose(ours.sum(1).numpy(), 1.0, atol=1e-5)


@functools.partial(jax.jit, static_argnums=1)
def _jit_metric_init(key, encoder):
    """The JAX loader's random metric tree for an encoder."""
    k1, k2 = jax.random.split(key)
    features = {"vits": 64, "vitb": 128, "vitl": 256}[encoder]
    cfg = jvit.VIT_CONFIGS[encoder]
    return {"core": {"vit": jvit.init_params(k1, cfg),
                     "dpt": jdpt.init_params(k2, cfg.embed_dim, features=features)},
            "head": jzoe.init_head_params(k2, features)}


@pytest.fixture(scope="module")
def metric_pair():
    params = _jit_metric_init(jax.random.key(0), "vits")
    sd = metric_depth_anything_state_dict(jax.tree.map(np.asarray, params))
    return params, metric_depth_anything_from_state_dict(sd, vit.VIT_CONFIGS["vits"])


_jit_infer = jax.jit(jzoe.metric_depth_anything_infer,
                     static_argnames=("encoder", "img_size"))


def test_bins_head(metric_pair):
    params, model = metric_pair
    rng = np.random.default_rng(3)
    # the core's feature shapes at 9 x 12 patches, features 64
    shapes = {"l4_rn": (5, 6, 64), "r4": (9, 12, 64), "r3": (18, 24, 64),
              "r2": (36, 48, 64), "r1": (72, 96, 64), "out_conv": (126, 168, 32)}
    feats = {k: rng.normal(size=(2, *s)).astype(np.float32) for k, s in shapes.items()}
    rel = rng.uniform(0.0, 2.0, size=(2, 126, 168)).astype(np.float32)
    theirs = jzoe.bins_head(params["head"], jnp.asarray(rel),
                            {k: jnp.asarray(v) for k, v in feats.items()})
    with torch.inference_mode():
        ours = zoe.bins_head(model, torch.from_numpy(rel),
                             {k: _nchw(v) for k, v in feats.items()})
    _close(ours, theirs)


def test_metric_infer_vits(metric_pair):
    params, model = metric_pair
    frames = np.random.default_rng(4).integers(0, 256, size=(2, 48, 64, 3),
                                               dtype=np.uint8)
    theirs = _jit_infer(params, jnp.asarray(frames), encoder="vits", img_size=SIZE)
    with torch.inference_mode():
        ours = zoe.metric_depth_anything_infer(model, torch.from_numpy(frames),
                                               img_size=SIZE)
    assert ours.dtype == torch.float32
    _close(ours, theirs)


def test_bf16_core_runs_the_head_in_f32(metric_pair):
    _params, model = metric_pair
    frames = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, size=(2, 48, 64, 3), dtype=np.uint8))
    with torch.inference_mode():
        f32 = zoe.metric_depth_anything_infer(model, frames, img_size=SIZE)
    half = zoe.build(vit.VIT_CONFIGS["vits"], 64)
    half.load_state_dict(model.state_dict())
    half.cast_core(torch.bfloat16)
    head = [p for n, p in half.named_parameters() if not n.startswith("core.")]
    core = [p for n, p in half.named_parameters() if n.startswith("core.")]
    assert head and all(p.dtype == torch.float32 for p in head)
    assert all(p.dtype == torch.bfloat16 for p in core)
    with torch.inference_mode():
        ours = zoe.metric_depth_anything_infer(half, frames, img_size=SIZE,
                                               compute_dtype=torch.bfloat16)
        # the head takes bf16 features as their f32 values: equal outputs
        img = torch.randn(1, 3, *SIZE, generator=torch.Generator().manual_seed(0))
        core_m = half.core.core
        feats = vit.get_intermediate_layers(core_m.pretrained,
                                            img.to(torch.bfloat16), n=4)
        rel, cf = dpt.dpt_head(core_m.depth_head, feats, 9, 12,
                               return_features=True)
        assert all(v.dtype == torch.bfloat16 for v in cf.values())
        a = zoe.bins_head(half, rel, cf)
        b = zoe.bins_head(half, rel.float(), {k: v.float() for k, v in cf.items()})
    assert a.dtype == torch.float32 and torch.equal(a, b)
    assert ours.dtype == torch.float32 and bool(torch.isfinite(ours).all())
    # bf16 through the core only: the metric depth stays near the f32 one
    assert float((ours - f32).abs().max()) < 0.05 * float(f32.abs().max())


def test_dpt_head_return_features():
    jparams = jax.jit(lambda k: jdpt.init_params(k, 64, features=32))(
        jax.random.key(1))
    rng = np.random.default_rng(6)
    ph, pw = 9, 12
    feats = [(rng.normal(size=(2, ph * pw, 64)).astype(np.float32),
              rng.normal(size=(2, 64)).astype(np.float32)) for _ in range(4)]
    j_out, j_feats = jdpt.dpt_head(jparams, [(jnp.asarray(t), jnp.asarray(c))
                                             for t, c in feats], ph, pw,
                                   return_features=True)
    head = dpt.DPTHead(64, 32)
    head.load_state_dict(dpt_head_state_dict(jax.tree.map(np.asarray, jparams)))
    with torch.inference_mode():
        out, ours = dpt.dpt_head(head, [(torch.from_numpy(t), torch.from_numpy(c))
                                        for t, c in feats], ph, pw,
                                 return_features=True)
        plain = dpt.dpt_head(head, [(torch.from_numpy(t), torch.from_numpy(c))
                                    for t, c in feats], ph, pw)
    assert torch.equal(out, plain)
    _close(out, j_out)
    assert set(ours) == set(j_feats) == {"out_conv", "l4_rn", "r4", "r3", "r2", "r1"}
    for k, v in ours.items():
        _close(_nhwc(v), j_feats[k])
