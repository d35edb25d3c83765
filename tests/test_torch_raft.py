"""The port's RAFT against the JAX package's, on the CPU.

Both run the JAX package's random init (jax.random), carried to the port with
`from_jax.raft_state_dict` and loaded with strict=True, in f32 on the same
numpy-seeded inputs, at the full widths (256-channel fnet, 128 + 128 cnet,
the 324-channel four-level lookup). The JAX side is jitted and runs its
`corr_impl="volume"` lookup; the port runs the kernels' plain versions (K4
for fnet's norms, K5 for the lookup). The O(HW)-memory `corr_impl="fused"`
lookup is held to JAX's and to the port's volume path. Also: the weight
round trip through
`convert_raft`, strict loads of a synthetic `raft-sintel.pth` with
DataParallel prefixes, and the seeded random init.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prisma_tpu.models import raft as jraft
from prisma_tpu.weights.torch_convert import convert_checked, convert_raft
from prisma_tpu_torch.models import raft
from prisma_tpu_torch.runtime.config import RuntimeConfig
from prisma_tpu_torch.weights import store
from prisma_tpu_torch.weights.from_jax import raft_state_dict

# f32 on both sides, sums in another order: the flows (up to ~18 px here)
# agree to ~1.5e-5 px after 4 iterations; the bar is about 6e-6 of the flow
# scale, the JAX package's own RAFT bar of 1e-5 relative
FLOW_ATOL = 1e-4
# the JAX default GRU re-associates the context contraction (gru_impl
# "fused"); tests/test_raft_parity.py holds it to the reference form at 1e-3
FUSED_ATOL = 1e-3


@functools.lru_cache(maxsize=None)
def _jax_params():
    return jax.tree.map(np.asarray, jax.jit(jraft.init_params)(jax.random.key(1)))


@pytest.fixture(scope="module")
def models():
    params = _jax_params()
    model = raft.build()
    model.load_state_dict(raft_state_dict(params), strict=True)
    return params, model


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _images(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 255, shape).astype(np.float32),
            rng.uniform(0, 255, shape).astype(np.float32))


@pytest.mark.parametrize("name,kind", [("fnet", "instance"), ("cnet", "affine")])
def test_encoder_matches_jax(models, name, kind):
    params, model = models
    x = np.random.default_rng(0).uniform(-1, 1, (2, 64, 96, 3)).astype(np.float32)
    theirs = jax.jit(functools.partial(jraft.encoder_forward, kind=kind))(
        params[name], jnp.asarray(x))
    with torch.inference_mode():
        ours = raft.encoder_forward(getattr(model, name), _nchw(x))
    assert ours.shape == (2, 256, 8, 12)
    np.testing.assert_allclose(ours.numpy().transpose(0, 2, 3, 1),
                               np.asarray(theirs), atol=1e-4, rtol=1e-4)


def test_corr_pyramid_matches_jax_on_ragged_sizes():
    """41x57 features pool to 20x28, 10x14 and 5x7 (odd rows and columns
    dropped); C = 32, so the folded 1/sqrt(C) is not a power of two and the
    two sides part by an f32 rounding."""
    rng = np.random.default_rng(7)
    f1, f2 = (rng.normal(size=(2, 41, 57, 32)).astype(np.float32) for _ in range(2))
    theirs = jraft.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4,
                                      precision="highest")
    ours = raft.build_corr_pyramid(_nchw(f1), _nchw(f2), 4)
    assert [tuple(v.shape) for v in ours] == [(2 * 41 * 57, 41, 57),
                                              (2 * 41 * 57, 20, 28),
                                              (2 * 41 * 57, 10, 14),
                                              (2 * 41 * 57, 5, 7)]
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, rtol=1e-5)


def test_corr_lookup_matches_jax():
    rng = np.random.default_rng(8)
    B, H, W = 2, 12, 20
    f1, f2 = (rng.normal(size=(B, H, W, 64)).astype(np.float32) for _ in range(2))
    coords = rng.uniform(-6, 26, (B, H, W, 2)).astype(np.float32)
    jp = jraft.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4,
                                  precision="highest")
    theirs = jraft.corr_lookup(jp, jnp.asarray(coords), 4)
    ours = raft.corr_lookup(raft.build_corr_pyramid(_nchw(f1), _nchw(f2), 4),
                            torch.from_numpy(coords), 4)
    assert ours.shape == (B, H, W, 324)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=2e-5)


def test_fmap_pyramid_matches_jax_on_ragged_sizes():
    """The fused lookup's pyramid: 41x57 fmaps pool to 20x28, 10x14 and 5x7,
    each odd row and column cropped first; a 6x9 map pools to 0x1 at level
    3 (an empty level)."""
    rng = np.random.default_rng(9)
    for h, w in ((41, 57), (6, 9)):
        f2 = rng.normal(size=(2, h, w, 16)).astype(np.float32)
        theirs = jraft.build_fmap_pyramid(jnp.asarray(f2), 4)
        ours = raft.build_fmap_pyramid(torch.from_numpy(f2), 4)
        assert [tuple(v.shape) for v in ours] == [v.shape for v in theirs]
        for a, b in zip(ours, theirs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("hw", [(12, 20), (6, 9)])
def test_corr_lookup_fused_matches_jax_and_the_volume(hw):
    """The fused lookup at C = 256 (the folded 1/sqrt(C) exact): against
    JAX's `corr_lookup_fused` and against the port's volume path (the
    pyramid of volumes and K5's plain version), windows with x on the slow
    axis, centres off every edge; 6x9 has an empty level 3 (zeros on all
    three sides)."""
    rng = np.random.default_rng(10)
    H, W = hw
    f1, f2 = (rng.normal(size=(2, H, W, 256)).astype(np.float32)
              for _ in range(2))
    coords = rng.uniform(-6, W + 6, (2, H, W, 2)).astype(np.float32)
    theirs = np.asarray(jax.jit(functools.partial(
        jraft.corr_lookup_fused, radius=4, precision="highest"))(
        jnp.asarray(f1), jraft.build_fmap_pyramid(jnp.asarray(f2), 4),
        jnp.asarray(coords)))
    ours = raft.corr_lookup_fused(
        torch.from_numpy(f1), raft.build_fmap_pyramid(torch.from_numpy(f2), 4),
        torch.from_numpy(coords), 4)
    assert ours.shape == (2, H, W, 324) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), theirs, atol=2e-5)
    volume = raft.corr_lookup(raft.build_corr_pyramid(_nchw(f1), _nchw(f2), 4),
                              torch.from_numpy(coords), 4)
    np.testing.assert_allclose(ours.numpy(), volume.numpy(), atol=2e-5)
    assert float(np.abs(theirs[..., :81]).max()) > 1.0


def test_forward_fused_matches_jax_and_the_volume_path(models):
    """forward with corr_impl="fused" at 64x96, 4 iterations: against JAX's
    fused forward (reference GRU form) and the port's volume path, within
    f32 rounding (FLOW_ATOL). Every other JAX corr_impl name runs the volume
    path; an unknown name raises."""
    params, model = models
    a, b = _images(3, (2, 64, 96, 3))
    jl, ju = jax.jit(functools.partial(jraft.forward, iters=4,
                                       gru_impl="reference",
                                       corr_impl="fused"))(
        params, jnp.asarray(a), jnp.asarray(b))
    with torch.inference_mode():
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        low, up = raft.forward(model, ta, tb, iters=4, corr_impl="fused")
        vlow, vup = raft.forward(model, ta, tb, iters=4)
        gk = raft.forward(model, ta, tb, iters=4, corr_impl="volume_gk")[1]
    assert float(np.abs(np.asarray(ju)).max()) > 1.0
    np.testing.assert_allclose(low.numpy(), np.asarray(jl), atol=FLOW_ATOL)
    np.testing.assert_allclose(up.numpy(), np.asarray(ju), atol=FLOW_ATOL)
    np.testing.assert_allclose(up.numpy(), vup.numpy(), atol=FLOW_ATOL)
    assert torch.equal(gk, vup)
    with pytest.raises(ValueError, match="corr_impl"):
        raft.forward(model, ta, tb, iters=1, corr_impl="alt_cuda_corr")


@pytest.mark.parametrize("gru_impl,atol", [("reference", FLOW_ATOL),
                                           ("fused", FUSED_ATOL)])
def test_forward_matches_jax(models, gru_impl, atol):
    """forward at 64x96 with 4 iterations, 2 pairs, against the JAX
    reference GRU form (tight) and its default fused form (1e-3)."""
    params, model = models
    a, b = _images(1, (2, 64, 96, 3))
    jl, ju = jax.jit(functools.partial(jraft.forward, iters=4, gru_impl=gru_impl))(
        params, jnp.asarray(a), jnp.asarray(b))
    with torch.inference_mode():
        low, up = raft.forward(model, torch.from_numpy(a), torch.from_numpy(b),
                               iters=4)
    assert low.shape == (2, 8, 12, 2) and up.shape == (2, 64, 96, 2)
    assert up.dtype == torch.float32
    assert float(np.abs(np.asarray(ju)).max()) > 1.0  # the flow has moved
    np.testing.assert_allclose(low.numpy(), np.asarray(jl), atol=atol)
    np.testing.assert_allclose(up.numpy(), np.asarray(ju), atol=atol)


def test_infer_pairs_pads_and_matches_jax(models):
    """infer_pairs at 60x90: centred replicate padding to 64x96 and back,
    the doubled batch with fnet run once over its images."""
    params, model = models
    a, b = _images(2, (2, 60, 90, 3))
    jf, jb = jax.jit(functools.partial(jraft.infer_pairs, iters=4,
                                       gru_impl="reference"))(
        params, jnp.asarray(a), jnp.asarray(b))
    with torch.inference_mode():
        f, bw = raft.infer_pairs(model, torch.from_numpy(a), torch.from_numpy(b),
                                 iters=4)
    assert f.shape == bw.shape == (2, 60, 90, 2)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=FLOW_ATOL)
    np.testing.assert_allclose(bw.numpy(), np.asarray(jb), atol=FLOW_ATOL)


# ------------------------------------------------------------------ weights

def test_state_dict_is_the_reference_checkpoints(models):
    _, model = models
    keys = set(model.state_dict())
    for k in ("fnet.conv1.weight", "fnet.layer2.0.downsample.0.bias",
              "cnet.norm1.running_var", "cnet.layer1.0.norm2.weight",
              "cnet.layer2.0.norm3.running_mean",
              "cnet.layer2.0.downsample.1.running_mean",
              "cnet.layer3.0.downsample.1.num_batches_tracked",
              "update_block.encoder.convc1.weight",
              "update_block.gru.convq2.bias",
              "update_block.flow_head.conv2.weight",
              "update_block.mask.0.weight", "update_block.mask.2.bias"):
        assert k in keys, k
    assert not any(k.startswith("fnet.") and "norm" in k for k in keys)
    assert not any("layer1.0.downsample" in k or "layer1.0.norm3" in k
                   for k in keys)


def test_convert_then_from_jax_round_trip(models):
    """convert_raft(raft_state_dict(p)) gives p back: exactly for the convs,
    within an ulp for cnet's folded batch norms (the unfolded variance is
    1 - eps, and (1 - eps) + eps rounds in f32); every key is consumed."""
    params, _ = models
    sd = raft_state_dict(params)
    back = convert_checked(convert_raft,
                           {"module." + k: v.numpy() for k, v in sd.items()})
    pairs = zip(jax.tree_util.tree_leaves_with_path(params),
                jax.tree_util.tree_leaves_with_path(back))
    for (path, a), (path_b, b) in pairs:
        assert path == path_b
        np.testing.assert_allclose(np.asarray(b), a, rtol=1.2e-7, atol=0,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("layout", ["module", "raw"])
def test_checkpoint_file_loads_strictly(tmp_path, models, layout):
    """raft-sintel.pth is a DataParallel state_dict (`module.` keys); a
    bare one loads too. A missing key fails the strict load."""
    _, model = models
    sd = model.state_dict()
    payload = ({"module." + k: v for k, v in sd.items()} if layout == "module"
               else sd)
    torch.save(payload, tmp_path / "raft-sintel.pth")
    runtime = RuntimeConfig(models_dir=str(tmp_path), device="cpu")
    loaded = store.load_raft(runtime)
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, sd[k]), k
    del payload[next(k for k in payload if k.endswith("convc1.bias"))]
    torch.save(payload, tmp_path / "raft-sintel.pth")
    with pytest.raises(RuntimeError, match="Missing key"):
        store.load_raft(runtime)


def test_random_init_is_seeded_and_missing_file_raises(tmp_path):
    runtime = RuntimeConfig(random_weights=True, device="cpu")
    a = store.load_raft(runtime).state_dict()
    b = store.load_raft(runtime).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["update_block.gru.convz1.weight"]
    assert float(w.std()) == pytest.approx((384 * 5) ** -0.5, rel=0.05)
    assert float(a["cnet.norm1.running_var"][0]) == pytest.approx(1 - 1e-5)
    with pytest.raises(FileNotFoundError):
        store.load_raft(RuntimeConfig(models_dir=str(tmp_path), device="cpu"))
