"""The port's BEiT-L core and MiDaS decoder against the JAX package's, in
f32 on the CPU.

Weights are the JAX package's random init (narrow: 128 wide, 4 heads, 4
blocks; a decoder of 32 features), every leaf shifted by seeded noise so
that no bias is zero, carried across with `weights.from_jax`; inputs are
seeded with numpy. Tolerances: the relative position index equal; the
bias-table resample within 1e-6 (the same f32 matrices); the hooked tokens
and the decoder's depth and features within 1e-5 of each output's scale
(f32 on both sides, sums in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prisma_tpu.models import beit as jbeit
from prisma_tpu.models import dpt as jdpt
from prisma_tpu.models import midas as jmidas
from prisma_tpu_torch.models import beit, midas
from prisma_tpu_torch.weights.from_jax import (beit_state_dict,
                                               midas_decoder_state_dict)

RTOL = 1e-5
NARROW = dict(embed=128, heads=4, depth=4)
DECODER = dict(features=32, out_channels=(16, 32, 64, 64))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for the module, its module-scoped fixtures
    included: the suite runs in several worker processes at once, and each
    torch op spreading over every core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(ours, theirs, rtol=RTOL):
    theirs = np.asarray(theirs)
    assert ours.shape == theirs.shape, (ours.shape, theirs.shape)
    np.testing.assert_allclose(ours.detach().numpy(), theirs, rtol=0,
                               atol=rtol * np.abs(theirs).max())


def noisy(tree, seed):
    """Every leaf of a JAX tree (as numpy) plus N(0, 0.02) noise."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + 0.02 * rng.normal(
        size=np.shape(a))).astype(np.float32), tree)


def jax_decoder(key, embed, features, out_channels):
    """A MiDaS decoder tree of the given widths, as jmidas.init_params
    builds the 1024-wide one."""
    k1, k2 = jax.random.split(key)
    tree = jdpt.init_params(k1, embed, features=features,
                            out_channels=out_channels)
    for name in ("output_conv1", "output_conv2_0", "output_conv2_2"):
        tree.pop(name)
    keys = jax.random.split(k2, 7)

    def lin(k, din, dout):
        return {"w": jax.random.normal(k, (din, dout)) * din ** -0.5,
                "b": jnp.zeros((dout,))}

    def conv(k, kh, cin, cout):
        return {"w": jax.random.normal(k, (kh, kh, cin, cout))
                * (kh * kh * cin) ** -0.5, "b": jnp.zeros((cout,))}

    tree["readout"] = [lin(keys[i], 2 * embed, embed) for i in range(4)]
    tree["head0"] = conv(keys[4], 3, features, features // 2)
    tree["head2"] = conv(keys[5], 3, features // 2, 32)
    tree["head4"] = conv(keys[6], 1, 32, 1)
    return tree


def port_beit(params_np, embed, heads, depth):
    model = beit.BEiT(beit.BEiTConfig(embed_dim=embed, depth=depth,
                                      num_heads=heads))
    model.load_state_dict(beit_state_dict(params_np), strict=True)
    return model.eval()


@pytest.mark.parametrize("wh,ww", [(3, 3), (4, 6), (24, 32)])
def test_relative_position_index(wh, ww):
    ours = beit.relative_position_index(wh, ww)
    theirs = jbeit.relative_position_index(wh, ww)
    np.testing.assert_array_equal(ours, theirs)
    assert ours.max() == (2 * wh - 1) * (2 * ww - 1) + 2


@pytest.mark.parametrize("old,new", [((3, 3), (3, 3)), ((3, 3), (3, 5)),
                                     ((24, 24), (24, 32)), ((24, 24), (4, 6))])
def test_resize_rel_pos_table(old, new):
    n = (2 * old[0] - 1) * (2 * old[1] - 1) + 3
    table = np.random.default_rng(0).normal(size=(n, 4)).astype(np.float32)
    ours = beit.resize_rel_pos_table(torch.from_numpy(table), old, new)
    theirs = np.asarray(jbeit.resize_rel_pos_table(table, old, new))
    assert ours.shape[0] == (2 * new[0] - 1) * (2 * new[1] - 1) + 3
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ours[-3:].numpy(), table[-3:])  # cls rows
    if old == new:
        np.testing.assert_array_equal(ours.numpy(), table)


@pytest.fixture(scope="module")
def beit_pair():
    params = noisy(jbeit.init_params(jax.random.key(0), **NARROW), 1)
    return params, port_beit(params, **NARROW)


def test_hooked_layers(beit_pair):
    params, model = beit_pair
    x = np.random.default_rng(2).normal(size=(2, 64, 96, 3)).astype(np.float32)
    theirs = jax.jit(jbeit.get_intermediate_layers)(params, jnp.asarray(x))
    with torch.inference_mode():
        ours = beit.get_intermediate_layers(
            model, torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(ours) == len(theirs) == 4
    for (tok, cls), (jtok, jcls) in zip(ours, theirs):
        assert tok.shape == (2, 4 * 6, NARROW["embed"])
        _close(tok, jtok)
        _close(cls, jcls)


def test_bias_computed_once_per_grid(beit_pair):
    _params, model = beit_pair
    with torch.inference_mode():
        a = model.rel_pos_bias(4, 6)
        assert model.rel_pos_bias(4, 6) is a
        assert a[0].shape == (NARROW["heads"], 25, 25)
        assert a[0].dtype == torch.float32
    with torch.no_grad():
        model.blocks[1].attn.relative_position_bias_table.mul_(2.0)
    with torch.inference_mode():
        b = model.rel_pos_bias(4, 6)
        assert b is not a and torch.equal(b[1], 2 * a[1])
    with torch.no_grad():
        model.blocks[1].attn.relative_position_bias_table.mul_(0.5)


def test_midas_decoder_features():
    embed = NARROW["embed"]
    jparams = noisy(jax_decoder(jax.random.key(3), embed, **DECODER), 4)
    model = midas.MidasDPT(torch.nn.Identity(), embed, **DECODER)
    model.load_state_dict(midas_decoder_state_dict(jparams), strict=True)
    rng = np.random.default_rng(5)
    ph, pw = 4, 6
    feats = [(rng.normal(size=(2, ph * pw, embed)).astype(np.float32),
              rng.normal(size=(2, embed)).astype(np.float32)) for _ in range(4)]
    j_out, j_feats = jmidas.decoder_forward(
        jparams, [(jnp.asarray(t), jnp.asarray(c)) for t, c in feats],
        (2, ph, pw), return_features=True)
    with torch.inference_mode():
        out, ours = midas.decoder_forward(
            model, [(torch.from_numpy(t), torch.from_numpy(c)) for t, c in feats],
            ph, pw, return_features=True)
    assert out.shape == (2, 16 * ph, 16 * pw)
    _close(out, j_out)
    assert set(ours) == set(j_feats) == {"out_conv", "l4_rn", "r4", "r3",
                                         "r2", "r1"}
    for k, v in ours.items():
        _close(v.permute(0, 2, 3, 1), j_feats[k])
