"""K5: the port's RAFT window lookup against the JAX package's forms.

On the CPU the wrapper takes its plain version, which is held against the JAX
package's `_window_patch_lookup` (the XLA lookup of `corr_impl="volume"`),
against both TPU kernels run in interpret mode (`window_lookup` of
raft_lookup.py on the zero-padded volume, `window_lookup_gather` of
raft_window.py on the transposed one, as tests/test_raft_pallas_lookup.py
runs them) and, in bf16, against the JAX package's bf16 blend. Also: centres
far outside the plane or not finite give zero windows, an empty level gives
zeros, and K5's card bounds see each of three deliberate faults. The
card-only tests hold the CUDA kernel against the plain version on the card;
run them with `python -m pytest --noconftest -m cuda
tests/test_torch_raft_lookup.py`.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from prisma_tpu_torch.ops.cuda.raft_lookup import (bounds, clamped_centres,
                                                   window_lookup,
                                                   window_lookup_ref)
from prisma_tpu_torch.runtime.check_lookup import edge_centres

R = 4
# f32 on both sides; the JAX forms blend in another association (and the
# one-hot and interpret paths through f32 products): a few f32 ulps of the
# O(1) values
ATOL_F32 = 1e-6


def _case(seed, N, H, W, margin=8.0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    vol = rng.normal(size=(N, H, W)).astype(dtype)
    c = np.stack([rng.uniform(-margin, W + margin, N),
                  rng.uniform(-margin, H + margin, N)], -1).astype(np.float32)
    return vol, c


def _jax_patch(vol, c):
    import jax.numpy as jnp

    from prisma_tpu.models.raft import _window_patch_lookup
    return np.asarray(_window_patch_lookup(jnp.asarray(vol), jnp.asarray(c[:, 0]),
                                           jnp.asarray(c[:, 1]), R), np.float32)


@pytest.mark.parametrize("hw", [(13, 21), (17, 23), (6, 9), (1, 2)])
def test_plain_matches_window_patch_lookup(hw):
    vol, c = _case(0, 300, *hw)
    ours = window_lookup_ref([torch.from_numpy(vol)], torch.from_numpy(c))
    np.testing.assert_allclose(ours.numpy(), _jax_patch(vol, c), atol=ATOL_F32)


def _row_starts_mod8(hw, c):
    """The start offsets mod 8 (values in a 16-byte bf16 chunk) of the
    patch rows on the plane, for centres c at the scale of an [n, H, W]
    level."""
    H, W = hw
    x0, y0, _, _ = clamped_centres(torch.from_numpy(c), hw, R)
    ys = y0[:, None] - R + torch.arange(2 * R + 2)
    start = (torch.arange(len(c))[:, None] * H * W + ys * W + x0[:, None] - R) % 8
    return set(start[(ys >= 0) & (ys < H)].tolist())


@pytest.mark.parametrize("hw", [(23, 37), (7, 5), (9, 8), (3, 1)])
def test_plain_matches_window_patch_lookup_at_edges(hw):
    """Centres at every corner the clamp keeps (both edges of the plane, the
    tensor's first and last values) and patch rows at every start offset
    mod 8, on odd widths and widths under one 16-byte bf16 chunk: the layout
    that the kernel's chunked row loads must respect."""
    c = edge_centres(300, hw, seed=8).numpy()
    vol = np.random.default_rng(9).normal(size=(300, *hw)).astype(np.float32)
    assert _row_starts_mod8(hw, c) == set(range(8))
    ours = window_lookup_ref([torch.from_numpy(vol)], torch.from_numpy(c))
    np.testing.assert_allclose(ours.numpy(), _jax_patch(vol, c), atol=ATOL_F32)
    assert (ours[0] != 0).any() and (ours[-1] != 0).any()


@pytest.mark.parametrize("hw", [(13, 23), (51, 90), (17, 129), (102, 180)])
def test_plain_matches_both_tpu_kernels(hw):
    """K5a on the volume zero-padded by 2r+2, K5b on the transposed volume
    padded to Wp % 8 == 0 and Hp >= 16, both in interpret mode; 70 pixels
    (not a multiple of either kernel's block), centres up to 8 px outside."""
    import jax.numpy as jnp

    from prisma_tpu.ops.pallas.raft_lookup import window_lookup as k5a
    from prisma_tpu.ops.pallas.raft_window import window_lookup_gather as k5b
    H, W = hw
    vol, c = _case(3, 70, H, W)
    ours = window_lookup_ref([torch.from_numpy(vol)], torch.from_numpy(c)).numpy()
    cx, cy = jnp.asarray(c[:, 0]), jnp.asarray(c[:, 1])
    p = 2 * R + 2
    a = k5a(jnp.pad(jnp.asarray(vol), ((0, 0), (p, p), (p, p))), cx, cy, hw,
            r=R, interpret=True)
    Hp, Wp = max(16, H), max(16, -(-W // 8) * 8)
    volt = np.zeros((70, Wp, Hp), np.float32)
    volt[:, :W, :H] = vol.transpose(0, 2, 1)
    b = k5b(jnp.asarray(volt), cx, cy, hw, r=R, interpret=True)
    np.testing.assert_allclose(ours, np.asarray(a), atol=ATOL_F32)
    np.testing.assert_allclose(ours, np.asarray(b), atol=ATOL_F32)


def test_four_levels_match_jax_corr_lookup():
    """The four-level lookup over a ragged pyramid (41x57 -> 20x28 -> 10x14
    -> 5x7) against the JAX package's corr_lookup on the same volumes."""
    import jax.numpy as jnp

    from prisma_tpu.models import raft as jraft
    rng = np.random.default_rng(1)
    B, H, W = 2, 41, 57
    pyr = [rng.normal(size=(B * H * W, H >> i, W >> i)).astype(np.float32)
           for i in range(4)]
    coords = rng.uniform(-6, 62, (B, H, W, 2)).astype(np.float32)
    theirs = np.asarray(jraft.corr_lookup([jnp.asarray(v) for v in pyr],
                                          jnp.asarray(coords), R))
    ours = window_lookup_ref([torch.from_numpy(v) for v in pyr],
                             torch.from_numpy(coords.reshape(-1, 2)))
    assert ours.shape == (B * H * W, 4 * 81)
    np.testing.assert_allclose(ours.numpy().reshape(theirs.shape), theirs,
                               atol=ATOL_F32)


def test_bf16_against_the_jax_bf16_blend():
    """The JAX package blends bf16 patches with bf16 fractions, rounding
    every product; K5 and its plain version blend in f32 and cast once. The
    two part by the bf16 roundings of the weights and products: within 4
    bf16 ulp of max |ref| (4 rounded terms), and 2^-8 of mean |ref| in the
    mean. The plain version's bf16 blend (the null path of chip_smoke.py)
    mirrors the JAX one to within 1 ulp."""
    import jax.numpy as jnp

    from prisma_tpu.models.raft import _window_patch_lookup
    vol, c = _case(2, 500, 24, 40)
    vb = torch.from_numpy(vol).to(torch.bfloat16)
    theirs = np.asarray(_window_patch_lookup(
        jnp.asarray(vb.float().numpy(), jnp.bfloat16), jnp.asarray(c[:, 0]),
        jnp.asarray(c[:, 1]), R), np.float32)
    ours = window_lookup_ref([vb], torch.from_numpy(c))
    assert ours.dtype == torch.bfloat16
    ulp, _ = bounds(ours)
    err = np.abs(ours.float().numpy() - theirs)
    assert err.max() <= 4 * ulp, (err.max(), ulp)
    assert err.mean() <= 2 ** -8 * np.abs(theirs).mean()
    null = window_lookup_ref([vb], torch.from_numpy(c), blend_dtype=torch.bfloat16)
    assert np.abs(null.float().numpy() - theirs).max() <= ulp


def test_far_and_non_finite_centres_give_zero_windows():
    vol, c = _case(4, 12, 13, 21)
    c[:8] = [[1e6, 3.0], [-1e6, 3.0], [4.0, 1e6], [np.inf, 2.0],
             [-np.inf, -np.inf], [np.nan, 5.0], [5.0, np.nan], [3e38, -3e38]]
    out = window_lookup_ref([torch.from_numpy(vol)] * 2, torch.from_numpy(c))
    assert torch.isfinite(out).all()
    assert (out[:8] == 0).all()
    ref = _jax_patch(vol[8:], c[8:])
    np.testing.assert_allclose(out[8:, :81].numpy(), ref, atol=ATOL_F32)


def test_empty_level_gives_zeros():
    """Level 3 of a 6x9 feature map pools to 0x1 (the band's 64x96 clip):
    its windows are zero, as in the JAX package."""
    vol, c = _case(5, 20, 6, 9)
    empty = torch.zeros(20, 0, 1)
    out = window_lookup_ref([torch.from_numpy(vol), empty], torch.from_numpy(c))
    assert out.shape == (20, 162) and (out[:, 81:] == 0).all()


def _faults(vol, c):
    """The plain version with each deliberate fault of chip_smoke.py."""
    v, cc = torch.from_numpy(vol), torch.from_numpy(c)
    ref = window_lookup_ref([v, v], cc)
    y_slow = ref.reshape(-1, 2, 9, 9).transpose(2, 3).reshape(ref.shape)
    pad = 2 * R + 2
    vr = F.pad(v[:, None], (pad,) * 4, mode="replicate")[:, 0]
    clamped = torch.cat([window_lookup_ref([vr], cc / 2 ** level + pad)
                         for level in range(2)], dim=1)
    undivided = torch.cat([window_lookup_ref([v], cc)] * 2, dim=1)
    return ref, {"y-slow": y_slow, "clamped": clamped, "undivided": undivided}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bounds_see_each_fault(dtype):
    """K5's bounds against its plain version pass the plain version itself
    and fail each deliberate fault, on a two-level pyramid of one plane
    with centres near its edges."""
    vol, c = _case(6, 400, 12, 22, margin=3.0)
    vol = torch.from_numpy(vol).to(dtype).float().numpy()
    ref, faults = _faults(vol, c)
    ref = ref.to(dtype)
    max_tol, mean_tol = bounds(ref)
    for name, wrong in faults.items():
        err = (wrong.to(dtype).float() - ref.float()).abs()
        assert float(err.max()) > max_tol and float(err.mean()) > mean_tol, name


def test_cpu_wrapper_takes_plain_version():
    vol, c = _case(7, 50, 9, 11)
    before = window_lookup.launches
    out = window_lookup([torch.from_numpy(vol)], torch.from_numpy(c))
    assert window_lookup.launches == before
    torch.testing.assert_close(out, window_lookup_ref([torch.from_numpy(vol)],
                                                      torch.from_numpy(c)),
                               rtol=0, atol=0)


def _card_case(N, hws, dtype, seed=0):
    """N pixels (not a multiple of the kernel's 16-pixel group): the first
    half at centres up to 10 px off the plane, the rest at `edge_centres`
    (both edges, every row start mod 8, the tensor's last values); rows 1-6
    far off the plane or not finite."""
    rng = np.random.default_rng(seed)
    pyr = [torch.from_numpy(rng.normal(size=(N, h, w)).astype(np.float32))
           .to("cuda", dtype) for h, w in hws]
    H, W = hws[0]
    c = np.stack([rng.uniform(-10, W + 10, N), rng.uniform(-10, H + 10, N)], -1)
    c[N // 2:] = edge_centres(N - N // 2, hws[0], seed).numpy()
    c[1:7] = [[1e6, 1.0], [-1e6, 2.0], [np.inf, 0.0], [np.nan, 1.0],
              [2.0, -np.inf], [3e38, 3e38]]
    return pyr, torch.from_numpy(c.astype(np.float32)).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("hws,dtype", [
    (((102, 180), (51, 90), (25, 45), (12, 22)), torch.bfloat16),  # RAFT's levels
    (((41, 57), (20, 28), (10, 14), (5, 7)), torch.float32),        # ragged
    (((6, 9), (3, 4), (1, 2), (0, 1)), torch.bfloat16),             # an empty level
    (((13, 21),), torch.float32),                                   # one level
    (((23, 37), (11, 18), (5, 9), (2, 4)), torch.bfloat16),         # odd widths
    (((23, 37), (11, 18), (5, 9)), torch.float32),
    (((7, 5), (3, 2)), torch.bfloat16),                             # under one chunk
    (((9, 8),), torch.bfloat16),                                    # one chunk wide
    (((3, 1), (1, 1)), torch.float32),
])
def test_kernel_matches_plain_on_card(hws, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pyr, c = _card_case(1003, hws, dtype)
    before = window_lookup.launches
    out = window_lookup(pyr, c)
    torch.cuda.synchronize()
    assert window_lookup.launches == before + 1
    ref = window_lookup_ref(pyr, c)
    assert out.shape == ref.shape and out.dtype == dtype
    assert (out[1:7] == 0).all()
    err = (out.float() - ref.float()).abs()
    max_tol, mean_tol = bounds(ref)
    assert float(err.max()) <= max_tol and float(err.mean()) <= mean_tol
    assert torch.equal(out, ref)  # the same f32 blend in the same order


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    vol = torch.zeros(4, 5, 6, device="cuda")
    c = torch.zeros(4, 2, device="cuda")
    with pytest.raises(TypeError):
        window_lookup([vol.half()], c)
    with pytest.raises(ValueError, match="radius"):
        window_lookup([vol], c, r=3)
    with pytest.raises(ValueError, match="coords"):
        window_lookup([vol], c.double())
    with pytest.raises(ValueError, match="contiguous"):
        window_lookup([vol.transpose(1, 2)], c)
