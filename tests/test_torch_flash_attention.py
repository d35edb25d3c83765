"""K1, K2 and K3: the port's attention kernels against the JAX package's.

On the CPU each wrapper takes its plain version, which is held against the
Pallas kernels in interpret mode and against the JAX package's dense and
scan forms, on the cases of tests/test_flash_attention.py: K1 (no bias), K2
(GMFlow's shifted-window region bias, from bands or ids) and K3 (streamed
global attention with f32 values). CPU emulations of the kernels' tile
arithmetic show that the card checks' bounds pass a right kernel and catch
a plausible fault. The card-only tests hold the CUDA kernels against the
plain versions on the card; run them on a machine with a card with
`python -m pytest --noconftest -m cuda tests/test_torch_flash_attention.py`
(this file imports JAX only inside the CPU tests).
"""

import math

import numpy as np
import pytest
import torch

from prisma_tpu_torch.ops.cuda.flash_attention import (
    bf16_bounds, flash_attention, flash_attention_ref,
    flash_attention_streamed, flash_attention_streamed_ref, streamed_bounds)

# f32 on both sides: the two differ only in summation order (2e-5, the bar
# of tests/test_flash_attention.py)
ATOL_F32 = 2e-5


def assert_bf16_close(out, ref):
    err = (out.float() - ref.float()).abs()
    max_tol, mean_tol = bf16_bounds(ref)
    assert float(err.max()) <= max_tol, (float(err.max()), max_tol)
    assert float(err.mean()) <= mean_tol, (float(err.mean()), mean_tol)


# keys per tile of the bf16 kernel (TK in csrc/flash_attention.cu)
BLOCK_K = 128
PENALTY_LOG2 = 100.0 * math.log2(math.e)


def emulate_bf16_kernel(q, k, v, codes=None, mask_tail=True, block_k=BLOCK_K):
    """The bf16 kernel's arithmetic on the CPU: 128-key tiles, an online
    softmax in the exp2 domain with f32 state, the region penalty (K2:
    `codes` [B, N], the region code of each token) subtracted from the scaled
    f32 score where a query's and a key's codes differ, P rounded to bf16 for
    P·V and the f32 P summed into the denominator, each thread's 32 columns
    of a row apart and the row's four threads joined at the end.
    mask_tail=False lets the zero-filled keys of a ragged last tile in (code
    0), as a kernel that forgot the mask would."""
    B, N, d = q.shape
    scale_log2 = math.log2(math.e) / math.sqrt(d)
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((B, N, 1), -math.inf)
    l = torch.zeros(B, N, 4)  # a row's four threads: columns 8c + 2t, 8c + 2t + 1
    acc = torch.zeros(B, N, d)
    for k0 in range(0, N, block_k):
        kt, vt = kf[:, k0:k0 + block_k], vf[:, k0:k0 + block_k]
        pad = block_k - kt.shape[1]
        if not mask_tail:
            kt, vt = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (kt, vt))
        s = torch.bmm(qf, kt.transpose(1, 2)) * scale_log2
        if codes is not None:
            kc = codes[:, k0:k0 + block_k]
            if not mask_tail:
                kc = torch.nn.functional.pad(kc, (0, pad))
            s = s - (codes[:, :, None] != kc[:, None, :]).float() * PENALTY_LOG2
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        cols = p.shape[-1]
        part = torch.nn.functional.pad(p, (0, (-cols) % 8)).view(B, N, -1, 4, 2)
        l = l * alpha + part.sum(dim=(2, 4))
        acc = acc * alpha + torch.bmm(p.to(torch.bfloat16).float(), vt)
        m = m_new
    return (acc / l.sum(dim=-1, keepdim=True)).to(torch.bfloat16)

CASES = [
    # (seed, B, N, d, q is k is v, Pallas block sizes)
    (0, 3, 512, 64, False, dict(block_q=128, block_k=128)),
    (1, 2, 100, 32, True, dict(block_q=128, block_k=128)),  # ragged N
    (3, 2, 2443, 64, False, {}),  # ViT-L 1080p rows, default blocks
]


def _inputs(seed, B, N, d, shared):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, N, d)).astype(np.float32)
    if shared:
        return q, q, q
    return (q, rng.normal(size=(B, N, d)).astype(np.float32),
            rng.normal(size=(B, N, d)).astype(np.float32))


@pytest.mark.parametrize("seed,B,N,d,shared,blocks", CASES,
                         ids=["512", "ragged100", "vitl2443"])
def test_plain_matches_pallas_and_xla(seed, B, N, d, shared, blocks):
    import jax.numpy as jnp

    from prisma_tpu.ops.pallas.flash_attention import (_xla_attention,
                                                       flash_attention as pallas)
    q, k, v = _inputs(seed, B, N, d, shared)
    ours = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v)).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    kernel = np.asarray(pallas(jq, jk, jv, interpret=True, **blocks))
    dense = np.asarray(_xla_attention(jq, jk, jv, d ** -0.5))
    assert ours.shape == (B, N, d)
    np.testing.assert_allclose(ours, kernel, atol=ATOL_F32)
    np.testing.assert_allclose(ours, dense, atol=ATOL_F32)


def test_plain_round_p_is_plain_in_f32():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 2, 100, 32, False))
    torch.testing.assert_close(flash_attention_ref(q, k, v, round_p=True),
                               flash_attention_ref(q, k, v), rtol=0,
                               atol=ATOL_F32)


@pytest.mark.parametrize("B,N,d", [(2, 2443, 64), (6, 100, 32), (6, 100, 64)],
                         ids=["vitl2443", "ragged100d32", "ragged100d64"])
def test_bf16_bounds_pass_the_kernel_arithmetic_and_catch_an_unmasked_tail(
        B, N, d):
    """The card test's bf16 bounds have the power to see a fault: the
    kernel's arithmetic, emulated, passes them; the same arithmetic with the
    ragged last key tile unmasked (2443 = 19 x 128 + 11) fails them."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(4, B, N, d, False))
    ref = flash_attention_ref(q, k, v, round_p=True)
    assert_bf16_close(emulate_bf16_kernel(q, k, v), ref)
    with pytest.raises(AssertionError):
        assert_bf16_close(emulate_bf16_kernel(q, k, v, mask_tail=False), ref)


def test_cpu_wrapper_takes_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 100, 32, False))
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    assert flash_attention.launches == before
    torch.testing.assert_close(out, flash_attention_ref(q, k, v), rtol=0,
                               atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,d,dtype", [
    (128, 2443, 64, torch.bfloat16),  # the ViT-L 1080p batch-8 shape
    (6, 100, 32, torch.float32),      # ragged, the f32 FMA path
    (6, 100, 32, torch.bfloat16),     # ragged, the bf16 d=32 instance (64-byte swizzle)
    (4, 1024, 128, torch.bfloat16),
    # the 128-row tiles at d=128 (two 64-column swizzle atoms): a key tile
    # of one row, a ragged single tile, one row short of a tile, one row
    # over (two tiles, the ring's barriers in their second phase), and the
    # GMFlow window length (35 x 128 + 110: an odd tile count)
    (3, 1, 128, torch.bfloat16),
    (3, 100, 128, torch.bfloat16),
    (3, 127, 128, torch.bfloat16),
    (3, 129, 128, torch.bfloat16),
    (3, 4590, 128, torch.bfloat16),
])
def test_kernel_matches_plain_on_card(B, N, d, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = (torch.from_numpy(a).to("cuda", dtype)
               for a in _inputs(0, B, N, d, False))
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    if dtype == torch.bfloat16:
        assert_bf16_close(out, flash_attention_ref(q, k, v, round_p=True))
    else:
        torch.testing.assert_close(out, flash_attention_ref(q, k, v), rtol=0,
                                   atol=ATOL_F32)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q = torch.zeros(2, 64, 48, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    q = torch.zeros(2, 64, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention(q, q, q)
    q = torch.zeros(6, 64, 64, device="cuda", dtype=torch.bfloat16)
    bands = torch.tensor([[51, 90]] * 4, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="multiple of nwin"):
        flash_attention(q, q, q, region_bands=bands, win_w=8)
    v = torch.zeros(6, 64, 2, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        flash_attention_streamed(q, q, v, 0.125)


# ------------------------------------------------------ K2: the region bias

def _bands_geometry(h, w, ns=2):
    """GMFlow's shifted-window bands and ids for an (h, w) feature map (the
    port's copy of the geometry: the card's machine has no JAX)."""
    from prisma_tpu_torch.models import gmflow as pgm
    return (pgm.shift_window_region_bands(h, w, ns),
            pgm.shift_window_region_ids(h, w, ns))


@pytest.mark.parametrize("hw", [(20, 24), (102, 180), (4, 12)])
def test_region_geometry_is_the_jax_packages(hw):
    from prisma_tpu.models import gmflow as jgm
    bands, ids = _bands_geometry(*hw)
    np.testing.assert_array_equal(bands, jgm.shift_window_region_bands(*hw, 2))
    np.testing.assert_array_equal(ids, jgm.shift_window_region_ids(*hw, 2))


def test_region_ids_mask():
    """ids labels: the plain version against the Pallas kernel (interpret)
    and `_xla_attention` (the cases of tests/test_flash_attention.py)."""
    import jax.numpy as jnp

    from prisma_tpu.ops.pallas.flash_attention import (_xla_attention,
                                                       flash_attention as pallas)
    rng = np.random.default_rng(2)
    B, N, d = 2, 300, 64
    q, k, v = (rng.normal(size=(B, N, d)).astype(np.float32) for _ in range(3))
    ids = rng.integers(0, 4, size=(B, N)).astype(np.int32)
    ours = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), ids=torch.from_numpy(ids))
    jq, jk, jv, jids = (jnp.asarray(a) for a in (q, k, v, ids))
    kernel = pallas(jq, jk, jv, ids=jids, block_q=128, block_k=128,
                    interpret=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(kernel), atol=ATOL_F32)
    np.testing.assert_allclose(
        ours.numpy(), np.asarray(_xla_attention(jq, jk, jv, d ** -0.5, ids=jids)),
        atol=ATOL_F32)


def test_region_bands_match_ids_path():
    """The bands form equals the ids form and the Pallas bands kernel
    (interpret) on real shift-window geometry, batch 3 x 4 windows."""
    import jax.numpy as jnp

    from prisma_tpu.ops.pallas.flash_attention import flash_attention as pallas
    rng = np.random.default_rng(5)
    h, w, ns, d = 20, 24, 2, 64
    bands, ids = _bands_geometry(h, w, ns)
    win, ww = (h // ns) * (w // ns), w // ns
    B = 3 * ns * ns
    q, k, v = (rng.normal(size=(B, win, d)).astype(np.float32) for _ in range(3))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    via_bands = flash_attention(tq, tk, tv, region_bands=torch.from_numpy(bands),
                                win_w=ww)
    idst = torch.from_numpy(np.tile(ids, (3, 1)).astype(np.int32))
    torch.testing.assert_close(via_bands, flash_attention(tq, tk, tv, ids=idst),
                               rtol=0, atol=ATOL_F32)
    kernel = pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    region_bands=jnp.asarray(bands), win_w=ww, block_q=128,
                    block_k=128, interpret=True)
    np.testing.assert_allclose(via_bands.numpy(), np.asarray(kernel),
                               atol=ATOL_F32)


def test_gmflow_window_attention_matches_xla():
    """The port's windowed attention (split, K2's plain version with bands,
    merge) against the JAX package's dense `_window_attention`, shifted."""
    import jax.numpy as jnp

    from prisma_tpu.models import gmflow as jgm
    from prisma_tpu_torch.models import gmflow as pgm
    rng = np.random.default_rng(3)
    B, h, w, C, ns = 2, 20, 24, 32, 2
    q, k, v = (rng.normal(size=(B, h * w, C)).astype(np.float32)
               for _ in range(3))
    ids = jgm.shift_window_region_ids(h, w, ns)
    theirs = jgm._window_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), h, w, ns, ids, impl="xla")
    split = [pgm._win_split(torch.from_numpy(a), h, w, ns, True)
             for a in (q, k, v)]
    out = pgm._window_attention_core(*split, pgm.region_bands(h, w, ns, "cpu"),
                                     w // ns)
    ours = pgm._win_merge(out, B, h, w, ns, True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=ATOL_F32)


def test_bf16_bounds_catch_a_band_shifted_by_one_row():
    """K2's card bounds have the power to see a misplaced band: the kernel's
    arithmetic, emulated on one sample of 4 shifted windows (26 x 45 tokens,
    the band structure of the 1080p windows at a quarter of their size),
    passes them against the plain version, and fails them against the plain
    version with bh one token row lower."""
    from prisma_tpu_torch.ops.cuda.flash_attention import region_codes
    h, w, ns = 52, 90, 2
    bands, _ = _bands_geometry(h, w, ns)
    n, ww = (h // ns) * (w // ns), w // ns
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.normal(size=(4, n, 128))
                                .astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    tb = torch.from_numpy(bands)
    out = emulate_bf16_kernel(q, k, v, codes=region_codes(4, n, tb, ww))
    assert_bf16_close(out, flash_attention_ref(q, k, v, region_bands=tb,
                                               win_w=ww, round_p=True))
    shifted = tb.clone()
    shifted[:, 0] += 1
    with pytest.raises(AssertionError):
        assert_bf16_close(out, flash_attention_ref(
            q, k, v, region_bands=shifted, win_w=ww, round_p=True))


def _main_path_case(kind):
    """(q, k, v, region kwargs of the plain version, codes for the emulation)
    at a main-path row shape: ViT-L [2, 2443, 64]; one 1080p GMFlow window
    row per band kind [4, 4590, 128] (the (102, 180) feature map's 2x2
    shifted windows: one without a boundary, one with a row band, one with a
    column band, one with both), from bands or from ids; a ragged d=32 case
    [6, 100, 32], bias-free or with random ids."""
    from prisma_tpu_torch.ops.cuda.flash_attention import region_codes
    shape = {"vitl": (2, 2443, 64), "bands": (4, 4590, 128),
             "ids": (4, 4590, 128), "ragged_d32": (6, 100, 32),
             "ragged_d32_ids": (6, 100, 32)}[kind]
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    B, N, _ = shape
    if kind == "bands":
        bands = torch.from_numpy(_bands_geometry(102, 180)[0])
        kw = dict(region_bands=bands, win_w=90)
        return q, k, v, kw, region_codes(B, N, bands, 90)
    if kind in ("ids", "ragged_d32_ids"):
        ids = (torch.from_numpy(_bands_geometry(102, 180)[1]) if kind == "ids"
               else torch.from_numpy(rng.integers(0, 4, size=(B, N)).astype(np.int32)))
        return q, k, v, dict(ids=ids), ids
    return q, k, v, {}, None


@pytest.mark.parametrize("kind", ["vitl", "bands", "ids", "ragged_d32",
                                  "ragged_d32_ids"])
def test_bf16_bounds_pass_the_hopper_tile_arithmetic(kind):
    """The bf16 kernel's tile arithmetic (128-key tiles, region codes, f32
    row sums per thread) at the main-path row shapes stays within
    `bf16_bounds` of the plain version with P rounded to bf16."""
    q, k, v, kw, codes = _main_path_case(kind)
    assert_bf16_close(emulate_bf16_kernel(q, k, v, codes=codes),
                      flash_attention_ref(q, k, v, round_p=True, **kw))


@pytest.mark.parametrize("kind,fault", [
    ("vitl", "unmasked_tail"),            # 2443 = 19 x 128 + 11: 117 zero keys
    ("ragged_d32", "unmasked_tail"),      # 100 of 128: 28 zero keys
    ("ragged_d32_ids", "unmasked_tail"),
    ("bands", "band_one_row_down"),       # bh + 1: 90 tokens change region
])
def test_bf16_bounds_catch_faults_at_the_hopper_tiles(kind, fault):
    """The same bounds fail the arithmetic of a kernel with a fault at the
    new tile size: the ragged last 128-key tile unmasked, or the bands moved
    down one token row."""
    q, k, v, kw, codes = _main_path_case(kind)
    if fault == "unmasked_tail":
        out = emulate_bf16_kernel(q, k, v, codes=codes, mask_tail=False)
        ref = flash_attention_ref(q, k, v, round_p=True, **kw)
    else:
        out = emulate_bf16_kernel(q, k, v, codes=codes)
        shifted = kw["region_bands"].clone()
        shifted[:, 0] += 1
        ref = flash_attention_ref(q, k, v, round_p=True, region_bands=shifted,
                                  win_w=kw["win_w"])
    with pytest.raises(AssertionError):
        assert_bf16_close(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("B,dtype,mode", [
    (8, torch.bfloat16, "bands"),  # 2 samples of the 1080p shifted windows
    (8, torch.bfloat16, "ids"),
    (4, torch.float32, "bands"),   # the f32 FMA path
    (56, torch.bfloat16, "bands"),  # the GMFlow step's batch: 14 x 4 windows
    (6, torch.bfloat16, "random_ids"),  # [6, 300, 64]: labels 0-3, a ragged tail
])
def test_region_kernel_matches_plain_on_card(B, dtype, mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    h, w, ns = 102, 180, 2
    bands, ids = _bands_geometry(h, w, ns)
    N, ww, d = ids.shape[1], w // ns, 128
    rng = np.random.default_rng(1)
    if mode == "random_ids":
        N, d = 300, 64
        ids = rng.integers(0, 4, size=(B, N)).astype(np.int32)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, N, d)).astype(np.float32))
               .to("cuda", dtype) for _ in range(3))
    kw = (dict(region_bands=torch.from_numpy(bands).cuda(), win_w=ww)
          if mode == "bands" else
          dict(ids=torch.from_numpy(np.tile(ids, (B // ids.shape[0], 1))).cuda()))
    before = flash_attention.region_launches
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.region_launches == before + 1
    if dtype == torch.bfloat16:
        assert_bf16_close(out, flash_attention_ref(q, k, v, round_p=True, **kw))
    else:
        torch.testing.assert_close(out, flash_attention_ref(q, k, v, **kw),
                                   rtol=0, atol=ATOL_F32)


# ------------------------------------------- K3: streamed global attention

def test_flash_streamed_matches_softmax():
    """Ragged N and M, N != M, coordinate-scale f32 values, custom scale:
    the plain version against the Pallas streamed kernel (interpret) and the
    explicit softmax (the case of tests/test_flash_attention.py, at the
    port's dv = 4; the Pallas kernel takes v padded to 128 lanes)."""
    import jax.numpy as jnp

    from prisma_tpu.ops.pallas.flash_attention import flash_attention_streamed as pallas
    rng = np.random.default_rng(7)
    B, N, M, d = 2, 300, 550, 32
    q = rng.normal(size=(B, N, d)).astype(np.float32)
    k = rng.normal(size=(B, M, d)).astype(np.float32)
    v = rng.uniform(0, 1440, size=(B, M, 4)).astype(np.float32)
    scale = 1.0 / d ** 0.5
    ours = flash_attention_streamed(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), scale)
    assert ours.dtype == torch.float32 and ours.shape == (B, N, 4)
    vp = np.concatenate([v, np.zeros((B, M, 124), np.float32)], axis=-1)
    kernel = pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(vp),
                    block_q=128, block_k=128, scale=scale, interpret=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(kernel)[..., :4],
                               rtol=2e-5, atol=2e-3)
    s = torch.from_numpy(q) @ torch.from_numpy(k).transpose(1, 2) * scale
    dense = torch.softmax(s.double(), -1) @ torch.from_numpy(v).double()
    np.testing.assert_allclose(ours.numpy(), dense.numpy(), rtol=2e-5,
                               atol=2e-3)


def test_gmflow_global_attend_matches_scan():
    """The port's `_global_attend` (K3's plain version on the CPU) against
    the JAX package's scan `_attn_blockwise` and its streamed-kernel route
    (interpret, the backend check forced), on the matching shapes."""
    import unittest.mock as mock

    import jax
    import jax.numpy as jnp

    from prisma_tpu.models import gmflow as jgm
    from prisma_tpu.ops.pallas import flash_attention as jfa
    from prisma_tpu_torch.models import gmflow as pgm
    rng = np.random.default_rng(11)
    B, N, C = 2, 210, 64
    q = rng.normal(size=(B, N, C)).astype(np.float32)
    k = rng.normal(size=(B, N, C)).astype(np.float32)
    scale = 1.0 / C ** 0.5
    grid = jgm._coords_grid_flat(14, 15)
    ours = pgm._global_attend(torch.from_numpy(q), torch.from_numpy(k),
                              pgm._coords_grid_flat(14, 15, "cpu"), scale)
    scan = jgm._attn_blockwise(jnp.asarray(q), jnp.asarray(k), grid, scale, 64)
    np.testing.assert_allclose(ours.numpy(), np.asarray(scan), rtol=1e-5,
                               atol=1e-4)
    real = jfa.flash_attention_streamed

    def interp(qq, kk, vv, **kw):
        kw.update(block_q=128, block_k=128, interpret=True)
        return real(qq, kk, vv, **kw)

    with mock.patch.object(jfa, "flash_attention_streamed", interp), \
         mock.patch.object(jax, "default_backend", lambda: "tpu"):
        kernel = jgm._global_attend(jnp.asarray(q), jnp.asarray(k), grid,
                                    scale, 2048, None)
    # the TPU route carries v as bf16 hi/lo halves: its own 5e-3 bar
    np.testing.assert_allclose(ours.numpy(), np.asarray(kernel), rtol=1e-4,
                               atol=5e-3)


# K3's tiles (csrc/flash_attention_streamed.cu): 128 keys a tile; in each
# 64-row block of a 256-query CTA a row's four threads own the columns 8c +
# 2t and 8c + 2t + 1 (t = 0..3) of every key tile
STREAMED_BLOCK_K = 128


def emulate_streamed_kernel(q, k, v, scale, mask_tail=True,
                            block_k=STREAMED_BLOCK_K, v_from_next_tile=None):
    """K3's arithmetic on the CPU: 128-key tiles; f32 scores and an online
    softmax in the exp2 domain, the row max taken on the raw scores and
    scaled once, p = 2^(s·scale·log2 e - m) (the scale folded before exp2);
    f32 unrounded P·V; each of a row's four threads keeps its own partial l
    = Σp and P·V over its columns, rescaled by the row's alpha, and the four
    are joined at the end.

    mask_tail=False lets the zero-filled keys of a ragged last tile in, as a
    kernel that forgot the mask would. v_from_next_tile=t gives key tile t
    the v rows of tile t + 1, as a ring whose v slot ran one tile ahead."""
    B, N, _ = q.shape
    M, dv = k.shape[1], v.shape[-1]
    if not mask_tail:
        pad = (-M) % block_k
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        M += pad
    scale_log2 = scale * math.log2(math.e)
    qf = q.float()
    m = torch.full((B, N, 1), -math.inf)
    l = torch.zeros(B, N, 4)
    acc = torch.zeros(B, N, 4, dv)
    for t, k0 in enumerate(range(0, M, block_k)):
        s = torch.bmm(qf, k[:, k0:k0 + block_k].float().transpose(1, 2))
        v0 = k0 + block_k if t == v_from_next_tile else k0
        vt = v[:, v0:v0 + s.shape[-1]]
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True) * scale_log2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * scale_log2 - m_new)
        cols = p.shape[-1]
        pad = (-cols) % 8
        pq = torch.nn.functional.pad(p, (0, pad)).view(B, N, -1, 4, 2)
        vq = torch.nn.functional.pad(vt, (0, 0, 0, pad)).view(B, -1, 4, 2, dv)
        l = l * alpha + pq.sum(dim=(2, 4))
        acc = acc * alpha[..., None] + torch.einsum("bncth,bcthe->bnte", pq, vq)
        m = m_new
    return acc.sum(dim=2) / l.sum(dim=2)[..., None]


def assert_streamed_close(out, ref, v):
    err = (out - ref).abs()
    max_tol, mean_tol = streamed_bounds(v)
    assert float(err.max()) <= max_tol, (float(err.max()), max_tol)
    assert float(err.mean()) <= mean_tol, (float(err.mean()), mean_tol)


def test_streamed_bounds_catch_an_unmasked_tail():
    """K3's card bounds have the power to see a fault: at the ragged M =
    18360 + 37 (a last tile of 93 keys), the kernel's arithmetic emulated
    on bf16 features passes them, and fails them with the tail unmasked."""
    rng = np.random.default_rng(4)
    M = 18360 + 37
    q, k = (torch.from_numpy(rng.normal(size=(1, n, 128)).astype(np.float32))
            .to(torch.bfloat16) for n in (48, M))
    v = torch.from_numpy(rng.uniform(0, 1440, size=(1, M, 2)).astype(np.float32))
    scale = 128 ** -0.5
    ref = flash_attention_streamed_ref(q, k, v, scale)
    assert_streamed_close(emulate_streamed_kernel(q, k, v, scale), ref, v)
    with pytest.raises(AssertionError):
        assert_streamed_close(emulate_streamed_kernel(q, k, v, scale,
                                                      mask_tail=False), ref, v)


def _peaked(rng, B, M, d, dv):
    """Keys a permutation of the queries times 4 (exact in bf16): each
    query's softmax is nearly one-hot on its own key, so out ~ v[j] with
    perm[j] = i. Returns q, k, v and that v."""
    q = torch.from_numpy(rng.normal(size=(B, M, d)).astype(np.float32)).to(torch.bfloat16)
    perm = rng.permutation(M)
    k = (q[:, perm].float() * 4).to(torch.bfloat16)
    v = torch.from_numpy(rng.uniform(0, 1440, size=(B, M, dv)).astype(np.float32))
    return q, k, v, v[:, np.argsort(perm)]


def test_streamed_bounds_see_a_v_tile_from_the_neighbouring_slot():
    """On peaked attention the card bounds see v taken from the wrong ring
    slot: the kernel's arithmetic passes them, and the same arithmetic with
    key tile 3 given tile 4's v rows fails them. (Near-uniform random scores
    average such a fault out of sight.)"""
    q, k, v, own = _peaked(np.random.default_rng(9), 1, 1024, 128, 2)
    scale = 128 ** -0.5
    ref = flash_attention_streamed_ref(q, k, v, scale)
    assert float((ref - own).abs().max()) < 0.1  # one-hot: each query's own v
    assert_streamed_close(emulate_streamed_kernel(q, k, v, scale), ref, v)
    with pytest.raises(AssertionError):
        assert_streamed_close(emulate_streamed_kernel(q, k, v, scale,
                                                      v_from_next_tile=3), ref, v)


def test_streamed_cpu_wrapper_takes_plain_version():
    rng = np.random.default_rng(1)
    q, k = (torch.from_numpy(rng.normal(size=(2, n, 32)).astype(np.float32))
            for n in (50, 70))
    v = torch.from_numpy(rng.uniform(0, 90, size=(2, 70, 2)).astype(np.float32))
    before = flash_attention_streamed.launches
    out = flash_attention_streamed(q, k, v, 0.2)
    assert flash_attention_streamed.launches == before
    torch.testing.assert_close(out, flash_attention_streamed_ref(q, k, v, 0.2),
                               rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,M,d,dv,dtype", [
    (2, 2000, 18360 + 37, 128, 2, torch.bfloat16),  # ragged matching keys
    (2, 300, 550, 32, 4, torch.float32),            # the f32 FMA path
    (1, 100, 130, 64, 1, torch.bfloat16),
])
def test_streamed_kernel_matches_plain_on_card(B, N, M, d, dv, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    q, k = (torch.from_numpy(rng.normal(size=(B, n, d)).astype(np.float32))
            .to("cuda", dtype) for n in (N, M))
    v = torch.from_numpy(rng.uniform(0, 1440, size=(B, M, dv))
                         .astype(np.float32)).cuda()
    scale = d ** -0.5
    before = flash_attention_streamed.launches
    out = flash_attention_streamed(q, k, v, scale)
    torch.cuda.synchronize()
    assert flash_attention_streamed.launches == before + 1
    assert_streamed_close(out, flash_attention_streamed_ref(q, k, v, scale), v)


def _streamed_on_card(B, N, M, d, dv, seed=0):
    rng = np.random.default_rng(seed)
    q, k = (torch.from_numpy(rng.normal(size=(B, n, d)).astype(np.float32))
            .to("cuda", torch.bfloat16) for n in (N, M))
    v = torch.from_numpy(rng.uniform(0, 1440, size=(B, M, dv))
                         .astype(np.float32)).cuda()
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("dv", [1, 2, 4])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("N", [1, 191, 193, 255, 257])
@pytest.mark.parametrize("M", [1, 127, 129, 18360 + 37])
def test_streamed_kernel_at_tile_edges_on_card(M, N, d, dv):
    """The bf16 kernel's tile edges: one key, one short of a 128-key tile and
    one over, the ragged matching key count; one query, and one either side
    of 192 and of the 256-query CTA; every head dim; dv 1, 2 (one 16-byte
    load for two keys) and 4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _streamed_on_card(2, N, M, d, dv)
    scale = d ** -0.5
    out = flash_attention_streamed(q, k, v, scale)
    assert_streamed_close(out, flash_attention_streamed_ref(q, k, v, scale), v)


@pytest.mark.cuda
def test_streamed_kernel_peaked_on_card():
    """Peaked attention on the card: the kernel passes the bounds; fed v
    shifted by one key tile it fails them, so the bounds would see a v slot
    out of step with its K slot."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, _ = (t.cuda() for t in _peaked(np.random.default_rng(9), 2, 4590, 128, 2))
    scale = 128 ** -0.5
    ref = flash_attention_streamed_ref(q, k, v, scale)
    assert_streamed_close(flash_attention_streamed(q, k, v, scale), ref, v)
    with pytest.raises(AssertionError):
        assert_streamed_close(flash_attention_streamed(
            q, k, v.roll(STREAMED_BLOCK_K, dims=1), scale), ref, v)


@pytest.mark.cuda
def test_streamed_kernel_rejects_a_scale_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = _streamed_on_card(1, 10, 20, 64, 2)
    for scale in (0.0, -0.125, math.inf):
        with pytest.raises(ValueError, match="scale"):
            flash_attention_streamed(q, k, v, scale)
