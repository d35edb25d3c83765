"""K1: the port's flash attention against the JAX package's Pallas kernel.

On the CPU the wrapper takes its plain version, which is held against the
Pallas kernel in interpret mode and against `_xla_attention` on the cases of
tests/test_flash_attention.py. The card-only test holds the CUDA kernel
against the plain version on the card; run it on a machine with a card with
`python -m pytest --noconftest -m cuda tests/test_torch_flash_attention.py`
(this file imports JAX only inside the CPU tests).
"""

import math

import numpy as np
import pytest
import torch

from prisma_tpu_torch.ops.cuda.flash_attention import (bf16_bounds,
                                                       flash_attention,
                                                       flash_attention_ref)

# f32 on both sides: the two differ only in summation order (2e-5, the bar
# of tests/test_flash_attention.py)
ATOL_F32 = 2e-5


def assert_bf16_close(out, ref):
    err = (out.float() - ref.float()).abs()
    max_tol, mean_tol = bf16_bounds(ref)
    assert float(err.max()) <= max_tol, (float(err.max()), max_tol)
    assert float(err.mean()) <= mean_tol, (float(err.mean()), mean_tol)


def emulate_bf16_kernel(q, k, v, mask_tail=True, block_k=64):
    """The bf16 kernel's arithmetic on the CPU: 64-key tiles, an online
    softmax in the exp2 domain with f32 state, P rounded to bf16 for P·V and
    the f32 P summed into the denominator. mask_tail=False lets the
    zero-filled keys of a ragged last tile in, as a kernel that forgot the
    mask would."""
    B, N, d = q.shape
    scale_log2 = math.log2(math.e) / math.sqrt(d)
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((B, N, 1), -math.inf)
    l = torch.zeros(B, N, 1)
    acc = torch.zeros(B, N, d)
    for k0 in range(0, N, block_k):
        kt, vt = kf[:, k0:k0 + block_k], vf[:, k0:k0 + block_k]
        if not mask_tail:
            pad = (0, 0, 0, block_k - kt.shape[1])
            kt, vt = torch.nn.functional.pad(kt, pad), torch.nn.functional.pad(vt, pad)
        s = torch.bmm(qf, kt.transpose(1, 2)) * scale_log2
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.bmm(p.to(torch.bfloat16).float(), vt)
        m = m_new
    return (acc / l).to(torch.bfloat16)

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
    ragged last key tile unmasked (2443 = 38 x 64 + 11) fails them."""
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
    (6, 100, 32, torch.bfloat16),     # ragged, the bf16 d=32 instance
    (4, 1024, 128, torch.bfloat16),
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
