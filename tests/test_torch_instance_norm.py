"""K4: the port's instance norm against the JAX package's.

On the CPU the wrapper takes its plain version, which is held against the
JAX package's XLA norm (`raft._instance_norm`) and its Pallas kernel in
interpret mode, on the cases of tests/test_instance_norm_kernel.py (the port
is NCHW, the JAX package NHWC). In bf16 the JAX XLA norm normalises in bf16
while K4 normalises in f32 and casts once, so bf16 is held to the Pallas
kernel, which computes as K4 does. The card-only tests hold the CUDA kernel
against the plain version on the card; run them on a machine with a card
with `python -m pytest --noconftest -m cuda tests/test_torch_instance_norm.py`.
"""

import numpy as np
import pytest
import torch

from prisma_tpu_torch.ops.cuda.instance_norm import (bounds,
                                                     instance_norm_relu,
                                                     instance_norm_relu_ref)

# f32 on both sides, sums in another order: the bar of the JAX tests
ATOL_F32 = 2e-5


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.float().numpy().transpose(0, 2, 3, 1)


def assert_within_bounds(out, ref):
    err = (out.float() - ref.float()).abs()
    max_tol, mean_tol = bounds(ref)
    assert float(err.max()) <= max_tol, (float(err.max()), max_tol)
    assert float(err.mean()) <= mean_tol, (float(err.mean()), mean_tol)


@pytest.mark.parametrize("shape", [(2, 24, 40, 64), (1, 13, 17, 128),
                                   (3, 9, 9, 32)])
def test_instance_norm_matches_xla_and_pallas(shape):
    import jax.numpy as jnp

    from prisma_tpu.models.raft import _instance_norm
    from prisma_tpu.ops.pallas.instance_norm import instance_norm_relu as pallas
    x = np.random.default_rng(0).normal(1.5, 3.0, shape).astype(np.float32)
    ours = _nhwc(instance_norm_relu(_nchw(x)))
    np.testing.assert_allclose(ours, np.asarray(_instance_norm(jnp.asarray(x))),
                               atol=ATOL_F32)
    np.testing.assert_allclose(
        ours, np.asarray(pallas(jnp.asarray(x), s_blk=64, interpret=True)),
        atol=ATOL_F32)


def test_instance_norm_relu():
    import jax.numpy as jnp

    from prisma_tpu.models.raft import _instance_norm
    x = np.random.default_rng(1).normal(0, 2.0, (2, 16, 24, 32)).astype(np.float32)
    ours = _nhwc(instance_norm_relu(_nchw(x), relu=True))
    assert (ours >= 0).all()
    np.testing.assert_allclose(
        ours, np.maximum(np.asarray(_instance_norm(jnp.asarray(x))), 0.0),
        atol=ATOL_F32)


def test_instance_norm_bf16():
    """bf16: the plain version against the Pallas kernel (f32 normalise,
    one cast), within K4's bf16 bounds; and within a bf16 ulp or two of the
    JAX XLA norm, which normalises in bf16."""
    import jax.numpy as jnp

    from prisma_tpu.models.raft import _instance_norm
    from prisma_tpu.ops.pallas.instance_norm import instance_norm_relu as pallas
    x = jnp.asarray(np.random.default_rng(2).normal(0, 2.0, (2, 16, 24, 64))
                    .astype(np.float32), jnp.bfloat16)
    xt = _nchw(np.asarray(x, np.float32)).to(torch.bfloat16)
    ours = instance_norm_relu(xt)
    assert ours.dtype == torch.bfloat16
    kernel = _nchw(np.asarray(pallas(x, s_blk=64, interpret=True), np.float32))
    assert_within_bounds(ours, kernel.to(torch.bfloat16))
    np.testing.assert_allclose(_nhwc(ours),
                               np.asarray(_instance_norm(x), np.float32),
                               atol=0.02, rtol=0.02)


def _slipped(x, eps=1e-5, ddof=0):
    """The plain formula with an eps or ddof slip, as a faulty kernel would
    compute it."""
    xf = x.float()
    n = x.shape[-1] * x.shape[-2]
    mean = xf.mean(dim=(-2, -1), keepdim=True)
    var = ((xf - mean) ** 2).sum(dim=(-2, -1), keepdim=True) / (n - ddof)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


@pytest.mark.parametrize("slip", [dict(eps=1e-3), dict(ddof=1)],
                         ids=["eps", "ddof"])
def test_f32_bounds_catch_an_eps_or_ddof_slip(slip):
    """K4's f32 card bound has the power to see a slip, on the ragged card
    case (planes of 13 x 17): the right formula passes it, a slipped one
    fails it."""
    x = torch.from_numpy(np.random.default_rng(3).normal(1.0, 2.0, (3, 5, 13, 17))
                         .astype(np.float32))
    ref = instance_norm_relu_ref(x)
    assert_within_bounds(_slipped(x), ref)
    with pytest.raises(AssertionError):
        assert_within_bounds(_slipped(x, **slip), ref)


def test_cpu_wrapper_takes_plain_version():
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 3, 8, 8))
                         .astype(np.float32))
    before = instance_norm_relu.launches
    out = instance_norm_relu(x, relu=True)
    assert instance_norm_relu.launches == before
    torch.testing.assert_close(out, instance_norm_relu_ref(x, relu=True),
                               rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,relu", [
    ((2, 64, 408, 720), torch.bfloat16, True),  # GMFlow's largest norm, cut to 2
    ((3, 5, 13, 17), torch.float32, False),     # ragged planes, value by value
    ((2, 128, 102, 180), torch.float32, True),
    ((2, 96, 204, 360), torch.bfloat16, False),
])
def test_kernel_matches_plain_on_card(shape, dtype, relu):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.from_numpy(np.random.default_rng(0).normal(1.0, 2.0, shape)
                         .astype(np.float32)).to("cuda", dtype)
    before = instance_norm_relu.launches
    out = instance_norm_relu(x, relu=relu)
    torch.cuda.synchronize()
    assert instance_norm_relu.launches == before + 1
    assert_within_bounds(out, instance_norm_relu_ref(x, relu=relu))


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.zeros(2, 3, 8, 8, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        instance_norm_relu(x)
    x = torch.zeros(2, 8, 8, 3, device="cuda").permute(0, 3, 1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        instance_norm_relu(x)
