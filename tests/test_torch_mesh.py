"""The port's data-parallel layer (parallel/mesh.py, the counterpart of
prisma_tpu/parallel/mesh.py), held against the JAX package's on the eight
host devices of tests/conftest.py: `data_devices` against
`data_mesh_or_none`, `pad_to_devices` and `split_batch_padded` against
`pad_to_mesh` and `shard_batch_padded`, and the depth step split over eight
CPU "devices" (devices=[cpu] * 8: one module run eight times) against
the JAX step sharded over the mesh, on the same weights of a tiny ViT, at
the tolerances of tests/test_mesh_sharding.py: depth, min and max within
1e-5, the heatmaps within one level. Then, as that file holds the JAX
package's, the depth, flow, mask, PatchFusion and Marigold steps split over
replicas against the same steps unsplit, at its tolerances: depth, min and
max within 1e-5, the heatmaps within one level; flows within 1e-3 px, the
masks equal, the HSV and 16-bit encodings within one level; the mask
composite and SDF within 1e-5; PatchFusion within 1e-5 of the depth,
Marigold within 1e-4. One `cuda` test runs the depth step over two real
cards and skips with fewer.
"""

import functools
import threading

import numpy as np
import pytest
import torch

from prisma_tpu_torch.parallel import mesh
from prisma_tpu_torch.runtime.config import RuntimeConfig

CPUS = [torch.device("cpu")] * 8
RANDOM = RuntimeConfig(random_weights=True, compute_dtype="float32",
                       device="cpu")


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two intra-op threads a test: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_data_devices(monkeypatch, n):
    """n visible cards against n visible JAX devices: a device list (of the
    mesh's size) exactly where `data_mesh_or_none` gives a mesh."""
    import jax

    import prisma_tpu.parallel as jpar

    host = jax.devices()
    monkeypatch.setattr(jax, "devices", lambda *a: host[:n])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    jmesh = jpar.data_mesh_or_none()
    ours = mesh.data_devices("cuda")
    assert (ours is None) == (jmesh is None)
    if ours is not None:
        assert ours == [torch.device("cuda", i) for i in range(n)]
        assert len(ours) == jmesh.devices.size
    assert mesh.data_devices("cuda:1") is None  # an index pins one card
    assert mesh.data_devices("cpu") is None
    assert mesh.data_devices(torch.device("cpu")) is None


@pytest.mark.parametrize("n,width,per", [(49, 4, 7), (10, 3, 2), (16, 2, 2)])
def test_split_batch_padded(n, width, per):
    """Against `pad_to_mesh` and `shard_batch_padded` over the 8-device
    mesh: 49 tiles pad to 56 and land 7 a replica; 10 members pad to 16, 2
    a replica; 16 split as they are. The padded values, the original length
    and each replica's rows equal the JAX shards'."""
    import prisma_tpu.parallel as jpar

    values = np.arange(n * width, dtype=np.float32).reshape(n, width)
    jmesh = jpar.get_mesh()
    sharded, jorig = jpar.shard_batch_padded(values, jmesh)
    shards = sorted(sharded.addressable_shards, key=lambda s: s.index[0].start)
    batch = torch.from_numpy(values)
    chunks, orig = mesh.split_batch_padded(batch, CPUS)
    assert orig == jorig == n and len(chunks) == len(shards) == 8
    for chunk, shard in zip(chunks, shards):
        assert tuple(chunk.shape) == shard.data.shape == (per, width)
        np.testing.assert_array_equal(chunk.numpy(), np.asarray(shard.data))
    padded = mesh.pad_to_devices(batch, 8)
    np.testing.assert_array_equal(padded.numpy(),
                                  np.asarray(jpar.pad_to_mesh(values, jmesh)))
    assert torch.equal(torch.cat(chunks), padded)
    assert torch.equal(mesh.gather(chunks, orig), batch)


def test_replicate_and_run_replicas():
    model = torch.nn.Linear(3, 2)
    assert mesh.replicate(model, CPUS[:2]) == [model, model]
    other = mesh.replicate(model, ["cpu", "meta"])
    assert other[0] is model and other[1].weight.device.type == "meta"
    assert mesh.replicate(model, ["meta"])[0] is other[1]  # made once

    calls = []

    def work(i, x):
        """Each replica's call on the caller's thread, in device order."""
        assert torch.is_inference_mode_enabled()
        calls.append((i, threading.get_ident()))
        if i == 5:
            raise ValueError("replica 5")
        return i * x

    with torch.inference_mode():
        assert mesh.run_replicas(work, CPUS[:4], [(i, 2) for i in range(4)]) \
            == [0, 2, 4, 6]
        assert calls == [(i, threading.get_ident()) for i in range(4)]
        with pytest.raises(ValueError, match="replica 5"):
            mesh.run_replicas(work, CPUS, [(i, 1) for i in range(8)])


def _same_step_outputs(split, whole, tols, exact=(), levels=()):
    assert set(split) == set(whole)
    for key in split:
        a, b = np.asarray(split[key]), np.asarray(whole[key])
        assert a.shape == b.shape and a.dtype == b.dtype, key
        if key in exact:
            np.testing.assert_array_equal(a, b, err_msg=key)
        elif key in levels:
            assert np.abs(a.astype(np.int64) - b.astype(np.int64)).max() <= 1, key
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=tols, err_msg=key)


@pytest.fixture(scope="module")
def tiny_depth():
    """(JAX params, the port's model on the same weights): the JAX
    package's random init of the tiny ViT of tests/test_torch_depth_anything
    (embed 64, depth 4, 2 heads, DPT 32), carried over with
    `weights.from_jax`; the JAX encoder name "tiny" stays registered while
    the file's tests run."""
    import jax

    from prisma_tpu.models import vit as jvit
    from prisma_tpu_torch.models import vit
    from prisma_tpu_torch.weights.from_jax import depth_anything_state_dict
    from prisma_tpu_torch.weights.store import depth_anything_from_state_dict
    from tests.test_torch_depth_anything import TINY, _jit_tiny_init

    with pytest.MonkeyPatch.context() as mp:
        jcfg = jvit.ViTConfig(**TINY)
        mp.setitem(jvit.VIT_CONFIGS, "tiny", jcfg)
        params = _jit_tiny_init(jax.random.key(0), jcfg)
        sd = depth_anything_state_dict(jax.tree.map(np.asarray, params))
        yield params, depth_anything_from_state_dict(sd, vit.ViTConfig(**TINY))


DEPTH_FRAMES = np.random.default_rng(0).integers(0, 256, (8, 48, 64, 3),
                                                 dtype=np.uint8)


def _depth_steps(model, devices):
    from prisma_tpu_torch.bands import depth_base
    from prisma_tpu_torch.models import depth_anything as da

    infer = functools.partial(da.infer, target=70)
    return (depth_base.make_step(model, infer, True, True, devices=devices),
            depth_base.make_step(model, infer, True, True))


def test_depth_step_split_matches_jax_sharded(tiny_depth):
    """The port's step over [cpu] * 8 against the JAX package's step with
    the batch sharded over its 8-device mesh."""
    from prisma_tpu.bands import depth_base as jdepth_base
    from prisma_tpu.models import depth_anything as jda

    params, model = tiny_depth
    jinfer = functools.partial(jda.infer, encoder="tiny", target=70)
    theirs = jdepth_base.make_step(params, jinfer, flip=True,
                                   need_depth=True)(DEPTH_FRAMES)
    assert len(theirs["depth"].sharding.device_set) == 8  # really sharded
    theirs = {k: np.asarray(v) for k, v in theirs.items()}
    ours = _depth_steps(model, CPUS)[0](DEPTH_FRAMES)
    _same_step_outputs(ours, theirs, 1e-5, levels=("heat",))


def test_depth_step_split_matches_unsplit(tiny_depth):
    split, whole = _depth_steps(tiny_depth[1], CPUS)
    _same_step_outputs(split(DEPTH_FRAMES), whole(DEPTH_FRAMES), 1e-5,
                       levels=("heat",))
    # a batch the replicas do not divide is edge-padded to 8 and split; the
    # padded frames' outputs are dropped
    _same_step_outputs(split(DEPTH_FRAMES[:5]), whole(DEPTH_FRAMES[:5]), 1e-5,
                       levels=("heat",))


def test_flow_step_split_matches_unsplit():
    """The window's 8 frames over 8 replicas: a pair each, the pair across
    each boundary built from the neighbour's first frame; the last replica,
    left with one frame, idles. Over 2 replicas, 4 and 3 pairs."""
    from prisma_tpu_torch.bands.flow_base import make_flow_step
    from prisma_tpu_torch.models import gmflow as gm
    from prisma_tpu_torch.weights import store

    model = store.load_gmflow(RANDOM)
    window = np.random.default_rng(3).integers(0, 256, (8, 32, 48, 3),
                                               dtype=np.uint8)

    def build(devices):
        return make_flow_step(model, gm.infer_pairs, (24, 36), need_masks=True,
                              need_flow=True, need_enc=True, devices=devices)

    whole = build(None)(window)
    assert whole["fwd"].shape == (7, 24, 36, 2)
    for devices in (CPUS, CPUS[:2]):
        _same_step_outputs(build(devices)(window), whole, 1e-3,
                           exact=("fwd_mask", "bwd_mask"),
                           levels=("fwd_rgb", "bwd_rgb", "fwd_enc", "bwd_enc"))


def test_mask_step_split_matches_unsplit():
    from prisma_tpu_torch.bands import mask_band
    from prisma_tpu_torch.models import solov2
    from prisma_tpu_torch.weights import store

    # the head narrowed to 64 channels (tests/test_torch_multiband.py's
    # narrow_mask): the split is under test, not the width
    cfg = solov2.SOLOv2Config(nms_pre=32, max_per_img=8, scale=(96, 64),
                              feat_channels=64, mask_feat_channels=64,
                              mask_out_channels=64)
    model = store.load_solov2(RANDOM, cfg)
    frames = np.random.default_rng(5).integers(0, 256, (8, 48, 64, 3),
                                               dtype=np.uint8)
    split = mask_band._make_step(model, (48, 64), 0.1, True, devices=CPUS)
    split2 = mask_band._make_step(model, (48, 64), 0.1, True,
                                  devices=CPUS[:2])
    whole = mask_band._make_step(model, (48, 64), 0.1, True)
    # oneDNN picks its convolution by batch size, so a frame's head outputs
    # would part by an ulp between batches of 8 and of 1 and flip a mask
    # pixel at the threshold now and then; the native convolution runs
    # each sample alone, which leaves the split itself to compare
    with torch.backends.mkldnn.flags(enabled=False):
        _same_step_outputs(split(frames), whole(frames), 1e-5)
        # 3 frames over 2 replicas: edge-padded to 4, the padded frame's
        # outputs dropped
        _same_step_outputs(split2(frames[:3]), whole(frames[:3]), 1e-5)


def test_patchfusion_split_matches_unsplit():
    """p16's 16 tiles in batches of 6, 6 and 4, each padded to 8: a tile a
    replica."""
    from prisma_tpu_torch.models import beit
    from prisma_tpu_torch.models import patchfusion as pf

    model = pf.init_params(pf.build(beit.BEiTConfig(embed_dim=32, depth=4,
                                                    num_heads=2),
                                    features=32, out_channels=(8, 8, 16, 16),
                                    model_hw=(64, 96)),
                           torch.Generator().manual_seed(0))
    img = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (100, 140, 3)).astype(np.float32))
    split = pf.infer(model, img, mode="p16", tile_batch=6, devices=CPUS)
    whole = pf.infer(model, img, mode="p16", tile_batch=6)
    assert split.shape == (100, 140)
    np.testing.assert_allclose(split.numpy(), whole.numpy(), rtol=0, atol=1e-5)


def test_marigold_split_matches_unsplit(monkeypatch):
    """10 members padded to 16, 2 a replica; the members' latents are drawn
    at the true ensemble size, so the split run ensembles the same ones."""
    from prisma_tpu_torch.models import marigold as mg
    from prisma_tpu_torch.weights import store

    monkeypatch.setenv("PRISMA_MARIGOLD_TINY", "1")
    model = store.load_marigold(RANDOM)
    frame = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (40, 56, 3), dtype=np.uint8))
    kw = dict(denoising_steps=2, ensemble_size=10, processing_res=48)
    with torch.inference_mode():
        split = mg.infer(model, frame, devices=CPUS, **kw)
        whole = mg.infer(model, frame, **kw)
    assert split.shape == (40, 56)
    np.testing.assert_allclose(split.numpy(), whole.numpy(), rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_depth_step_over_two_cards(monkeypatch):
    """The depth step split over the first two cards against the same step
    on the first alone, in f32 with TF32 off (as chip_smoke.py's f32
    checks: with it on, cuDNN's TF32 convolutions at batch 4 and at batch 8
    part by 2.3e-3 on a 1.6 scale): within 1e-4 of the depth's scale."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    from prisma_tpu_torch.bands import depth_base
    from prisma_tpu_torch.models import depth_anything as da
    from prisma_tpu_torch.weights import store

    _, model, _ = store.load_depth_anything(RANDOM, encoder="vits")
    model = model.cuda()
    infer = functools.partial(da.infer, target=126)
    frames = np.random.default_rng(0).integers(0, 256, (8, 96, 128, 3),
                                               dtype=np.uint8)
    devices = [torch.device("cuda", i) for i in range(2)]
    split = depth_base.make_step(model, infer, True, True, devices=devices)(frames)
    whole = depth_base.make_step(model, infer, True, True)(frames)
    scale = np.abs(whole["depth"]).max()
    np.testing.assert_allclose(split["depth"], whole["depth"], rtol=0,
                               atol=1e-4 * scale)
