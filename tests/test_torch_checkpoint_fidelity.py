"""Real-checkpoint fidelity of the port, gated on the files under
PRISMA_TPU_MODELS (default `models/`): the port's counterpart of
tests/test_checkpoint_fidelity.py.

No checkpoint ships with the repository, so every test here skips until
`download_models.sh` (plus the files named below) has filled the folder.
For each file that is present, a test loads it through the port's
`weights.store.load_*` (strict key check) and through the JAX package's
loader, runs both in f32 on the CPU on the same seeded input, and compares.
README "Numerics" gives the JAX package's bars against the reference torch
code: Depth-Anything ~5e-8, RAFT 1e-5, GMFlow 5e-3, the ZoeDepth bins
1e-3 of the scale, matrix NMS 1e-5. The port and the JAX package sum in
other orders, so where a bar lies below what f32 allows between two
implementations (Depth-Anything's ~5e-8), or is absolute where trained
weights give larger outputs than random ones (RAFT's 1e-5 px), the limit is
ten times the parity this file read on random-weight files in the real
layouts (the port's seeded random models plus N(0, 0.01) noise, saved as
each file is laid out, on the CPU; `python scripts/torch_checkpoint_parity.py`
makes the files and prints each comparison), relative to the output's
scale:

- Depth-Anything (relative): 3e-5 of the depth's scale (read: 3.1e-6 for
  vits);
- RAFT: 2e-5 of the low-resolution flow's scale at 4 iterations (read:
  2.0e-6, 5.5e-6 px on a 2.7 px scale);
- GMFlow (one and two scales): README's 5e-3 px (read: 5.2e-4 px and
  1.4e-5 px);
- SOLOv2: the head outputs within 3e-5 of their scale (read: 3.1e-6), then
  matrix NMS's decayed scores on the same head outputs within README's
  1e-5 (read: 2.0e-6);
- MiDaS (DPT_Large, v2.1): 3e-5 of the output's scale (read: 2.2e-6 for
  v2.1);
- the metric Depth-Anything, ZoeD_N and PatchFusion: README's bins bar,
  1e-3 of the depth's scale; Marigold (the members' latents injected from
  the JAX package's draw): 1e-4 of the output's scale, as the port's own
  tests hold it. These four were not read on such files.

Inventory: the files of download_models.sh, plus ZoeD_M12_N.pt,
patchfusion_u4k.pt, dpt_large_384.pt, midas_v21_384.pt,
gmflow_with_refine_sintel-3ed1cf48.pth and the marigold/ snapshot. JAX and
the models are imported inside the tests, so collecting this file is quick.
"""

import glob
import os

import numpy as np
import pytest

MODELS_DIR = os.environ.get("PRISMA_TPU_MODELS", "models")


def _path(name: str) -> str:
    return os.path.join(MODELS_DIR, name)


def _need(*names):
    missing = [n for n in names if not os.path.exists(_path(n))]
    if missing:
        pytest.skip(f"checkpoint(s) not present under {MODELS_DIR}: {missing}")


def _runtimes():
    """(the port's RuntimeConfig, the JAX package's), f32 on the CPU."""
    from prisma_tpu.runtime.config import RuntimeConfig as JaxRuntime
    from prisma_tpu_torch.runtime.config import RuntimeConfig
    return (RuntimeConfig(models_dir=MODELS_DIR, compute_dtype="float32",
                          device="cpu"),
            JaxRuntime(models_dir=MODELS_DIR, compute_dtype="float32",
                       weight_cache=False))


def _frames(n: int, h: int, w: int, seed: int = 1234) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3),
                                                dtype=np.uint8)


def _close(ours, theirs, rel: float = 0.0, atol: float = 0.0):
    """ours (torch) against theirs (JAX/numpy) within atol + rel * max
    |theirs|."""
    ours = ours.detach().float().numpy() if hasattr(ours, "detach") \
        else np.asarray(ours)
    theirs = np.asarray(theirs, np.float32)
    assert ours.shape == theirs.shape, (ours.shape, theirs.shape)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, theirs, rtol=0,
                               atol=atol + rel * float(np.abs(theirs).max()))


@pytest.mark.parametrize("encoder", ["vits", "vitb", "vitl"])
def test_depth_anything_checkpoint(encoder):
    _need(f"depth_anything_{encoder}14.pt")
    import torch

    from prisma_tpu.models import depth_anything as jda
    from prisma_tpu.weights import store as jstore
    from prisma_tpu_torch.models import depth_anything as da
    from prisma_tpu_torch.weights import store

    rt, jrt = _runtimes()
    _, model, _ = store.load_depth_anything(rt, encoder=encoder)
    _, params, _ = jstore.load_depth_anything(jrt, encoder=encoder)
    frames = _frames(1, 70, 94)
    theirs = jda.infer(params, frames, encoder=encoder, precision="highest",
                       target=126)
    with torch.inference_mode():
        ours = da.infer(model, torch.from_numpy(frames), target=126)
    _close(ours, theirs, rel=3e-5)


@pytest.mark.parametrize("metric", ["indoor", "outdoor"])
def test_metric_depth_anything_checkpoint(metric):
    _need(f"depth_anything_metric_depth_{metric}.pt")
    import torch

    from prisma_tpu.models import zoedepth as jzoe
    from prisma_tpu.weights import store as jstore
    from prisma_tpu_torch.models import zoedepth as zoe
    from prisma_tpu_torch.weights import store

    rt, jrt = _runtimes()
    _, model, _ = store.load_depth_anything(rt, metric=metric)
    _, params, enc = jstore.load_depth_anything(jrt, metric=metric)
    frames = _frames(1, 70, 94)
    theirs = jzoe.metric_depth_anything_infer(
        params, frames, encoder=enc, img_size=(126, 126), precision="highest")
    with torch.inference_mode():
        ours = zoe.metric_depth_anything_infer(
            model, torch.from_numpy(frames), img_size=(126, 126))
    _close(ours, theirs, rel=1e-3)


def test_raft_checkpoint():
    _need("raft-sintel.pth")
    import torch

    from prisma_tpu.models import raft as jraft
    from prisma_tpu.weights import store as jstore
    from prisma_tpu_torch.models import raft
    from prisma_tpu_torch.weights import store

    rt, jrt = _runtimes()
    model = store.load_raft(rt)
    params = jstore.load_raft(jrt)
    a = _frames(1, 64, 96).astype(np.float32)
    b = _frames(1, 64, 96, seed=1235).astype(np.float32)
    jlow, _ = jraft.forward(params, a, b, iters=4, precision="highest",
                            gru_impl="reference")
    with torch.inference_mode():
        low, _ = raft.forward(model, torch.from_numpy(a), torch.from_numpy(b),
                              iters=4)
    _close(low, jlow, rel=2e-5)


@pytest.mark.parametrize("name,scales", [
    ("gmflow_sintel-0c07dcb3.pth", 1),
    ("gmflow_with_refine_sintel-3ed1cf48.pth", 2)])
def test_gmflow_checkpoint(name, scales):
    _need(name)
    import torch

    from prisma_tpu.models import gmflow as jgm
    from prisma_tpu.weights import store as jstore
    from prisma_tpu_torch.models import gmflow as gm
    from prisma_tpu_torch.weights import store

    rt, jrt = _runtimes()
    model = store.load_gmflow(rt, gm.refine_config() if scales == 2 else None)
    jcfg = jgm.refine_config() if scales == 2 else jgm.GMFlowConfig()
    params = jstore.load_gmflow(jrt, jcfg)
    a = _frames(1, 64, 96).astype(np.float32)
    b = _frames(1, 64, 96, seed=1235).astype(np.float32)
    jf, jb = jgm.infer_pairs(params, a, b, jcfg, precision="highest")
    with torch.inference_mode():
        f, bw = gm.infer_pairs(model, torch.from_numpy(a), torch.from_numpy(b))
    _close(f, jf, atol=5e-3)
    _close(bw, jb, atol=5e-3)


def test_solov2_checkpoint():
    if not glob.glob(_path("solov2_r101_fpn_3x_coco*.pth")):
        pytest.skip(f"no solov2_r101_fpn_3x_coco*.pth under {MODELS_DIR}")
    import jax.numpy as jnp
    import torch

    from prisma_tpu.models import resnet as jresnet
    from prisma_tpu.models import solov2 as jsolo
    from prisma_tpu.weights import store as jstore
    from prisma_tpu_torch.models import resnet, solov2
    from prisma_tpu_torch.weights import store

    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(a).transpose(0, 3, 1, 2)))

    rt, jrt = _runtimes()
    cfg = solov2.SOLOv2Config(scale=(320, 192))
    model = store.load_solov2(rt, cfg)
    params = jstore.load_solov2(jrt)
    frame = _frames(1, 96, 128)
    img, img_hw = jsolo.preprocess(jnp.asarray(frame), scale=cfg.scale)
    feats = jresnet.forward(params["backbone"], img, "highest")
    fpn = jsolo.fpn_forward(params["fpn"], list(feats), "highest")
    heads = jsolo.head_forward(params["head"], fpn, jsolo.SOLOv2Config(),
                               "highest")
    with torch.inference_mode():
        t_feats = resnet.forward(model.backbone, nchw(img))
        t_fpn = solov2.fpn_forward(model.neck, t_feats)
        t_heads = solov2.head_forward(model.mask_head, t_fpn, cfg)
    for ours, theirs in zip((*t_heads[0], *t_heads[1], t_heads[2]),
                            (*heads[0], *heads[1], heads[2])):
        _close(ours.permute(0, 2, 3, 1), theirs, rel=3e-5)
    k, c, m = heads
    slab = jsolo.get_results(k, c, m, img_hw, frame.shape[1:3],
                             jsolo.SOLOv2Config())
    with torch.inference_mode():
        ours = solov2.get_results([nchw(t) for t in k], [nchw(t) for t in c],
                                  nchw(m), img_hw, frame.shape[1:3], cfg)
    assert np.array_equal(ours["valid"].numpy(), np.asarray(slab["valid"]))
    _close(ours["scores"], slab["scores"], atol=1e-5)


@pytest.mark.parametrize("name,version", [("dpt_large_384.pt", "midas3"),
                                          ("midas_v21_384.pt", "midas2")])
def test_midas_checkpoint(name, version):
    _need(name)
    import torch

    from prisma_tpu.models import midas as jmidas
    from prisma_tpu.weights import store as jstore
    from prisma_tpu_torch.models import midas
    from prisma_tpu_torch.weights import store

    rt, jrt = _runtimes()
    arch, model = store.load_midas(rt, version)
    jarch, params = jstore.load_midas(jrt, version)
    assert arch == jarch
    frames = _frames(1, 64, 64)
    j_infer, infer = ((jmidas.infer, midas.infer) if arch == "dpt"
                      else (jmidas.infer_v2, midas.infer_v2))
    theirs = j_infer(params, frames, precision="highest", target=96)
    with torch.inference_mode():
        ours = infer(model, torch.from_numpy(frames), target=96)
    _close(ours, theirs, rel=3e-5)


def test_zoed_checkpoint():
    _need("ZoeD_M12_N.pt")
    import torch

    from prisma_tpu.models import zoed as jzoed
    from prisma_tpu.weights import store as jstore
    from prisma_tpu_torch.models import zoed
    from prisma_tpu_torch.weights import store

    rt, jrt = _runtimes()
    model = store.load_zoed(rt)
    params = jstore.load_zoed(jrt)
    frames = _frames(1, 64, 96)
    theirs = jzoed.infer(params, frames, img_size=(64, 96),
                         precision="highest")
    with torch.inference_mode():
        ours = zoed.infer(model, torch.from_numpy(frames), img_size=(64, 96))
    _close(ours, theirs, rel=1e-3)


def test_patchfusion_checkpoint():
    _need("patchfusion_u4k.pt")
    import torch

    from prisma_tpu.models import patchfusion as jpf
    from prisma_tpu.weights import store as jstore
    from prisma_tpu_torch.models import patchfusion as pf
    from prisma_tpu_torch.weights import store

    rt, jrt = _runtimes()
    model, model_hw = store.load_patchfusion(rt)
    params, j_hw = jstore.load_patchfusion(jrt)
    assert tuple(model_hw) == tuple(j_hw)
    img = _frames(1, 128, 160)[0]
    theirs = jpf.infer(params, img.astype(np.float32) / 255.0, mode="p16",
                       model_hw=j_hw, precision="highest")
    with torch.inference_mode():
        ours = pf.infer(model, torch.from_numpy(img), mode="p16")
    _close(ours, theirs, rel=1e-3)


def test_marigold_checkpoint(monkeypatch):
    if not os.path.isdir(_path("marigold")):
        pytest.skip(f"no marigold/ snapshot under {MODELS_DIR}")
    import jax
    import jax.numpy as jnp
    import torch

    from prisma_tpu.models import marigold as jmar
    from prisma_tpu.weights import store as jstore
    from prisma_tpu_torch.models import marigold as mg
    from prisma_tpu_torch.weights import store

    def jax_latents(seed, n, shape, device="cpu"):
        """The JAX package's member latents, NHWC draws as NCHW."""
        c, h, w = shape
        keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed), i))(
            jnp.arange(n))
        z = jax.vmap(lambda k: jax.random.normal(k, (h, w, c), jnp.float32))(keys)
        return torch.from_numpy(
            np.asarray(z).transpose(0, 3, 1, 2).copy()).to(device)

    rt, jrt = _runtimes()
    model = store.load_marigold(rt)
    params, unet_cfg = jstore.load_marigold(jrt)
    frame = _frames(1, 48, 64)[0]
    kw = dict(denoising_steps=2, ensemble_size=2, processing_res=64, seed=3)
    theirs = jmar.infer(params, frame, unet_cfg=unet_cfg, **kw)
    monkeypatch.setattr(mg, "member_latents", jax_latents)
    with torch.inference_mode():
        ours = mg.infer(model, torch.from_numpy(frame), **kw)
    _close(ours, theirs, rel=1e-4)
