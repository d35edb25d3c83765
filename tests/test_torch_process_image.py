"""The port's process on an image against the JAX package's.

`python -m prisma_tpu_torch.cli.process -i photo.png --random_weights
--device cpu` runs an image's default folder: rgba, the SOLOv2 mask with its
SDF, and depth_patchfusion at r128 (4 grid passes, then 128 random tiles).
The JAX package's process runs the same image with the same weights: the
port's seeded SOLOv2 and a narrow PatchFusion (model size 32x64: a BEiT 64
wide, 4 heads, 4 blocks; 32 features), converted for the JAX package by its
own torch_convert (its band loaders monkeypatched); SOLOv2's test scale
shrunk to 160x96 on both sides; float32 on the CPU.

Held equal: the file inventory, metadata.json (but the depth's min and max,
which agree within 1e-5 of the depth scale), the rgba bytes. The mask PNG
may differ at no more than 0.5% of pixels (a mask pixel at the threshold may
flip, as in tests/test_torch_mask_band.py), the depth PNG at no more than
1% (a float bin edge moves a pixel's level, and with a smooth random depth
the max-normalised Sobel term of its neighbours, as tests/test_torch_zoed.py
shows).
"""

import json
import os

import numpy as np
import pytest
import torch

from tests.test_resume import _folder_bytes
from tests.test_torch_patchfusion import NARROW

PF_HW = (32, 64)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for the module, its module-scoped fixtures
    included: the suite runs in several worker processes at once, and each
    torch op spreading over every core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def one_set_of_weights(monkeypatch):
    from prisma_tpu.bands import depth_patchfusion_band as jpfb
    from prisma_tpu.bands import mask_band as jmask
    from prisma_tpu.models import solov2 as jsolo
    from prisma_tpu.weights.torch_convert import (convert_checked,
                                                  convert_patchfusion,
                                                  convert_solov2)
    from prisma_tpu_torch.bands import depth_patchfusion_band as pfb
    from prisma_tpu_torch.models import patchfusion as pf
    from prisma_tpu_torch.models import solov2
    from prisma_tpu_torch.runtime.config import RuntimeConfig
    from prisma_tpu_torch.weights import store

    def np_sd(model):
        return {k: v.numpy() for k, v in model.state_dict().items()}

    model = pf.init_params(pf.build(**NARROW, model_hw=PF_HW),
                           torch.Generator().manual_seed(0))
    monkeypatch.setattr(pfb, "load_patchfusion", lambda runtime: (model, PF_HW))
    tree = convert_checked(convert_patchfusion, np_sd(model))
    monkeypatch.setattr(jpfb, "load_patchfusion", lambda runtime: (tree, PF_HW))
    solo = convert_checked(convert_solov2, np_sd(store.load_solov2(
        RuntimeConfig(random_weights=True, device="cpu"))))
    # the JAX mask band binds load_solov2 when it is imported
    monkeypatch.setattr(jmask, "load_solov2", lambda runtime, cfg=None: solo)
    for mod in (solov2, jsolo):
        real = mod.test_scale
        monkeypatch.setattr(mod, "test_scale",
                            lambda h, w, long_edge=160, short_edge=96, real=real:
                            real(h, w, long_edge, short_edge))


def test_process_image_matches_jax_process(tmp_path, one_set_of_weights):
    import cv2

    from prisma_tpu.cli.process import main as jmain
    from prisma_tpu_torch.cli.process import main

    img = np.random.default_rng(0).integers(0, 256, (64, 96, 3), dtype=np.uint8)
    paths = {}
    for name in ("jax", "port"):
        os.makedirs(tmp_path / name)
        paths[name] = str(tmp_path / name / "photo.png")
        cv2.imwrite(paths[name], img)
    folder = main(["-i", paths["port"], "--random_weights", "--dtype",
                   "float32", "--device", "cpu"])
    jfolder = jmain(["-i", paths["jax"], "--random_weights", "--dtype",
                     "float32"])

    pb, jb = _folder_bytes(folder), _folder_bytes(jfolder)
    assert set(pb) == set(jb) == {"rgba.png", "mask.png",
                                  "depth_patchfusion.png", "metadata.json"}
    assert sorted(os.listdir(folder)) == sorted(os.listdir(jfolder))
    assert pb["rgba.png"] == jb["rgba.png"]

    ours, theirs = (json.loads(f["metadata.json"]) for f in (pb, jb))
    assert ours["bands"]["depth"] == ours["bands"]["depth_patchfusion"]
    vals = [[m["bands"][band].pop("values") for band in ("depth",
                                                         "depth_patchfusion")]
            for m in (ours, theirs)]
    assert ours == theirs
    assert ours["bands"]["depth"]["url"] == "depth_patchfusion.png"
    theirs_v = vals[1][0]
    scale = max(abs(theirs_v["min"]["value"]), abs(theirs_v["max"]["value"]))
    for key in ("min", "max"):
        assert (abs(vals[0][0][key]["value"] - theirs_v[key]["value"])
                <= 1e-5 * scale)

    a, b = (cv2.imread(os.path.join(f, "mask.png")).astype(int)
            for f in (folder, jfolder))
    assert a.shape == b.shape == (64, 96, 3)
    assert np.any(a != b, axis=-1).mean() <= 0.005

    a, b = (cv2.imread(os.path.join(f, "depth_patchfusion.png")).astype(int)
            for f in (folder, jfolder))
    assert a.shape == b.shape == (64, 96, 3)
    assert np.any(a != b, axis=-1).mean() <= 0.01


def test_process_depth_marigold_matches_jax_process(tmp_path, monkeypatch):
    """`-d depth_marigold` on an image (rgba, then Marigold; no mask), both
    packages on the same tiny weights (tests/test_torch_marigold.py's pair),
    2 steps x 2 members at 48, the JAX package's member latents injected
    into the port (jax.random cannot be reproduced without JAX): the file
    inventory and metadata.json equal but the depth's min and max, which
    agree within 1e-4 of their scale; the depth finite and within 1e-4 of
    the JAX package's; the heatmap PNGs: the port's writer on the JAX depth
    gives the JAX package's bytes, and the two differ by at most 2 levels
    (a float bin edge moves a pixel's heat and the max-normalised Sobel term
    of its neighbours by one level each; this random depth is rough, so
    ~2% of its pixels sit at an edge)."""
    import functools

    import cv2

    from prisma_tpu.bands import depth_marigold_band as jband
    from prisma_tpu.cli.process import main as jmain
    from prisma_tpu_torch.bands import depth_marigold_band as band
    from prisma_tpu_torch.cli.process import main
    from prisma_tpu_torch.models import marigold as mg
    from tests.test_torch_marigold import TINY_UNET, TINY_VAE, _pair, jax_latents

    params, model, ucfg, _ = _pair(TINY_UNET, TINY_VAE, 2)
    monkeypatch.setattr(band, "load_marigold", lambda runtime, device: model)
    monkeypatch.setattr(jband, "load_marigold", lambda runtime: (params, ucfg))
    monkeypatch.setattr(mg, "member_latents", jax_latents)
    small = dict(denoise_steps=2, ensemble_size=2, processing_res=48)
    for mod in (band, jband):
        monkeypatch.setattr(mod, "run", functools.partial(mod.run, **small))

    img = np.random.default_rng(1).integers(0, 256, (40, 56, 3), dtype=np.uint8)
    paths = {}
    for name in ("jax", "port"):
        os.makedirs(tmp_path / name)
        paths[name] = str(tmp_path / name / "photo.png")
        cv2.imwrite(paths[name], img)
    args = ["-d", "depth_marigold", "--mask", "none", "--dtype", "float32",
            "-n"]
    folder = main(["-i", paths["port"], "--device", "cpu"] + args)
    jfolder = jmain(["-i", paths["jax"]] + args)

    pb, jb = _folder_bytes(folder), _folder_bytes(jfolder)
    assert set(pb) == set(jb) == {"rgba.png", "depth_marigold.png",
                                  "depth_marigold.npy", "metadata.json"}
    ours, theirs = (json.loads(f["metadata.json"]) for f in (pb, jb))
    vals = [[m["bands"][b].pop("values") for b in ("depth", "depth_marigold")]
            for m in (ours, theirs)]
    assert ours == theirs
    assert ours["bands"]["depth"]["url"] == "depth_marigold.png"
    depth = np.load(os.path.join(folder, "depth_marigold.npy"))
    jdepth = np.load(os.path.join(jfolder, "depth_marigold.npy"))
    assert depth.shape == (40, 56) and np.isfinite(depth).all()
    np.testing.assert_allclose(depth, jdepth, rtol=0,
                               atol=1e-4 * np.abs(jdepth).max())
    theirs_v = vals[1][0]
    scale = max(abs(theirs_v["min"]["value"]), abs(theirs_v["max"]["value"]))
    for key in ("min", "max"):
        assert (abs(vals[0][0][key]["value"] - theirs_v[key]["value"])
                <= 1e-4 * scale)
    from prisma_tpu_torch.io.writers import write_depth
    write_depth(str(tmp_path / "theirs.png"), jdepth, normalize=True,
                heatmap=True, encode_range=True, flip=False)
    a, b = (cv2.imread(os.path.join(f, "depth_marigold.png")).astype(int)
            for f in (folder, jfolder))
    assert np.array_equal(cv2.imread(str(tmp_path / "theirs.png")), b)
    assert a.shape == b.shape == (40, 56, 3)
    assert np.abs(a - b).max() <= 2
