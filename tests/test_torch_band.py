"""The port's depth_anything band against the JAX package's, folder to folder.

Both bands run the same vits weights (the JAX package's random init, written
as a reference-layout checkpoint that each package loads from disk) on one
6-frame 96x64 clip at img_size 126 in float32. The file inventory and
metadata.json must be equal; CSV and .npy values agree to 1e-4 of the depth
scale (f32 sums in another order); decoded mp4 and PNG pixels agree as the
x264 and float-bin-edge effects allow (bounds below). Also: the port's band
imports with jax, cv2 and triton blocked, and its CLI runs an image with
the relative and the metric model.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

import jax

from prisma_tpu.models import depth_anything as jda
from prisma_tpu.runtime.config import RuntimeConfig as JaxRuntimeConfig
from prisma_tpu_torch.runtime.config import RuntimeConfig
from prisma_tpu_torch.weights.from_jax import depth_anything_state_dict
from tests.test_flow_raft_band import _make_folder
from tests.test_resume import _decode_frames, _folder_bytes

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = dict(encoder="vits", img_size=126, subpath="depth_anything", npy=True)
RT = dict(batch_size=3, compute_dtype="float32", random_weights=False,
          segment_frames=4)


def _scale_tol(ours, theirs):
    return dict(rtol=0, atol=1e-4 * np.abs(theirs).max())


def test_band_matches_jax_band(tmp_path):
    from prisma_tpu.bands import depth_anything_band as jband
    from prisma_tpu_torch.bands import depth_anything_band as band

    models = tmp_path / "models"
    models.mkdir()
    params = jax.jit(jda.init_params, static_argnums=1)(jax.random.key(0),
                                                        "vits")
    torch.save(depth_anything_state_dict(jax.tree.map(np.asarray, params)),
               models / "depth_anything_vits14.pt")
    jfolder = _make_folder(tmp_path / "jax", frames=6, w=96, h=64)
    folder = str(tmp_path / "port" / "seq")
    shutil.copytree(jfolder, folder)  # the same input bytes

    jband.run(jfolder, runtime=JaxRuntimeConfig(
        models_dir=str(models), weight_cache=False, **RT), **RUN)
    band.run(folder, runtime=RuntimeConfig(models_dir=str(models),
                                           device="cpu", **RT), **RUN)

    jb, pb = _folder_bytes(jfolder), _folder_bytes(folder)
    assert set(pb) == set(jb)
    assert json.loads(pb["metadata.json"]) == json.loads(jb["metadata.json"])
    for name in ("depth_anything_min.csv", "depth_anything_max.csv"):
        ours = np.array(pb[name].decode().split(), dtype=np.float64)
        theirs = np.array(jb[name].decode().split(), dtype=np.float64)
        assert ours.shape == theirs.shape == (6,)
        np.testing.assert_allclose(ours, theirs, **_scale_tol(ours, theirs))
    npys = sorted(n for n in pb if n.endswith(".npy"))
    assert len(npys) == 6
    for name in npys:
        ours = np.load(os.path.join(folder, name))
        theirs = np.load(os.path.join(jfolder, name))
        np.testing.assert_allclose(ours, theirs, **_scale_tol(ours, theirs))

    # per-frame heatmap PNGs: at most 2 levels apart (a float bin edge moves
    # the heat and the Sobel edge term by one level each); the two range
    # pixels of row 0 pack min/max in 24 bits, so they compare as the CSVs
    import cv2
    for name in sorted(n for n in pb if n.endswith(".png")):
        ours = cv2.imread(os.path.join(folder, name)).astype(int)
        theirs = cv2.imread(os.path.join(jfolder, name)).astype(int)
        body = np.ones(ours.shape[:2], bool)
        body[0, :2] = False
        assert np.abs(ours - theirs)[body].max() <= 2, name

    # mp4: decoded content, with the x264 bounds of tests/test_multiband.py
    ours, theirs = (_decode_frames(os.path.join(f, "depth_anything.mp4"))
                    for f in (folder, jfolder))
    assert len(ours) == len(theirs) == 6
    for a, b in zip(ours, theirs):
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert d.mean() < 1.5 and d.max() <= 40


def test_band_cli_runs_an_image(tmp_path):
    import cv2
    from prisma_tpu_torch.bands import depth_anything_band as band
    img = str(tmp_path / "photo.png")
    cv2.imwrite(img, np.random.default_rng(0).integers(
        0, 255, (48, 64, 3)).astype(np.uint8))
    band.main(["-i", img, "--encoder", "vits", "--dtype", "float32",
               "--random_weights", "--img_size", "126", "-p", "--device", "cpu"])
    assert cv2.imread(str(tmp_path / "depth_anything.png")).shape == (48, 64, 3)
    assert os.path.getsize(tmp_path / "depth_anything.ply") > 0
    # the metric model (ZoeDepth head) runs too, without the flip
    os.remove(tmp_path / "depth_anything.png")
    band.main(["-i", img, "--encoder", "vits", "--dtype", "float32",
               "--random_weights", "--metric", "indoor", "--img_size", "126",
               "168", "--force", "--device", "cpu"])
    assert cv2.imread(str(tmp_path / "depth_anything.png")).shape == (48, 64, 3)


def test_port_imports_without_jax_cv2_or_triton():
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'cv2', 'triton', 'torchvision'):\n"
        "    sys.modules[m] = None\n"
        "import prisma_tpu_torch\n"
        "for mod in pkgutil.walk_packages(prisma_tpu_torch.__path__, "
        "'prisma_tpu_torch.'):\n"
        "    importlib.import_module(mod.name)\n"
        "import prisma_tpu_torch.bands.depth_anything_band\n"
        "import prisma_tpu_torch.bands.mask_band, prisma_tpu_torch.bands.multiband\n"
        "import prisma_tpu_torch.bands.rgba, prisma_tpu_torch.bands.camera_colmap_band\n"
        "import prisma_tpu_torch.cli.process, prisma_tpu_torch.models.zoedepth\n"
        "import prisma_tpu_torch.models.solov2, prisma_tpu_torch.ops.sdf\n"
        "import prisma_tpu_torch.io.colmap_model\n"
        "import prisma_tpu_torch.bands.depth_patchfusion_band\n"
        "import prisma_tpu_torch.bands.depth_zoedepth_band\n"
        "import prisma_tpu_torch.models.beit, prisma_tpu_torch.models.midas\n"
        "import prisma_tpu_torch.models.zoed, prisma_tpu_torch.ops.roi_align\n"
        "import prisma_tpu_torch.models.patchfusion as pf, torch, numpy as np\n"
        "m = pf.build(pf.beit.BEiTConfig(embed_dim=32, depth=4, num_heads=2),\n"
        "             features=32, out_channels=(8, 8, 16, 16), model_hw=(32, 32))\n"
        "pf.init_params(m, torch.Generator().manual_seed(0))\n"
        "img = torch.from_numpy(np.zeros((40, 40, 3), np.uint8))\n"
        "assert pf.infer(m, img, mode='p16', tile_batch=16).shape == (40, 40)\n"
        "assert 'prisma_tpu' not in sys.modules, 'imported the JAX package'\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
