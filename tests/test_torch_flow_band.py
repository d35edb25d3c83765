"""The port's flow_gmflow band against the JAX package's, folder to folder.

Both bands run the same GMFlow weights (the JAX package's random init,
written as a reference-layout checkpoint wrapped under 'model' that each
package loads from disk) on one 4-frame 96x64 clip in float32, with
backwards, consistency masks, .flo subpaths and 16-bit flow PNGs. The file
inventory and metadata.json must be equal; the max-disp CSV and the .flo
flows agree to 5e-3 px, the JAX package's own GMFlow bar against the
reference (f32 through the resize and the whole model, sums in another
order; 2.4e-3 px seen); the consistency masks (the validity channel of the 16-bit PNGs) may flip at
the threshold on at most 0.5% of pixels; decoded mp4 frames agree as x264
allows. Also: the band's module imports with jax, cv2 and triton blocked,
asking for the card without one raises before any work, the CLI runs, and
the refinement flags raise.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from prisma_tpu.models import gmflow as jgm
from prisma_tpu.runtime.config import RuntimeConfig as JaxRuntimeConfig
from prisma_tpu_torch.io.writers import read_flo
from prisma_tpu_torch.runtime.config import RuntimeConfig
from prisma_tpu_torch.weights.from_jax import gmflow_state_dict
from tests.test_flow_raft_band import _make_folder
from tests.test_resume import _decode_frames, _folder_bytes

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = dict(backwards=True, mask=True, subpath="flow", subpath_mask="flow_enc")
RT = dict(batch_size=3, compute_dtype="float32", random_weights=False,
          segment_frames=4)
FLOW_ATOL = 5e-3
MASK_FLIP_SHARE = 0.005


def _checkpoint(models_dir):
    params = jax.tree.map(np.asarray,
                          jax.jit(jgm.init_params)(jax.random.key(0)))
    torch.save({"model": gmflow_state_dict(params)},
               os.path.join(models_dir, "gmflow_sintel-0c07dcb3.pth"))


def test_band_matches_jax_band(tmp_path):
    import cv2

    from prisma_tpu.bands import flow_gmflow_band as jband
    from prisma_tpu_torch.bands import flow_gmflow_band as band

    models = tmp_path / "models"
    models.mkdir()
    _checkpoint(str(models))
    jfolder = _make_folder(tmp_path / "jax", frames=4, w=96, h=64)
    folder = str(tmp_path / "port" / "seq")
    shutil.copytree(jfolder, folder)  # the same input bytes

    jband.run(jfolder, runtime=JaxRuntimeConfig(
        models_dir=str(models), weight_cache=False, **RT), **RUN)
    band.run(folder, runtime=RuntimeConfig(models_dir=str(models),
                                           device="cpu", **RT), **RUN)

    jb, pb = _folder_bytes(jfolder), _folder_bytes(folder)
    assert set(pb) == set(jb)
    assert json.loads(pb["metadata.json"]) == json.loads(jb["metadata.json"])
    ours = np.array(pb["flow_gmflow.csv"].decode().split(), dtype=np.float64)
    theirs = np.array(jb["flow_gmflow.csv"].decode().split(), dtype=np.float64)
    assert ours.shape == theirs.shape == (4,) and ours[-1] == 0.0
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=FLOW_ATOL)

    flos = sorted(n for n in pb if n.endswith(".flo"))
    assert len(flos) == 8  # 3 pairs + the zero-flow last frame, fwd and bwd
    for name in flos:
        a = read_flo(os.path.join(folder, name))
        b = read_flo(os.path.join(jfolder, name))
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=FLOW_ATOL, err_msg=name)

    # 16-bit PNGs: flow * 256 within one count; the validity channel is the
    # consistency mask, which may flip at its threshold
    pngs = sorted(n for n in pb if n.startswith("flow_enc"))
    assert len(pngs) == 8
    flips = total = 0
    for name in pngs:
        a = cv2.imread(os.path.join(folder, name), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(os.path.join(jfolder, name), cv2.IMREAD_UNCHANGED)
        assert a.dtype == b.dtype == np.uint16 and a.shape == b.shape
        # imwrite and imread both take the array as BGR, so it comes back in
        # its (u, v, valid) order
        flips += int((a[..., 2] != b[..., 2]).sum())
        total += a[..., 2].size
        both = (a[..., 2] > 0) & (b[..., 2] > 0)
        d = np.abs(a[..., :2].astype(int) - b[..., :2].astype(int))[both]
        assert d.size == 0 or d.max() <= 1, name
    assert flips <= MASK_FLIP_SHARE * total, (flips, total)

    for video in ("flow_gmflow.mp4", "flow_gmflow_bwd.mp4",
                  "flow_gmflow_mask.mp4", "flow_gmflow_mask_bwd.mp4"):
        ours, theirs = (_decode_frames(os.path.join(f, video))
                        for f in (folder, jfolder))
        assert len(ours) == len(theirs) == 4
        for a, b in zip(ours, theirs):
            d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert d.mean() < 1.5 and d.max() <= 40, video


def test_cli_runs_and_refuses_refinement(tmp_path):
    from prisma_tpu_torch.bands import flow_gmflow_band as band
    folder = _make_folder(tmp_path, frames=3, w=96, h=64)
    band.main(["-i", folder, "--random_weights", "--dtype", "float32",
               "--batch", "3", "--device", "cpu", "-b",
               "--inference_size", "48", "80"])
    files = sorted(os.listdir(folder))
    assert "flow_gmflow.mp4" in files and "flow_gmflow_bwd.mp4" in files
    dists = open(os.path.join(folder, "flow_gmflow.csv")).read().split()
    assert len(dists) == 3 and float(dists[-1]) == 0.0
    for flags in (["--num_scales", "2"], ["--corr_radius_list", "-1", "4"],
                  ["--prop_radius_list", "1"]):
        with pytest.raises(NotImplementedError, match="item 11"):
            band.main(["-i", folder, "--random_weights", "--device", "cpu",
                       "--force", *flags])


def test_asking_for_the_card_without_one_raises(tmp_path):
    from prisma_tpu_torch.bands import flow_gmflow_band as band
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert RuntimeConfig().device == "cuda"
    folder = _make_folder(tmp_path, frames=2, w=32, h=32)
    before = sorted(os.listdir(folder))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        band.run(folder, runtime=RuntimeConfig(random_weights=True))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        band.main(["-i", folder, "--random_weights"])
    assert sorted(os.listdir(folder)) == before  # no work done


def test_flow_band_imports_without_jax_cv2_or_triton():
    code = (
        "import sys\n"
        "for m in ('jax', 'cv2', 'triton'):\n"
        "    sys.modules[m] = None\n"
        "import prisma_tpu_torch.bands.flow_gmflow_band\n"
        "import prisma_tpu_torch.runtime.profile_step\n"
        "from prisma_tpu_torch.runtime.config import RuntimeConfig\n"
        "assert RuntimeConfig().device == 'cuda'\n"
        "assert 'prisma_tpu' not in sys.modules, 'imported the JAX package'\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
