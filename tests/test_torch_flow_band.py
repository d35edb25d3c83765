"""The port's flow bands (flow_gmflow, flow_raft) against the JAX package's,
folder to folder.

Both bands run the same GMFlow weights (the JAX package's random init,
written as a reference-layout checkpoint wrapped under 'model' that each
package loads from disk) on one 4-frame 96x64 clip in float32, with
backwards, consistency masks, .flo subpaths and 16-bit flow PNGs. The file
inventory and metadata.json must be equal; the max-disp CSV and the .flo
flows agree to 5e-3 px, the JAX package's own GMFlow bar against the
reference (f32 through the resize and the whole model, sums in another
order; 2.4e-3 px seen); the consistency masks (the validity channel of the 16-bit PNGs) may flip at
the threshold on at most 0.5% of pixels; decoded mp4 frames agree as x264
allows. The flow_raft band is held the same way, on RAFT weights written
as `raft-sintel.pth` with DataParallel `module.` keys, at 3 GRU iterations;
its flows agree to 1e-3 px (the JAX band runs its default fused GRU, which
tests/test_raft_parity.py holds to the reference form at 1e-3), with its
volume lookup and with `corr_impl="fused"`. GMFlow's refinement (--num_scales
2) is held the same way on a gmflow_with_refine checkpoint (the JAX band
runs its banded-matmul local correlation, which agrees with the taps form
the port runs to ~2e-5 in f32). Also: each band's module imports with jax,
cv2 and triton blocked, asking for the card without one raises before any
work, and the CLIs run, the refinement's and the fused lookup's among them.
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
from prisma_tpu.models import raft as jraft
from prisma_tpu.runtime.config import RuntimeConfig as JaxRuntimeConfig
from prisma_tpu_torch.io.writers import read_flo
from prisma_tpu_torch.runtime.config import RuntimeConfig
from prisma_tpu_torch.weights.from_jax import gmflow_state_dict, raft_state_dict
from tests.test_flow_raft_band import _make_folder
from tests.test_resume import _decode_frames, _folder_bytes

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = dict(backwards=True, mask=True, subpath="flow", subpath_mask="flow_enc")
RT = dict(batch_size=3, compute_dtype="float32", random_weights=False,
          segment_frames=4)
FLOW_ATOL = 5e-3
RAFT_FLOW_ATOL = 1e-3
MASK_FLIP_SHARE = 0.005


def _checkpoint(models_dir):
    params = jax.tree.map(np.asarray,
                          jax.jit(jgm.init_params)(jax.random.key(0)))
    torch.save({"model": gmflow_state_dict(params)},
               os.path.join(models_dir, "gmflow_sintel-0c07dcb3.pth"))


def _refine_checkpoint(models_dir):
    """The JAX refine init at half scale (REFINE_WEIGHT_SCALE of
    tests/test_torch_gmflow.py: at full scale the refinement's sharp local
    softmax amplifies last-bit differences past the bar)."""
    params = jax.tree.map(
        lambda x: np.asarray(x) * 0.5,
        jax.jit(lambda k: jgm.init_params(k, jgm.refine_config()))(
            jax.random.key(0)))
    torch.save({"model": gmflow_state_dict(params)},
               os.path.join(models_dir, "gmflow_with_refine_sintel-3ed1cf48.pth"))


def _raft_checkpoint(models_dir):
    params = jax.tree.map(np.asarray,
                          jax.jit(jraft.init_params)(jax.random.key(1)))
    torch.save({"module." + k: v for k, v in raft_state_dict(params).items()},
               os.path.join(models_dir, "raft-sintel.pth"))


def _compare_band_folders(tmp_path, jband, band, checkpoint, band_name, atol,
                          video_max=40, jax_kw=(), port_kw=(), **kw):
    """Run the JAX band and the port's on the same 4-frame 96x64 clip and
    weights; hold the port's folder to the JAX one. video_max: the largest
    difference of a decoded mp4 value that x264 may make of a last-bit
    difference in its input. jax_kw / port_kw: run() arguments for one
    package alone (each its own config object); kw: for both."""
    import cv2

    models = tmp_path / "models"
    models.mkdir()
    checkpoint(str(models))
    jfolder = _make_folder(tmp_path / "jax", frames=4, w=96, h=64)
    folder = str(tmp_path / "port" / "seq")
    shutil.copytree(jfolder, folder)  # the same input bytes

    jband.run(jfolder, runtime=JaxRuntimeConfig(
        models_dir=str(models), weight_cache=False, **RT), **RUN, **kw,
        **dict(jax_kw))
    band.run(folder, runtime=RuntimeConfig(models_dir=str(models),
                                           device="cpu", **RT), **RUN, **kw,
             **dict(port_kw))

    jb, pb = _folder_bytes(jfolder), _folder_bytes(folder)
    assert set(pb) == set(jb)
    assert json.loads(pb["metadata.json"]) == json.loads(jb["metadata.json"])
    ours = np.array(pb[f"{band_name}.csv"].decode().split(), dtype=np.float64)
    theirs = np.array(jb[f"{band_name}.csv"].decode().split(), dtype=np.float64)
    assert ours.shape == theirs.shape == (4,) and ours[-1] == 0.0
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=atol)

    flos = sorted(n for n in pb if n.endswith(".flo"))
    assert len(flos) == 8  # 3 pairs + the zero-flow last frame, fwd and bwd
    for name in flos:
        a = read_flo(os.path.join(folder, name))
        b = read_flo(os.path.join(jfolder, name))
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=name)

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

    for video in (f"{band_name}.mp4", f"{band_name}_bwd.mp4",
                  f"{band_name}_mask.mp4", f"{band_name}_mask_bwd.mp4"):
        ours, theirs = (_decode_frames(os.path.join(f, video))
                        for f in (folder, jfolder))
        assert len(ours) == len(theirs) == 4
        for a, b in zip(ours, theirs):
            d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert d.mean() < 1.5 and d.max() <= video_max, video


def test_band_matches_jax_band(tmp_path):
    from prisma_tpu.bands import flow_gmflow_band as jband
    from prisma_tpu_torch.bands import flow_gmflow_band as band
    _compare_band_folders(tmp_path, jband, band, _checkpoint, "flow_gmflow",
                          FLOW_ATOL)


def test_refine_band_matches_jax_band(tmp_path):
    """--num_scales 2: the 96x64 clip at 0.75 is 72x48, padded to 96x64 (/32);
    1/8 features 8x12 in 2x2 splits, 1/4 features 16x24 in 8x8 splits."""
    from prisma_tpu.bands import flow_gmflow_band as jband
    from prisma_tpu_torch.bands import flow_gmflow_band as band
    from prisma_tpu_torch.models import gmflow as gm
    _compare_band_folders(tmp_path, jband, band, _refine_checkpoint,
                          "flow_gmflow", FLOW_ATOL,
                          jax_kw={"cfg": jgm.refine_config()},
                          port_kw={"cfg": gm.refine_config()})


def test_raft_band_matches_jax_band(tmp_path):
    """The 64x96 clip gives 6x9 features: RAFT's level 3 pools to 0x1 and
    reads as zeros in both packages. The flows agree to ~1.2e-5 px, yet x264
    turns the last-bit differences of the HSV frames into up to 46 at a few
    pixels of a frame (8 of 18432 values above 20, seen), hence video_max."""
    from prisma_tpu.bands import flow_raft_band as jband
    from prisma_tpu_torch.bands import flow_raft_band as band
    _compare_band_folders(tmp_path, jband, band, _raft_checkpoint, "flow_raft",
                          RAFT_FLOW_ATOL, video_max=64, iterations=3)


def test_raft_fused_band_matches_jax_band(tmp_path):
    """--corr_impl fused in both packages, on the same clip, weights and
    bounds as the volume lookup above (the empty level 3 reads as zeros in
    both fused lookups too)."""
    from prisma_tpu.bands import flow_raft_band as jband
    from prisma_tpu_torch.bands import flow_raft_band as band
    _compare_band_folders(tmp_path, jband, band, _raft_checkpoint, "flow_raft",
                          RAFT_FLOW_ATOL, video_max=64, iterations=3,
                          corr_impl="fused")


def test_cli_runs_and_refuses_refinement(tmp_path):
    """The CLI runs one scale (with --inference_size) and the refinement
    (--num_scales 2, the JAX band's flag logic: x4 upsample, /32 padding,
    the per-scale lists as tuples); it refuses per-scale lists whose length
    is not the number of scales."""
    from prisma_tpu_torch.bands import flow_gmflow_band as band
    from prisma_tpu_torch.models import gmflow as gm
    folder = _make_folder(tmp_path, frames=3, w=96, h=64)
    band.main(["-i", folder, "--random_weights", "--dtype", "float32",
               "--batch", "3", "--device", "cpu", "-b",
               "--inference_size", "48", "80"])
    files = sorted(os.listdir(folder))
    assert "flow_gmflow.mp4" in files and "flow_gmflow_bwd.mp4" in files
    dists = open(os.path.join(folder, "flow_gmflow.csv")).read().split()
    assert len(dists) == 3 and float(dists[-1]) == 0.0

    seen = []
    real_run = band.run

    def run(*a, cfg=None, **kw):
        seen.append(cfg)
        return real_run(*a, cfg=cfg, **kw)

    band.run = run
    try:
        band.main(["-i", folder, "--random_weights", "--dtype", "float32",
                   "--batch", "3", "--device", "cpu", "--force", "--mask",
                   "--num_scales", "2", "--corr_radius_list", "-1", "4",
                   "--padding_factor", "64"])
    finally:
        band.run = real_run
    assert seen == [gm.GMFlowConfig(num_scales=2, upsample_factor=4,
                                    padding_factor=64,
                                    corr_radius_list=(-1, 4))]
    assert "flow_gmflow_mask.mp4" in os.listdir(folder)
    dists = open(os.path.join(folder, "flow_gmflow.csv")).read().split()
    assert len(dists) == 3 and all(np.isfinite(float(d)) for d in dists)
    for flags in (["--num_scales", "2", "--attn_splits_list", "2"],
                  ["--prop_radius_list", "-1", "1"]):
        with pytest.raises(ValueError, match="one entry per scale"):
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


def test_raft_cli_runs(tmp_path):
    """The CLI runs with the default lookup and with --corr_impl fused (the
    same folder, the flows within RAFT_FLOW_ATOL); it takes the JAX band's
    --corr_impl choices and its PRISMA_RAFT_CORR default, and refuses
    another name."""
    from prisma_tpu_torch.bands import flow_raft_band as band
    from prisma_tpu_torch.io.writers import read_flo
    folder = _make_folder(tmp_path, frames=3, w=96, h=64)
    flows = {}
    for impl in ("volume", "fused"):
        band.main(["-i", folder, "--random_weights", "--dtype", "float32",
                   "--batch", "3", "--device", "cpu", "-b", "--iterations",
                   "2", "--scale", "1.0", "--mask", "--force", "--subpath",
                   f"flo_{impl}", "--corr_impl", impl])
        files = sorted(os.listdir(folder))
        for name in ("flow_raft.mp4", "flow_raft_bwd.mp4", "flow_raft_mask.mp4"):
            assert name in files, files
        dists = open(os.path.join(folder, "flow_raft.csv")).read().split()
        assert len(dists) == 3 and float(dists[-1]) == 0.0
        flows[impl] = [read_flo(os.path.join(d, name))
                       for d, _, names in sorted(os.walk(folder))
                       if os.path.basename(d).startswith(f"flo_{impl}_")
                       for name in sorted(names)]
    assert len(flows["fused"]) == len(flows["volume"]) > 0
    for a, b in zip(flows["fused"], flows["volume"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=RAFT_FLOW_ATOL)
    with pytest.raises(SystemExit):  # not a --corr_impl choice
        band.main(["-i", folder, "--random_weights", "--device", "cpu",
                   "--corr_impl", "alt_cuda_corr"])


def test_raft_asking_for_the_card_without_one_raises(tmp_path):
    from prisma_tpu_torch.bands import flow_raft_band as band
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    folder = _make_folder(tmp_path, frames=2, w=32, h=32)
    before = sorted(os.listdir(folder))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        band.run(folder, runtime=RuntimeConfig(random_weights=True))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        band.main(["-i", folder, "--random_weights"])
    assert sorted(os.listdir(folder)) == before  # no work done


def test_raft_band_imports_without_jax_cv2_or_triton():
    code = (
        "import sys\n"
        "for m in ('jax', 'cv2', 'triton'):\n"
        "    sys.modules[m] = None\n"
        "import prisma_tpu_torch.bands.flow_raft_band\n"
        "import prisma_tpu_torch.ops.cuda.probe_gather\n"
        "assert 'prisma_tpu' not in sys.modules, 'imported the JAX package'\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
