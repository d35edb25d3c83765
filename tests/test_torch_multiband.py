"""The port's fused single-decode pipeline (bands/multiband.py) and its own
process entry point (cli/process.py).

Inside the port, the three cases of tests/test_multiband.py: the default
process video run (fused) against --sequential_bands, a band whose output
exists skipped inside the fused run, and a fused run killed mid-way and
resumed, each against an uninterrupted run: data files byte-identical,
metadata.json equal, mp4s by decoded content with that file's x264 bounds.

Across the packages: the port's `process` against the JAX package's on the
same 6-frame clip, each building its own rgba folder (the inverted PNGs
equal, rgba.mp4 decoded within x264's bounds; the JAX package's bands then
decode the port's rgba.mp4, so that both decode the same bytes) and the
same weights (the port's seeded random metric vits model, SOLOv2 and
GMFlow, converted for the JAX package by its own torch_convert), in float32
on the CPU: the file inventory and metadata.json equal; the depth min/max CSVs
within 1e-4 of the depth scale and the flow CSV within 5e-3 px (the f32
bars of tests/test_torch_zoedepth.py and tests/test_torch_flow_band.py);
the .flo flows (--flo) within 5e-3 px (1.7e-4 px seen); the inverted mask
PNGs at most 0.5% of pixels apart (a mask pixel at the threshold or an
instance at the confidence may flip, as in tests/test_torch_mask_band.py);
decoded mp4 frames within x264's bounds: mean < 1.5 and max 40 for depth and
for mask outside the flipped pixels; mean < 2.5 and max 64 for the HSV flow
frames, which each normalise by their own largest flow: with random weights
that is ~0.01 px in some pairs, so a 1e-5 px difference moves hues by a
level before x264 (mean 1.53 seen), and the .flo check above is the one
that holds the flows.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch


from prisma_tpu_torch.io.writers import read_flo
from prisma_tpu_torch.models import solov2
from tests.test_multiband import _assert_equivalent, _make_video
from tests.test_resume import _decode_frames, _folder_bytes
from tests.test_torch_rgba import deterministic_x264  # noqa: F401

pytestmark = pytest.mark.usefixtures("deterministic_x264")

COMMON = ["--random_weights", "--encoder", "vits", "--batch", "2",
          "--dtype", "float32", "--depth_size", "126", "--flow_backwards",
          "--flow_mask", "--segment_frames", "4"]


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two intra-op threads a test: the suite runs in several worker
    processes at once, and each torch op spreading over every core of the
    machine oversubscribes it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_mask(monkeypatch):
    """SOLOv2's test scale shrunk to 160x96, as tests/test_multiband.py
    does (the orchestration is under test here, not SOLOv2's numerics)."""
    real = solov2.test_scale
    monkeypatch.setattr(solov2, "test_scale",
                        lambda h, w, long_edge=160, short_edge=96:
                        real(h, w, long_edge, short_edge))


@pytest.fixture
def narrow_mask(monkeypatch, small_mask):
    """Inside the port alone, SOLOv2's head narrowed too (64 channels where
    it has 512, 256 and 128): its full-width kernel and class branches on
    the 40x40 grid are most of a CPU run, and the orchestration is under
    test here."""
    from prisma_tpu_torch.bands import mask_band
    from prisma_tpu_torch.weights import store
    narrow = solov2.SOLOv2Config(feat_channels=64, mask_feat_channels=64,
                                 mask_out_channels=64)
    monkeypatch.setattr(mask_band, "load_solov2",
                        lambda runtime, cfg=None:
                        store.load_solov2(runtime, cfg or narrow))


def _rgba_folder(tmp_path, name, frames=6, w=96, h=64):
    """A clip and its rgba folder, built by the port's process."""
    from prisma_tpu_torch.cli.process import main
    os.makedirs(tmp_path / name)
    clip = str(tmp_path / name / "clip.mp4")
    _make_video(clip, frames=frames, w=w, h=h)
    main(["-i", clip, "--mask", "none", "--depth", "none", "--flow", "none",
          "--device", "cpu"])
    return clip


def test_fused_matches_sequential(tmp_path, narrow_mask):
    from prisma_tpu_torch.cli.process import main
    clip_a = _rgba_folder(tmp_path, "a")
    os.makedirs(tmp_path / "b")
    clip_b = str(tmp_path / "b" / "clip.mp4")
    shutil.copy(clip_a, clip_b)
    shutil.copytree(tmp_path / "a" / "clip", tmp_path / "b" / "clip")

    fused_dir = main(["-i", clip_a, "--device", "cpu"] + COMMON)
    seq_dir = main(["-i", clip_b, "--sequential_bands", "--device", "cpu"]
                   + COMMON)
    files = sorted(os.listdir(fused_dir))
    for expected in ["rgba.mp4", "images", "mask.mp4", "mask",
                     "depth_anything.mp4", "depth_anything_min.csv",
                     "depth_anything_max.csv", "flow_gmflow.mp4",
                     "flow_gmflow.csv", "flow_gmflow_bwd.mp4",
                     "flow_gmflow_mask.mp4", "flow_gmflow_mask_bwd.mp4",
                     "metadata.json"]:
        assert expected in files, f"{expected} missing from {files}"
    meta = json.load(open(os.path.join(fused_dir, "metadata.json")))
    assert meta["bands"]["depth"] == meta["bands"]["depth_anything"]
    assert meta["bands"]["flow"] == meta["bands"]["flow_gmflow"]
    assert meta["bands"]["mask"]["ids"][0] == "person"
    _assert_equivalent(fused_dir, seq_dir)


def test_fused_skips_existing_band(tmp_path, narrow_mask, capsys):
    from prisma_tpu_torch.bands import multiband
    from prisma_tpu_torch.runtime.config import RuntimeConfig

    clip = str(tmp_path / "clip.mp4")
    _make_video(clip, frames=3)
    open(str(tmp_path / "mask.mp4"), "wb").close()  # the mask output exists
    runtime = RuntimeConfig(random_weights=True, compute_dtype="float32",
                            batch_size=2, segment_frames=0, overwrite=False,
                            device="cpu")
    ran = multiband.run_fused(
        clip, runtime, mask_on=True, depth_band="depth_anything",
        depth_build={"encoder": "vits", "img_size": 126, "metric": "outdoor"},
        flow_band=None)
    assert ran == {"mask_mmdet": False, "depth_anything": True}
    assert "skipping" in capsys.readouterr().out
    assert os.path.exists(str(tmp_path / "depth_anything.mp4"))
    assert os.path.getsize(str(tmp_path / "mask.mp4")) == 0
    with pytest.raises(ValueError, match="depth_marigold is not fusable"):
        multiband.run_fused(clip, runtime, depth_band="depth_marigold")


def test_fused_resume_byte_identical(tmp_path, narrow_mask, monkeypatch):
    import gc

    from prisma_tpu_torch.bands import depth_base, multiband
    from prisma_tpu_torch.io.video import SegmentedVideoWriter
    from prisma_tpu_torch.runtime.config import RuntimeConfig

    _rgba_folder(tmp_path, "g", frames=8, w=64, h=48)
    golden = str(tmp_path / "g" / "clip")
    crashy = str(tmp_path / "crashy")
    shutil.copytree(golden, crashy)
    rt = dict(random_weights=True, compute_dtype="float32", batch_size=2,
              segment_frames=2, device="cpu")
    kw = dict(mask_on=True, mask_sdf=True, mask_subpath="mask",
              depth_band="depth_anything",
              depth_build={"encoder": "vits", "img_size": 126,
                           "metric": "outdoor"},
              flow_band="flow_gmflow")
    multiband.run_fused(golden, RuntimeConfig(**rt), **kw)

    # crash after 2 batches: 4 of 8 frames, 2 complete 2-frame segments for
    # mask and depth, 1 for flow
    real_make_step = depth_base.make_step
    calls = {"n": 0}

    def failing_make_step(*args, **kwargs):
        step = real_make_step(*args, **kwargs)

        def wrapped(frames):
            if calls["n"] >= 2:
                raise KeyboardInterrupt("simulated kill")
            calls["n"] += 1
            return step(frames)

        return wrapped

    monkeypatch.setattr(depth_base, "make_step", failing_make_step)
    with pytest.raises(KeyboardInterrupt):
        multiband.run_fused(crashy, RuntimeConfig(**rt), **kw)
    monkeypatch.setattr(depth_base, "make_step", real_make_step)
    gc.collect()  # release the interrupted segment writers

    assert SegmentedVideoWriter.completed_frames(
        os.path.join(crashy, "depth_anything.mp4"), 2) == 4
    assert SegmentedVideoWriter.completed_frames(
        os.path.join(crashy, "flow_gmflow.mp4"), 2) == 2
    multiband.run_fused(crashy, RuntimeConfig(**rt), **kw)
    for leftover in ("depth_anything.mp4.segments", "flow_gmflow.mp4.segments",
                     "mask.mp4.segments"):
        assert not os.path.isdir(os.path.join(crashy, leftover))
    _assert_equivalent(golden, crashy)


@pytest.fixture
def one_set_of_weights(monkeypatch):
    """The port's random metric vits model, SOLOv2 and GMFlow (its loaders'
    seeded inits, which its process loads again), handed to the JAX
    package's band loaders through the JAX package's own converters."""
    from prisma_tpu.bands import depth_anything_band as jdab
    from prisma_tpu.bands import flow_gmflow_band as jfgb
    from prisma_tpu.weights import store as jstore
    from prisma_tpu.weights.torch_convert import (
        convert_checked, convert_gmflow, convert_metric_depth_anything,
        convert_solov2)
    from prisma_tpu_torch.models import vit
    from prisma_tpu_torch.runtime.config import RuntimeConfig
    from prisma_tpu_torch.weights import store

    rt = RuntimeConfig(random_weights=True, device="cpu")
    _, metric, _ = store.load_depth_anything(rt, "vits", "outdoor")

    def np_sd(model):
        return {k: v.numpy() for k, v in model.state_dict().items()}

    tree = {"metric": convert_checked(convert_metric_depth_anything,
                                      np_sd(metric),
                                      depth=vit.VIT_CONFIGS["vits"].depth),
            "solov2": convert_checked(convert_solov2,
                                      np_sd(store.load_solov2(rt))),
            "gmflow": convert_checked(convert_gmflow,
                                      np_sd(store.load_gmflow(rt)))}
    monkeypatch.setattr(jdab, "load_depth_anything",
                        lambda runtime, encoder="vitl", metric="none":
                        ("metric", tree["metric"], "vits"))
    monkeypatch.setattr(jstore, "load_solov2",
                        lambda runtime, cfg=None: tree["solov2"])
    monkeypatch.setattr(jfgb, "load_gmflow",
                        lambda runtime, cfg=None: tree["gmflow"])


def test_process_matches_jax_process(tmp_path, small_mask, monkeypatch,
                                     one_set_of_weights):
    import cv2

    from prisma_tpu.cli.process import main as jmain
    from prisma_tpu.models import solov2 as jsolo
    from prisma_tpu_torch.cli.process import main
    real = jsolo.test_scale
    monkeypatch.setattr(jsolo, "test_scale",
                        lambda h, w, long_edge=160, short_edge=96:
                        real(h, w, long_edge, short_edge))

    for name in ("jax", "port"):
        os.makedirs(tmp_path / name)
    clip_j = str(tmp_path / "jax" / "clip.mp4")
    _make_video(clip_j, frames=6)
    clip_p = str(tmp_path / "port" / "clip.mp4")
    shutil.copy(clip_j, clip_p)

    # the port's process from the clip alone: its own rgba, then the bands
    folder = main(["-i", clip_p, "--flo", "--device", "cpu"] + COMMON)
    # the JAX package's rgba from the same clip; its rgba.mp4 then gives way
    # to the port's, so that both packages' bands decode the same bytes (two
    # x264 encodes of the same frames may differ by an LSB here and there,
    # which the CSV and .flo bars below would see)
    jfolder = jmain(["-i", clip_j, "--mask", "none", "--depth", "none",
                     "--flow", "none"])
    for i in range(6):
        name = os.path.join("images", f"{i:06d}.png")
        a, b = (cv2.imread(os.path.join(f, name)) for f in (folder, jfolder))
        np.testing.assert_array_equal(a, b, err_msg=name)
    ours, theirs = (_decode_frames(os.path.join(f, "rgba.mp4"))
                    for f in (folder, jfolder))
    assert len(ours) == len(theirs) == 6
    for i, (a, b) in enumerate(zip(ours, theirs)):
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert d.mean() < 1.5 and d.max() <= 40, ("rgba.mp4", i, d.mean())
    shutil.copy(os.path.join(folder, "rgba.mp4"),
                os.path.join(jfolder, "rgba.mp4"))
    jmain(["-i", clip_j, "--flo"] + COMMON)

    jb, pb = _folder_bytes(jfolder), _folder_bytes(folder)
    assert set(pb) == set(jb)
    assert "mask.mp4" in pb and "depth_anything_min.csv" in pb \
        and "flow_gmflow_mask_bwd.mp4" in pb
    assert json.loads(pb["metadata.json"]) == json.loads(jb["metadata.json"])

    def csv(files, name):
        return np.array(files[name].decode().split(), dtype=np.float64)

    for name in ("depth_anything_min.csv", "depth_anything_max.csv"):
        ours, theirs = csv(pb, name), csv(jb, name)
        assert ours.shape == theirs.shape == (6,)
        np.testing.assert_allclose(ours, theirs, rtol=0,
                                   atol=1e-4 * np.abs(theirs).max())
    ours, theirs = csv(pb, "flow_gmflow.csv"), csv(jb, "flow_gmflow.csv")
    assert ours.shape == theirs.shape == (6,)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=5e-3)
    flos = sorted(n for n in pb if n.endswith(".flo"))
    assert len(flos) == 12  # 5 pairs + the zero-flow last frame, fwd and bwd
    for name in flos:
        a, b = (read_flo(os.path.join(f, name)) for f in (folder, jfolder))
        np.testing.assert_allclose(a, b, rtol=0, atol=5e-3, err_msg=name)

    flipped = {}
    for i in range(6):
        name = os.path.join("mask", f"{i:05d}.png")
        a, b = (cv2.imread(os.path.join(f, name)).astype(int)
                for f in (folder, jfolder))
        flipped[i] = np.any(a != b, axis=-1)
        assert flipped[i].mean() <= 0.005, (name, flipped[i].mean())
    for video, vmean, vmax in (
            ("depth_anything.mp4", 1.5, 40), ("mask.mp4", 1.5, 40),
            ("flow_gmflow.mp4", 2.5, 64), ("flow_gmflow_bwd.mp4", 2.5, 64),
            ("flow_gmflow_mask.mp4", 2.5, 64),
            ("flow_gmflow_mask_bwd.mp4", 2.5, 64)):
        ours, theirs = (_decode_frames(os.path.join(f, video))
                        for f in (folder, jfolder))
        assert len(ours) == len(theirs) == 6, video
        for i, (a, b) in enumerate(zip(ours, theirs)):
            d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            if video == "mask.mp4":
                d = d[~flipped[i]]
            assert d.mean() < vmean and d.max() <= vmax, (video, i, d.mean())


def test_process_raises_before_any_work(tmp_path, narrow_mask, monkeypatch):
    """The port has a band module for every band of process's tables; the
    card where there is none raises before the folder exists; an image's
    default (depth_patchfusion, whose band is stubbed here:
    tests/test_torch_process_image.py runs it) goes past that check; an
    image with -d depth_anything runs (mask too)."""
    import cv2
    import torch

    from prisma_tpu_torch.bands import depth_patchfusion_band
    from prisma_tpu_torch.bands.base import BAND_MODULES
    from prisma_tpu_torch.cli import process
    from prisma_tpu_torch.cli.process import main
    img = str(tmp_path / "photo.png")
    cv2.imwrite(img, np.random.default_rng(0).integers(
        0, 255, (64, 96, 3)).astype(np.uint8))
    folder = tmp_path / "photo"
    assert set(process.DEPTH_BANDS + process.FLOW_BANDS + process.MASK_BANDS
               + ["camera_colmap"]) <= set(BAND_MODULES)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            main(["-i", img, "-d", "depth_anything", "--random_weights"])
        with pytest.raises(RuntimeError, match="no CUDA card"):
            main(["-i", img, "--random_weights"])
    assert not folder.exists()

    # an image's default depth band is depth_patchfusion, run at its
    # default mode (r128; a video's is p49)
    calls = []
    monkeypatch.setattr(depth_patchfusion_band, "run",
                        lambda folder, **kw: calls.append((folder, kw)))
    other = str(tmp_path / "other.png")
    shutil.copy(img, other)
    main(["-i", other, "--random_weights", "--mask", "none", "--device", "cpu"])
    assert len(calls) == 1 and calls[0][0] == str(tmp_path / "other")
    assert {k: v for k, v in calls[0][1].items() if k != "runtime"} == {
        "subpath": "", "npy": False, "ply": False}
    monkeypatch.undo()

    out = main(["-i", img, "-d", "depth_anything", "--random_weights",
                "--encoder", "vits", "--depth_size", "126", "--dtype",
                "float32", "--device", "cpu"])
    # the JAX package's image folder: rgba's and mask's subpaths are made
    # empty for an image
    assert sorted(os.listdir(out)) == ["depth_anything.png", "images", "mask",
                                      "mask.png", "metadata.json", "rgba.png"]
    meta = json.load(open(os.path.join(out, "metadata.json")))
    assert meta["bands"]["depth"] == meta["bands"]["depth_anything"]
    assert meta["bands"]["mask"]["ids"][0] == "person"
    assert cv2.imread(os.path.join(out, "mask.png")).shape == (64, 96, 3)


def test_process_depth_midas_matches_jax_process(tmp_path, monkeypatch):
    """`-d depth_midas` on a clip with no mask and no flow (one band: its
    own video loop), both packages on the same narrow DPT_Large
    (tests/test_torch_midas.py's pair) at --depth_size 96: the file
    inventory and metadata.json equal, the min/max CSVs within 1e-4 of the
    disparity's scale, the heat mp4 within x264's bounds (mean < 1.5, max
    40); then, with the mask on, process hands depth_midas to the fused
    pipeline with the size as the band's target."""
    from prisma_tpu.bands import depth_midas_band as jband
    from prisma_tpu.cli.process import main as jmain
    from prisma_tpu.models import midas as jmidas
    from prisma_tpu_torch.bands import depth_midas_band as band
    from prisma_tpu_torch.bands import multiband
    from prisma_tpu_torch.cli.process import main
    from tests.test_torch_midas import J_CFG, jax_dpt
    from prisma_tpu_torch.weights import store
    from prisma_tpu_torch.weights.from_jax import midas_dpt_state_dict

    params = jax_dpt(0)
    model = store.midas_dpt_from_state_dict(midas_dpt_state_dict(params))
    monkeypatch.setattr(band, "load_midas",
                        lambda runtime, model_version: ("dpt", model))
    monkeypatch.setattr(jband, "load_midas",
                        lambda runtime, model_version: ("dpt", params))
    monkeypatch.setattr(jmidas, "MIDAS_VIT_CONFIG", J_CFG)
    monkeypatch.setattr(jmidas, "HOOKS", (0, 1, 2, 3))
    for name in ("jax", "port"):
        os.makedirs(tmp_path / name)
    clip_j = str(tmp_path / "jax" / "clip.mp4")
    _make_video(clip_j, frames=5)
    clip_p = str(tmp_path / "port" / "clip.mp4")
    shutil.copy(clip_j, clip_p)
    args = ["-d", "depth_midas", "--mask", "none", "--flow", "none",
            "--batch", "2", "--dtype", "float32", "--depth_size", "96",
            "--segment_frames", "4"]
    folder = main(["-i", clip_p, "--device", "cpu"] + args)
    jfolder = jmain(["-i", clip_j, "--mask", "none", "--depth", "none",
                     "--flow", "none"])
    shutil.copy(os.path.join(folder, "rgba.mp4"),
                os.path.join(jfolder, "rgba.mp4"))
    jmain(["-i", clip_j] + args)

    pb, jb = _folder_bytes(folder), _folder_bytes(jfolder)
    assert set(pb) == set(jb)
    assert {"depth_midas.mp4", "depth_midas_min.csv"} <= set(pb)
    assert json.loads(pb["metadata.json"]) == json.loads(jb["metadata.json"])
    for name in ("depth_midas_min.csv", "depth_midas_max.csv"):
        ours, theirs = (np.array(f[name].decode().split(), dtype=np.float64)
                        for f in (pb, jb))
        assert ours.shape == theirs.shape == (5,)
        np.testing.assert_allclose(ours, theirs, rtol=0,
                                   atol=1e-4 * np.abs(theirs).max())
    ours, theirs = (_decode_frames(os.path.join(f, "depth_midas.mp4"))
                    for f in (folder, jfolder))
    assert len(ours) == len(theirs) == 5
    for i, (a, b) in enumerate(zip(ours, theirs)):
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert d.mean() < 1.5 and d.max() <= 40, (i, d.mean())

    calls = []
    monkeypatch.setattr(multiband, "run_fused", lambda folder, runtime, **kw: (
        calls.append(kw) or {"mask_mmdet": True, "depth_midas": True,
                             "flow_gmflow": True}))
    main(["-i", clip_p, "-d", "depth_midas", "--depth_size", "96",
          "--device", "cpu", "--output", str(tmp_path / "fused")])
    assert len(calls) == 1 and calls[0]["depth_band"] == "depth_midas"
    assert calls[0]["depth_build"] == {"target": 96} and calls[0]["mask_on"]
