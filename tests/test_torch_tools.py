"""The port's host tools against the JAX package's, on the CPU: the concat
contact sheet (cli/concat.py), the rerun viewer's helpers and log functions
(cli/view.py), the io helpers (extract_frames_from_video, make_video,
create_folder, copy_folder, to_float_rgb) and the depth loop's device trace.

Videos are compared by decoding, every mp4 written at x264's ultrafast
preset (`deterministic_x264`): the two packages decode and encode through
the same native library, so their frames must be equal. The log functions
run against a recording stand-in for `rerun` in both packages: the entity
paths, time sequences and logged values must be equal, floats within 1e-6
of their scale (the depth decode is numpy in one, torch in the other).
"""

import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from tests.test_resume import _decode_frames
from tests.test_torch_rgba import deterministic_x264  # noqa: F401

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, FRAMES = 48, 32, 5


def _frames(n=FRAMES, w=W, h=H, seed=0):
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        out.append(np.stack([(xx * 5 + i * 13 + seed) % 256, (yy * 7) % 256,
                             (xx + yy + i * 9) % 256], -1).astype(np.uint8))
    return out


def _write_clip(path, frames, fps=24.0):
    from prisma_tpu_torch.io.video import VideoWriter
    wr = VideoWriter(frames[0].shape[1], frames[0].shape[0], fps, filename=path)
    for f in frames:
        wr.write(f)
    wr.close()


def _heat_frames(n=FRAMES, w=W, h=H):
    """Heatmap frames of a depth ramp, as a depth band writes them."""
    from prisma_tpu_torch.ops import encode as enc
    import torch
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        heat = ((xx + yy * 2 + i * 3) % 97 / 96.0).astype(np.float32)
        out.append((enc.heat_to_rgb(torch.from_numpy(heat)).numpy() * 255)
                   .astype(np.uint8))
    return out


def _write_colmap_bin(path, n_points=3):
    """A binary COLMAP model: one PINHOLE camera, two images (out of name
    order) seeing n_points points, one point with no colour."""
    os.makedirs(path)
    rng = np.random.default_rng(1)
    with open(os.path.join(path, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, W * 2, H * 2))
        f.write(struct.pack("<4d", 60.0, 62.0, W, H))
    with open(os.path.join(path, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", 2))
        for image_id, name in ((2, "000002.png"), (1, "000001.png")):
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            f.write(struct.pack("<i4d3di", image_id, *q, *rng.normal(size=3), 1))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", n_points + 1))
            for pid in [*range(1, n_points + 1), -1]:
                f.write(struct.pack("<ddq", *rng.uniform(0, W, 2), pid))
    with open(os.path.join(path, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", n_points))
        for pid in range(1, n_points + 1):
            rgb = (0, 0, 0) if pid == 1 else (10 * pid, 20, 30)
            f.write(struct.pack("<Q3d3Bd", pid, *rng.normal(size=3), *rgb,
                                0.1 * pid))
            f.write(struct.pack("<Q", 6))
            f.write(struct.pack("<12i", *[1, 0, 2, 0] * 3))


@pytest.fixture
def folder(tmp_path, deterministic_x264):
    """A PRISMA video folder: rgba.mp4, a depth band's heat mp4 with its
    min/max CSVs, a flow band's png, a camera band's scalar value and a
    COLMAP model under sparse/0."""
    path = tmp_path / "seq"
    os.makedirs(path)
    _write_clip(str(path / "rgba.mp4"), _frames())
    _write_clip(str(path / "depth_anything.mp4"), _heat_frames())
    import cv2
    cv2.imwrite(str(path / "flow.png"), _frames(1, seed=5)[0])
    for name, vals in (("depth_anything_min.csv", [0.5, 0.6, 0.7, 0.8, 0.9]),
                       ("depth_anything_max.csv", [5.0, 5.5, 6.0, 6.5, 7.0]),
                       ("counts.csv", [3, 4, 5, 6, 7]),
                       ("uv.csv", ["1.0,2.0", "3.5,4.5"])):
        with open(path / name, "w") as f:
            f.write("\n".join(str(v) for v in vals) + "\n")
    data = {"width": W, "height": H, "fps": 24.0, "frames": FRAMES,
            "focal_length": 40.0, "principal_point": [W / 2, H / 2],
            "bands": {
                "rgba": {"url": "rgba.mp4"},
                "depth_anything": {"url": "depth_anything.mp4", "values": {
                    "min": {"type": "float", "url": "depth_anything_min.csv"},
                    "max": {"type": "float", "url": "depth_anything_max.csv"}}},
                "flow": {"url": "flow.png", "values": {
                    "count": {"type": "int", "url": "counts.csv"},
                    "uv": {"type": "vec2", "url": "uv.csv"}}},
                "camera": {"values": {
                    "fov": {"type": "float", "value": "58.5"},
                    "frames": {"type": "int", "value": "5"},
                    "model": {"type": "str", "value": "PINHOLE"}}}}}
    with open(path / "metadata.json", "w") as f:
        json.dump(data, f)
    _write_colmap_bin(str(path / "sparse" / "0"))
    return str(path), data


def test_host_tools_import_without_cv2_rerun_or_jax():
    code = ("import sys\n"
            "import prisma_tpu_torch.cli.view, prisma_tpu_torch.cli.concat\n"
            "import prisma_tpu_torch.parallel.mesh\n"
            "import prisma_tpu_torch.io.video, prisma_tpu_torch.io.image\n"
            "bad = [m for m in ('cv2', 'rerun', 'jax', 'prisma_tpu')\n"
            "       if m in sys.modules]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("top,bottom", [(["depth"], ["rgba"]),
                                        (["depth", "rgba"], ["rgba", "depth"]),
                                        (["depth"], []), ([], ["rgba"])])
def test_concat_image_matches_jax(tmp_path, top, bottom):
    import cv2

    from prisma_tpu.cli.concat import concat_image as jconcat
    from prisma_tpu_torch.cli.concat import concat_image

    rng = np.random.default_rng(2)
    cv2.imwrite(str(tmp_path / "rgba.png"), rng.integers(0, 256, (10, 12, 3),
                                                         dtype=np.uint8))
    cv2.imwrite(str(tmp_path / "depth.png"), rng.integers(0, 256, (10, 12, 3),
                                                          dtype=np.uint8))
    data = {"bands": {"rgba": {"url": "rgba.png"}, "depth": {"url": "depth.png"}}}
    ours, theirs = str(tmp_path / "ours.png"), str(tmp_path / "theirs.png")
    concat_image(str(tmp_path), ours, data, top, bottom)
    jconcat(str(tmp_path), theirs, data, top, bottom)
    a, b = cv2.imread(ours), cv2.imread(theirs)
    assert a.shape == (10 * (bool(top) + bool(bottom)),
                       12 * max(len(top), len(bottom)), 3)
    np.testing.assert_array_equal(a, b)


def test_concat_video_matches_jax(folder, tmp_path):
    from prisma_tpu.cli.concat import concat_video as jconcat
    from prisma_tpu_torch.cli.concat import concat_video

    path, data = folder
    for top, bottom in ((["depth_anything"], ["rgba"]),
                        (["depth_anything", "rgba"], [])):
        ours, theirs = str(tmp_path / "ours.mp4"), str(tmp_path / "theirs.mp4")
        concat_video(path, ours, data, top, bottom)
        jconcat(path, theirs, data, top, bottom)
        a, b = _decode_frames(ours), _decode_frames(theirs)
        assert len(a) == len(b) == FRAMES
        assert a[0].shape == ((2 * H, W, 3) if bottom else (H, 2 * W, 3))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_concat_main_matches_jax(folder, tmp_path):
    """Both CLIs with their flags and defaults (top depth_patchfusion,
    bottom rgba), on a video folder whose depth band is renamed."""
    from prisma_tpu.cli.concat import main as jmain
    from prisma_tpu_torch.cli.concat import main

    path, data = folder
    data["bands"]["depth_patchfusion"] = data["bands"].pop("depth_anything")
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(data, f)
    ours, theirs = str(tmp_path / "ours.mp4"), str(tmp_path / "theirs.mp4")
    main(["-i", path, "-o", ours])
    jmain(["-input", path, "-output", theirs, "-top", "depth_patchfusion",
           "-bottom", "rgba"])
    a, b = _decode_frames(ours), _decode_frames(theirs)
    assert len(a) == FRAMES and a[0].shape == (2 * H, W, 3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(SystemExit, match="No metadata"):
        main(["-i", str(tmp_path / "nowhere"), "-o", ours])


def test_view_helpers_match_jax(folder):
    from prisma_tpu.cli import view as jview
    from prisma_tpu.io.colmap_model import Camera as JCamera
    from prisma_tpu_torch.cli import view
    from prisma_tpu_torch.io.colmap_model import Camera

    path, data = folder
    ours, theirs = view.extract_values(path, data), jview.extract_values(path, data)
    assert ours == theirs
    assert ours["flow_uv"] == [[1.0, 2.0], [3.5, 4.5]]
    assert ours["camera_frames"] == 5 and ours["camera_model"] == "PINHOLE"

    for img in (_heat_frames(1)[0], _heat_frames(1)[0].astype(np.float32) / 255):
        a = view.decode_depth_band(img, 2.0, 12.0)
        b = jview.decode_depth_band(img, 2.0, 12.0)
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * 12.0)

    for model, params in (("PINHOLE", [600.0, 610.0, 320.0, 240.0]),
                          ("SIMPLE_PINHOLE", [600.0, 320.0, 240.0]),
                          ("OPENCV", [600.0, 610.0, 320.0, 240.0, 0.1])):
        cam = Camera(1, model, 640, 480, np.array(params))
        jcam = JCamera(1, model, 640, 480, np.array(params))
        (a, sa), (b, sb) = (view.scale_camera(cam, (320, 120)),
                            jview.scale_camera(jcam, (320, 120)))
        np.testing.assert_array_equal(sa, sb)
        np.testing.assert_array_equal(a.params, b.params)
        assert (a.model, a.width, a.height) == (b.model, b.width, b.height)


class _Logged:
    """A rerun archetype as the stand-in records it: its name and arguments."""

    def __init__(self, name, args, kwargs):
        self.name, self.args, self.kwargs = name, args, kwargs

    def compress(self, **kwargs):
        return _Logged(self.name + ".compress", (self,), kwargs)

    def key(self):
        return (self.name, _plain(self.args), _plain(self.kwargs))


def _plain(x):
    """Nested records, lists and arrays as tuples of floats and strings."""
    if isinstance(x, _Logged):
        return x.key()
    if isinstance(x, dict):
        return tuple(sorted((k, _plain(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    if isinstance(x, np.ndarray):
        return ("array", x.shape, tuple(x.astype(np.float64).ravel().tolist()))
    if isinstance(x, (np.generic, int, float)) and not isinstance(x, bool):
        return float(x)
    return x


class RecordingRR:
    """A stand-in for the rerun module: every log call, with the time
    sequence set when it was made."""

    class ViewCoordinates:
        RDF = "ViewCoordinates.RDF"
        RIGHT_HAND_Y_DOWN = "ViewCoordinates.RIGHT_HAND_Y_DOWN"

    def __init__(self):
        self.time, self.calls = None, []

    def set_time_sequence(self, timeline, value):
        self.time = (timeline, int(value))

    def log(self, path, *objs, **kwargs):
        self.calls.append((self.time, path, _plain(objs), _plain(kwargs)))

    def __getattr__(self, name):
        return lambda *args, **kwargs: _Logged(name, args, kwargs)


def _assert_same_calls(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert a[:2] == b[:2]
        _assert_close(a[2:], b[2:])


def _assert_close(a, b):
    if isinstance(a, tuple) and a and a[0] == "array":
        assert b[0] == "array" and a[1] == b[1]
        x, y = np.asarray(a[2]), np.asarray(b[2])
        np.testing.assert_allclose(x, y, rtol=0,
                                   atol=1e-6 * max(np.abs(y).max(initial=0), 1))
    elif isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _assert_close(x, y)
    elif isinstance(a, float):
        assert b == pytest.approx(a, rel=1e-6, abs=1e-9)
    else:
        assert a == b


@pytest.mark.parametrize("fn", ["log_values", "log_band_image", "log_band",
                                "log_sparse_reconstruction", "init"])
def test_log_functions_match_jax(folder, monkeypatch, fn):
    from prisma_tpu.cli import view as jview
    from prisma_tpu_torch.cli import view

    path, data = folder
    records = []
    for mod in (view, jview):
        rr = RecordingRR()
        data = json.loads(json.dumps(folder[1]))
        data["values"] = mod.extract_values(path, data)
        if fn == "log_values":
            mod.log_values(rr, data["values"])
        elif fn == "log_band_image":
            frame = _heat_frames(1)[0]
            mod.log_band_image(rr, data, "depth_anything", frame, (24, 16),
                               index=2)
            image_data = dict(data, values={"depth_anything_min": 1.0,
                                            "depth_anything_max": 4.0})
            mod.log_band_image(rr, image_data, "depth_anything", frame, None)
            mod.log_band_image(rr, data, "rgba", _frames(1)[0], (24, 16))
        elif fn == "log_band":
            for band in ("depth_anything", "rgba", "flow", "camera"):
                mod.log_band(rr, path, data, band, (24, 16))
        elif fn == "log_sparse_reconstruction":
            assert mod.log_sparse_reconstruction(rr, path, resize=(24, 16),
                                                 filter_output=False)
            assert mod.log_sparse_reconstruction(rr, path)  # all filtered
            assert not mod.log_sparse_reconstruction(rr, path + "/sparse")
        else:
            monkeypatch.setattr(mod, "_rr", lambda rr=rr: rr)
            mod.init(path, scale=0.5)
        records.append(rr.calls)
    _assert_same_calls(*records)
    paths = {c[1] for c in records[0]}
    expect = {"log_values": "bands/flow_uv", "log_band_image": "bands/rgba",
              "log_band": "bands/depth_anything", "init": "bands/rgba",
              "log_sparse_reconstruction": "bands/keypoints"}[fn]
    assert expect in paths, paths


def test_io_helpers_match_jax(tmp_path, deterministic_x264):
    import cv2

    from prisma_tpu.io import image as jimage
    from prisma_tpu.io import video as jvideo
    from prisma_tpu_torch.io import image, video

    rng = np.random.default_rng(3)
    for img in (rng.integers(0, 256, (6, 5), dtype=np.uint8),
                rng.integers(0, 256, (6, 5, 3), dtype=np.uint8),
                rng.integers(0, 256, (6, 5, 4), dtype=np.uint8)):
        a, b = image.to_float_rgb(img), jimage.to_float_rgb(img)
        assert a.dtype == b.dtype == np.float64 and a.shape == (6, 5, 3)
        np.testing.assert_array_equal(a, b)

    src = tmp_path / "src"
    image.create_folder(str(src / "a" / "b"))
    image.create_folder(str(src / "a" / "b"))  # exists: no error
    (src / "a" / "b" / "f.txt").write_text("x")
    (src / "g.txt").write_text("y")
    image.copy_folder(str(src), str(tmp_path / "ours"))
    jimage.copy_folder(str(src), str(tmp_path / "theirs"))
    image.copy_folder(str(src), str(tmp_path / "ours"))  # into an existing one
    listing = [sorted(os.path.relpath(os.path.join(r, f), d)
                      for r, _, fs in os.walk(d) for f in fs)
               for d in (str(tmp_path / "ours"), str(tmp_path / "theirs"))]
    assert listing[0] == listing[1] == ["a/b/f.txt", "g.txt"]

    clip = str(tmp_path / "clip.mp4")
    _write_clip(clip, _frames(8), fps=24.0)
    for kw in ({}, {"extension": "png", "invert": True}, {"fps": 10},
               {"extension": "png", "fps": 30}):
        out_a, out_b = str(tmp_path / "fa"), str(tmp_path / "fb")
        n = video.extract_frames_from_video(clip, out_a, **kw)
        assert n == jvideo.extract_frames_from_video(clip, out_b, **kw)
        names = sorted(os.listdir(out_a))
        assert names == sorted(os.listdir(out_b)) and len(names) == n
        assert names[0] == f"001.{kw.get('extension', 'jpg')}"
        for name in names:
            np.testing.assert_array_equal(cv2.imread(os.path.join(out_a, name)),
                                          cv2.imread(os.path.join(out_b, name)))
        if kw.get("extension") == "png":
            # the round trip: make_video over the extracted frames
            made_a, made_b = str(tmp_path / "ma.mp4"), str(tmp_path / "mb.mp4")
            video.make_video(made_a, out_a, fps=12)
            jvideo.make_video(made_b, out_b, fps=12)
            a, b = _decode_frames(made_a), _decode_frames(made_b)
            assert len(a) == len(b) == n
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
            assert video.get_video_data(made_a)[2] == pytest.approx(12.0)
        for d in (out_a, out_b):
            for name in os.listdir(d):
                os.remove(os.path.join(d, name))
    with pytest.raises(FileNotFoundError, match="no .png/.jpg"):
        video.make_video(str(tmp_path / "none.mp4"), str(tmp_path / "fa"))


@pytest.fixture
def two_torch_threads():
    """Two intra-op threads for a test that runs a model: the suite runs in
    several worker processes at once, and each torch op spreading over
    every core oversubscribes the machine."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_depth_loop_writes_a_device_trace(tmp_path, monkeypatch,
                                          deterministic_x264,
                                          two_torch_threads):
    """The depth band's video loop with PRISMA_TPU_TRACE set writes a
    torch.profiler Chrome trace into that folder, and the band's outputs
    are those of a run without it."""
    import shutil

    from prisma_tpu_torch.bands import depth_anything_band as band
    from prisma_tpu_torch.runtime.config import RuntimeConfig
    from tests.test_resume import _folder_bytes

    clips = []
    for name in ("plain", "traced"):
        d = tmp_path / name
        os.makedirs(d)
        clips.append(str(d / "clip.mp4"))
    _write_clip(clips[0], _frames(5))
    shutil.copy(clips[0], clips[1])
    rt = dict(batch_size=2, compute_dtype="float32", random_weights=True,
              segment_frames=0, device="cpu")
    run = dict(encoder="vits", img_size=42, npy=True,
               subpath="depth_anything")
    band.run(clips[0], runtime=RuntimeConfig(**rt), **run)
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("PRISMA_TPU_TRACE", str(trace_dir))
    band.run(clips[1], runtime=RuntimeConfig(**rt), **run)

    traces = os.listdir(trace_dir)
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
    with open(trace_dir / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    a, b = (_folder_bytes(os.path.dirname(c)) for c in clips)
    assert set(a) == set(b)
    for name in a:
        if name.endswith(".mp4"):
            for x, y in zip(_decode_frames(os.path.join(tmp_path, "plain", name)),
                            _decode_frames(os.path.join(tmp_path, "traced", name))):
                np.testing.assert_array_equal(x, y)
        elif name != "metadata.json":
            assert a[name] == b[name], name
