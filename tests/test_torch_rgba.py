"""The port's rgba band (bands/rgba.py) and the io helpers it and the
process entry point use, against the JAX package's, on one clip and one
image.

- a plain clip: the inverted per-frame PNGs equal; rgba.mp4 decoded within
  x264's bounds (mean < 1.5, max 40, as tests/test_multiband.py holds two
  encodes of the same frames);
- a Record3D-style side-by-side clip (RGB left, hue-encoded depth right,
  `--rgbd right --encoding_depth hue`): the same for the RGB half, the
  hue-to-heat conversion of each frame's depth half within 1e-3 of 255 (f32
  on both sides) and depth.mp4 decoded within x264's bounds;
- an image: rgba.png equal;
- every mp4 encoded at x264's ultrafast preset, the one that gives the same
  bitstream for the same frames under load (deterministic_x264);
- io.image.get_image_size, io.image.open_float_rgb and
  io.video.get_video_data equal.
"""

import os
import shutil

import numpy as np
import pytest

from tests.test_resume import _decode_frames

W, H, FRAMES = 96, 64, 4


@pytest.fixture
def deterministic_x264(monkeypatch):
    """Every mp4 either package writes in the test encoded at x264's
    ultrafast preset. At its default (medium) and veryfast presets, x264
    under load (the suite's worker processes on a shared host) can return
    different bitstreams for the same frames: on these 96x64 frames two such
    encodes decoded up to 1.8 levels apart in mean, above the 1.5 bar for
    two encodes of (nearly) the same frames. Ultrafast gave one bitstream in
    80 encodes under the same load. Both packages open their writers through
    the same native call, which this wraps."""
    from prisma_tpu.io import video as jvideo
    from prisma_tpu_torch.io import video

    for mod in (jvideo, video):
        lib = mod._load_lib()
        real = lib.pvc_open_writer

        def open_writer(*args, _real=real):
            return _real(*args[:-1], b"ultrafast")

        monkeypatch.setattr(lib, "pvc_open_writer", open_writer)


pytestmark = pytest.mark.usefixtures("deterministic_x264")


def _side_by_side_frames():
    """RGB gradients in the left half, a hue ramp (the Record3D depth
    encoding: full saturation and value, hue = depth) in the right."""
    import cv2
    yy, xx = np.mgrid[0:H, 0:W // 2]
    out = []
    for i in range(FRAMES):
        rgb = np.stack([(xx * 5 + i * 10) % 256, (yy * 3) % 256,
                        (xx + yy + i * 7) % 256], -1).astype(np.uint8)
        hue = ((xx + yy * 2 + i * 9) % 180).astype(np.uint8)  # cv2: 0..179
        hsv = np.stack([hue, np.full_like(hue, 255), np.full_like(hue, 255)], -1)
        depth = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)
        out.append(np.concatenate([rgb, depth], axis=1))
    return out


def _write_clip(path, frames):
    from prisma_tpu.io.video import VideoWriter
    wr = VideoWriter(frames[0].shape[1], frames[0].shape[0], 24.0,
                     filename=path)
    for f in frames:
        wr.write(f)
    wr.close()


def _both(tmp_path, name, argv):
    """Run both packages' rgba CLI on copies of `name` in folders jax/ and
    port/ -> (jax folder, port folder)."""
    from prisma_tpu.bands import rgba as jrgba
    from prisma_tpu_torch.bands import rgba

    folders = []
    for side, main, extra in (("jax", jrgba.main, []),
                              ("port", rgba.main, ["--device", "cpu"])):
        folder = tmp_path / side
        os.makedirs(folder)
        src = str(folder / name)
        shutil.copy(str(tmp_path / name), src)
        args = [a.replace("{folder}", str(folder)) for a in argv]
        main(["-i", src] + args + extra)
        folders.append(str(folder))
    return folders


def _assert_pngs_equal(a_dir, b_dir, n):
    import cv2
    names = sorted(os.listdir(a_dir))
    assert names == sorted(os.listdir(b_dir)) and len(names) == n
    for name in names:
        a, b = (cv2.imread(os.path.join(d, name)) for d in (a_dir, b_dir))
        np.testing.assert_array_equal(a, b, err_msg=name)


def _assert_videos_close(a, b, n):
    ours, theirs = _decode_frames(a), _decode_frames(b)
    assert len(ours) == len(theirs) == n
    for i, (x, y) in enumerate(zip(ours, theirs)):
        d = np.abs(x.astype(np.int32) - y.astype(np.int32))
        assert d.mean() < 1.5 and d.max() <= 40, (a, i, d.mean(), d.max())


def test_rgba_video_matches_jax(tmp_path):
    from tests.test_multiband import _make_video
    _make_video(str(tmp_path / "clip.mp4"), frames=FRAMES, w=W, h=H)
    jdir, pdir = _both(tmp_path, "clip.mp4", ["--subpath", "{folder}/images"])
    _assert_pngs_equal(os.path.join(jdir, "images"),
                       os.path.join(pdir, "images"), FRAMES)
    _assert_videos_close(os.path.join(pdir, "rgba.mp4"),
                         os.path.join(jdir, "rgba.mp4"), FRAMES)


def test_rgba_rgbd_hue_split_matches_jax(tmp_path):
    from prisma_tpu.bands import rgba as jrgba
    from prisma_tpu.io.video import VideoReader
    from prisma_tpu_torch.bands import rgba

    _write_clip(str(tmp_path / "r3d.mp4"), _side_by_side_frames())
    jdir, pdir = _both(tmp_path, "r3d.mp4",
                       ["--subpath", "{folder}/images", "--rgbd", "right",
                        "--encoding_depth", "hue",
                        "--output_depth", "{folder}/depth.mp4"])
    _assert_pngs_equal(os.path.join(jdir, "images"),
                       os.path.join(pdir, "images"), FRAMES)
    _assert_videos_close(os.path.join(pdir, "rgba.mp4"),
                         os.path.join(jdir, "rgba.mp4"), FRAMES)
    _assert_videos_close(os.path.join(pdir, "depth.mp4"),
                         os.path.join(jdir, "depth.mp4"), FRAMES)
    r = VideoReader(str(tmp_path / "r3d.mp4"))
    for frame in r:
        half = np.asarray(frame)[:, W // 2:].astype(np.uint8)
        ours, theirs = rgba._hue_depth_to_heat(half), jrgba._hue_depth_to_heat(half)
        assert ours.shape == theirs.shape == (H, W // 2, 3)
        assert np.ptp(theirs) > 100  # the ramp spans the heat map
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-3)
    r.close()


def test_rgba_image_and_io_helpers_match_jax(tmp_path):
    import cv2

    from prisma_tpu.io import image as jimage
    from prisma_tpu.io import video as jvideo
    from prisma_tpu_torch.io import image, video
    from tests.test_multiband import _make_video

    photo = np.random.default_rng(0).integers(0, 256, (H, W, 3)).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "photo.png"), photo)
    jdir, pdir = _both(tmp_path, "photo.png", [])
    a, b = (cv2.imread(os.path.join(d, "rgba.png")) for d in (pdir, jdir))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, photo)

    path = str(tmp_path / "photo.png")
    assert image.get_image_size(path) == jimage.get_image_size(path) == (W, H)
    ours, theirs = image.open_float_rgb(path), jimage.open_float_rgb(path)
    assert ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)
    clip = str(tmp_path / "clip.mp4")
    _make_video(clip, frames=FRAMES, w=W, h=H)
    assert video.get_video_data(clip) == jvideo.get_video_data(clip) \
        == (W, H, pytest.approx(24.0), FRAMES)
