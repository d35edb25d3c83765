"""The port's camera_colmap band and COLMAP reader (host-only copies) against
the JAX package's, with a fake `colmap` binary on the PATH whose mapper
drops a staged text model: camera_pose.csv and metadata.json equal, byte for
byte and key for key; without the binary both skip and register nothing.
"""

import json
import os
import stat
import sys

import numpy as np

from prisma_tpu.bands import camera_colmap_band as jband
from prisma_tpu_torch.bands import camera_colmap_band as band
from prisma_tpu_torch.io import colmap_model
from prisma_tpu_torch.utils import meta

FAKE_COLMAP = """#!{python}
import os, shutil, sys

if len(sys.argv) > 1 and sys.argv[1] == "mapper":
    out = sys.argv[sys.argv.index("--output_path") + 1]
    dst = os.path.join(out, "0")
    if not os.path.isdir(dst):
        shutil.copytree(os.environ["COLMAP_FAKE_MODEL"], dst)
"""


def _stage_text_model(path):
    """A COLMAP text model: one SIMPLE_PINHOLE camera, three images (given
    out of name order), one point."""
    os.makedirs(path)
    with open(os.path.join(path, "cameras.txt"), "w") as f:
        f.write("# CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]\n"
                "1 SIMPLE_PINHOLE 96 64 80.5 48 32\n")
    rng = np.random.default_rng(0)
    with open(os.path.join(path, "images.txt"), "w") as f:
        for image_id, name in ((2, "000001.png"), (1, "000000.png"),
                               (3, "000002.png")):
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            t = rng.normal(size=3)
            f.write(f"{image_id} {' '.join(map(repr, q.tolist()))} "
                    f"{' '.join(map(repr, t.tolist()))} 1 {name}\n10.5 20.5 1\n")
    with open(os.path.join(path, "points3D.txt"), "w") as f:
        f.write("1 0.1 0.2 2.0 9 9 9 0.5 1 0\n")


def _folder(root):
    folder = str(root / "clip")
    os.makedirs(os.path.join(folder, "images"))
    for i in range(3):
        open(os.path.join(folder, "images", f"{i:06d}.png"), "wb").close()
    data = meta.create_metadata(folder)
    meta.add_band(data, "rgba", url="rgba.mp4")
    meta.write_metadata(folder, data)
    return folder


def test_camera_band_matches_jax_band(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    shim = bindir / "colmap"
    shim.write_text(FAKE_COLMAP.format(python=sys.executable))
    shim.chmod(shim.stat().st_mode | stat.S_IEXEC)
    staged = str(tmp_path / "staged")
    _stage_text_model(staged)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    monkeypatch.setenv("COLMAP_FAKE_MODEL", staged)

    jfolder = _folder(tmp_path / "jax")
    folder = _folder(tmp_path / "port")
    jband.run(jfolder)
    band.run(folder)
    ours = open(os.path.join(folder, "camera_pose.csv")).read()
    theirs = open(os.path.join(jfolder, "camera_pose.csv")).read()
    assert ours == theirs and len(ours.splitlines()) == 4  # header + 3 frames
    m = json.load(open(os.path.join(folder, "metadata.json")))
    assert m == json.load(open(os.path.join(jfolder, "metadata.json")))
    assert m["bands"]["camera_pose"]["url"] == "camera_pose.csv"
    assert m["focal_length"] == 80.5 and m["principal_point"] == [80.5, 48.0]
    cams, imgs, pts = colmap_model.read_model(os.path.join(folder, "sparse", "0"))
    assert sorted(img.name for img in imgs.values()) == [
        f"{i:06d}.png" for i in range(3)]
    assert cams[1].model == "SIMPLE_PINHOLE" and len(pts) == 1


def test_camera_band_skips_without_colmap(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    folder = _folder(tmp_path)
    before = open(os.path.join(folder, "metadata.json")).read()
    band.run(folder)
    assert "colmap binary not found" in capsys.readouterr().out
    assert not os.path.exists(os.path.join(folder, "camera_pose.csv"))
    assert json.load(open(os.path.join(folder, "metadata.json"))) == \
        json.loads(before)
