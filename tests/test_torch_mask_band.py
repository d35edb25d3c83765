"""The port's mask band against the JAX package's, on an image and on a
short clip, with one set of SOLOv2 weights (the JAX package's random init,
handed to both bands by patching each band's loader) at a test scale of
160x96, in float32 on the CPU.

The file inventory and metadata.json must be equal. The mask is a sum of
255-white instance masks: where the two packages' mask probabilities sit
within ~1e-6 of the 0.5 threshold a pixel may flip, and an instance whose
decayed score sits within ~2e-3 of the 0.5 confidence may be kept on one
side only (tests/test_torch_solov2.py holds the slab itself). So the frames
are held to: at most 0.5% of pixels apart in the composite channels (red,
blue, the inverted PNGs), and the SDF green channel equal wherever the
composite is (it is a function of the composite); decoded mp4 frames as x264
allows (tests/test_multiband.py's bounds) outside the pixels whose
composite differs.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax

from prisma_tpu.bands import mask_band as jband
from prisma_tpu.models import solov2 as jsolo
from prisma_tpu.runtime.config import RuntimeConfig as JaxRuntimeConfig
from prisma_tpu_torch.bands import mask_band as band
from prisma_tpu_torch.models import solov2
from prisma_tpu_torch.runtime.config import RuntimeConfig
from prisma_tpu_torch.weights.from_jax import solov2_state_dict
from tests.test_flow_raft_band import _make_folder
from tests.test_resume import _decode_frames, _folder_bytes
from tests.test_torch_rgba import deterministic_x264  # noqa: F401

pytestmark = pytest.mark.usefixtures("deterministic_x264")

SCALE = (160, 96)
RT = dict(batch_size=2, compute_dtype="float32", random_weights=True,
          segment_frames=2)
FLIP_SHARE = 0.005


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two intra-op threads a test: the suite runs in several worker
    processes at once, and each torch op spreading over every core of the
    machine oversubscribes it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return jax.jit(jsolo.init_params)(jax.random.key(3))


@pytest.fixture
def same_weights(params, monkeypatch):
    """Both bands' loaders hand out the one set of weights."""
    sd = solov2_state_dict(jax.tree.map(np.asarray, params))

    def port_loader(runtime, cfg=None):
        model = solov2.build(cfg or solov2.SOLOv2Config())
        model.load_state_dict(sd)
        return model

    monkeypatch.setattr(jband, "load_solov2", lambda runtime, cfg=None: params)
    monkeypatch.setattr(band, "load_solov2", port_loader)


def _run_both(src, dst, **kw):
    jband.run(src, runtime=JaxRuntimeConfig(weight_cache=False, **RT),
              cfg=jsolo.SOLOv2Config(scale=SCALE), sdf=True, **kw)
    band.run(dst, runtime=RuntimeConfig(device="cpu", **RT),
             cfg=solov2.SOLOv2Config(scale=SCALE), sdf=True, **kw)


def _compare_frames(ours, theirs, inverted=False):
    """ours, theirs [H, W, 3] uint8 decoded from PNG (exact) frames."""
    ours, theirs = ours.astype(int), theirs.astype(int)
    comp = np.any(ours[..., [0, 2]] != theirs[..., [0, 2]], axis=-1)
    if inverted:  # all three channels are 255 - composite
        comp |= ours[..., 1] != theirs[..., 1]
    assert comp.mean() <= FLIP_SHARE, comp.mean()
    if not inverted:
        np.testing.assert_array_equal(ours[..., 1][~comp], theirs[..., 1][~comp])
    return comp


def test_mask_band_image(tmp_path, same_weights):
    import cv2
    img = np.random.default_rng(0).integers(0, 255, (96, 128, 3)).astype(np.uint8)
    for d in ("jax", "port"):
        os.makedirs(tmp_path / d)
        cv2.imwrite(str(tmp_path / d / "photo.png"), img)
    _run_both(str(tmp_path / "jax" / "photo.png"),
              str(tmp_path / "port" / "photo.png"))
    theirs = cv2.imread(str(tmp_path / "jax" / "mask.png"))[..., ::-1]
    ours = cv2.imread(str(tmp_path / "port" / "mask.png"))[..., ::-1]
    assert ours.shape == theirs.shape == (96, 128, 3)
    _compare_frames(ours, theirs)
    kept = float((theirs[..., 0] > 0).mean())
    levels = np.unique(theirs[..., 0])
    print(f"kept mask pixels: {kept:.3f}; composite levels {levels.tolist()}")
    # random weights keep overlapping instances at this seed: the composite
    # (a wrapped sum of 255s) takes several values
    assert kept > 0 and len(levels) > 1


def test_mask_band_clip(tmp_path, same_weights):
    import cv2
    jfolder = _make_folder(tmp_path / "jax", frames=3, w=128, h=96)
    folder = str(tmp_path / "port" / "seq")
    shutil.copytree(jfolder, folder)  # the same input bytes
    _run_both(jfolder, folder, subpath="mask")

    jb, pb = _folder_bytes(jfolder), _folder_bytes(folder)
    assert set(pb) == set(jb)
    assert json.loads(pb["metadata.json"]) == json.loads(jb["metadata.json"])
    assert json.loads(pb["metadata.json"])["bands"]["mask"]["ids"] == band.CLASSES
    diff = {}
    for i in range(3):
        name = os.path.join("mask", f"{i:05d}.png")
        ours, theirs = (cv2.imread(os.path.join(f, name))[..., ::-1]
                        for f in (folder, jfolder))
        diff[i] = _compare_frames(ours, theirs, inverted=True)
    ours, theirs = (_decode_frames(os.path.join(f, "mask.mp4"))
                    for f in (folder, jfolder))
    assert len(ours) == len(theirs) == 3
    for i, (a, b) in enumerate(zip(ours, theirs)):
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))[~diff[i]]
        assert d.mean() < 1.5 and d.max() <= 40
