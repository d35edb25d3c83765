"""ReRun viewer for PRISMA folders (counterpart of prisma_tpu/cli/view.py;
reference `view.py`).

Streams a band folder into rerun: pinhole camera from the manifest intrinsics,
per-band images/videos (depth bands decoded from the heatmap via rgb_to_heat
and rescaled by the per-frame min/max CSVs, view.py:186-210), CSV value blocks
as time-series scalars (view.py:134-183), and the COLMAP sparse reconstruction
with visible-point filtering (view.py:53-131).

rerun-sdk is an optional dependency, imported in `_rr`, and OpenCV is
imported where an image is resized or read: the pure helpers (value
extraction, depth decode, camera scaling) import and run without either.

    python -m prisma_tpu_torch.cli.view -i <folder> [-s 0.5]
"""

from __future__ import annotations

import argparse
import os
import re

import numpy as np
import torch

from prisma_tpu_torch.io.colmap_model import Camera, read_model
from prisma_tpu_torch.ops import encode as enc
from prisma_tpu_torch.utils import meta

ROOT = "bands/"
DEPTH_SCALING = {
    "depth_midas": 7.0,
    "depth_marigold": 0.3,
    "depth_zoedepth": 1.0,
    "depth_patchfusion": 1.0,
}
FILTER_MIN_VISIBLE = 500


def _rr():
    try:
        import rerun as rr
        return rr
    except ImportError as e:
        raise ImportError(
            "view requires the rerun-sdk package (pip install rerun-sdk)") from e


def scale_camera(camera: Camera, resize: tuple[int, int]):
    """Scale pinhole intrinsics to a resized image (view.py:37-48)."""
    scale = np.array([resize[0] / camera.width, resize[1] / camera.height])
    if camera.model == "PINHOLE":
        params = np.append(camera.params[:2] * scale, camera.params[2:] * scale)
    elif camera.model == "SIMPLE_PINHOLE":
        params = np.append(camera.params[:1] * scale, camera.params[1:] * scale)
    else:
        params = camera.params
    return Camera(camera.id, camera.model, resize[0], resize[1], params), scale


def decode_depth_band(img_rgb: np.ndarray, depth_min: float,
                      depth_max: float) -> np.ndarray:
    """Heatmap frame -> metric-ish depth via hue decode + min/max rescale."""
    rgb = (img_rgb.astype(np.float32) / 255.0 if img_rgb.dtype == np.uint8
           else img_rgb.astype(np.float32))
    heat = enc.rgb_to_heat(torch.from_numpy(rgb)).numpy()
    return depth_min + heat * (depth_max - depth_min)


def extract_values(folder: str, data: dict) -> dict:
    """Load per-band value blocks (CSV series or scalars) — view.py:134-183."""
    values: dict = {}
    for band, entry in data.get("bands", {}).items():
        for name, spec in entry.get("values", {}).items():
            address = f"{band}_{name}"
            t = spec.get("type")
            if "url" in spec:
                with open(os.path.join(folder, spec["url"])) as f:
                    lines = f.readlines()
                if t == "int":
                    values[address] = [int(x) for x in lines]
                elif t == "float":
                    values[address] = [float(x) for x in lines]
                elif t == "vec2":
                    values[address] = [[float(v) for v in x.split(",")]
                                       for x in lines]
            elif "value" in spec:
                v = spec["value"]
                values[address] = int(v) if t == "int" else (
                    float(v) if t == "float" else v)
    return values


def log_values(rr, values: dict) -> None:
    for address, v in values.items():
        if isinstance(v, list):
            for i, item in enumerate(v):
                rr.set_time_sequence("frame", i)
                rr.log(ROOT + address, rr.TimeSeriesScalar(item))
        else:
            rr.set_time_sequence("frame", 0)
            rr.log(ROOT + address, rr.TimeSeriesScalar(v))


def log_band_image(rr, data: dict, band: str, img: np.ndarray,
                   resize, index=None) -> None:
    import cv2

    if resize is None:
        resize = (int(data["width"]), int(data["height"]))
    img = cv2.resize(img, resize)
    if band.startswith("depth"):
        dmin, dmax = 1.0, 10.0
        key_min, key_max = band + "_min", band + "_max"
        vals = data.get("values", {})
        if index is not None:
            if key_min in vals:
                dmin = vals[key_min][index]
            if key_max in vals:
                dmax = vals[key_max][index]
        else:
            dmin = vals.get(key_min, dmin)
            dmax = vals.get(key_max, dmax)
        depth = decode_depth_band(img, dmin, dmax)
        rr.log(ROOT + band,
               rr.DepthImage(depth, meter=DEPTH_SCALING.get(band, 1.0)))
    else:
        rr.log(ROOT + band, rr.Image(img).compress(jpeg_quality=95))


def log_band(rr, folder: str, data: dict, band: str, resize) -> None:
    url = data["bands"][band].get("url")
    if not url:
        return
    path = os.path.join(folder, url)
    if url.endswith(".mp4"):
        from prisma_tpu_torch.io.video import VideoReader
        reader = VideoReader(path)
        for i, frame in enumerate(reader):
            if i >= int(data["frames"]):
                break
            rr.set_time_sequence("frame", i)
            log_band_image(rr, data, band, frame, resize, index=i)
        reader.close()
    elif url.endswith((".png", ".jpg")):
        import cv2
        rr.set_time_sequence("frame", 0)
        img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        log_band_image(rr, data, band, img, resize)


def log_sparse_reconstruction(rr, folder: str, resize=None,
                              filter_output: bool = True) -> bool:
    sparse_path = os.path.join(folder, "sparse", "0")
    if not os.path.isdir(sparse_path):
        return False
    cameras, images, points3D = read_model(sparse_path, ext=".bin")
    if filter_output:
        points3D = {pid: p for pid, p in points3D.items()
                    if p.rgb.any() and len(p.image_ids) > 4}

    for image in sorted(images.values(), key=lambda im: im.name):
        idx_match = re.search(r"\d+", image.name)
        frame_idx = int(idx_match.group(0)) if idx_match else 0
        quat_xyzw = image.qvec[[1, 2, 3, 0]]
        camera = cameras[image.camera_id]
        scale = np.array([1.0, 1.0])
        if resize:
            camera, scale = scale_camera(camera, resize)

        visible = [pid != -1 and pid in points3D for pid in image.point3D_ids]
        visible_ids = image.point3D_ids[visible]
        if filter_output and len(visible_ids) < FILTER_MIN_VISIBLE:
            continue
        pts = [points3D[pid] for pid in visible_ids]
        xys = image.xys[visible] * scale

        rr.set_time_sequence("frame", frame_idx)
        errors = [p.error for p in pts]
        rr.log(ROOT + "avg_reproj_err",
               rr.TimeSeriesScalar(np.mean(errors), color=[240, 45, 58]))
        rr.log("points", rr.Points3D([p.xyz for p in pts],
                                     colors=[p.rgb for p in pts]),
               rr.AnyValues(error=errors))
        rr.log(ROOT, rr.Transform3D(translation=image.tvec,
                                    rotation=rr.Quaternion(xyzw=quat_xyzw),
                                    from_parent=True))
        rr.log(ROOT, rr.ViewCoordinates.RDF, timeless=True)
        rr.log(ROOT, rr.Pinhole(resolution=[camera.width, camera.height],
                                focal_length=camera.params[:2],
                                principal_point=camera.params[2:]))
        rr.log(ROOT + "keypoints", rr.Points2D(xys, colors=[34, 138, 167]))
    return True


def init(folder: str, scale: float = 0.5) -> None:
    rr = _rr()
    data = meta.load_metadata(folder)
    data["values"] = extract_values(folder, data)
    log_values(rr, data["values"])

    resize = (int(int(data["width"]) * scale), int(int(data["height"]) * scale))
    rr.log("bands", rr.ViewCoordinates.RIGHT_HAND_Y_DOWN, timeless=True)

    sparse = False
    frames = int(data.get("frames", 1))
    if "frames" in data:
        sparse = log_sparse_reconstruction(rr, folder, resize=resize)
    if not sparse:
        for frame_idx in range(frames):
            rr.set_time_sequence("frame", frame_idx)
            rr.log(ROOT, rr.Pinhole(
                resolution=list(resize),
                focal_length=[data["focal_length"] * scale] * 2,
                principal_point=[data["principal_point"][0] * scale,
                                 data["principal_point"][1] * scale]))

    for band in data["bands"]:
        log_band(rr, folder, data, band, resize)


def main(argv=None):
    rr = _rr()
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", "-i", help="Input folder", type=str,
                        required=True)
    parser.add_argument("--scale", "-s", help="Scale factor", type=float,
                        default=0.5)
    rr.script_add_args(parser)
    args = parser.parse_args(argv)
    rr.script_setup(args, "view")
    init(args.input, args.scale)
    rr.script_teardown(args)


if __name__ == "__main__":
    main()
