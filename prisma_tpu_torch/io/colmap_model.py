"""COLMAP sparse-reconstruction reader (binary + text formats); the port's
copy of prisma_tpu/io/colmap_model.py.

Implements the documented COLMAP model layout (cameras/images/points3D in .bin or
.txt form) used by the camera_colmap band and the viewer. Functional parity with the
reference's vendored reader (`bands/common/colmap.py`), implemented
from the format specification.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

# model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS_BY_NAME = {name: (mid, n) for mid, (name, n) in CAMERA_MODELS.items()}


@dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class Image:
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3D_ids: np.ndarray


@dataclass
class Point3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def qvec2rotmat(qvec) -> np.ndarray:
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
    ])


def rotmat2qvec(R) -> np.ndarray:
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
    ]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read(f, fmt: str):
    size = struct.calcsize("<" + fmt)
    return struct.unpack("<" + fmt, f.read(size))


def read_cameras_binary(path: str) -> dict[int, Camera]:
    cameras = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "iiQQ")
            name, num_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, "d" * num_params))
            cameras[cam_id] = Camera(cam_id, name, width, height, params)
    return cameras


def read_images_binary(path: str) -> dict[int, Image]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            vals = _read(f, "idddddddi")
            image_id, camera_id = vals[0], vals[8]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (num_pts,) = _read(f, "Q")
            data = np.frombuffer(f.read(24 * num_pts),
                                 dtype=[("x", "<f8"), ("y", "<f8"), ("id3d", "<i8")])
            xys = np.stack([data["x"], data["y"]], axis=-1) if num_pts else np.zeros((0, 2))
            images[image_id] = Image(image_id, qvec, tvec, camera_id,
                                     name.decode("utf-8"), xys, data["id3d"].copy())
    return images


def read_points3D_binary(path: str) -> dict[int, Point3D]:
    points = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            vals = _read(f, "QdddBBBd")
            pid = vals[0]
            xyz = np.array(vals[1:4])
            rgb = np.array(vals[4:7])
            error = vals[7]
            (track_len,) = _read(f, "Q")
            track = np.frombuffer(f.read(8 * track_len),
                                  dtype=[("image_id", "<i4"), ("p2d", "<i4")])
            points[pid] = Point3D(pid, xyz, rgb, error,
                                  track["image_id"].copy(), track["p2d"].copy())
    return points


def read_cameras_text(path: str) -> dict[int, Camera]:
    cameras = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            elems = line.split()
            cam_id = int(elems[0])
            cameras[cam_id] = Camera(cam_id, elems[1], int(elems[2]), int(elems[3]),
                                     np.array(tuple(map(float, elems[4:]))))
    return cameras


def read_images_text(path: str) -> dict[int, Image]:
    images = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip() and not ln.strip().startswith("#")]
    for head, pts in zip(lines[0::2], lines[1::2]):
        elems = head.split()
        image_id = int(elems[0])
        qvec = np.array(tuple(map(float, elems[1:5])))
        tvec = np.array(tuple(map(float, elems[5:8])))
        camera_id = int(elems[8])
        name = elems[9]
        pe = pts.split()
        xys = np.stack([np.array(list(map(float, pe[0::3]))),
                        np.array(list(map(float, pe[1::3])))], axis=-1) if pe else np.zeros((0, 2))
        ids = np.array(list(map(int, pe[2::3])), dtype=np.int64) if pe else np.zeros(0, np.int64)
        images[image_id] = Image(image_id, qvec, tvec, camera_id, name, xys, ids)
    return images


def read_points3D_text(path: str) -> dict[int, Point3D]:
    points = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            elems = line.split()
            pid = int(elems[0])
            xyz = np.array(tuple(map(float, elems[1:4])))
            rgb = np.array(tuple(map(int, elems[4:7])))
            error = float(elems[7])
            image_ids = np.array(list(map(int, elems[8::2])))
            p2d = np.array(list(map(int, elems[9::2])))
            points[pid] = Point3D(pid, xyz, rgb, error, image_ids, p2d)
    return points


def detect_model_format(path: str, ext: str) -> bool:
    return all(os.path.isfile(os.path.join(path, f + ext))
               for f in ("cameras", "images", "points3D"))


def read_model(path: str, ext: str = ""):
    """Read a COLMAP model dir -> (cameras, images, points3D) dicts."""
    if ext == "":
        if detect_model_format(path, ".bin"):
            ext = ".bin"
        elif detect_model_format(path, ".txt"):
            ext = ".txt"
        else:
            raise FileNotFoundError(f"no COLMAP model found in {path}")
    if ext == ".bin":
        return (read_cameras_binary(os.path.join(path, "cameras.bin")),
                read_images_binary(os.path.join(path, "images.bin")),
                read_points3D_binary(os.path.join(path, "points3D.bin")))
    return (read_cameras_text(os.path.join(path, "cameras.txt")),
            read_images_text(os.path.join(path, "images.txt")),
            read_points3D_text(os.path.join(path, "points3D.txt")))
