"""Band sidecar writers: range-encoded depth heatmap PNGs, binary PLY,
Middlebury .flo, 16-bit packed flow PNGs, per-frame CSV (counterpart of the
depth and flow writers of prisma_tpu/io/writers.py).

Output bytes follow the reference (`bands/common/io.py:138-211`,
`bands/common/geom.py`). The heatmap math is the port's torch
`ops.encode.depth_to_heatmap`; the range pixels are re-derived in float64 for
exact 24-bit packing. cv2 is imported inside the functions that need it.
"""

from __future__ import annotations

import numpy as np
import torch

from prisma_tpu_torch.io.image import write_rgb_u8
from prisma_tpu_torch.ops import encode as enc


def np_float_to_rgb(value: float, min_value: float = 0.0, max_value: float = 1.0,
                    base: int = 256) -> np.ndarray:
    """float64-exact 24-bit fixed-point packing (for PNG range pixels)."""
    L = np.clip((value - min_value) / (max_value - min_value), 0.0, 1.0)
    L = L * (base ** 3 - 1)
    return np.array(
        [
            np.floor(L % base) / (base - 1),
            np.floor(L / base) % base / (base - 1),
            np.floor(L / (base * base)) % base / (base - 1),
        ]
    )


def write_depth(path: str, depth: np.ndarray, normalize: bool = True,
                flip: bool = False, heatmap: bool = False,
                encode_range: bool = True) -> None:
    """Write a depth map as a range-encoded heatmap PNG or a 16-bit PNG."""
    depth = np.asarray(depth, dtype=np.float64)
    if heatmap:
        rgb_u8, _, _ = enc.depth_to_heatmap(
            torch.from_numpy(depth.astype(np.float32)), normalize=normalize,
            flip=flip, encode_range=False)
        rgb_u8 = rgb_u8.numpy()
        if encode_range:
            dmin, dmax = float(depth.min()), float(depth.max())
            rgb_u8[0, 0] = np.floor(np_float_to_rgb(dmin, 0.0, 1000.0) * 255).astype(np.uint8)
            rgb_u8[0, 1] = np.floor(np_float_to_rgb(dmax, 0.0, 1000.0) * 255).astype(np.uint8)
        write_rgb_u8(path, rgb_u8)
    else:
        import cv2
        if normalize:
            dmin, dmax = depth.min(), depth.max()
            depth = (depth - dmin) / (dmax - dmin)
        if flip:
            depth = 1.0 - depth
        max_val = (2 ** 16) - 1
        cv2.imwrite(path, (depth * max_val).astype("uint16"))


def write_flo(path: str, flow: np.ndarray) -> None:
    """Middlebury .flo: magic 202021.25 (f32), width/height (i32), row-major f32 data."""
    flow = np.asarray(flow, dtype=np.float32)
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.array([202021.25], dtype=np.float32).tofile(f)
        np.array([w], dtype=np.int32).tofile(f)
        np.array([h], dtype=np.int32).tofile(f)
        flow.tofile(f)


def write_flow_png16(path: str, encoded_u16: np.ndarray) -> None:
    """16-bit packed flow+validity PNG (`--subpath_mask` output).

    The reference (bands/common/flow.py:96) passes `encode_flow`'s
    (u, v, valid) uint16 array straight to cv2.imwrite, which treats the
    channels as BGR: the file stores them reversed. The same call on the
    same array gives the same bytes."""
    import cv2
    cv2.imwrite(path, np.ascontiguousarray(encoded_u16.astype(np.uint16)))


def read_flo(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)[0]
        if abs(magic - 202021.25) >= 1e-3:
            raise ValueError(f"bad .flo magic in {path}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        return np.fromfile(f, np.float32, count=h * w * 2).reshape(h, w, 2)


def write_csv(path: str, values) -> None:
    """One value per line, matching the reference's per-frame stat CSVs."""
    with open(path, "w") as f:
        for v in values:
            f.write(f"{v}\n")


def create_point_cloud(depth: np.ndarray, u0: float, v0: float,
                       fx: float = 1000.0, fy: float = 1000.0) -> np.ndarray:
    """Unproject a (median-blurred) depth map to camera-space points [H, W, 3]."""
    import cv2
    depth = cv2.medianBlur(np.asarray(depth, dtype=np.float32), 5)
    H, W = depth.shape
    x = (np.arange(W, dtype=np.float32)[None, :] - u0) / fx
    y = (np.arange(H, dtype=np.float32)[:, None] - v0) / fy
    pts = np.stack([np.broadcast_to(x, (H, W)),
                    -np.broadcast_to(y, (H, W)),
                    -np.ones((H, W), dtype=np.float32)], axis=2)
    return depth[:, :, None] * pts


def save_point_cloud(pcl: np.ndarray, rgb: np.ndarray, path: str,
                     binary: bool = True) -> None:
    """Binary little-endian PLY with x/y/z float32 + red/green/blue uint8."""
    assert pcl.shape[0] == rgb.shape[0]
    n = pcl.shape[0]
    verts = np.empty(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                               ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    verts["x"], verts["y"], verts["z"] = pcl[:, 0], pcl[:, 1], pcl[:, 2]
    verts["red"], verts["green"], verts["blue"] = (
        rgb[:, 0].astype(np.uint8), rgb[:, 1].astype(np.uint8), rgb[:, 2].astype(np.uint8))
    fmt = "binary_little_endian" if binary else "ascii"
    header = (
        f"ply\nformat {fmt} 1.0\nelement vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            verts.tofile(f)
        else:
            for v in verts:
                f.write(f"{v['x']} {v['y']} {v['z']} {v['red']} {v['green']} {v['blue']}\n".encode())


def write_pcl(path: str, depth: np.ndarray, rgb: np.ndarray, flip: bool = False) -> None:
    """Depth + RGB -> PLY point cloud (principal point at image center)."""
    depth = np.asarray(depth)
    if flip:
        dmin, dmax = depth.min(), depth.max()
        norm = (depth - dmin) / (dmax - dmin)
        depth = dmin + (1.0 - norm) * (dmax - dmin)
    pcl = create_point_cloud(depth, rgb.shape[1] / 2, rgb.shape[0] / 2)
    save_point_cloud(pcl.reshape(-1, 3), np.asarray(rgb).reshape(-1, 3), path)
