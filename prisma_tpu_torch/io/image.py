"""Image read/write helpers (counterpart of prisma_tpu/io/image.py).

cv2 is imported inside the functions, so that the port imports on machines
without OpenCV; only reading and writing image files needs it.
"""

from __future__ import annotations

import os

import numpy as np


def create_folder(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def copy_folder(src: str, dst: str) -> None:
    """Recursive folder copy (reference io.py copy_folder)."""
    import shutil

    shutil.copytree(src, dst, dirs_exist_ok=True)


def get_image_size(path: str) -> tuple[int, int]:
    """(width, height) of an image file."""
    import cv2
    img = cv2.imread(path)
    return img.shape[1], img.shape[0]


def open_float_rgb(path: str) -> np.ndarray:
    """Open image as float RGB in [0, 1]."""
    return open_rgb(path).astype(np.float64) / 255.0


def open_rgb(path: str) -> np.ndarray:
    """Open image as uint8 RGB."""
    import cv2
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    if img.ndim == 2:
        img = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
    elif img.shape[2] == 4:
        img = cv2.cvtColor(img, cv2.COLOR_BGRA2BGR)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def to_float_rgb(image) -> np.ndarray:
    """An image array (gray, RGB or RGBA uint8) -> float RGB in [0, 1]."""
    img = np.array(image)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img[..., :3].astype(np.float64) / 255.0


def write_rgb(path: str, rgb: np.ndarray) -> None:
    """Write float RGB in [0, 1] to an image file."""
    import cv2
    bgr = cv2.cvtColor((np.asarray(rgb) * 255).astype(np.uint8), cv2.COLOR_RGB2BGR)
    cv2.imwrite(path, bgr)


def write_rgb_u8(path: str, rgb_u8: np.ndarray) -> None:
    """Write uint8 RGB (e.g. a device-encoded heatmap frame) to an image file."""
    import cv2
    cv2.imwrite(path, cv2.cvtColor(np.asarray(rgb_u8), cv2.COLOR_RGB2BGR))
