"""Image read/write helpers (counterpart of prisma_tpu/io/image.py; the
slice's two: read an RGB image, write a uint8 RGB image).

cv2 is imported inside the functions, so that the port imports on machines
without OpenCV; only reading and writing image files needs it.
"""

from __future__ import annotations

import numpy as np


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


def write_rgb_u8(path: str, rgb_u8: np.ndarray) -> None:
    """Write uint8 RGB (e.g. a device-encoded heatmap frame) to an image file."""
    import cv2
    cv2.imwrite(path, cv2.cvtColor(np.asarray(rgb_u8), cv2.COLOR_RGB2BGR))
