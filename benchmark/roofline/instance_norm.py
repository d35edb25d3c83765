"""The instance norm's work from shapes: a frozen copy of chip_smoke.py's
K4 bound (`bound(0, nbytes(x, out))`). The norm of [N, C, H, W] reads x
once and writes the output once; its operations are negligible beside the
bytes, so the bound is the bytes at the card's memory rate."""

from __future__ import annotations

KERNELS = ("instance_norm_relu",)


def nbytes(N: int, C: int, H: int, W: int, elem_bytes: int = 2) -> float:
    return 2.0 * N * C * H * W * elem_bytes


def bound_s(N: int, C: int, H: int, W: int, peak: dict,
            elem_bytes: int = 2) -> float:
    return nbytes(N, C, H, W, elem_bytes) / peak["hbm_bytes_s"]
