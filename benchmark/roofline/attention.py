"""Attention's work from shapes: a frozen copy of the counts of
prisma_tpu_torch/runtime/check_attention.py and chip_smoke.py's `bound`.

A call is softmax(q kᵀ) v over B independent rows of N queries and M keys,
with q and k of width d and v of width dv. Its operations are the two
products, 2 B N M (d + dv); its bytes are each input read once and the
output written once. Its bound is the larger of the operations at the
card's bf16 peak and the bytes at its memory rate."""

from __future__ import annotations

import json
import os

KERNELS = tuple(json.load(open(os.path.join(os.path.dirname(__file__),
                                            "attention.json")))
                ["kernel_substrings"])


def call(B: int, N: int, M: int, d: int, dv: int, qk_bytes: int = 2,
         v_bytes: int = 2, out_bytes: int = 2) -> dict:
    """One attention call's shapes and element sizes."""
    return dict(B=B, N=N, M=M, d=d, dv=dv, qk_bytes=qk_bytes,
                v_bytes=v_bytes, out_bytes=out_bytes)


def flops(c: dict) -> float:
    return 2.0 * c["B"] * c["N"] * c["M"] * (c["d"] + c["dv"])


def nbytes(c: dict) -> float:
    B, N, M = c["B"], c["N"], c["M"]
    return (c["qk_bytes"] * B * (N + M) * c["d"]
            + c["v_bytes"] * B * M * c["dv"]
            + c["out_bytes"] * B * N * c["dv"])


def bound_s(c: dict, peak: dict) -> float:
    """The least time the card could take for the call, in seconds."""
    return max(flops(c) / peak["bf16_flop_s"], nbytes(c) / peak["hbm_bytes_s"])


def is_attention(kernel_name: str) -> bool:
    low = kernel_name.lower()
    return any(s in low for s in KERNELS)
