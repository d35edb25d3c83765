"""Typed runtime configuration shared by all bands (counterpart of
prisma_tpu/runtime/config.py, with torch dtypes and an explicit device)."""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import torch


def _default_device() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


@dataclass
class RuntimeConfig:
    """Execution knobs shared by all bands."""
    batch_size: int = 8                  # frames per device step (video)
    compute_dtype: str = "bfloat16"      # model dtype on device
    overwrite: bool = True               # non-interactive by default (library use)
    models_dir: str = field(
        default_factory=lambda: os.environ.get("PRISMA_TPU_MODELS", "models"))
    random_weights: bool = False         # tests / smoke runs without checkpoints
    # frame-index resume: video bands write fixed-size mp4 segments and a
    # min/max ledger; a killed run resumes at the last complete segment
    # (0 = single-session writer, no resume)
    segment_frames: int = 64
    # x264 preset for band output mp4s ("" = x264's default, medium)
    x264_preset: str = "veryfast"
    # concurrent segment encoders per output stream; 0 = auto from host cores
    encode_workers: int = 0
    # torch device the models run on: the card when there is one
    device: str = field(default_factory=_default_device)

    def resolve_dtype(self) -> torch.dtype:
        return {"float32": torch.float32,
                "bfloat16": torch.bfloat16}[self.compute_dtype]

    def resolve_encode_workers(self) -> int:
        if self.encode_workers > 0:
            return self.encode_workers
        return max(1, min(4, (os.cpu_count() or 1) // 2))
