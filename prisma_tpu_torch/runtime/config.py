"""Typed runtime configuration shared by all bands (counterpart of
prisma_tpu/runtime/config.py, with torch dtypes and an explicit device)."""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import torch


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
    # torch device the models run on: the card; a caller who wants the CPU
    # asks for it with device="cpu" (the CLIs' --device cpu)
    device: str = "cuda"

    def resolve_dtype(self) -> torch.dtype:
        return {"float32": torch.float32,
                "bfloat16": torch.bfloat16}[self.compute_dtype]

    def resolve_device(self) -> torch.device:
        """The device to run on; asking for the card where there is none
        raises, before any work: the port never falls back to the CPU."""
        device = torch.device(self.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {self.device!r} asked for, but torch sees no CUDA "
                "card; pass device='cpu' (--device cpu) to run on the CPU")
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"device must be cuda or cpu, not {self.device!r}")
        return device

    def resolve_encode_workers(self) -> int:
        if self.encode_workers > 0:
            return self.encode_workers
        return max(1, min(4, (os.cpu_count() or 1) // 2))
