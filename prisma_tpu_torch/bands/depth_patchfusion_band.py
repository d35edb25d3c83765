"""depth_patchfusion band driver: tiled high-resolution metric depth
(counterpart of prisma_tpu/bands/depth_patchfusion_band.py).

Reference: `bands/depth_patchfusion.py`, one image or frame at a time in
mode p16, p49 or rN (r128 by default; process.py runs a video at p49),
metric depth written without the flip, the depth bands' CSV, subpath, npy
and ply contract.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from prisma_tpu_torch.bands import depth_base
from prisma_tpu_torch.bands.base import BandIO, resolve
from prisma_tpu_torch.models import patchfusion as pf
from prisma_tpu_torch.runtime.config import RuntimeConfig
from prisma_tpu_torch.weights.store import load_patchfusion

BAND = "depth_patchfusion"


def infer_frames(model: pf.PatchFusion, frames_u8: torch.Tensor, idx0: int = 0,
                 *, mode: str, dtype: torch.dtype,
                 tile_batch: int = 8) -> torch.Tensor:
    """uint8 frames [B, H, W, 3] on the model's device -> depth [B, H, W]
    f32, one frame after the other. idx0 (depth_base's non-fused contract)
    is unused: PatchFusion is deterministic per frame."""
    return torch.stack([pf.infer(model, f, mode=mode, compute_dtype=dtype,
                                 tile_batch=tile_batch) for f in frames_u8])


def build_infer(runtime: RuntimeConfig, mode: str = "r128",
                tile_batch: int = 8):
    """-> (model on runtime's device, cast to its compute dtype with the
    f32 parts kept; infer(model, frames_u8, idx0) -> depth; flip)."""
    device = runtime.resolve_device()
    model, _model_hw = load_patchfusion(runtime)
    dtype = runtime.resolve_dtype()
    model = model.to(device).cast(dtype)
    infer = functools.partial(infer_frames, mode=mode, dtype=dtype,
                              tile_batch=tile_batch)
    return model, infer, False  # metric depth: no flip


def run(input_path: str, output: str = "", subpath: str = "",
        mode: str = "r128", npy: bool = False, ply: bool = False,
        tile_batch: int = 8, runtime: RuntimeConfig | None = None) -> BandIO:
    """tile_batch: tiles per batch within a pass (default 8)."""
    runtime = runtime or RuntimeConfig()
    runtime.resolve_device()  # no card where one is asked for: raise first
    io = resolve(BAND, input_path, output=output, subpath=subpath,
                 force_extension="png", runtime=runtime)
    model, infer, flip = build_infer(runtime, mode=mode, tile_batch=tile_batch)

    if io.is_video():
        need_depth = bool(io.subpath) or npy
        step = depth_base.make_step(model, infer, flip, need_depth, fused=False)
        depth_base.run_video(io, step, flip=flip, npy=npy)
    else:
        def infer_image(frames: np.ndarray) -> np.ndarray:
            x = torch.from_numpy(frames).to(runtime.device)
            return infer(model, x).cpu().numpy()

        depth_base.run_image(io, infer_image, flip=flip, npy=npy, ply=ply)
    return io


def main(argv=None):
    """Standalone band CLI (reference bands/depth_patchfusion.py:230-255)."""
    from prisma_tpu_torch.bands.cli import band_parser, run_guarded, \
        runtime_from_args

    parser = band_parser(BAND, npy_ply=True)
    parser.add_argument("--mode", type=str, default="r128",
                        help="p16, p49 or rN (N random tiles)")
    parser.add_argument("--tile_batch", type=int, default=8,
                        help="tiles per batch within a pass (default 8)")
    args = parser.parse_args(argv)
    run_guarded(BAND, run, args.input, output=args.output,
                subpath=args.subpath, mode=args.mode, npy=args.npy,
                ply=args.ply, tile_batch=args.tile_batch,
                runtime=runtime_from_args(args))


if __name__ == "__main__":
    main()
