"""The depth_marigold band: diffusion depth on one device (counterpart of
prisma_tpu/bands/depth_marigold_band.py).

Reference: `bands/depth_marigold.py` - 10 DDIM steps x 10 ensemble members
at 768 px, relative depth written with flip=False. A video runs through the
non-fused depth step (`depth_base.make_step(fused=False)`), one frame after
the other, each seeded by its global frame index.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from prisma_tpu_torch.bands import depth_base
from prisma_tpu_torch.bands.base import BandIO, resolve
from prisma_tpu_torch.models import marigold as mg
from prisma_tpu_torch.runtime.config import RuntimeConfig
from prisma_tpu_torch.weights.store import load_marigold

BAND = "depth_marigold"
DENOISE_STEPS = 10
ENSEMBLE_SIZE = 10
PROCESSING_RESOLUTION = 768


def infer_frames(model: mg.Marigold, frames_u8: torch.Tensor, idx0: int = 0,
                 *, steps: int, ensemble: int, res: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """uint8 frames [B, H, W, 3] on the model's device -> depth [B, H, W]
    f32, frame idx0 + i seeded by its global index (a resume regroups
    batches; a frame's latents must not depend on the grouping)."""
    return torch.stack([mg.infer(model, f, denoising_steps=steps,
                                 ensemble_size=ensemble, processing_res=res,
                                 seed=idx0 + i, compute_dtype=dtype)
                        for i, f in enumerate(frames_u8)])


def build_infer(runtime: RuntimeConfig, denoise_steps: int = DENOISE_STEPS,
                ensemble_size: int = ENSEMBLE_SIZE,
                processing_res: int = PROCESSING_RESOLUTION):
    """-> (model on runtime's device in its compute dtype, infer(model,
    frames_u8, idx0) -> depth, flip)."""
    device = runtime.resolve_device()
    dtype = runtime.resolve_dtype()
    model = load_marigold(runtime, device=device).to(device=device, dtype=dtype)
    infer = functools.partial(infer_frames, steps=int(denoise_steps),
                              ensemble=int(ensemble_size),
                              res=int(processing_res), dtype=dtype)
    return model, infer, False  # relative depth written without the flip


def run(input_path: str, output: str = "", subpath: str = "",
        denoise_steps: int = DENOISE_STEPS, ensemble_size: int = ENSEMBLE_SIZE,
        processing_res: int = PROCESSING_RESOLUTION, npy: bool = False,
        ply: bool = False, runtime: RuntimeConfig | None = None) -> BandIO:
    runtime = runtime or RuntimeConfig()
    runtime.resolve_device()  # no card where one is asked for: raise first
    io = resolve(BAND, input_path, output=output, subpath=subpath,
                 force_extension="png", runtime=runtime)
    model, infer, flip = build_infer(runtime, denoise_steps, ensemble_size,
                                     processing_res)

    if io.is_video():
        need_depth = bool(io.subpath) or npy
        step = depth_base.make_step(model, infer, flip, need_depth, fused=False)
        depth_base.run_video(io, step, flip=flip, npy=npy)
    else:
        @torch.inference_mode()
        def infer_image(frames: np.ndarray) -> np.ndarray:
            x = torch.from_numpy(frames).to(runtime.device)
            return infer(model, x).cpu().numpy()

        depth_base.run_image(io, infer_image, flip=flip, npy=npy, ply=ply)
    return io


def main(argv=None):
    """Standalone band CLI (reference bands/depth_marigold.py:188-214)."""
    from prisma_tpu_torch.bands.cli import band_parser, run_guarded, \
        runtime_from_args

    parser = band_parser(BAND, npy_ply=True)
    parser.add_argument("--denoise_steps", type=int, default=DENOISE_STEPS)
    parser.add_argument("--ensemble_size", type=int, default=ENSEMBLE_SIZE)
    parser.add_argument("--processing_res", type=int,
                        default=PROCESSING_RESOLUTION)
    args = parser.parse_args(argv)
    run_guarded(BAND, run, args.input, output=args.output,
                subpath=args.subpath, denoise_steps=args.denoise_steps,
                ensemble_size=args.ensemble_size,
                processing_res=args.processing_res, npy=args.npy,
                ply=args.ply, runtime=runtime_from_args(args))


if __name__ == "__main__":
    main()
