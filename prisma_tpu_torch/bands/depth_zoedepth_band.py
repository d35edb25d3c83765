"""depth_zoedepth band driver: ZoeD_N metric depth (counterpart of
prisma_tpu/bands/depth_zoedepth_band.py).

Reference: `bands/depth_zoedepth.py`, `model.infer_pil` (pad and flip
augmented), metric depth written without the flip
(depth_zoedepth.py:56,100-171).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from prisma_tpu_torch.bands import depth_base
from prisma_tpu_torch.bands.base import BandIO, resolve
from prisma_tpu_torch.models import zoed
from prisma_tpu_torch.runtime.config import RuntimeConfig
from prisma_tpu_torch.weights.store import load_zoed

BAND = "depth_zoedepth"


def build_infer(runtime: RuntimeConfig, img_size=None):
    """-> (model, infer, flip), shared by run() and bands/multiband.py: the
    model on runtime's device, its core in the compute dtype (the bins head
    f32), and infer(model, frames_u8) -> depth.

    img_size: (h, w) of the BEiT input, multiples of 32; None = the
    reference's (384, 512). Smaller grids are for smoke and CI runs."""
    device = runtime.resolve_device()
    dtype = runtime.resolve_dtype()
    model = load_zoed(runtime).to(device).cast_core(dtype)
    img_size = tuple(int(v) for v in img_size) if img_size else zoed.IMG_SIZE
    infer = functools.partial(zoed.infer, compute_dtype=dtype,
                              img_size=img_size)
    return model, infer, False  # metric depth: no flip


def run(input_path: str, output: str = "", subpath: str = "",
        npy: bool = False, ply: bool = False, img_size=None,
        runtime: RuntimeConfig | None = None) -> BandIO:
    """img_size: see build_infer."""
    runtime = runtime or RuntimeConfig()
    runtime.resolve_device()  # no card where one is asked for: raise first
    io = resolve(BAND, input_path, output=output, subpath=subpath,
                 force_extension="png", runtime=runtime)
    model, infer, flip = build_infer(runtime, img_size=img_size)

    if io.is_video():
        need_depth = bool(io.subpath) or npy
        step = depth_base.make_step(model, infer, flip, need_depth)
        depth_base.run_video(io, step, flip=flip, npy=npy)
    else:
        @torch.inference_mode()
        def infer_image(frames: np.ndarray) -> np.ndarray:
            x = torch.from_numpy(frames).to(runtime.device)
            return infer(model, x).cpu().numpy()

        depth_base.run_image(io, infer_image, flip=flip, npy=npy, ply=ply)
    return io


def main(argv=None):
    """Standalone band CLI (reference bands/depth_zoedepth.py:170-200)."""
    from prisma_tpu_torch.bands.cli import band_parser, run_guarded, \
        runtime_from_args

    parser = band_parser(BAND, npy_ply=True)
    parser.add_argument("--img_size", type=int, nargs=2, default=None,
                        metavar=("H", "W"),
                        help="BEiT input size (default 384 512)")
    args = parser.parse_args(argv)
    run_guarded(BAND, run, args.input, output=args.output,
                subpath=args.subpath, npy=args.npy, ply=args.ply,
                img_size=args.img_size, runtime=runtime_from_args(args))


if __name__ == "__main__":
    main()
