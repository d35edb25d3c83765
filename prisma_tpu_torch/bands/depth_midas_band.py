"""The depth_midas band: MiDaS on one device, all four reference model
versions (counterpart of prisma_tpu/bands/depth_midas_band.py).

Reference: `bands/depth_midas.py:26-64` - midas2 and midas2-small load
MiDaS v2.1, midas3 and midas3-small DPT_Large; the -small versions use the
hub's small transform (target 256) in place of the default (384). All
resize to the upper bound at multiples of 32, normalise with ImageNet's
statistics, resize the disparity back bicubic with align_corners, and
write the heatmap with flip=True.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from prisma_tpu_torch.bands import depth_base
from prisma_tpu_torch.bands.base import BandIO, resolve
from prisma_tpu_torch.models import midas
from prisma_tpu_torch.runtime.config import RuntimeConfig
from prisma_tpu_torch.weights.store import MIDAS_VERSIONS, load_midas

BAND = "depth_midas"


def build_infer(runtime: RuntimeConfig, model_version: str = "midas3",
                target: int | None = None):
    """-> (model on runtime's device in its compute dtype, infer(model,
    frames_u8) -> disparity, flip), shared by run() and bands/multiband.py.

    target: the upper-bound resize budget; None = the reference transform's
    (256 for the -small versions, else 384)."""
    device = runtime.resolve_device()
    arch, model = load_midas(runtime, model_version)
    dtype = runtime.resolve_dtype()
    model = model.to(device=device, dtype=dtype)
    if target is None:
        target = 256 if model_version.endswith("-small") else 384
    infer = functools.partial(midas.infer_v2 if arch == "v2" else midas.infer,
                              compute_dtype=dtype, target=int(target))
    return model, infer, True  # disparity: near is 1 after the flip


def run(input_path: str, output: str = "", subpath: str = "",
        model_version: str = "midas3", npy: bool = False, ply: bool = False,
        target: int | None = None,
        runtime: RuntimeConfig | None = None) -> BandIO:
    """target: see build_infer."""
    runtime = runtime or RuntimeConfig()
    runtime.resolve_device()  # no card where one is asked for: raise first
    io = resolve(BAND, input_path, output=output, subpath=subpath,
                 force_extension="png", runtime=runtime)
    model, infer, flip = build_infer(runtime, model_version=model_version,
                                     target=target)

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
    """Standalone band CLI (reference bands/depth_midas.py:170-218)."""
    from prisma_tpu_torch.bands.cli import band_parser, run_guarded, \
        runtime_from_args

    parser = band_parser(BAND, npy_ply=True)
    parser.add_argument("--model", type=str, default="midas3",
                        choices=list(MIDAS_VERSIONS),
                        help="model_version (depth_midas.py:26)")
    parser.add_argument("--img_size", type=int, default=None,
                        help="upper-bound resize target (default 384, "
                             "256 for -small variants)")
    args = parser.parse_args(argv)
    run_guarded(BAND, run, args.input, output=args.output,
                subpath=args.subpath, model_version=args.model, npy=args.npy,
                ply=args.ply, target=args.img_size,
                runtime=runtime_from_args(args))


if __name__ == "__main__":
    main()
