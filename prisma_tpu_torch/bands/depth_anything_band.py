"""depth_anything band driver: Depth-Anything on one device, relative or
metric (counterpart of prisma_tpu/bands/depth_anything_band.py).

Reference: `bands/depth_anything.py` — the relative model (DPT head,
flip=True on write) or the metric one (ZoeDepth head over the
DepthAnythingCore, no flip; process.py passes --metric outdoor by default,
process.py:53).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from prisma_tpu_torch.bands import depth_base
from prisma_tpu_torch.bands.base import BandIO, resolve
from prisma_tpu_torch.models import depth_anything as da
from prisma_tpu_torch.models import zoedepth as zoe
from prisma_tpu_torch.runtime.config import RuntimeConfig
from prisma_tpu_torch.runtime.profiling import SETUP_WEIGHTS, timed
from prisma_tpu_torch.weights.store import load_depth_anything

BAND = "depth_anything"


def build_infer(runtime: RuntimeConfig, encoder: str = "vitl",
                metric: str = "none", img_size=None):
    """-> (model, infer, flip): the model on runtime's device in its compute
    dtype (the metric model's bins head stays f32), and infer(model,
    frames_u8) -> depth.

    img_size: the inference budget, multiples of 14: for the relative model
    the lower-bound resize target (default 518), an int or a one-element
    sequence; for the metric model the core size (default (392, 518)), one
    int (square) or H W."""
    device = runtime.resolve_device()
    kind, model, _enc = load_depth_anything(runtime, encoder=encoder,
                                            metric=metric)
    dtype = runtime.resolve_dtype()
    if kind == "metric":
        with timed(SETUP_WEIGHTS):
            model = model.to(device=device).cast_core(dtype)
        if img_size is None:
            size = (392, 518)
        elif hasattr(img_size, "__len__"):
            size = tuple(int(v) for v in img_size) if len(img_size) > 1 \
                else (int(img_size[0]),) * 2
        else:
            size = (int(img_size),) * 2
        infer = functools.partial(zoe.metric_depth_anything_infer,
                                  img_size=size, compute_dtype=dtype)
        return model, infer, False
    with timed(SETUP_WEIGHTS):
        model = model.to(device=device, dtype=dtype)
    target = 518 if img_size is None else \
        int(img_size[0] if hasattr(img_size, "__len__") else img_size)
    infer = functools.partial(da.infer, compute_dtype=dtype, target=target)
    return model, infer, True


def run(input_path: str, output: str = "", subpath: str = "",
        encoder: str = "vitl", metric: str = "none", npy: bool = False,
        ply: bool = False, img_size=None,
        runtime: RuntimeConfig | None = None) -> BandIO:
    """img_size: see build_infer."""
    runtime = runtime or RuntimeConfig()
    runtime.resolve_device()  # no card where one is asked for: raise first
    io = resolve(BAND, input_path, output=output, subpath=subpath,
                 force_extension="png", runtime=runtime)
    model, infer, flip = build_infer(runtime, encoder=encoder, metric=metric,
                                     img_size=img_size)

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
    """Standalone band CLI (reference bands/depth_anything.py:254-292)."""
    from prisma_tpu_torch.bands.cli import band_parser, run_guarded, \
        runtime_from_args

    parser = band_parser(BAND, npy_ply=True)
    parser.add_argument("--encoder", type=str, default="vitl",
                        choices=["vits", "vitb", "vitl"])
    parser.add_argument("--metric", type=str, default="none",
                        choices=["none", "indoor", "outdoor"],
                        help="use the metric (ZoeDepth-head) model")
    parser.add_argument("--img_size", type=int, nargs="+", default=None,
                        help="inference budget: one int (relative resize "
                             "target, default 518) or H W (metric core size, "
                             "default 392 518); multiples of 14")
    args = parser.parse_args(argv)
    run_guarded(BAND, run, args.input, output=args.output,
                subpath=args.subpath, encoder=args.encoder, metric=args.metric,
                npy=args.npy, ply=args.ply, img_size=args.img_size,
                runtime=runtime_from_args(args))


if __name__ == "__main__":
    main()
