"""Shared argparse plumbing for the standalone band CLIs.

Every reference band is an independently runnable argparse tool with a common
flag core (`bands/depth_midas.py:170-218`, `bands/mask_mmdet.py:150-198`, …):
`-i/--input`, `-o/--output`, `--subpath`, and for the depth bands `--npy` /
`--ply`. The port keeps that surface per band and adds the runtime knobs the
flow CLIs introduced (`--batch`, `--dtype`, `--random_weights`,
`--segment_frames`) plus `--force`: without it a band whose output already
exists is SKIPPED (the non-interactive equivalent of the reference's
`check_overwrite` prompt, `bands/common/io.py:35-51`, which defaults to No).
"""

from __future__ import annotations

import argparse

from prisma_tpu_torch.runtime.config import RuntimeConfig


def band_parser(band: str, npy_ply: bool = False,
                subpath_default: str = "") -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog=f"python -m prisma_tpu_torch.bands.{band}")
    parser.add_argument("--input", "-i", help="input image/video/PRISMA folder",
                        type=str, required=True)
    parser.add_argument("--output", "-o", help="output image/video", type=str,
                        default="")
    parser.add_argument("--subpath", "-d", help="subpath to per-frame files",
                        type=str, default=subpath_default)
    if npy_ply:
        parser.add_argument("--npy", "-n", help="save numpy data",
                            action="store_true")
        parser.add_argument("--ply", "-p", help="create point-cloud PLY",
                            action="store_true")
    add_runtime_flags(parser)
    return parser


def add_runtime_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--batch", help="frames per device step", type=int,
                        default=8)
    parser.add_argument("--dtype", type=str, default="bfloat16",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--random_weights", action="store_true",
                        help="random-init models (smoke runs)")
    parser.add_argument("--segment_frames", type=int, default=64,
                        help="mp4 segment size for frame-index resume "
                             "(0 disables resume)")
    parser.add_argument("--force", "-F", action="store_true",
                        help="recompute even if the output already exists")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="where the models run (default: the CUDA card; "
                             "cpu runs the kernels' plain versions)")


def runtime_from_args(args) -> RuntimeConfig:
    return RuntimeConfig(batch_size=args.batch, compute_dtype=args.dtype,
                         random_weights=args.random_weights,
                         segment_frames=args.segment_frames,
                         overwrite=args.force, device=args.device)


def run_guarded(band: str, fn, *args, **kwargs):
    """Call a band's run(); turn the exists-and-not-forced case into a skip."""
    try:
        return fn(*args, **kwargs)
    except FileExistsError as e:
        print(f"[{band}] skipping: {e}; pass --force to recompute")
        return None
