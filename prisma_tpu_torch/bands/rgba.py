"""rgba band: normalize the input into the PRISMA folder (reference bands/rgba.py;
the port's copy of prisma_tpu/bands/rgba.py).

- images: re-encode input as rgba.png (rgba.py:103-109)
- videos: decode->re-encode (strips audio) to rgba.mp4, writing INVERTED
  (255 - frame) per-frame PNGs to the images/ subpath (rgba.py:93-99 — the
  inversion feeds COLMAP masking downstream)
- RGBD side-by-side splits (left/right/top/bottom) with optional hue-encoded
  Record3D depth -> heatmap conversion (rgba.py:24-75)
"""

from __future__ import annotations

import os

import numpy as np
import torch

from prisma_tpu_torch.bands.base import BandIO
from prisma_tpu_torch.io.image import open_float_rgb, write_rgb
from prisma_tpu_torch.io.video import VideoReader, VideoWriter
from prisma_tpu_torch.ops import encode as enc


def _crop_rects(width: int, height: int, split: str):
    """(rgb_crop, depth_crop) as (x, y, w, h), matching rgba.py:29-40."""
    rects = {
        "left": ((width // 2, 0, width // 2, height), (0, 0, width // 2, height)),
        "right": ((0, 0, width // 2, height), (width // 2, 0, width // 2, height)),
        "top": ((0, height // 2, width, height // 2), (0, 0, width, height // 2)),
        "bottom": ((0, 0, width, height // 2), (0, height // 2, width, height // 2)),
    }
    return rects[split]


def _crop(frame: np.ndarray, rect) -> np.ndarray:
    x, y, w, h = rect
    return frame[y:y + h, x:x + w]


def _hue_depth_to_heat(frame_u8: np.ndarray) -> np.ndarray:
    """Record3D hue-encoded depth -> heatmap RGB (rgba.py:61-63)."""
    hue = enc.rgb_hue(torch.from_numpy(frame_u8.astype(np.float32))).numpy()
    hue = np.clip(hue / 360.0, 0.0, 1.0)
    return enc.heat_to_rgb(torch.from_numpy(hue)).numpy() * 255.0


def process_image(io: BandIO) -> None:
    image = open_float_rgb(io.input)
    write_rgb(io.output, image)


def process_video(io: BandIO, fps: float = 24, rgbd: str = "none",
                  encoding_depth: str = "none", output_depth: str = "") -> None:
    reader = VideoReader(io.input)
    if rgbd == "none":
        writer = VideoWriter(reader.width, reader.height, fps, filename=io.output)
        for i, frame in enumerate(reader):
            if io.subpath:
                write_rgb(os.path.join(io.subpath, f"{i:06d}.png"),
                          (255.0 - np.clip(frame, 0, 255)) / 255.0)
            writer.write(frame)
        writer.close()
    else:
        rgb_rect, depth_rect = _crop_rects(reader.width, reader.height, rgbd)
        rgb_writer = VideoWriter(rgb_rect[2], rgb_rect[3], fps, filename=io.output)
        depth_writer = VideoWriter(depth_rect[2], depth_rect[3], fps,
                                   filename=output_depth)
        for i, frame in enumerate(reader):
            rgb = _crop(frame, rgb_rect)
            depth = _crop(frame, depth_rect).astype(np.float64)
            if encoding_depth == "hue":
                depth = _hue_depth_to_heat(depth.astype(np.uint8))
            if io.subpath:
                write_rgb(os.path.join(io.subpath, f"{i:06d}.png"),
                          (255.0 - np.clip(rgb, 0, 255)) / 255.0)
            rgb_writer.write(rgb)
            depth_writer.write(depth.astype(np.uint8))
        rgb_writer.close()
        depth_writer.close()
    reader.close()


def run(io: BandIO, fps: float = 24, rgbd: str = "none",
        encoding_depth: str = "none", output_depth: str = "") -> None:
    if io.is_video():
        process_video(io, fps=fps, rgbd=rgbd, encoding_depth=encoding_depth,
                      output_depth=output_depth)
    else:
        process_image(io)
    io.finish()


def main(argv=None):
    """Standalone band CLI (reference bands/rgba.py:125-190)."""
    from prisma_tpu_torch.bands.base import resolve
    from prisma_tpu_torch.bands.cli import band_parser, runtime_from_args

    parser = band_parser("rgba")
    parser.add_argument("--fps", "-r", help="fix framerate of videos",
                        type=float, default=24)
    parser.add_argument("--rgbd", help="where the depth half is",
                        choices=["none", "left", "right", "top", "bottom"],
                        default="none")
    parser.add_argument("--encoding_depth", choices=["none", "hue"],
                        default="none", help="encoding of the depth half")
    parser.add_argument("--output_depth", type=str, default="",
                        help="output file for the split-off depth video")
    args = parser.parse_args(argv)
    try:
        io = resolve("rgba", args.input, output=args.output,
                     subpath=args.subpath, runtime=runtime_from_args(args))
    except FileExistsError as e:
        print(f"[rgba] skipping: {e}; pass --force to recompute")
        return
    run(io, fps=args.fps, rgbd=args.rgbd, encoding_depth=args.encoding_depth,
        output_depth=args.output_depth)


if __name__ == "__main__":
    main()
