"""Contact-sheet concatenation of bands (counterpart of
prisma_tpu/cli/concat.py; reference `concat.py`).

Builds one image or video from a PRISMA folder: bands in the top list are
horizontally concatenated, likewise the bottom list, and the two rows are
stacked vertically (concat.py:23-117). Defaults: top=depth_patchfusion,
bottom=rgba (concat.py:19-20). Videos go through the port's native-codec
reader and writer; images through OpenCV, imported where they are read.

    python -m prisma_tpu_torch.cli.concat -i <folder> -o <out.png|out.mp4>
        [-t band ...] [-b band ...]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from prisma_tpu_torch.io.video import VideoReader, VideoWriter
from prisma_tpu_torch.utils import meta

DEFAULT_TOP = ["depth_patchfusion"]
DEFAULT_BOTTOM = ["rgba"]


def _band_path(folder: str, data: dict, band: str) -> str:
    return os.path.join(folder, data["bands"][band]["url"])


def _row(images):
    """The images side by side (as cv2.hconcat), or None for none."""
    return np.concatenate(images, axis=1) if images else None


def _stack(top_row, bottom_row):
    """The two rows one above the other (as cv2.vconcat); a missing row
    leaves the other alone."""
    if top_row is None:
        return bottom_row
    if bottom_row is None:
        return top_row
    return np.concatenate([top_row, bottom_row], axis=0)


def concat_image(folder: str, output: str, data: dict, top, bottom) -> None:
    import cv2

    top_row = _row([cv2.imread(_band_path(folder, data, b)) for b in top])
    bottom_row = _row([cv2.imread(_band_path(folder, data, b)) for b in bottom])
    cv2.imwrite(output, _stack(top_row, bottom_row))


def concat_video(folder: str, output: str, data: dict, top, bottom) -> None:
    readers = {b: VideoReader(_band_path(folder, data, b))
               for b in list(top) + list(bottom)}
    width = max(sum(readers[b].width for b in row) or 0
                for row in (top, bottom) if row) if (top or bottom) else 0
    height = (max((readers[b].height for b in top), default=0)
              + max((readers[b].height for b in bottom), default=0))

    writer = VideoWriter(width, height, data["fps"], filename=output)
    for _ in range(int(data["frames"])):
        top_row = _row([readers[b].read() for b in top])
        bottom_row = _row([readers[b].read() for b in bottom])
        writer.write(_stack(top_row, bottom_row))
    writer.close()
    for r in readers.values():
        r.close()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-input", "-i", help="Input folder", type=str,
                        required=True)
    parser.add_argument("-output", "-o", help="Output file", type=str,
                        required=True)
    parser.add_argument("-top", "-t", help="Top row of bands", type=str,
                        nargs="+")
    parser.add_argument("-bottom", "-b", help="Bottom row of bands", type=str,
                        nargs="+")
    args = parser.parse_args(argv)

    data = meta.load_metadata(args.input)
    if data is None:
        raise SystemExit(f"ERROR: No metadata found in {args.input}")
    top = args.top or DEFAULT_TOP
    bottom = args.bottom or DEFAULT_BOTTOM
    if meta.is_video(data["bands"]["rgba"]["url"]):
        concat_video(args.input, args.output, data, top, bottom)
    else:
        concat_image(args.input, args.output, data, top, bottom)


if __name__ == "__main__":
    main()
