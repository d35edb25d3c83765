"""Shared band-driver skeleton.

Every reference band driver follows the same shape (SURVEY.md §2.3): try
load_metadata(input); if the input is a PRISMA folder, rewrite input to the rgba
band url and output via get_target; check overwrite; dispatch image/video;
write_metadata. This module centralizes that contract for the in-process bands.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

from prisma_tpu_torch.runtime.config import RuntimeConfig
from prisma_tpu_torch.utils import meta

# the bands the port runs, by the module of prisma_tpu_torch.bands that
# holds each one's run(); a band of the JAX package missing here is not
# ported yet
BAND_MODULES = {"depth_anything": "depth_anything_band",
                "flow_gmflow": "flow_gmflow_band",
                "flow_raft": "flow_raft_band",
                "mask_mmdet": "mask_band",
                "camera_colmap": "camera_colmap_band"}


def not_ported(bands) -> str:
    """'' if the port has every band of `bands`, else a message naming the
    ones it lacks."""
    missing = [b for b in bands if b not in BAND_MODULES]
    return "" if not missing else (
        f"not ported yet: {', '.join(missing)} (see ROADMAP.md queue 1)")


@dataclass
class BandIO:
    """Resolved inputs/outputs of a band invocation."""
    band: str
    input: str
    output: str
    data: Optional[dict]          # loaded metadata (None outside a PRISMA folder)
    meta_root: str                # path whose metadata we update on finish
    subpath: str = ""             # per-frame output folder (absolute, if set)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)

    @property
    def output_folder(self) -> str:
        return os.path.dirname(self.output)

    def is_video(self) -> bool:
        return meta.is_video(self.output)

    def finish(self) -> None:
        meta.write_metadata(self.meta_root, self.data)

    def set_values_url(self, values: dict) -> None:
        if self.data is not None:
            self.data["bands"].setdefault(self.band, {})["values"] = values

    def set_folder(self, folder: str) -> None:
        if self.data is not None:
            self.data["bands"].setdefault(self.band, {})["folder"] = folder


def resolve(band: str, input_path: str, output: str = "", subpath: str = "",
            force_extension: str = "png",
            runtime: Optional[RuntimeConfig] = None) -> BandIO:
    """Reference driver input resolution (e.g. bands/depth_anything.py:267-276)."""
    runtime = runtime or RuntimeConfig()
    data = meta.load_metadata(input_path)
    meta_root = input_path
    if data is not None:
        resolved_input = meta.get_url(input_path, data, "rgba")
        output = meta.get_target(resolved_input, data, band=band, target=output,
                                 force_extension=force_extension)
        input_path = resolved_input
    elif output == "" or os.path.isdir(output):
        base = os.path.basename(input_path).rsplit(".", 1)
        ext = base[1] if meta.is_video(input_path) else force_extension
        folder = output if os.path.isdir(output) else os.path.dirname(input_path)
        output = os.path.join(folder, f"{band}.{ext}")

    io = BandIO(band=band, input=input_path, output=output, data=data,
                meta_root=meta_root, runtime=runtime)
    if subpath:
        io.set_folder(subpath)
        io.subpath = os.path.join(io.output_folder, subpath)
        os.makedirs(io.subpath, exist_ok=True)
    if not runtime.overwrite and os.path.exists(output):
        raise FileExistsError(f"{output} exists (overwrite disabled)")
    return io
