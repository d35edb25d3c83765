"""Plain float32 reference of the default video run (`process.py -i
clip.mp4`): the mask band (SOLOv2 R101-FPN with the SDF,
benchmark/reference/solov2.py), metric Depth-Anything (the ZoeDepth head
over the ViT-L core, benchmark/reference/zoedepth.py, heat-mapped without
the flip) and GMFlow at its default flags (benchmark/reference/gmflow.py),
over one segment of frames.

The weights of the three checkpoints live in one state_dict, each key under
its band's name ("mask.", "depth.", "flow."); the configuration holds each
band's sizes under the same names. For a segment of T frames the outputs
have T - 1 rows, as the fused step's: mask and depth of frames [0, T - 1),
flow of the T - 1 pairs; or only the rows asked for. Each departure from
the published description is noted in the band's module.
"""

from __future__ import annotations

import torch

from benchmark.reference import gmflow, solov2, zoedepth
from benchmark.reference.common import Ops, depth_heat

BANDS = {"mask": solov2, "depth": zoedepth, "flow": gmflow}


def param_specs(cfg: dict) -> list:
    return [(f"{band}.{n}", s, i) for band, mod in BANDS.items()
            for n, s, i in mod.param_specs(cfg[band])]


def split(sd: dict) -> dict:
    """{band: its state_dict, the band's prefix taken off}."""
    out = {band: {} for band in BANDS}
    for k, v in sd.items():
        band, name = k.split(".", 1)
        out[band][name] = v
    return out


def band_outputs(sd: dict, frames_u8: torch.Tensor, cfg: dict,
                 ops: Ops = Ops(), frame_rows=None, pair_rows=None,
                 mask_tol: float = 0.0) -> dict:
    """The fused step's outputs for one segment, named as its:
    'mask.composite', 'mask.green', 'depth.heat', 'depth.min', 'depth.max',
    'flow.fwd_rgb', 'flow.max_disp'; and the mask band's others under
    'mask.' (solov2.band_outputs with the tolerance mask_tol: the band of
    masks 'sure' to 'maybe', their greens, the instances a frame).
    frame_rows / pair_rows (ascending indices, None: all): the frames of
    mask and depth and the pairs of flow computed; the rows come in that
    order."""
    by_band = split(sd)
    n = frames_u8.shape[0] - 1
    frames = frames_u8[list(range(n)) if frame_rows is None else frame_rows]
    pairs = range(n) if pair_rows is None else pair_rows
    mask = solov2.band_outputs(by_band["mask"], frames, cfg["mask"], ops,
                               tol=mask_tol)
    heat, dmin, dmax = depth_heat(zoedepth.metric_depth(
        by_band["depth"], frames, cfg["depth"], ops), flip=False)
    flows = [gmflow.band_outputs(by_band["flow"], frames_u8[t:t + 2],
                                 cfg["flow"], backwards=False, mask=False,
                                 ops=ops) for t in pairs]
    return {**{f"mask.{k}": v for k, v in mask.items()},
            "depth.heat": heat, "depth.min": dmin,
            "depth.max": dmax,
            "flow.fwd_rgb": torch.cat([f["fwd_rgb"] for f in flows]),
            "flow.max_disp": torch.cat([f["max_disp"] for f in flows])}
