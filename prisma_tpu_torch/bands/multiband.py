"""Fused single-decode multi-band pipeline: mask + depth + flow in one pass
(counterpart of prisma_tpu/bands/multiband.py).

The reference runs one subprocess per band, each decoding the source video
again (reference process.py:60-73). Here the default video run decodes
rgba.mp4 once and drives the three band steps per frame batch in one
process, on one device; each band's mp4s encode on their writers' threads
while the device computes the next batch.

Each band's host epilogue is the sink object its sequential driver uses
(depth_base.DepthVideoSink, flow_base.FlowVideoSink, mask_band.MaskVideoSink),
and the batch and flow-window grouping is the sequential drivers', so the
fused outputs equal running the bands one by one.

Frame-index resume: every output video is segmented; the pipeline resumes
all bands at the least of their completed segment boundaries, so one reader
position serves every sink (bands ahead of it rewrite identical segments).
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from prisma_tpu_torch.bands.base import BAND_MODULES, resolve
from prisma_tpu_torch.io.video import VideoReader
from prisma_tpu_torch.runtime.config import RuntimeConfig
from prisma_tpu_torch.runtime.profiling import StageProfiler

# the video depth bands whose step is one model call (depth_base.make_step),
# as the JAX package fuses them; marigold and patchfusion run after the
# fused steps, one frame at a time
FUSED_DEPTH_BANDS = ("depth_anything", "depth_midas", "depth_zoedepth")


def _resolve_or_skip(band, input_path, runtime, subpath="",
                     force_extension="png"):
    from prisma_tpu_torch.utils import meta
    try:
        io = resolve(band, input_path, output="", subpath=subpath,
                     force_extension=force_extension, runtime=runtime)
    except FileExistsError as e:
        print(f"#  {band}: skipping ({e}); pass --force to recompute")
        return None
    # persist the band entry resolve() registered, so that the next band's
    # resolve loads it (the sequential drivers reload metadata.json between
    # bands)
    if io.data is not None:
        meta.write_metadata(io.meta_root, io.data)
    return io


def build_steps(runtime: RuntimeConfig, H: int, W: int, *,
                mask_on: bool = True, mask_sdf: bool = True,
                mask_confidence: float | None = None,
                depth_band: str | None = "depth_anything",
                depth_build: dict | None = None, depth_need: bool = False,
                flow_band: str | None = "flow_gmflow",
                flow_build: dict | None = None, flow_scale: float = 0.75,
                flow_backwards: bool = False, flow_mask: bool = False,
                flow_flo: bool = False, flow_enc: bool = False):
    """The device steps run_fused dispatches for a batch of (H, W) frames,
    each None where its band is off: -> (mask_step, depth_step, flow_step,
    depth_flip). Options as run_fused's; depth_need: the step returns the
    depth itself (per-frame files, npy); flow_flo / flow_enc: .flo files /
    16-bit PNGs are written."""
    from prisma_tpu_torch.bands import depth_base, flow_base, mask_band

    mask_step = depth_step = flow_step = None
    depth_flip = False
    if mask_on:
        conf = mask_band.CONFIDENCE_THRESHOLD if mask_confidence is None \
            else mask_confidence
        mask_step = mask_band.build_step(runtime, (H, W), conf, mask_sdf)
    if depth_band is not None:
        mod = importlib.import_module(
            f"prisma_tpu_torch.bands.{BAND_MODULES[depth_band]}")
        model, infer, depth_flip = mod.build_infer(runtime, **(depth_build or {}))
        depth_step = depth_base.make_step(model, infer, depth_flip, depth_need)
    if flow_band is not None:
        mod = importlib.import_module(
            f"prisma_tpu_torch.bands.{BAND_MODULES[flow_band]}")
        model, finfer = mod.build_pairs(runtime, **(flow_build or {}))
        if not isinstance(model, torch.nn.Module):
            model = model()  # the band's lazy loader
        flow_step = flow_base.build_flow_step(
            model, finfer, flow_scale, W, H, runtime, backwards=flow_backwards,
            mask=flow_mask, flo=flow_flo, enc=flow_enc)
    return mask_step, depth_step, flow_step, depth_flip


def run_fused(input_path: str, runtime: RuntimeConfig | None = None, *,
              mask_on: bool = True, mask_sdf: bool = True,
              mask_confidence: float | None = None, mask_subpath: str = "",
              depth_band: str | None = "depth_anything",
              depth_build: dict | None = None, depth_subpath: str = "",
              depth_npy: bool = False,
              flow_band: str | None = "flow_gmflow",
              flow_build: dict | None = None, flow_backwards: bool = False,
              flow_mask: bool = False, flow_subpath: str = "",
              flow_subpath_mask: str = "", flow_scale: float = 0.75,
              ) -> dict[str, bool]:
    """Run the asked subset of {mask, depth, flow} over one decode.

    depth_build / flow_build: kwargs of the band module's build_infer /
    build_pairs (encoder=, metric=, img_size= / iterations=,
    inference_size=, cfg=). Returns {band_name: ran} for the bands asked
    for (False: skipped, its output already there)."""
    from prisma_tpu_torch.bands import depth_base, flow_base, mask_band

    runtime = runtime or RuntimeConfig()
    runtime.resolve_device()  # no card where one is asked for: raise first
    if depth_band is not None and depth_band not in FUSED_DEPTH_BANDS:
        raise ValueError(f"{depth_band} is not fusable (fused set: "
                         f"{FUSED_DEPTH_BANDS})")
    ran: dict[str, bool] = {}

    # resolve everything first: an existing output skips before any weight
    # load or device work, as in the sequential drivers
    mask_io = depth_io = flow_io = None
    if mask_on:
        mask_io = _resolve_or_skip(mask_band.BAND, input_path, runtime,
                                   subpath=mask_subpath)
        ran["mask_mmdet"] = mask_io is not None
    if depth_band is not None:
        depth_io = _resolve_or_skip(depth_band, input_path, runtime,
                                    subpath=depth_subpath)
        ran[depth_band] = depth_io is not None
    if flow_band is not None:
        flow_io = _resolve_or_skip(flow_band, input_path, runtime,
                                   force_extension="mp4")
        ran[flow_band] = flow_io is not None

    ios = [io for io in (mask_io, depth_io, flow_io) if io is not None]
    if not ios:
        return ran
    print(f"\n#  {' + '.join(io.band.upper() for io in ios)} "
          f"(fused single-decode)")

    # one metadata dict shared by every sink; the last resolved io saw every
    # earlier band's entry (persisted above)
    shared = next((io.data for io in reversed(ios) if io.data is not None),
                  None)
    if shared is not None:
        for io in ios:
            io.data = shared

    reader = VideoReader(ios[0].input)
    W, H, fps = reader.width, reader.height, reader.fps
    B = runtime.batch_size
    win = max(1, B - 1) + 1  # a flow window: pairs_per_batch consecutive pairs

    # the resume point: the least of the active bands' completed segments.
    # Sinks may lower it further (a short ledger); rebuild until they agree.
    seg = runtime.segment_frames
    global_start = 0
    if seg:
        from prisma_tpu_torch.io.video import SegmentedVideoWriter
        global_start = min(SegmentedVideoWriter.completed_frames(io.output, seg)
                           for io in ios)

    # the device steps (weights load only for bands that will run)
    mask_step, depth_step, flow_step, depth_flip = build_steps(
        runtime, H, W, mask_on=mask_io is not None, mask_sdf=mask_sdf,
        mask_confidence=mask_confidence,
        depth_band=depth_band if depth_io is not None else None,
        depth_build=depth_build,
        depth_need=depth_io is not None and (bool(depth_io.subpath)
                                             or depth_npy),
        flow_band=flow_band if flow_io is not None else None,
        flow_build=flow_build, flow_scale=flow_scale,
        flow_backwards=flow_backwards, flow_mask=flow_mask,
        flow_flo=bool(flow_subpath), flow_enc=bool(flow_subpath_mask))

    def build_sinks(start):
        sinks = {}
        if mask_io is not None:
            sinks["mask"] = mask_band.MaskVideoSink(mask_io, W, H, fps,
                                                    sdf=mask_sdf, start=start)
        if depth_io is not None:
            sinks["depth"] = depth_base.DepthVideoSink(
                depth_io, W, H, fps, flip=depth_flip, npy=depth_npy,
                start=start)
        if flow_io is not None:
            sinks["flow"] = flow_base.FlowVideoSink(
                flow_io, W, H, fps, backwards=flow_backwards, mask=flow_mask,
                subpath=flow_subpath, subpath_mask=flow_subpath_mask,
                start=start)
        return sinks

    sinks = build_sinks(global_start if seg else None)
    while seg and min(s.start for s in sinks.values()) != global_start:
        global_start = min(s.start for s in sinks.values())
        for s in sinks.values():
            if getattr(s, "ledger", None) is not None:
                s.ledger.close()
        sinks = build_sinks(global_start)

    # the fused loop: all three steps for a batch, then each band's sink
    reader.skip(global_start)
    prof = StageProfiler()

    def run_step(step, x):
        with prof.host("prisma.step"):
            return step(x)

    prof.start_device_trace()
    frames_done = 0
    flow_buf: list[np.ndarray] = []
    for frames, valid in prof.iterate(reader.batches(B, pad_to_full=True),
                                      "prisma.decode_wait"):
        mask_out = run_step(mask_step, frames) if mask_step is not None \
            else None
        depth_out = run_step(depth_step, frames) if depth_step is not None \
            else None
        flow_outs = []
        if flow_step is not None:
            flow_buf.extend(frames[:valid])
            while len(flow_buf) >= win:
                window = np.stack(flow_buf[:win])
                flow_buf = flow_buf[win - 1:]
                flow_outs.append(run_step(flow_step, window))
        with prof.stage("prisma.sink"):
            if mask_out is not None:
                sinks["mask"].emit(mask_out, valid)
            if depth_out is not None:
                sinks["depth"].emit(depth_out, valid)
            for out in flow_outs:
                sinks["flow"].emit(out, win - 1)
        frames_done += valid

    # flow tail: a short final window pads by repeating the last frame (the
    # grouping of flow_base.run_flow_band)
    if flow_step is not None and len(flow_buf) > 1:
        n_pairs = len(flow_buf) - 1
        while len(flow_buf) < win:
            flow_buf.append(flow_buf[-1])
        out = run_step(flow_step, np.stack(flow_buf))
        with prof.stage("prisma.sink"):
            sinks["flow"].emit(out, n_pairs)

    if "mask" in sinks:
        sinks["mask"].close()
        mask_band.finish_meta(mask_io, mask_subpath)
    if "depth" in sinks:
        sinks["depth"].close()
    if "flow" in sinks:
        sinks["flow"].close()
    reader.close()
    prof.stop_device_trace()
    prof.report(items=frames_done)
    return ran
