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

The device part of the loop is `FusedDispatch` (the steps on a batch, the
flow buffer and its windows, the padded tail window); `segment_step` runs
it over a segment of frames held in memory, with no decode and no sink, as
a benchmark calls it.
"""

from __future__ import annotations

import importlib
from collections import Counter

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
                flow_flo: bool = False, flow_enc: bool = False,
                mask_cfg=None):
    """The device steps run_fused dispatches for a batch of (H, W) frames,
    each None where its band is off: -> (mask_step, depth_step, flow_step,
    depth_flip). Options as run_fused's; depth_need: the step returns the
    depth itself (per-frame files, npy); flow_flo / flow_enc: .flo files /
    16-bit PNGs are written; mask_cfg: SOLOv2's `SOLOv2Config` (None: the
    published R101 one)."""
    from prisma_tpu_torch.bands import depth_base, flow_base, mask_band

    mask_step = depth_step = flow_step = None
    depth_flip = False
    if mask_on:
        conf = mask_band.CONFIDENCE_THRESHOLD if mask_confidence is None \
            else mask_confidence
        mask_step = mask_band.build_step(runtime, (H, W), conf, mask_sdf,
                                         mask_cfg)
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


def _call(step, x):
    return step(x)


class FusedDispatch:
    """The device part of the fused loop over one stream of frames: the mask
    and depth steps on each batch, the frames appended to the flow buffer,
    the flow windows of `batch_size` frames (`batch_size - 1` pairs) that a
    batch completes, each window's last frame the next one's first, and the
    short final window padded with its last frame (flow_base.run_flow_band's
    grouping). A step that is None is skipped; `run(step, x)` calls each.

    `counts` (a Counter kept on the host, no device sync): the batches and
    windows dispatched by band ("mask batches", "depth batches", "flow
    windows") and the frames that padding added ("padded batch frames",
    "padded flow frames")."""

    def __init__(self, mask_step, depth_step, flow_step, batch_size: int,
                 run=_call):
        self.mask_step = mask_step
        self.depth_step = depth_step
        self.flow_step = flow_step
        self.win = max(1, batch_size - 1) + 1
        self.run = run
        self.flow_buf: list[np.ndarray] = []
        self.counts: Counter = Counter()

    def batch(self, frames: np.ndarray, valid: int):
        """frames [B, H, W, 3], the first `valid` real and the rest padding
        -> (mask output or None, depth output or None, [the outputs of the
        flow windows the batch completes])."""
        mask_out = depth_out = None
        if self.mask_step is not None:
            mask_out = self.run(self.mask_step, frames)
            self.counts["mask batches"] += 1
        if self.depth_step is not None:
            depth_out = self.run(self.depth_step, frames)
            self.counts["depth batches"] += 1
        if mask_out is not None or depth_out is not None:
            self.counts["padded batch frames"] += len(frames) - valid
        return mask_out, depth_out, self.feed(frames[:valid])

    def feed(self, frames) -> list:
        """Append frames to the flow buffer -> the outputs of the windows
        they complete, `win - 1` pairs each."""
        if self.flow_step is None:
            return []
        self.flow_buf.extend(frames)
        outs = []
        while len(self.flow_buf) >= self.win:
            window = np.stack(self.flow_buf[:self.win])
            self.flow_buf = self.flow_buf[self.win - 1:]
            outs.append(self.run(self.flow_step, window))
            self.counts["flow windows"] += 1
        return outs

    def tail(self):
        """The short final window, padded to `win` frames by repeating its
        last -> (its output, its real pairs), or None where the buffer holds
        no pair. The buffer is left empty."""
        buf, self.flow_buf = self.flow_buf, []
        if self.flow_step is None or len(buf) < 2:
            return None
        pad = self.win - len(buf)
        out = self.run(self.flow_step, np.stack(buf + [buf[-1]] * pad))
        self.counts["flow windows"] += 1
        self.counts["padded flow frames"] += pad
        return out, len(buf) - 1

    def drive(self, batches, flow_only=()):
        """One stream: each (frames, valid) of `batches` through `batch`,
        then the frames of `flow_only` (which the flow windows take and the
        mask and depth steps do not), then the tail window -> yields
        (valid, [(band, output, rows to keep)]) a batch and, last,
        (0, [what follows the last batch])."""
        self.flow_buf = []
        for frames, valid in batches:
            mask_out, depth_out, flow_outs = self.batch(frames, valid)
            outs = [(band, out, valid) for band, out in
                    (("mask", mask_out), ("depth", depth_out))
                    if out is not None]
            yield valid, outs + [("flow", out, self.win - 1)
                                 for out in flow_outs]
        outs = [("flow", out, self.win - 1) for out in self.feed(flow_only)]
        tail = self.tail()
        yield 0, outs + ([("flow", *tail)] if tail is not None else [])


def _batches(frames: np.ndarray, batch_size: int):
    """(frames, valid) in batches of `batch_size`, the last edge-padded as
    `VideoReader.batches(pad_to_full=True)` pads it."""
    for i in range(0, len(frames), batch_size):
        batch = frames[i:i + batch_size]
        valid = len(batch)
        if valid < batch_size:
            batch = np.concatenate(
                [batch, np.repeat(batch[-1:], batch_size - valid, 0)])
        yield batch, valid


def segment_step(mask_step, depth_step, flow_step, batch_size: int):
    """The fused step over a segment of frames held in memory: host uint8
    frames [T, H, W, 3], T >= 2 -> {"<band>.<output>": host array of T - 1
    rows} (bands "mask", "depth", "flow"). Mask and depth run on frames
    [0, T - 1) in batches of `batch_size`, the last edge-padded; flow runs
    on the T - 1 pairs in run_fused's windows. The returned step's `counts`
    is its FusedDispatch's, over every call."""
    fused = FusedDispatch(mask_step, depth_step, flow_step, batch_size)

    def step(frames: np.ndarray) -> dict:
        n = len(frames) - 1
        if n < 1:
            raise ValueError(f"a segment needs 2 frames or more, got {n + 1}")
        rows: dict[str, list] = {}
        for _, outs in fused.drive(_batches(frames[:n], batch_size),
                                   flow_only=frames[n:]):
            for band, out, valid in outs:
                for k, v in out.items():
                    rows.setdefault(f"{band}.{k}", []).append(v[:valid])
        return {k: np.concatenate(v) for k, v in rows.items()}

    step.counts = fused.counts
    return step


def build_segment_step(runtime: RuntimeConfig, H: int, W: int, **options):
    """`segment_step` over the steps `build_steps(runtime, H, W, **options)`
    builds, in batches of runtime.batch_size."""
    mask_step, depth_step, flow_step, _ = build_steps(runtime, H, W,
                                                      **options)
    return segment_step(mask_step, depth_step, flow_step,
                        runtime.batch_size)


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

    fused = FusedDispatch(mask_step, depth_step, flow_step, B, run=run_step)
    prof.start_device_trace()
    frames_done = 0
    batches = prof.iterate(reader.batches(B, pad_to_full=True),
                           "prisma.decode_wait")
    for valid, outs in fused.drive(batches):
        if outs:
            with prof.stage("prisma.sink"):
                for band, out, rows in outs:
                    sinks[band].emit(out, rows)
        frames_done += valid

    if "mask" in sinks:
        sinks["mask"].close()
        mask_band.finish_meta(mask_io, mask_subpath)
    if "depth" in sinks:
        sinks["depth"].close()
    if "flow" in sinks:
        sinks["flow"].close()
    reader.close()
    prof.stop_device_trace()
    prof.report(items=frames_done,
                counts={"dispatched": fused.counts})
    return ran
