"""Generic depth-band driver (counterpart of prisma_tpu/bands/depth_base.py).

Reference contract (bands/depth_anything.py:146-251, same for all depth bands):
- video: <band>.mp4 of per-frame-normalized heatmaps, <band>_min.csv /
  <band>_max.csv, optional per-frame range-encoded PNGs in the subpath folder,
  optional .npy per frame; metadata values entry with csv urls.
- image: <band>.png via write_depth(heatmap, range pixels), optional .npy/.ply,
  metadata values entry with min/max floats.

Frames arrive in batches from the background decoder thread; the step moves a
uint8 batch to the model's device, runs infer + the normalize/heatmap
epilogue there, eagerly (over several cards: one replica and one slice of
the batch a card, `parallel.mesh`), and returns host numpy (both copies
through `runtime.host_copy`: pinned on a card); the x264 encode
runs on the writer's background thread while the next batch computes. The
step opens the spans of `runtime.profiling`: `prisma.step` and in it
`prisma.step.inputs`, `.model`, `.epilogue` and `.outputs` (on the split
path the first three again for each replica, from the caller's thread).
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch

from prisma_tpu_torch.bands.base import BandIO
from prisma_tpu_torch.io.image import open_rgb
from prisma_tpu_torch.io.video import VideoReader, VideoWriter
from prisma_tpu_torch.io.writers import write_csv, write_depth, write_pcl
from prisma_tpu_torch.ops import encode as enc
from prisma_tpu_torch.parallel import mesh
from prisma_tpu_torch.runtime import host_copy
from prisma_tpu_torch.runtime.profiling import StageProfiler, span

# A video step: (frames_u8 [B, H, W, 3], idx0 = the global index of
#   frames[0]) -> dict of host arrays with 'heat' [B, H, W, 3] u8, 'min' [B],
#   'max' [B], and optionally 'depth' [B, H, W] f32.
VideoStep = Callable[..., dict]
# An image infer: (frames_u8 [1, H, W, 3]) -> depth [1, H, W] f32
ImageInfer = Callable[[np.ndarray], np.ndarray]


def make_step(model: torch.nn.Module, infer: Callable, flip: bool,
              need_depth: bool, fused: bool = True,
              devices=None) -> VideoStep:
    """The shared depth video step: infer + the per-frame
    normalize/flip/heatmap epilogue, on the model's device.

    fused: infer(model, frames) is one model call over the batch
    (depth_anything, zoedepth, midas); otherwise infer(model, frames, idx0)
    takes the global index of the batch's first frame too, for the tile and
    ensemble drivers (patchfusion; marigold seeds by it), which split their
    own tiles or members (`patchfusion.infer`, `marigold.infer`: devices=).

    devices (fused only; a list, e.g. `parallel.mesh.data_devices`): the
    model is replicated on each, and every batch is edge-padded to a
    multiple of them and split, each replica running infer and the
    epilogue on its frames; the padded frames' outputs are dropped."""
    if devices and not fused:
        raise ValueError("devices= splits the frames of a fused step only")
    replicas = mesh.replicate(model, devices) if devices else None

    def run(m: torch.nn.Module, frames, idx0: int) -> dict:
        """The step on m's device (host frames, an array or a tensor) ->
        device tensors (no wait)."""
        with span("prisma.step.inputs"):
            x = host_copy.to_device(frames, next(m.parameters()).device)
        with span("prisma.step.model"):
            depth = infer(m, x) if fused else infer(m, x, idx0)
        with span("prisma.step.epilogue"):
            heat, dmin, dmax = enc.depth_heat(depth, flip)
        out = {"heat": heat, "min": dmin, "max": dmax}
        if need_depth:
            out["depth"] = depth
        return out

    @torch.inference_mode()
    def step(frames: np.ndarray, idx0: int = 0) -> dict:
        with span("prisma.step"):
            frames = np.ascontiguousarray(frames)
            if replicas is None:
                out = run(model, frames, idx0)
                with span("prisma.step.outputs"):
                    return host_copy.to_host(out)
            with span("prisma.step.inputs"):
                chunks = mesh.pad_to_devices(
                    torch.from_numpy(frames),
                    len(replicas)).chunk(len(replicas))
            outs = mesh.run_replicas(run, devices, [
                (m, c, idx0) for m, c in zip(replicas, chunks)])
            with span("prisma.step.outputs"):
                outs = [host_copy.to_host(o) for o in outs]
                return {k: np.concatenate([o[k] for o in outs])[:len(frames)]
                        for k in outs[0]}

    return step


def _resume_state(output: str, segment_frames: int,
                  start_override: int | None = None):
    """-> (start_frame, mins, maxs, ledger_file) for frame-index resume.

    The resume index is the contiguous run of complete mp4 segments from a
    previous interrupted run; per-frame min/max come back from the ledger CSV
    kept next to the segments. A ledger shorter than the segments (lost
    buffered lines) restarts from scratch — correctness over savings.
    start_override caps the resume point (the fused multi-band pipeline
    resumes every band at the least of the bands' completed segments, so one
    reader position serves all sinks).
    """
    import shutil

    from prisma_tpu_torch.io.video import SegmentedVideoWriter

    seg_dir = output + ".segments"
    ledger_path = os.path.join(seg_dir, "values.csv")
    start = SegmentedVideoWriter.completed_frames(output, segment_frames)
    if start_override is not None:
        start = min(start, start_override)
    mins: list[float] = []
    maxs: list[float] = []
    if start:
        rows = []
        if os.path.exists(ledger_path):
            with open(ledger_path) as f:
                rows = [line.split(",") for line in f.read().splitlines()
                        if line]
        if len(rows) < start:
            shutil.rmtree(seg_dir, ignore_errors=True)
            start = 0
        else:
            mins = [float(r[0]) for r in rows[:start]]
            maxs = [float(r[1]) for r in rows[:start]]
    os.makedirs(seg_dir, exist_ok=True)
    # truncate the ledger to the resume point, then append
    with open(ledger_path, "w") as f:
        for mn, mx in zip(mins, maxs):
            f.write(f"{mn!r},{mx!r}\n")
    return start, mins, maxs, open(ledger_path, "a")


class DepthVideoSink:
    """Host epilogue of a depth video band: segmented mp4 writer + fsynced
    min/max ledger + per-frame PNG/NPY artifacts + final CSVs/metadata.
    Shared by the sequential driver (run_video) and the fused multi-band
    pipeline (bands/multiband.py), whose `start` caps the resume point."""

    def __init__(self, io: BandIO, width: int, height: int, fps: float,
                 flip: bool, npy: bool, start: int | None = None):
        self.io = io
        self.flip = flip
        self.npy = npy
        self.seg = io.runtime.segment_frames
        if self.seg:
            from prisma_tpu_torch.io.video import SegmentedVideoWriter
            self.start, self.mins, self.maxs, self.ledger = \
                _resume_state(io.output, self.seg, start)
            self.writer = SegmentedVideoWriter(
                width, height, fps, filename=io.output,
                segment_frames=self.seg, start_frame=self.start,
                preset=io.runtime.x264_preset,
                workers=io.runtime.resolve_encode_workers())
        else:
            self.writer = VideoWriter(width, height, fps, filename=io.output,
                                      preset=io.runtime.x264_preset)
            self.start, self.mins, self.maxs, self.ledger = 0, [], [], None
        self.idx = self.start

    def emit(self, out: dict, valid: int) -> None:
        """Consume one step's output dict of host arrays."""
        io, seg = self.io, self.seg
        heat, bmin, bmax = out["heat"], out["min"], out["max"]
        depth = out.get("depth")
        for b in range(valid):
            idx = self.idx
            self.mins.append(float(bmin[b]))
            self.maxs.append(float(bmax[b]))
            if self.ledger is not None:
                # ledger rows hit disk BEFORE the segment-closing write below,
                # so a complete segment always has its values on resume
                self.ledger.write(f"{self.mins[-1]!r},{self.maxs[-1]!r}\n")
                if (idx + 1) % seg == 0:
                    self.ledger.flush()
                    os.fsync(self.ledger.fileno())
            # per-frame artifacts hit disk BEFORE the mp4 frame write: the
            # segment-closing write marks the frame complete for resume, so
            # everything belonging to the frame must already exist
            if depth is not None:
                if self.npy and io.subpath:
                    np.save(os.path.join(io.subpath, f"{idx:05d}.npy"),
                            depth[b])
                if io.subpath:
                    write_depth(os.path.join(io.subpath, f"{idx:05d}.png"),
                                depth[b], normalize=True, flip=self.flip,
                                heatmap=True, encode_range=True)
            self.writer.write(heat[b])
            self.idx += 1

    def close(self) -> None:
        io = self.io
        if self.ledger is not None:
            self.ledger.close()
        self.writer.close()
        write_csv(os.path.join(io.output_folder, io.band + "_min.csv"),
                  self.mins)
        write_csv(os.path.join(io.output_folder, io.band + "_max.csv"),
                  self.maxs)
        io.set_values_url({
            "min": {"type": "float", "url": io.band + "_min.csv"},
            "max": {"type": "float", "url": io.band + "_max.csv"},
        })
        io.finish()


def run_video(io: BandIO, step: VideoStep, flip: bool,
              npy: bool = False) -> None:
    prof = StageProfiler()
    reader = VideoReader(io.input)
    sink = DepthVideoSink(io, reader.width, reader.height, reader.fps,
                          flip=flip, npy=npy)
    reader.skip(sink.start)

    prof.start_device_trace()
    for frames, valid in prof.iterate(
            reader.batches(io.runtime.batch_size, pad_to_full=True),
            "prisma.decode_wait"):
        with prof.host("prisma.step"):
            out = step(frames, idx0=sink.idx)
        with prof.stage("prisma.sink"):
            sink.emit(out, valid)
    n_done = sink.idx - sink.start
    sink.close()
    reader.close()
    prof.stop_device_trace()
    prof.report(items=n_done)


def run_image(io: BandIO, infer: ImageInfer, flip: bool,
              npy: bool = False, ply: bool = False) -> None:
    frame = open_rgb(io.input)
    depth = np.asarray(infer(frame[None]))[0].astype(np.float32)

    if io.data is not None:
        io.set_values_url({
            "min": {"value": float(depth.min()), "type": "float"},
            "max": {"value": float(depth.max()), "type": "float"},
        })
    if npy:
        np.save(os.path.join(io.output_folder, io.band + ".npy"), depth)
    if ply:
        write_pcl(os.path.join(io.output_folder, io.band + ".ply"), depth,
                  frame, flip=flip)
    write_depth(io.output, depth, normalize=True, heatmap=True,
                encode_range=True, flip=flip)
    io.finish()
