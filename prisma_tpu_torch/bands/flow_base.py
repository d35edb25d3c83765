"""Shared flow-band driver loop (counterpart of prisma_tpu/bands/flow_base.py).

Reference contract (`bands/flow_raft.py`, `bands/flow_gmflow.py`, one driver
shape): 0.75x INTER_CUBIC downscale, per consecutive pair forward (and
backward) flow, HSV mp4 (re-upscaled by the encoder), max-disp CSV,
optional consistency-mask videos, optional .flo subpaths, a zero-flow last
frame, metadata bands.

The model-specific part is `infer_pairs(model, img1, img2)`; the step moves
a uint8 frame window [T+1, H, W, 3] to the model's device, runs the resize,
the model and the HSV/consistency epilogues there, eagerly (over several
cards: one replica and one run of the window a card, `parallel.mesh`), and
returns host numpy per pair (both copies through `runtime.host_copy`:
pinned on a card), under the spans of `runtime.profiling`
(`prisma.step`; in it `prisma.step.inputs`, `.model`, `.epilogue`, `.outputs`,
the first three once a replica on the split path).
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch

from prisma_tpu_torch.bands.base import BandIO, resolve
from prisma_tpu_torch.io.video import VideoReader, VideoWriter
from prisma_tpu_torch.io.writers import write_csv, write_flo, write_flow_png16
from prisma_tpu_torch.ops import encode as enc
from prisma_tpu_torch.ops.flow import compute_fwdbwd_mask
from prisma_tpu_torch.ops.resize import resize2d
from prisma_tpu_torch.parallel import mesh
from prisma_tpu_torch.runtime import host_copy
from prisma_tpu_torch.runtime.config import RuntimeConfig
from prisma_tpu_torch.runtime.profiling import (SETUP_WEIGHTS, StageProfiler,
                                                span, timed)


def make_flow_step(model: torch.nn.Module, infer_pairs: Callable, ds_hw,
                   need_masks: bool, need_flow: bool,
                   need_enc: bool = False,
                   devices=None) -> Callable[[np.ndarray], dict]:
    """The fused flow step on the model's device and in its dtype: uint8
    frames [T+1, H, W, 3] -> dict of host arrays per pair: 'fwd_rgb' [T, h,
    w, 3] uint8, 'max_disp' [T]; with need_flow or need_masks also 'fwd',
    'bwd' [T, h, w, 2] f32 and 'bwd_rgb'; with need_masks 'fwd_mask',
    'bwd_mask' [T, h, w] bool; with need_enc 'fwd_enc', 'bwd_enc' [T, h, w,
    3] uint16 (flow + validity packed for the 16-bit PNGs).

    devices (a list, e.g. `parallel.mesh.data_devices`): the model is
    replicated on each, and a window whose T+1 frames they divide evenly is
    split into one run of consecutive frames a device, each run extended by
    the next one's first frame (the pair that crosses the boundary); a run
    left with no pair idles. Another window runs whole on the model's
    device."""
    dh, dw = ds_hw
    dtype = next(model.parameters()).dtype
    split = len(devices) if devices else 1
    replicas = mesh.replicate(model, devices) if split > 1 else None

    def run(m: torch.nn.Module, frames_u8: np.ndarray) -> dict:
        with span("prisma.step.inputs"):
            frames = host_copy.to_device(frames_u8,
                                         next(m.parameters()).device)
        with span("prisma.step.model"):
            ds = resize2d(frames.float(), (dh, dw), method="cubic").to(dtype)
            fwd, bwd = infer_pairs(m, ds[:-1], ds[1:])
        with span("prisma.step.epilogue"):
            fwd = fwd.float()
            bwd = bwd.float()
            fwd_rgb, fwd_max = enc.process_flow(fwd)
            out = {"fwd_rgb": fwd_rgb, "max_disp": fwd_max}
            if need_masks or need_flow:
                out["fwd"] = fwd
                out["bwd"] = bwd
                out["bwd_rgb"] = enc.process_flow(bwd)[0]
            if need_masks:
                out["fwd_mask"], out["bwd_mask"] = compute_fwdbwd_mask(fwd,
                                                                       bwd)
        return out

    def host(out: dict) -> dict:
        """run's device tensors -> host arrays, the 16-bit encodings made."""
        res = host_copy.to_host(out)
        if need_masks and need_enc:
            res["fwd_enc"] = enc.encode_flow(out["fwd"], out["fwd_mask"])
            res["bwd_enc"] = enc.encode_flow(out["bwd"], out["bwd_mask"])
        return res

    @torch.inference_mode()
    def step(frames_u8: np.ndarray) -> dict:
        with span("prisma.step"):
            frames_u8 = np.ascontiguousarray(frames_u8)
            n = frames_u8.shape[0]
            if split == 1 or n % split:
                out = run(model, frames_u8)
                with span("prisma.step.outputs"):
                    return host(out)
            k = n // split
            work = [(m, frames_u8[i * k:(i + 1) * k + 1])
                    for i, m in enumerate(replicas)]
            work = [(m, f) for m, f in work if len(f) > 1]
            outs = mesh.run_replicas(run, devices[:len(work)], work)
            with span("prisma.step.outputs"):
                outs = [host(o) for o in outs]
                return {key: np.concatenate([o[key] for o in outs])
                        for key in outs[0]}

    return step


class FlowVideoSink:
    """Host epilogue of a flow band: the fwd/bwd/mask mp4 writers with
    frame-index resume (the least of all output videos' completed
    segments), the fsynced max-disp ledger, per-pair .flo / 16-bit PNG
    artifacts, the zero-flow last frame, and the csv/metadata finish."""

    def __init__(self, io: BandIO, W: int, H: int, fps: float,
                 backwards: bool, mask: bool, subpath: str = "",
                 subpath_mask: str = "", start: int | None = None):
        self.io = io
        self.band = io.band
        self.W, self.H = W, H
        self.backwards = backwards
        self.mask = mask
        self.subpath = subpath
        out_base = io.output.rsplit(".", 1)[0]
        self.out_base = out_base
        runtime = io.runtime

        self.flo_dir = ""
        if subpath:
            io.set_folder(subpath)
            self.flo_dir = os.path.join(io.output_folder, subpath)
            os.makedirs(self.flo_dir + "_fwd", exist_ok=True)
            if backwards:
                os.makedirs(self.flo_dir + "_bwd", exist_ok=True)

        # --subpath_mask: per-pair 16-bit packed flow+validity PNGs (reference
        # flow_raft.py:212-216 / common/flow.py:95-98)
        self.enc_dir = ""
        if subpath_mask:
            self.enc_dir = os.path.join(io.output_folder, subpath_mask)
            os.makedirs(self.enc_dir + "_fwd", exist_ok=True)
            if backwards:
                os.makedirs(self.enc_dir + "_bwd", exist_ok=True)

        # frame-index resume: every output video is segmented; the resume
        # point is the last segment boundary ALL of them completed, backed by
        # a max-disp ledger fsynced before each boundary
        seg = runtime.segment_frames
        self.seg = seg
        video_paths = [io.output]
        if backwards:
            video_paths.append(out_base + "_bwd.mp4")
        if mask:
            video_paths.append(os.path.join(io.output_folder,
                                            self.band + "_mask.mp4"))
            if backwards:
                video_paths.append(out_base + "_mask_bwd.mp4")

        self.start = 0
        self.max_disps: list[float] = []
        self.ledger = None
        preset = runtime.x264_preset
        if seg:
            import shutil

            from prisma_tpu_torch.io.video import SegmentedVideoWriter
            self.start = min(SegmentedVideoWriter.completed_frames(p, seg)
                             for p in video_paths)
            if start is not None:
                self.start = min(self.start, start)
            ledger_path = io.output + ".segments/values.csv"
            if self.start:
                rows = []
                if os.path.exists(ledger_path):
                    with open(ledger_path) as f:
                        rows = [r for r in f.read().splitlines() if r]
                if len(rows) < self.start:
                    for p in video_paths:
                        shutil.rmtree(p + ".segments", ignore_errors=True)
                    self.start = 0
                else:
                    self.max_disps = [float(r) for r in rows[:self.start]]
            os.makedirs(os.path.dirname(ledger_path), exist_ok=True)
            with open(ledger_path, "w") as f:
                for v in self.max_disps:
                    f.write(f"{v!r}\n")
            self.ledger = open(ledger_path, "a")
            workers = runtime.resolve_encode_workers()

            def make_writer(path):
                return SegmentedVideoWriter(W, H, fps, filename=path,
                                            segment_frames=seg,
                                            start_frame=self.start,
                                            preset=preset, workers=workers)
        else:
            def make_writer(path):
                return VideoWriter(W, H, fps, filename=path, preset=preset)

        self.fwd_video = make_writer(io.output)
        self.bwd_video = make_writer(out_base + "_bwd.mp4") if backwards \
            else None
        self.fwd_mask_video = self.bwd_mask_video = None
        if mask:
            self.fwd_mask_video = make_writer(
                os.path.join(io.output_folder, self.band + "_mask.mp4"))
            if backwards:
                self.bwd_mask_video = make_writer(out_base + "_mask_bwd.mp4")
        self.idx = self.start

    def emit(self, out: dict, n_pairs: int) -> None:
        backwards, mask = self.backwards, self.mask
        flo_dir, enc_dir, seg = self.flo_dir, self.enc_dir, self.seg
        fwd_rgb = out["fwd_rgb"]
        md = out["max_disp"]
        for b in range(n_pairs):
            idx = self.idx
            self.max_disps.append(float(md[b]))
            if self.ledger is not None:
                # ledger rows hit disk before the segment-closing write below
                self.ledger.write(f"{self.max_disps[-1]!r}\n")
                if (idx + 1) % seg == 0:
                    self.ledger.flush()
                    os.fsync(self.ledger.fileno())
            # per-frame .flo/.png artifacts hit disk BEFORE any mp4 frame
            # write: a segment-closing write marks the frame complete for
            # resume
            if flo_dir:
                write_flo(os.path.join(flo_dir + "_fwd", "%04d.flo" % idx),
                          out["fwd"][b])
                if backwards:
                    write_flo(os.path.join(flo_dir + "_bwd", "%04d.flo" % idx),
                              out["bwd"][b])
            if enc_dir:
                write_flow_png16(
                    os.path.join(enc_dir + "_fwd", "%04d.png" % idx),
                    out["fwd_enc"][b])
                if backwards:
                    write_flow_png16(
                        os.path.join(enc_dir + "_bwd", "%04d.png" % idx),
                        out["bwd_enc"][b])
            self.fwd_video.write(fwd_rgb[b])
            if mask:
                fm = out["fwd_mask"][b]
                self.fwd_mask_video.write(
                    np.stack([np.where(fm, 255, 0)] * 3, -1).astype(np.uint8))
                if self.bwd_mask_video is not None:
                    bm = out["bwd_mask"][b]
                    self.bwd_mask_video.write(
                        np.stack([np.where(bm, 255, 0)] * 3,
                                 -1).astype(np.uint8))
            if backwards and self.bwd_video is not None:
                self.bwd_video.write(out["bwd_rgb"][b])
            self.idx += 1

    def close(self) -> None:
        io, H, W = self.io, self.H, self.W
        backwards, mask = self.backwards, self.mask
        band, idx = self.band, self.idx

        # zero-flow last frame (reference flow_raft.py:115-126)
        zero_flow = np.zeros((H, W, 2), np.float32)
        zrgb, zmax = enc.process_flow(torch.from_numpy(zero_flow))
        zrgb = zrgb.numpy()
        self.fwd_video.write(zrgb)
        self.max_disps.append(float(zmax))
        if backwards and self.bwd_video is not None:
            self.bwd_video.write(zrgb)
        if mask:
            zm = np.zeros((H, W, 3), np.uint8)
            self.fwd_mask_video.write(zm)
            if self.bwd_mask_video is not None:
                self.bwd_mask_video.write(zm)
        if self.flo_dir:
            write_flo(os.path.join(self.flo_dir + "_fwd", "%04d.flo" % idx),
                      zero_flow)
            if backwards:
                write_flo(os.path.join(self.flo_dir + "_bwd",
                                       "%04d.flo" % idx), zero_flow)
        if self.enc_dir:
            # reference quirk: the final zero-flow frame is encoded at
            # ORIGINAL resolution (flow_raft.py:117-126 builds zeros from the
            # full-size frame), while per-pair PNGs are at the downscaled size
            zenc = np.concatenate(
                [np.full((H, W, 2), 2 ** 15, np.uint16),
                 np.zeros((H, W, 1), np.uint16)], axis=-1)
            write_flow_png16(os.path.join(self.enc_dir + "_fwd",
                                          "%04d.png" % idx), zenc)
            if backwards:
                write_flow_png16(os.path.join(self.enc_dir + "_bwd",
                                              "%04d.png" % idx), zenc)

        if self.ledger is not None:
            self.ledger.close()
        for v in (self.fwd_video, self.bwd_video, self.fwd_mask_video,
                  self.bwd_mask_video):
            if v is not None:
                v.close()

        write_csv(self.out_base + ".csv", self.max_disps)

        if io.data is not None:
            io.data["bands"][band] = {
                "url": band + ".mp4",
                "values": {"dist": {"type": "float", "url": band + ".csv"}},
            }
            if self.subpath:
                io.data["bands"][band]["folder"] = self.subpath
            if backwards:
                io.data["bands"][band + "_bwd"] = {"url": band + "_bwd.mp4"}
                if self.subpath:
                    io.data["bands"][band + "_bwd"]["folder"] = \
                        self.subpath + "_bwd"
            if mask:
                io.data["bands"][band + "_mask"] = {"url": band + "_mask.mp4"}
                if backwards:
                    io.data["bands"][band + "_mask_bwd"] = {
                        "url": band + "_mask_bwd.mp4"}
        io.finish()


def build_flow_step(model: torch.nn.Module, infer_pairs: Callable,
                    scale: float, W: int, H: int, runtime: RuntimeConfig, *,
                    backwards: bool, mask: bool, flo: bool = False,
                    enc: bool = False):
    """Move the model to runtime's device in its compute dtype and build the
    flow step for a (W, H) input stream, sized to what the band's sink
    consumes (FlowVideoSink's options; flo / enc: it writes .flo files /
    16-bit PNGs). The HSV and consistency epilogues run in f32 (the step
    casts the flows back)."""
    dh, dw = int(round(H * scale)), int(round(W * scale))
    with timed(SETUP_WEIGHTS):
        model = model.to(device=runtime.resolve_device(),
                         dtype=runtime.resolve_dtype())
    return make_flow_step(model, infer_pairs, (dh, dw), mask or enc,
                          flo or backwards, need_enc=enc)


def run_flow_band(band: str, input_path: str, model, infer_pairs: Callable,
                  output: str = "", subpath: str = "", backwards: bool = False,
                  mask: bool = False, scale: float = 0.75,
                  subpath_mask: str = "",
                  runtime: RuntimeConfig | None = None) -> BandIO:
    """model: an nn.Module, or a callable that returns one (loaded after the
    output is resolved, so an existing output skips before any load)."""
    runtime = runtime or RuntimeConfig()
    runtime.resolve_device()  # no card where one is asked for: raise first
    io = resolve(band, input_path, output=output, force_extension="mp4",
                 runtime=runtime)
    if not isinstance(model, torch.nn.Module):
        model = model()

    reader = VideoReader(io.input)
    W, H, fps = reader.width, reader.height, reader.fps
    sink = FlowVideoSink(io, W, H, fps, backwards=backwards, mask=mask,
                         subpath=subpath, subpath_mask=subpath_mask)
    step = build_flow_step(model, infer_pairs, scale, W, H, runtime,
                           backwards=backwards, mask=mask, flo=bool(subpath),
                           enc=bool(subpath_mask))

    pairs_per_batch = max(1, runtime.batch_size - 1)
    reader.skip(sink.start)
    prof = StageProfiler()

    def emit(window, n_pairs):
        with prof.host("prisma.step"):
            out = step(np.stack(window))
        with prof.stage("prisma.sink"):
            sink.emit(out, n_pairs)

    prof.start_device_trace()
    window: list[np.ndarray] = []
    for frame in prof.iterate(reader, "prisma.decode_wait"):
        window.append(frame)
        if len(window) == pairs_per_batch + 1:
            emit(window, pairs_per_batch)
            window = window[-1:]
    if len(window) > 1:
        n_pairs = len(window) - 1
        while len(window) < pairs_per_batch + 1:
            window.append(window[-1])
        emit(window, n_pairs)

    n_done = sink.idx - sink.start
    sink.close()
    reader.close()
    prof.stop_device_trace()
    prof.report(items=n_done)
    return io
