"""mask band driver: SOLOv2 instance segmentation -> white-on-black mask
(counterpart of prisma_tpu/bands/mask_band.py).

Reference contract (`bands/mask_mmdet.py`): run SOLOv2 per frame, keep only
person/animal classes above confidence 0.5, SUM the white (255) binary masks
into an RGB image (uint8 wraparound preserved), optionally pack a clamped SDF
into the GREEN channel (--sdf), write inverted (255 - mask) per-frame PNGs for
COLMAP masking, and register band "mask" with the kept class list in metadata
(mask_mmdet.py:84-102,131-161).

The step moves a uint8 batch to the model's device, runs the network on the
whole batch, the slab and composite per frame and the SDF there, eagerly,
and returns host numpy (both copies through `runtime.host_copy`: pinned on
a card); the host epilogue below is the JAX package's.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from prisma_tpu_torch.bands.base import BandIO, resolve
from prisma_tpu_torch.io.image import open_rgb, write_rgb_u8
from prisma_tpu_torch.io.video import VideoReader, VideoWriter
from prisma_tpu_torch.models import solov2
from prisma_tpu_torch.ops.sdf import sdf_green_device
from prisma_tpu_torch.parallel import mesh
from prisma_tpu_torch.runtime import host_copy
from prisma_tpu_torch.runtime.config import RuntimeConfig
from prisma_tpu_torch.weights.store import load_solov2

BAND = "mask"

# COCO indices of the reference's kept classes (mask_mmdet.py:30)
CLASSES = ["person", "bird", "cat", "dog", "horse", "sheep", "cow",
           "elephant", "bear", "zebra", "giraffe"]
CLASS_IDS = (0, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23)
CONFIDENCE_THRESHOLD = 0.5


def _make_step(model: solov2.SOLOv2, ori_hw, confidence: float, sdf: bool,
               devices=None):
    """The mask step on the model's device and in its dtype: uint8 frames
    [B, H, W, 3] -> host arrays 'composite' [B, H, W] f32 (the sum of the
    kept masks x 255) and, with sdf, 'green' [B, H, W] f32.

    devices (a list, e.g. `parallel.mesh.data_devices`): the model is
    replicated on each, and every batch is edge-padded to a multiple of
    them and split, one slice a replica; the padded frames' outputs are
    dropped."""
    dtype, cfg = next(model.parameters()).dtype, model.cfg
    replicas = mesh.replicate(model, devices) if devices else None

    def run(m: solov2.SOLOv2, frames_u8: torch.Tensor) -> dict:
        device = next(m.parameters()).device
        class_ids = torch.tensor(CLASS_IDS, device=device)
        x = host_copy.to_device(frames_u8, device)
        img, img_hw = solov2.preprocess(x, dtype=dtype, scale=cfg.scale)
        composite = []
        for out in solov2.forward(m, img, img_hw, ori_hw):
            keep = (out["valid"] & (out["scores"] > confidence)
                    & (out["labels"][:, None] == class_ids[None]).any(dim=1))
            # the reference sums 255-white masks in float, then casts to
            # uint8 (which wraps)
            composite.append(((out["masks"] & keep[:, None, None]).float()
                              * 255.0).sum(dim=0))
        composite = torch.stack(composite)
        res = {"composite": composite}
        if sdf:
            res["green"] = sdf_green_device(composite != 0.0)
        return res

    @torch.inference_mode()
    def step(frames_u8: np.ndarray) -> dict:
        x = torch.from_numpy(np.ascontiguousarray(frames_u8))
        if replicas is None:
            return host_copy.to_host(run(model, x))
        chunks = mesh.pad_to_devices(x, len(replicas)).chunk(len(replicas))
        outs = mesh.run_replicas(run, devices, list(zip(replicas, chunks)))
        outs = [host_copy.to_host(o) for o in outs]
        return {k: np.concatenate([o[k] for o in outs])[:len(x)]
                for k in outs[0]}

    return step


def _composite_to_rgb(composite: np.ndarray) -> np.ndarray:
    m = composite.astype(np.float64)
    return np.stack([m, m, m], axis=-1)


def _write_frame(masks_f64, green, writer_or_path, inverted_path=""):
    """Host epilogue per frame: inverted PNG (pre-SDF, reference order), green
    channel injection, uint8 cast with the reference's wrap semantics."""
    if inverted_path:
        write_rgb_u8(inverted_path, (255.0 - masks_f64).astype(np.uint8))
    if green is not None:
        masks_f64[..., 1] = green.astype(np.float64) * 255.0
    frame = masks_f64.astype(np.uint8)
    if isinstance(writer_or_path, str):
        write_rgb_u8(writer_or_path, frame)
    else:
        writer_or_path.write(frame)


class MaskVideoSink:
    """Host epilogue of the mask video band: segmented mp4 writer with
    frame-index resume + inverted per-frame COLMAP PNGs. Shared by the
    sequential driver (run) and the fused pipeline (bands/multiband.py);
    per-frame PNGs are idempotent, so only the mp4 needs the segments."""

    def __init__(self, io: BandIO, width: int, height: int, fps: float,
                 sdf: bool, start: int | None = None):
        self.io = io
        self.sdf = sdf
        runtime = io.runtime
        seg = runtime.segment_frames
        self.start = 0
        if seg:
            from prisma_tpu_torch.io.video import SegmentedVideoWriter
            self.start = SegmentedVideoWriter.completed_frames(io.output, seg)
            if start is not None:
                self.start = min(self.start, start)
            self.writer = SegmentedVideoWriter(
                width, height, fps, filename=io.output, segment_frames=seg,
                start_frame=self.start, preset=runtime.x264_preset,
                workers=runtime.resolve_encode_workers())
        else:
            self.writer = VideoWriter(width, height, fps, filename=io.output,
                                      preset=runtime.x264_preset)
        self.idx = self.start

    def emit(self, out: dict, valid: int) -> None:
        comp = out["composite"]
        green = out.get("green") if self.sdf else None
        for b in range(valid):
            inv = os.path.join(self.io.subpath, f"{self.idx:05d}.png") \
                if self.io.subpath else ""
            _write_frame(_composite_to_rgb(comp[b]),
                         green[b] if green is not None else None,
                         self.writer, inv)
            self.idx += 1

    def close(self) -> None:
        self.writer.close()


def load_model(runtime: RuntimeConfig,
               cfg: solov2.SOLOv2Config | None = None) -> solov2.SOLOv2:
    """SOLOv2 on runtime's device in its compute dtype."""
    return load_solov2(runtime, cfg).to(device=runtime.resolve_device(),
                                        dtype=runtime.resolve_dtype())


def build_step(runtime: RuntimeConfig, ori_hw, confidence: float, sdf: bool,
               cfg: solov2.SOLOv2Config | None = None):
    """Load SOLOv2 and build the mask step for (H, W) frames; shared by run()
    and the fused pipeline."""
    return _make_step(load_model(runtime, cfg), ori_hw, confidence, sdf)


def run(input_path: str, output: str = "", subpath: str = "",
        sdf: bool = True, confidence: float = CONFIDENCE_THRESHOLD,
        runtime: RuntimeConfig | None = None,
        cfg: solov2.SOLOv2Config | None = None) -> BandIO:
    runtime = runtime or RuntimeConfig()
    runtime.resolve_device()  # no card where one is asked for: raise first
    io = resolve(BAND, input_path, output=output, subpath=subpath,
                 force_extension="png", runtime=runtime)

    if io.is_video():
        reader = VideoReader(io.input)
        sink = MaskVideoSink(io, reader.width, reader.height, reader.fps,
                             sdf=sdf)
        reader.skip(sink.start)
        step = build_step(runtime, (reader.height, reader.width), confidence,
                          sdf, cfg)
        for frames, valid in reader.batches(runtime.batch_size,
                                            pad_to_full=True):
            sink.emit(step(frames), valid)
        sink.close()
        reader.close()
    else:
        frame = open_rgb(io.input)
        step = build_step(runtime, frame.shape[:2], confidence, sdf, cfg)
        out = step(frame[None])
        _write_frame(_composite_to_rgb(out["composite"][0]),
                     out["green"][0] if sdf else None, io.output)

    finish_meta(io, subpath)
    return io


def finish_meta(io: BandIO, subpath: str) -> None:
    """Register the mask band entry (url + kept class ids) in metadata."""
    if io.data is not None:
        entry = io.data["bands"].setdefault(BAND, {})
        entry["url"] = os.path.basename(io.output)
        entry["ids"] = CLASSES
        if subpath:
            entry["folder"] = subpath
    io.finish()


def main(argv=None):
    """Standalone band CLI (reference bands/mask_mmdet.py:150-198)."""
    from prisma_tpu_torch.bands.cli import band_parser, run_guarded, \
        runtime_from_args

    parser = band_parser(BAND)
    parser.add_argument("--confidence", "-c", type=float,
                        default=CONFIDENCE_THRESHOLD,
                        help="confidence threshold")
    parser.add_argument("--sdf", "-s", action="store_true",
                        help="encode SDF on the GREEN channel")
    args = parser.parse_args(argv)
    run_guarded(BAND, run, args.input, output=args.output,
                subpath=args.subpath, sdf=args.sdf,
                confidence=args.confidence, runtime=runtime_from_args(args))


if __name__ == "__main__":
    main()
