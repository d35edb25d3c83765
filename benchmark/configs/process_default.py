"""The default video run's builder (the names of benchmark/run.py's
docstring): the port's fused step over a segment of frames
(`bands/multiband.build_segment_step`, over the steps `run_fused` builds
with `process.py`'s default bands and flags), the plain reference, the
comparison and the work a step needs."""

from __future__ import annotations

import os

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import run
from benchmark.reference import gmflow, process_default as ref, solov2, \
    zoedepth
from benchmark.reference.common import Ops
from benchmark.roofline import attention

OVERLAP = 1
PRIMARY = "mask.composite"
# SOLOv2 at the test scale and head widths of the port's narrow_mask test
# fixture, calibrated on a 96x64 frame (its masks 10% of the mask features'
# pixels: at 1% they would sit at the levels' strides, the area filter's
# cut); the metric core on ViT-S at a 42x56 input, the GMFlow of
# gmflow_sintel's TINY; all in float32
TINY = dict(
    mask=dict(backbone="ResNet-101", num_classes=80, in_channels=256,
              feat_channels=64, stacked_convs=4, strides=[8, 8, 16, 32, 32],
              num_grids=[40, 36, 24, 16, 12], mask_feat_channels=64,
              mask_out_channels=64, mask_stride=4, gn_groups=32, nms_pre=500,
              score_thr=0.1, mask_thr=0.5, filter_thr=0.05, sigma=2.0,
              max_per_img=100, scale=[160, 96], confidence=0.5, sdf=True,
              init=dict(cls_gain=30.0, cls_feat_bias=-1.5, kernel_gain=24.0,
                        feat_bias=-1.5, calibration=dict(
                            instances_per_class=2, dropped_class_bias=-100.0,
                            mask_share=0.1, mask_quantile=0.9, seed=0,
                            width=96, height=64, texture=dict(
                                cell_px=16, octaves=2, grain=4.0)))),
    depth=dict(encoder="vits", metric="outdoor", embed_dim=384, depth=12,
               num_heads=6, patch_size=14, mlp_ratio=4, pos_grid=37,
               features=64, out_channels=[48, 96, 192, 384], img_size=[42, 56],
               n_bins=64, bin_embedding_dim=128, n_attractors=[16, 8, 4, 1],
               init=dict(layerscale=0.1)),
    flow=dict(feature_channels=32, num_transformer_layers=2, num_head=1,
              ffn_dim_expansion=4, attn_splits=2, corr_radius=-1,
              prop_radius=-1, upsample_factor=8, padding_factor=16,
              scale=0.75, init=dict(ln_gain=0.1)),
    dtype="float32")
# The reference's tolerance on each continuous score that decides whether
# SOLOv2 keeps an instance (benchmark/reference/solov2.instances): a
# factor in [0.9, 1.1]. The port in bfloat16 moves the class logits by 2-4%
# of their spread against float32 (the null, bfloat16 operands alone, about
# as much), so every random SOLOv2 keeps or drops an instance here and
# there whose score sits within a few percent of a cut; the reference marks
# those as open and holds the mask to the band between what it keeps
# whichever way and what it keeps some way.
MASK_TOLERANCE = 0.1
NULL_FLOOR = {"mask_px_gap": 1e-4, "green_gap": 1e-2, "heat_gap": 1e-2,
              "fwd_rgb_gap": 1e-2}
# mask pixels outside the reference's band over pixels that the port or
# the band's sure part marks, the latter counted as at least 1e4 an input
# (about 0.01% of a 1080p input's 56 frames): 1 for an inverted mask and
# for one left all false
RATIOS = {"mask_mismatch_of_marked": ("mask_differ_px", "mask_marked_px",
                                      1e4)}

param_specs = ref.param_specs


def calibration_frame(cfg: dict, device) -> torch.Tensor:
    """uint8 [1, H, W, 3]: a frame of the benchmark's texture, of the
    calibration's size and seed."""
    from benchmark import frames

    cal = cfg["init"]["calibration"]
    W, H = cal["width"], cal["height"]
    gen = torch.Generator(device=device).manual_seed(cal["seed"])
    tex = cal["texture"]
    return frames.texture(gen, H, W, tex["cell_px"], tex["octaves"],
                          tex["grain"], device).permute(1, 2, 0)[None]


def save_checkpoint(sd: dict, models_dir: str, cfg: dict) -> list:
    """Each band's weights under its checkpoint's real name and layout:
    SOLOv2 under 'state_dict' (mmdetection's), its class and kernel biases
    calibrated first (solov2.calibrate), the metric model and GMFlow under
    'model'."""
    paths = []
    by_band = ref.split(sd)
    solov2.calibrate(by_band["mask"], calibration_frame(
        cfg["mask"], sd["mask.mask_head.conv_cls.bias"].device), cfg["mask"])
    for band, weights in by_band.items():
        path = os.path.join(models_dir, cfg["checkpoints"][band])
        weights = {k: v.clone() for k, v in weights.items()}
        torch.save({"state_dict" if band == "mask" else "model": weights},
                   path)
        paths.append(path)
    return paths


def load_reference_weights(saved: list, device) -> dict:
    sd = {}
    for path, band in zip(saved, ref.BANDS):
        ckpt = torch.load(path, map_location=device, weights_only=True)
        ckpt = ckpt["state_dict" if band == "mask" else "model"]
        sd.update({f"{band}.{k}": v.float() for k, v in ckpt.items()})
    return sd


def solov2_config(mask: dict):
    from prisma_tpu_torch.models import solov2 as port_solov2

    fields = port_solov2.SOLOv2Config.__dataclass_fields__
    return port_solov2.SOLOv2Config(**{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in mask.items() if k in fields})


def build_step(cfg: dict, traffic: dict, models_dir: str, device: str):
    from prisma_tpu_torch.bands import multiband
    from prisma_tpu_torch.models import gmflow as gm
    from prisma_tpu_torch.runtime.config import RuntimeConfig

    runtime = RuntimeConfig(models_dir=models_dir, random_weights=False,
                            device=device, compute_dtype=cfg["dtype"],
                            batch_size=cfg["batch"])
    mask, depth, flow = cfg["mask"], cfg["depth"], cfg["flow"]
    gcfg = gm.GMFlowConfig(
        feature_channels=flow["feature_channels"],
        num_transformer_layers=flow["num_transformer_layers"],
        attn_splits=flow["attn_splits"],
        ffn_dim_expansion=flow["ffn_dim_expansion"],
        upsample_factor=flow["upsample_factor"],
        padding_factor=flow["padding_factor"])
    return multiband.build_segment_step(
        runtime, traffic["height"], traffic["width"],
        mask_sdf=mask["sdf"], mask_confidence=mask["confidence"],
        mask_cfg=solov2_config(mask),
        depth_band="depth_anything",
        depth_build=dict(encoder=depth["encoder"], metric=depth["metric"],
                         img_size=depth["img_size"]),
        flow_band="flow_gmflow", flow_build=dict(cfg=gcfg),
        flow_scale=flow["scale"])


def checked_rows(n: int, batch: int) -> tuple:
    """(frames, pairs) of a step of n rows that the reference checks: the
    first and the last batch of mask and depth, the first and the last flow
    window (batch - 1 pairs each). The reference over every row of the
    sample's four inputs took ~3.5 min a run on an H100; these take about
    a fourth of that."""
    def ends(size):
        last = (n - 1) // size * size
        return sorted(set(range(min(size, n))) | set(range(last, n)))
    return ends(batch), ends(batch - 1)


def reference(sd: dict, frames: torch.Tensor, cfg: dict, traffic: dict,
              ops: Ops = Ops()) -> dict:
    """The reference's rows of checked_rows, with their indices under
    'rows.frames' and 'rows.pairs' (compare takes the same rows of the
    step's outputs)."""
    frame_rows, pair_rows = checked_rows(frames.shape[0] - 1, cfg["batch"])
    out = ref.band_outputs(sd, frames, cfg, ops, frame_rows, pair_rows,
                           MASK_TOLERANCE)
    out["rows.frames"] = torch.tensor(frame_rows)
    out["rows.pairs"] = torch.tensor(pair_rows)
    return out


def _np(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else t


def _worst_level_gap(a: np.ndarray, b) -> float:
    """The largest over the rows of the mean |a - b| in levels of 255."""
    gap = np.abs(a.astype(np.int16) - _np(b).astype(np.int16))
    return float(gap.reshape(len(gap), -1).mean(axis=1).max())


def _own_green(marked: np.ndarray, device) -> np.ndarray:
    """The reference's SDF green channel of the given mask."""
    with torch.inference_mode():
        return solov2.sdf_green(torch.from_numpy(marked).to(device)) \
            .cpu().numpy()


def _worst(a: np.ndarray) -> float:
    """The largest over the rows of a row's mean."""
    return float(a.reshape(len(a), -1).mean(axis=1).max())


def compare(out: dict, want: dict) -> dict:
    """Over the rows the reference checked (checked_rows), each the worst
    frame (or pair) of the input, so that a fault in one frame is not
    spread over the others. The mask (composite != 0) against the
    reference's band (MASK_TOLERANCE): mask_px_gap, the share of a frame's
    pixels that the port marks outside what the reference keeps some way
    or leaves unmarked of what it keeps whichever way; green_gap, the mean
    distance of the green from the band between the two masks' greens, in
    levels of 255; green_self_gap, the mean |green - the reference's SDF
    green of the port's own mask| in levels (the step's two outputs agree
    frame by frame); mask_differ_px and mask_marked_px, the pixels outside
    the band and those that the port or the band's sure part marks (RATIOS:
    1 for a mask inverted or left all false). heat_gap, the mean |heat -
    reference heat| in levels of 255 (the metric depth through its
    per-frame min and max), and fwd_rgb_gap, the same of the forward
    flow's HSV image. For the record: mask_marked_share, the share of
    pixels the reference keeps whichever way, mask_open_share, the share
    it keeps some way and not every way, and mask_kept, the instances it
    keeps whichever way a frame. Not compared: the depth's min and max,
    max_disp (as in the depth and GMFlow cells)."""
    def rows(key, index):
        """out's rows of the reference's (the null has those alone)."""
        a = out[key]
        return a if len(a) == len(want[key]) else a[_np(want[index])]

    sure, maybe = _np(want["mask.sure"]), _np(want["mask.maybe"])
    marked = rows("mask.composite", "rows.frames") != 0
    outside = (sure & ~marked) | (marked & ~maybe)
    green = rows("mask.green", "rows.frames").astype(np.float32)
    below = np.maximum(_np(want["mask.green_sure"]) - green, 0.0)
    above = np.maximum(green - _np(want["mask.green_maybe"]), 0.0)
    own = np.abs(green - _own_green(marked, want["mask.green"].device))
    return {
        "mask_px_gap": _worst(outside),
        "green_gap": _worst((below + above) * 255.0),
        "green_self_gap": _worst(own * 255.0),
        "mask_differ_px": float(outside.sum()),
        "mask_marked_px": float((marked | sure).sum()),
        "mask_marked_share": float(sure.mean()),
        "mask_open_share": float((maybe & ~sure).mean()),
        "mask_kept": float(_np(want["mask.sure_kept"]).mean()),
        "heat_gap": _worst_level_gap(rows("depth.heat", "rows.frames"),
                                     want["depth.heat"]),
        "fwd_rgb_gap": _worst_level_gap(rows("flow.fwd_rgb", "rows.pairs"),
                                        want["flow.fwd_rgb"])}


def _gmflow_builder():
    return run.load_module(os.path.join(run.BENCH_DIR, "configs",
                                        "gmflow_sintel.py"),
                           "benchmark_config_gmflow_sintel")


def _windows(cfg: dict, traffic: dict) -> int:
    """The GMFlow windows of a step: its pairs over a window's pairs."""
    pairs = traffic["frames_per_input"] - OVERLAP
    return -(-pairs // (cfg["batch"] - 1))


def step_flops(cfg: dict, traffic: dict) -> float:
    """The products of a step (convolutions, linears, attention, SOLOv2's
    dynamic-mask product with all nms_pre candidates), counted on the
    reference's graph over meta tensors: one frame of SOLOv2 and of the
    metric model and one GMFlow pair, times the step's frames and pairs.
    Resizes, the matrix NMS's mask overlaps and elementwise work are not
    counted."""
    n = traffic["frames_per_input"] - OVERLAP
    H, W = traffic["height"], traffic["width"]
    sd = {k: torch.empty(s, device="meta") for k, s, _ in param_specs(cfg)}
    by_band = ref.split(sd)
    h, w = solov2.test_size(H, W, cfg["mask"]["scale"])
    image = torch.empty(1, 3, -(-h // 32) * 32, -(-w // 32) * 32,
                        device="meta")
    frame = torch.empty(1, H, W, 3, dtype=torch.uint8, device="meta")
    pair = torch.empty(2, H, W, 3, dtype=torch.uint8, device="meta")
    with FlopCounterMode(display=False) as counter:
        solov2.flops_graph(by_band["mask"], image, cfg["mask"])
        zoedepth.metric_depth(by_band["depth"], frame, cfg["depth"])
    per_frame = counter.get_total_flops()
    with FlopCounterMode(display=False) as counter:
        gmflow.pair_flows(by_band["flow"], pair, cfg["flow"])
    return float(per_frame * n + counter.get_total_flops() * n)


def attention_calls(cfg: dict, traffic: dict) -> list:
    """The metric core's 24 ViT blocks a batch, one K1 call each over the
    batch's heads at [8 x 16, 1037, 64], over the step's batches; and
    each GMFlow window's calls (gmflow_sintel's builder) over its
    windows."""
    d = cfg["depth"]
    h, w = d["img_size"]
    n = (h // d["patch_size"]) * (w // d["patch_size"]) + 1
    hd = d["embed_dim"] // d["num_heads"]
    frames = traffic["frames_per_input"] - OVERLAP
    batches = -(-frames // cfg["batch"])
    calls = [attention.call(cfg["batch"] * d["num_heads"], n, n, hd, hd)] \
        * (d["depth"] * batches)
    window = dict(traffic, frames_per_input=cfg["batch"])
    return calls + _gmflow_builder().attention_calls(
        cfg["flow"], window) * _windows(cfg, traffic)
