"""The 1-scale GMFlow configurations' builder (the names of
benchmark/run.py's docstring): the port's flow step over windows of frames,
the plain reference, the comparison and the work a step needs."""

from __future__ import annotations

import os

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import gmflow as ref
from benchmark.reference.common import Ops, fwdbwd_masks
from benchmark.roofline import attention

OVERLAP = 1
PRIMARY = "fwd_rgb"
TINY = dict(feature_channels=32, num_transformer_layers=2, dtype="float32")
NULL_FLOOR = {"fwd_rgb_gap": 1e-2, "fwd_flow_gap": 1e-3, "bwd_flow_gap": 1e-3,
              "bwd_rgb_gap": 1e-2}
# pixels differing over pixels marked, the marked counted as at least 25 an
# input: a pixel flipped at the threshold reads 1% or less however few the
# random flows make consistent
RATIOS = {"mask_mismatch_of_marked": ("mask_differ_px", "mask_marked_px",
                                      25.0)}


param_specs = ref.param_specs


def save_checkpoint(sd: dict, models_dir: str, cfg: dict) -> str:
    path = os.path.join(models_dir, cfg["checkpoint"])
    torch.save({"model": sd}, path)
    return path


def load_reference_weights(path: str, device) -> dict:
    sd = torch.load(path, map_location=device, weights_only=True)["model"]
    return {k: v.float() for k, v in sd.items()}


def _flags(traffic: dict):
    f = traffic["flags"]
    return bool(f.get("backwards", False)), bool(f.get("mask", False))


def build_step(cfg: dict, traffic: dict, models_dir: str, device: str):
    from prisma_tpu_torch.bands import flow_base, flow_gmflow_band
    from prisma_tpu_torch.models import gmflow as gm
    from prisma_tpu_torch.runtime.config import RuntimeConfig

    runtime = RuntimeConfig(models_dir=models_dir, random_weights=False,
                            device=device, compute_dtype=cfg["dtype"],
                            batch_size=cfg["batch"])
    gcfg = gm.GMFlowConfig(
        feature_channels=cfg["feature_channels"],
        num_transformer_layers=cfg["num_transformer_layers"],
        attn_splits=cfg["attn_splits"],
        ffn_dim_expansion=cfg["ffn_dim_expansion"],
        upsample_factor=cfg["upsample_factor"],
        padding_factor=cfg["padding_factor"])
    lazy_model, infer_pairs = flow_gmflow_band.build_pairs(runtime, cfg=gcfg)
    backwards, mask = _flags(traffic)
    return flow_base.build_flow_step(lazy_model(), infer_pairs, cfg["scale"],
                                     traffic["width"], traffic["height"],
                                     runtime, backwards=backwards, mask=mask)


def reference(sd: dict, frames: torch.Tensor, cfg: dict, traffic: dict,
              ops: Ops = Ops()) -> dict:
    backwards, mask = _flags(traffic)
    return ref.band_outputs(sd, frames, cfg, backwards, mask, ops)


def _rgb_gap(a: np.ndarray, b: torch.Tensor) -> float:
    return float(np.abs(a.astype(np.int16)
                        - b.cpu().numpy().astype(np.int16)).mean())


def _epe(a: np.ndarray, b: torch.Tensor) -> float:
    return float(np.sqrt(((a - b.cpu().numpy()) ** 2).sum(-1)).mean())


def compare(out: dict, want: dict) -> dict:
    """Means over the window's pairs and pixels: fwd_rgb_gap (bwd_rgb_gap),
    |HSV image - reference's| in levels of 255, which carries the flow
    through its own maximum; fwd_flow_gap (bwd_flow_gap), the end point
    distance in pixels. The masks are judged alone, whatever the flows:
    against the reference's consistency test applied to the port's own
    flows of each side, mask_differ_px counts the pixels on which the two
    differ and mask_marked_px those that either marks consistent (their
    quotient over the sample, RATIOS, is 1 for inverted masks, and for masks
    left all false where the reference marks 25 pixels an input), and mask_marked_share is the share of all pixels that the
    reference marks, for the record. `max_disp` is not compared on its own:
    no limit parts a bfloat16 run from an fp8 one on it (PERF.md)."""
    nums = {"fwd_rgb_gap": _rgb_gap(out["fwd_rgb"], want["fwd_rgb"])}
    if "fwd" in want:
        nums["fwd_flow_gap"] = _epe(out["fwd"], want["fwd"])
        nums["bwd_flow_gap"] = _epe(out["bwd"], want["bwd"])
        nums["bwd_rgb_gap"] = _rgb_gap(out["bwd_rgb"], want["bwd_rgb"])
    if "fwd_mask" in want:
        dev = want["fwd"].device
        ref_masks = torch.stack(fwdbwd_masks(
            torch.as_tensor(out["fwd"], device=dev),
            torch.as_tensor(out["bwd"], device=dev))).cpu().numpy()
        masks = np.stack([out["fwd_mask"], out["bwd_mask"]]).astype(bool)
        nums["mask_differ_px"] = float(np.logical_xor(masks, ref_masks).sum())
        nums["mask_marked_px"] = float(np.logical_or(masks, ref_masks).sum())
        nums["mask_marked_share"] = float(ref_masks.mean())
    return nums


def feature_grid(cfg: dict, traffic: dict):
    """(h, w) of the 1/8 features of the padded flow-scale frame."""
    m = cfg["padding_factor"]
    h = int(round(traffic["height"] * cfg["scale"]))
    w = int(round(traffic["width"] * cfg["scale"]))
    return -(-h // m) * m // 8, -(-w // m) * m // 8


def step_flops(cfg: dict, traffic: dict) -> float:
    """The products of the model over one window's pairs (convolutions,
    linears, window attention, global matching and propagation), counted
    on the reference's graph over meta tensors (one pair, times the
    window's pairs)."""
    sd = {n: torch.empty(s, device="meta") for n, s, _ in param_specs(cfg)}
    pair = torch.empty(2, traffic["height"], traffic["width"], 3,
                       dtype=torch.uint8, device="meta")
    with FlopCounterMode(display=False) as counter:
        ref.pair_flows(sd, pair, cfg)
    return float(counter.get_total_flops()) * (traffic["frames_per_input"]
                                               - OVERLAP)


def attention_calls(cfg: dict, traffic: dict) -> list:
    """Per layer a self and a cross window attention over both directions'
    windows (K1 unshifted, K2 shifted); global matching both ways and the
    propagation of both directions (K3, f32 values of width 2)."""
    h, w = feature_grid(cfg, traffic)
    pairs = traffic["frames_per_input"] - OVERLAP
    ns, C = cfg["attn_splits"], cfg["feature_channels"]
    win = (h // ns) * (w // ns)
    calls = [attention.call(2 * pairs * ns * ns, win, win, C, C)] \
        * (2 * cfg["num_transformer_layers"])
    glob = dict(v_bytes=4, out_bytes=4)
    calls += [attention.call(pairs, h * w, h * w, C, 2, **glob)] * 2
    calls += [attention.call(2 * pairs, h * w, h * w, C, 2, **glob)]
    return calls
