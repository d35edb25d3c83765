"""The Depth-Anything configurations' builder: the port's band step, the
plain reference, the comparison and the work a step needs. The names it
defines are every builder's, as benchmark/run.py's docstring lists them."""

from __future__ import annotations

import os

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import depth_anything as ref
from benchmark.reference.common import Ops
from benchmark.roofline import attention

OVERLAP = 0
PRIMARY = "heat"
TINY = dict(encoder="vits", embed_dim=384, depth=12, num_heads=6, features=64,
            out_channels=[48, 96, 192, 384], target=42, dtype="float32",
            checkpoint="depth_anything_vits14.pt")
NULL_FLOOR = {"heat_gap": 1e-2}


param_specs = ref.param_specs


def save_checkpoint(sd: dict, models_dir: str, cfg: dict) -> str:
    path = os.path.join(models_dir, cfg["checkpoint"])
    torch.save(sd, path)
    return path


def load_reference_weights(path: str, device) -> dict:
    sd = torch.load(path, map_location=device, weights_only=True)
    return {k: v.float() for k, v in sd.items()}


def build_step(cfg: dict, traffic: dict, models_dir: str, device: str):
    from prisma_tpu_torch.bands import depth_anything_band, depth_base
    from prisma_tpu_torch.runtime.config import RuntimeConfig

    runtime = RuntimeConfig(models_dir=models_dir, random_weights=False,
                            device=device, compute_dtype=cfg["dtype"],
                            batch_size=cfg["batch"])
    model, infer, flip = depth_anything_band.build_infer(
        runtime, encoder=cfg["encoder"], img_size=cfg["target"])
    need_depth = bool(traffic["flags"].get("need_depth", False))
    return depth_base.make_step(model, infer, flip, need_depth=need_depth)


def reference(sd: dict, frames: torch.Tensor, cfg: dict, traffic: dict,
              ops: Ops = Ops()) -> dict:
    return ref.band_outputs(sd, frames, cfg, ops)


def compare(out: dict, want: dict) -> dict:
    """heat_gap: the mean |heat - reference heat| over the input's frames
    and pixels, in levels of 255. The heat is the whole chain: the resize
    and normalisation, ViT-L, the DPT head, the resize back, each frame's
    min and max, and the heat map. (The min and max alone are not compared:
    no limit parts a bfloat16 run from an fp8 one on them, PERF.md.)"""
    heat = np.abs(out["heat"].astype(np.int16)
                  - want["heat"].cpu().numpy().astype(np.int16))
    return {"heat_gap": float(heat.mean())}


def token_grid(cfg: dict, traffic: dict):
    h, w = ref.input_size(traffic["width"], traffic["height"], cfg["target"],
                          cfg["patch_size"])
    return h // cfg["patch_size"], w // cfg["patch_size"]


def step_flops(cfg: dict, traffic: dict) -> float:
    """The products of the model over one step's frames (linears,
    convolutions, attention), counted on the reference's graph over meta
    tensors (one frame, times the batch): resizes and elementwise work are
    not counted."""
    sd = {n: torch.empty(s, device="meta") for n, s, _ in param_specs(cfg)}
    frame = torch.empty(1, traffic["height"], traffic["width"], 3,
                        dtype=torch.uint8, device="meta")
    with FlopCounterMode(display=False) as counter:
        ref.depth(sd, frame, cfg)
    return float(counter.get_total_flops()) * cfg["batch"]


def attention_calls(cfg: dict, traffic: dict) -> list:
    """24 ViT blocks, each one K1 call over the batch's heads."""
    ph, pw = token_grid(cfg, traffic)
    n = ph * pw + 1
    d = cfg["embed_dim"] // cfg["num_heads"]
    c = attention.call(cfg["batch"] * cfg["num_heads"], n, n, d, d)
    return [c] * cfg["depth"]
