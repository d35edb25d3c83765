"""The builder of the toy band (the names of benchmark/run.py's docstring),
a configuration of a family that no cell measures, for the harness's tests:
no input is shared between steps, its outputs are `tone` and `level`, and
its weights lie in two checkpoint files. Its step is plain torch in the
configuration's dtype, standing in for a band step of the port."""

from __future__ import annotations

import os

import numpy as np
import torch

from benchmark import run
from benchmark.reference.common import Ops

ref = run.load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   os.pardir, "reference", "toy_tone.py"),
                      "benchmark_reference_toy_tone")

OVERLAP = 0
PRIMARY = "tone"
TINY = dict(hidden=8, dtype="float32")
NULL_FLOOR = {}

param_specs = ref.param_specs


def save_checkpoint(sd: dict, models_dir: str, cfg: dict) -> list:
    """The inner layer in the first file, the outer in the second."""
    paths = []
    for name, prefix in zip(cfg["checkpoints"], ("inner.", "outer.")):
        path = os.path.join(models_dir, name)
        torch.save({k: v.clone() for k, v in sd.items()
                    if k.startswith(prefix)}, path)
        paths.append(path)
    return paths


def _load(paths: list, device) -> dict:
    sd = {}
    for path in paths:
        sd.update(torch.load(path, map_location=device, weights_only=True))
    return sd


def load_reference_weights(saved: list, device) -> dict:
    return {k: v.float() for k, v in _load(saved, device).items()}


def build_step(cfg: dict, traffic: dict, models_dir: str, device: str):
    dtype = getattr(torch, cfg["dtype"])
    w = {k: v.to(dtype) for k, v in _load(
        [os.path.join(models_dir, n) for n in cfg["checkpoints"]],
        device).items()}

    @torch.inference_mode()
    def step(frames: np.ndarray) -> dict:
        x = torch.from_numpy(np.ascontiguousarray(frames)).to(device, dtype)
        x = x / 127.5 - 1.0
        h = (x @ w["inner.weight"].T + w["inner.bias"]).clamp_min(0.0)
        y = torch.sigmoid(h @ w["outer.weight"].T
                          + w["outer.bias"]).float()[..., 0]
        return {"tone": (y * 255.0).floor().to(torch.uint8).cpu().numpy(),
                "level": y.mean(dim=(1, 2)).cpu().numpy()}

    return step


def reference(sd: dict, frames: torch.Tensor, cfg: dict, traffic: dict,
              ops: Ops = Ops()) -> dict:
    return ref.band_outputs(sd, frames, cfg, ops)


def compare(out: dict, want: dict) -> dict:
    """tone_gap: the mean |tone - reference tone| in levels of 255."""
    gap = np.abs(out["tone"].astype(np.int16)
                 - want["tone"].cpu().numpy().astype(np.int16))
    return {"tone_gap": float(gap.mean())}


def step_flops(cfg: dict, traffic: dict) -> float:
    pixels = traffic["width"] * traffic["height"] * (
        traffic["frames_per_input"] - OVERLAP)
    return 2.0 * pixels * 4 * cfg["hidden"]


def attention_calls(cfg: dict, traffic: dict) -> list:
    return []
