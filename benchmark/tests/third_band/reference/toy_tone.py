"""The plain reference of the toy band: each pixel's RGB, scaled to [-1, 1],
through a linear layer to `hidden` units, relu, a linear layer to one unit
and a sigmoid; the tone image is that times 255, floored to uint8, and the
level each frame's mean of it before the floor."""

from __future__ import annotations

import torch

from benchmark.reference.common import Ops


def param_specs(cfg: dict) -> list:
    h = cfg["hidden"]
    return [("inner.weight", (h, 3), ("normal", 3 ** -0.5)),
            ("inner.bias", (h,), ("normal", 0.1)),
            ("outer.weight", (1, h), ("normal", 4 * h ** -0.5)),
            ("outer.bias", (1,), ("const", 0.0))]


def band_outputs(sd: dict, frames: torch.Tensor, cfg: dict,
                 ops: Ops = Ops()) -> dict:
    x = frames.float() / 127.5 - 1.0
    h = torch.relu(ops.linear(x, sd["inner.weight"], sd["inner.bias"]))
    y = torch.sigmoid(ops.linear(h, sd["outer.weight"],
                                 sd["outer.bias"]))[..., 0]
    return {"tone": torch.floor(y * 255.0).to(torch.uint8),
            "level": y.mean(dim=(1, 2))}
