"""Checkpoint store: build models from local torch checkpoints or at random
(counterpart of prisma_tpu/weights/store.py, without its orbax cache: the port
loads the reference state_dict directly).

Weights resolve from a local models/ directory (PRISMA_TPU_MODELS or
RuntimeConfig.models_dir):

  depth_anything_{vits,vitb,vitl}14.pt   torch state_dict (HF mixin layout)
  gmflow_sintel-0c07dcb3.pth             torch checkpoint, state_dict under 'model'

With runtime.random_weights=True models initialize randomly from a seeded
torch.Generator instead: same shapes, no files needed.
"""

from __future__ import annotations

import os

import torch

from prisma_tpu_torch.models import depth_anything as da
from prisma_tpu_torch.models import gmflow as gm
from prisma_tpu_torch.models import vit as pvit
from prisma_tpu_torch.runtime.config import RuntimeConfig

RANDOM_SEED = 0


def _load_torch_state_dict(path: str) -> dict:
    """A checkpoint file's state_dict: unwrapped from a `state_dict` or `model`
    entry, with DataParallel `module.` prefixes removed."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model"):
        if isinstance(sd, dict) and key in sd and isinstance(sd[key], dict):
            sd = sd[key]
    return {k.removeprefix("module."): v for k, v in sd.items()}


def depth_anything_from_state_dict(sd: dict, cfg: pvit.ViTConfig,
                                   device="cpu") -> da.DepthAnything:
    """Build a DepthAnything whose DPT widths are the state_dict's and load it
    with strict=True."""
    features = sd["depth_head.scratch.layer1_rn.weight"].shape[0]
    out_channels = tuple(sd[f"depth_head.projects.{i}.weight"].shape[0]
                         for i in range(4))
    model = da.build(cfg, features, out_channels, device=device)
    model.load_state_dict(sd, strict=True)
    return model


def load_depth_anything(runtime: RuntimeConfig, encoder: str = "vitl",
                        metric: str = "none"):
    """-> ("relative", model (f32, CPU), encoder)."""
    if metric != "none":
        raise NotImplementedError(
            "metric Depth-Anything (ZoeDepth head) is not ported yet: "
            "ROADMAP.md queue 1, 'ZoeDepth and metric depth'")
    cfg = pvit.VIT_CONFIGS[encoder]
    if runtime.random_weights:
        gen = torch.Generator().manual_seed(RANDOM_SEED)
        return "relative", da.init_params(da.build(cfg), gen), encoder

    path = os.path.join(runtime.models_dir, f"depth_anything_{encoder}14.pt")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"checkpoint {path} not found; place the torch state_dict there or "
            "set runtime.random_weights=True for smoke runs")
    return ("relative",
            depth_anything_from_state_dict(_load_torch_state_dict(path), cfg),
            encoder)


def load_gmflow(runtime: RuntimeConfig,
                cfg: gm.GMFlowConfig | None = None) -> gm.GMFlow:
    """GMFlow (1-scale), f32 on the CPU: random from the seed, or the
    reference checkpoint `gmflow_sintel-0c07dcb3.pth` (reference
    flow_gmflow.py:35,60-63; the state_dict sits under 'model') loaded with
    strict=True."""
    cfg = cfg or gm.GMFlowConfig()
    if runtime.random_weights:
        gen = torch.Generator().manual_seed(RANDOM_SEED)
        return gm.init_params(gm.build(cfg), gen)
    path = os.path.join(runtime.models_dir, "gmflow_sintel-0c07dcb3.pth")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"checkpoint {path} not found; place the gmflow checkpoint there "
            "or set runtime.random_weights=True for smoke runs")
    model = gm.build(cfg)
    model.load_state_dict(_load_torch_state_dict(path), strict=True)
    return model
