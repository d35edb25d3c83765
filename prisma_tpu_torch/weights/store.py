"""Checkpoint store: build models from local torch checkpoints or at random
(counterpart of prisma_tpu/weights/store.py, without its orbax cache: the port
loads the reference state_dict directly).

Weights resolve from a local models/ directory (PRISMA_TPU_MODELS or
RuntimeConfig.models_dir):

  depth_anything_{vits,vitb,vitl}14.pt   torch state_dict (HF mixin layout)
  depth_anything_metric_depth_{indoor,outdoor}.pt
                                         ZoeDepth over the ViT-L core, under 'model'
  gmflow_sintel-0c07dcb3.pth             torch checkpoint, state_dict under 'model'
  raft-sintel.pth                        torch state_dict, DataParallel `module.` keys
  solov2_r101_fpn_3x_coco*.pth           mmdet checkpoint, state_dict under 'state_dict'

With runtime.random_weights=True models initialize randomly from a seeded
torch.Generator instead: same shapes, no files needed.
"""

from __future__ import annotations

import glob
import os

import torch

from prisma_tpu_torch.models import depth_anything as da
from prisma_tpu_torch.models import gmflow as gm
from prisma_tpu_torch.models import raft
from prisma_tpu_torch.models import solov2
from prisma_tpu_torch.models import vit as pvit
from prisma_tpu_torch.models import zoedepth as zoe
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


# buffers of the metric checkpoint that are functions of the bin count
# (dist_layers.py:46-48); convert_metric_depth_anything reads none of them
METRIC_DERIVED = ("conditional_log_binomial.log_binomial_transform.k_idx",
                  "conditional_log_binomial.log_binomial_transform.K_minus_1")
# the random metric core's DPT width per encoder (the JAX package's)
METRIC_RANDOM_FEATURES = {"vits": 64, "vitb": 128, "vitl": 256}


def metric_depth_anything_from_state_dict(sd: dict, cfg: pvit.ViTConfig,
                                          device="cpu") -> zoe.MetricDepthAnything:
    """Build a MetricDepthAnything whose DPT widths are the state_dict's and
    load it with strict=True (the derived log-binomial buffers dropped)."""
    sd = {k: v for k, v in sd.items() if k not in METRIC_DERIVED}
    core = "core.core.depth_head."
    features = sd[core + "scratch.layer1_rn.weight"].shape[0]
    out_channels = tuple(sd[f"{core}projects.{i}.weight"].shape[0]
                         for i in range(4))
    model = zoe.build(cfg, features, out_channels, device=device)
    model.load_state_dict(sd, strict=True)
    return model


def load_depth_anything(runtime: RuntimeConfig, encoder: str = "vitl",
                        metric: str = "none"):
    """-> (kind, model (f32, CPU), encoder) with kind "relative" or "metric".

    Metric: the ZoeDepth-over-DepthAnythingCore checkpoint
    depth_anything_metric_depth_{metric}.pt (reference depth_anything.py:
    38-39), always ViT-L; random weights keep the asked encoder."""
    if metric != "none":
        if runtime.random_weights:
            gen = torch.Generator().manual_seed(RANDOM_SEED)
            model = zoe.build(pvit.VIT_CONFIGS[encoder],
                              METRIC_RANDOM_FEATURES[encoder])
            return "metric", zoe.init_params(model, gen), encoder
        path = os.path.join(runtime.models_dir,
                            f"depth_anything_metric_depth_{metric}.pt")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"checkpoint {path} not found; place the metric checkpoint "
                "there or set runtime.random_weights=True")
        return ("metric", metric_depth_anything_from_state_dict(
            _load_torch_state_dict(path), pvit.VIT_CONFIGS["vitl"]), "vitl")
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


def load_raft(runtime: RuntimeConfig,
              cfg: raft.RAFTConfig | None = None) -> raft.RAFT:
    """RAFT, f32 on the CPU: random from the seed, or the reference
    checkpoint `raft-sintel.pth` (reference flow_raft.py:33,42-44; its keys
    carry DataParallel's `module.`, which the loader strips) loaded with
    strict=True."""
    cfg = cfg or raft.RAFTConfig()
    if runtime.random_weights:
        gen = torch.Generator().manual_seed(RANDOM_SEED)
        return raft.init_params(raft.build(cfg), gen)
    path = os.path.join(runtime.models_dir, "raft-sintel.pth")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"checkpoint {path} not found; place raft-sintel.pth there or set "
            "runtime.random_weights=True for smoke runs")
    model = raft.build(cfg)
    model.load_state_dict(_load_torch_state_dict(path), strict=True)
    return model


def load_solov2(runtime: RuntimeConfig,
                cfg: solov2.SOLOv2Config | None = None) -> solov2.SOLOv2:
    """SOLOv2 R101, f32 on the CPU: random from the seed, or the mmdet
    checkpoint `solov2_r101_fpn_3x_coco*.pth` (reference mask_mmdet.py:
    27-28; the state_dict sits under 'state_dict') loaded with strict=True.
    Batch-norm step counters, which a checkpoint may leave out and inference
    never reads, are filled in."""
    cfg = cfg or solov2.SOLOv2Config()
    model = solov2.build(cfg)
    if runtime.random_weights:
        gen = torch.Generator().manual_seed(RANDOM_SEED)
        return solov2.init_params(model, gen)
    matches = sorted(glob.glob(os.path.join(runtime.models_dir,
                                            "solov2_r101_fpn_3x_coco*.pth")))
    if not matches:
        raise FileNotFoundError(
            f"no solov2_r101_fpn_3x_coco*.pth under {runtime.models_dir}; "
            "place the mmdet checkpoint there or set runtime.random_weights=True")
    sd = _load_torch_state_dict(matches[0])
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd.setdefault(k, v.new_zeros(()))
    model.load_state_dict(sd, strict=True)
    return model
