"""Checkpoint store: build models from local torch checkpoints or at random
(counterpart of prisma_tpu/weights/store.py, without its orbax cache: the port
loads the reference state_dict directly).

Weights resolve from a local models/ directory (PRISMA_TPU_MODELS or
RuntimeConfig.models_dir):

  depth_anything_{vits,vitb,vitl}14.pt   torch state_dict (HF mixin layout)
  depth_anything_metric_depth_{indoor,outdoor}.pt
                                         ZoeDepth over the ViT-L core, under 'model'
  gmflow_sintel-0c07dcb3.pth             torch checkpoint, state_dict under 'model'
  gmflow_with_refine_sintel-3ed1cf48.pth the same, for two scales (--num_scales 2)
  raft-sintel.pth                        torch state_dict, DataParallel `module.` keys
  solov2_r101_fpn_3x_coco*.pth           mmdet checkpoint, state_dict under 'state_dict'
  ZoeD_M12_N.pt                          ZoeD_N (BEiT-L core + bins head), under 'model'
  patchfusion_u4k.pt                     PatchFusion, state_dict (or under 'model')
  dpt_large_384.pt                       MiDaS DPT_Large (hub DPTDepthModel), state_dict
  midas_v21_384.pt                       MiDaS v2.1 (hub MidasNet), state_dict
  marigold/{unet,vae,text_encoder}/*.bin the Bingxin/Marigold diffusers snapshot

With runtime.random_weights=True models initialize randomly from a seeded
torch.Generator instead: same shapes, no files needed (the BEiT depth of
ZoeD_N from PRISMA_ZOED_DEPTH, PatchFusion's BEiT depth and model size from
PRISMA_PF_DEPTH and PRISMA_PF_SIZE, a tiny Marigold with
PRISMA_MARIGOLD_TINY=1, as the JAX package's loaders read them).

Every `load_*` runs under the set-up span `prisma.setup.weights`
(`runtime.profiling.timed`).
"""

from __future__ import annotations

import fnmatch
import glob
import json
import os

import torch

from prisma_tpu_torch.models import beit
from prisma_tpu_torch.models import depth_anything as da
from prisma_tpu_torch.models import gmflow as gm
from prisma_tpu_torch.models import marigold as mg
from prisma_tpu_torch.models import midas
from prisma_tpu_torch.models import sd2
from prisma_tpu_torch.models import patchfusion as pf
from prisma_tpu_torch.models import raft
from prisma_tpu_torch.models import solov2
from prisma_tpu_torch.models import zoed
from prisma_tpu_torch.models import vit as pvit
from prisma_tpu_torch.models import zoedepth as zoe
from prisma_tpu_torch.runtime.config import RuntimeConfig
from prisma_tpu_torch.runtime.profiling import SETUP_WEIGHTS, timed

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


def _metric_encoder(sd: dict) -> str:
    """The name in VIT_CONFIGS of a metric state_dict's ViT, by its width
    and its number of blocks."""
    p = "core.core.pretrained."
    width = sd[p + "cls_token"].shape[-1]
    depth = len({k.split(".")[4] for k in sd if k.startswith(p + "blocks.")})
    for name, cfg in pvit.VIT_CONFIGS.items():
        if (cfg.embed_dim, cfg.depth) == (width, depth):
            return name
    raise ValueError(f"no ViT of width {width} and {depth} blocks in "
                     f"VIT_CONFIGS ({sorted(pvit.VIT_CONFIGS)})")


@timed(SETUP_WEIGHTS)
def load_depth_anything(runtime: RuntimeConfig, encoder: str = "vitl",
                        metric: str = "none"):
    """-> (kind, model (f32, CPU), encoder) with kind "relative" or "metric".

    Metric: the ZoeDepth-over-DepthAnythingCore checkpoint
    depth_anything_metric_depth_{metric}.pt (reference depth_anything.py:
    38-39), whose ViT is the one of VIT_CONFIGS of the file's width and
    depth (the published files: ViT-L); random weights keep the asked
    encoder."""
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
        sd = _load_torch_state_dict(path)
        name = _metric_encoder(sd)
        return ("metric", metric_depth_anything_from_state_dict(
            sd, pvit.VIT_CONFIGS[name]), name)
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


@timed(SETUP_WEIGHTS)
def load_gmflow(runtime: RuntimeConfig,
                cfg: gm.GMFlowConfig | None = None) -> gm.GMFlow:
    """GMFlow, f32 on the CPU: random from the seed, or the reference
    checkpoint loaded with strict=True: `gmflow_sintel-0c07dcb3.pth`
    (reference flow_gmflow.py:35,60-63; the state_dict sits under 'model'),
    or `gmflow_with_refine_sintel-3ed1cf48.pth` for a cfg with two scales."""
    cfg = cfg or gm.GMFlowConfig()
    if runtime.random_weights:
        gen = torch.Generator().manual_seed(RANDOM_SEED)
        return gm.init_params(gm.build(cfg), gen)
    name = ("gmflow_with_refine_sintel-3ed1cf48.pth" if cfg.num_scales > 1
            else "gmflow_sintel-0c07dcb3.pth")
    path = os.path.join(runtime.models_dir, name)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"checkpoint {path} not found; place the gmflow checkpoint there "
            "or set runtime.random_weights=True for smoke runs")
    model = gm.build(cfg)
    model.load_state_dict(_load_torch_state_dict(path), strict=True)
    return model


@timed(SETUP_WEIGHTS)
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


@timed(SETUP_WEIGHTS)
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


# buffers of the BEiT-core checkpoints that are functions of the geometry or
# the bin count (the JAX converter reads none of them either)
DERIVED = ("*relative_position_index", "*attn_mask",
           "*log_binomial_transform.k_idx", "*log_binomial_transform.K_minus_1")
# timm's classifier on the MiDaS BEiT core (beit_large_patch16_384 pools by
# the mean, so timm registers fc_norm and head), which neither package reads;
# under PatchFusion it sits in both cores
BEIT_UNREAD = ("*core.core.pretrained.model.fc_norm.*",
               "*core.core.pretrained.model.head.*")


def _drop(sd: dict, patterns) -> dict:
    return {k: v for k, v in sd.items()
            if not any(fnmatch.fnmatch(k, p) for p in patterns)}


def _load_strict(model: torch.nn.Module, sd: dict) -> torch.nn.Module:
    """load_state_dict(strict=True) of a checkpoint without its derived
    buffers; batch-norm step counters it leaves out are filled in."""
    sd = _drop(sd, DERIVED)
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd.setdefault(k, v.new_zeros(()))
    model.load_state_dict(sd, strict=True)
    return model


def _checkpoint(runtime: RuntimeConfig, name: str) -> dict:
    path = os.path.join(runtime.models_dir, name)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"checkpoint {path} not found; place {name} there or set "
            "runtime.random_weights=True for smoke runs")
    return _load_torch_state_dict(path)


def _zoed_widths(sd: dict, prefix: str = "") -> dict:
    """The widths of a ZoeDepth (BEiT core) state_dict: the BEiT's embed,
    depth and heads, the decoder's features and out_channels."""
    p = prefix + "core.core."
    b = p + "pretrained.model."
    depth = 0
    while f"{b}blocks.{depth}.norm1.weight" in sd:
        depth += 1
    return {"beit_cfg": beit.BEiTConfig(
                embed_dim=sd[b + "patch_embed.proj.weight"].shape[0],
                depth=depth,
                num_heads=sd[b + "blocks.0.attn.relative_position_bias_table"]
                .shape[1]),
            "features": sd[p + "scratch.layer1_rn.weight"].shape[0],
            "out_channels": tuple(
                sd[f"{p}pretrained.act_postprocess{i}.3.weight"].shape[0]
                for i in range(1, 5))}


def zoed_from_state_dict(sd: dict, device="cpu") -> zoed.ZoeDepth:
    """A ZoeDepth of the state_dict's widths, loaded with strict=True (the
    derived buffers and timm's BEiT classifier dropped)."""
    return _load_strict(zoed.build(**_zoed_widths(sd), device=device),
                        _drop(sd, BEIT_UNREAD))


def patchfusion_from_state_dict(sd: dict, model_hw=pf.MODEL_HW,
                                device="cpu") -> pf.PatchFusion:
    """A PatchFusion of the state_dict's widths at model_hw, loaded with
    strict=True (the derived buffers and both cores' timm BEiT classifiers
    dropped)."""
    model = pf.build(**_zoed_widths(sd, "coarse_model."), model_hw=model_hw,
                     device=device)
    return _load_strict(model, _drop(sd, BEIT_UNREAD))


@timed(SETUP_WEIGHTS)
def load_zoed(runtime: RuntimeConfig) -> zoed.ZoeDepth:
    """ZoeD_N, f32 on the CPU: random from the seed (a BEiT-L of
    PRISMA_ZOED_DEPTH blocks, default 24), or `ZoeD_M12_N.pt` (reference
    depth_zoedepth.py:31-35) loaded with strict=True."""
    if runtime.random_weights:
        depth = int(os.environ.get("PRISMA_ZOED_DEPTH", "24"))
        model = zoed.build(beit.BEiTConfig(depth=depth))
        return zoed.init_params(model, torch.Generator().manual_seed(RANDOM_SEED))
    return zoed_from_state_dict(_checkpoint(runtime, "ZoeD_M12_N.pt"))


@timed(SETUP_WEIGHTS)
def load_patchfusion(runtime: RuntimeConfig):
    """-> (PatchFusion f32 on the CPU, model_hw): random from the seed (BEiT
    depth PRISMA_PF_DEPTH, default 24; model size PRISMA_PF_SIZE "h,w",
    default 384,512), or `patchfusion_u4k.pt` (reference
    depth_patchfusion.py) loaded with strict=True at (384, 512)."""
    if runtime.random_weights:
        hw = tuple(int(v) for v in os.environ.get(
            "PRISMA_PF_SIZE", "384,512").split(","))
        depth = int(os.environ.get("PRISMA_PF_DEPTH", "24"))
        model = pf.build(beit.BEiTConfig(depth=depth), model_hw=hw)
        return pf.init_params(model, torch.Generator().manual_seed(
            RANDOM_SEED)), hw
    return (patchfusion_from_state_dict(
        _checkpoint(runtime, "patchfusion_u4k.pt")), pf.MODEL_HW)


# MiDaS model versions (reference depth_midas.py:26-41): both midas2 load
# MiDaS v2.1, both midas3 DPT_Large; -small only lowers the transform target
MIDAS_VERSIONS = ("midas2-small", "midas2", "midas3-small", "midas3")
MIDAS_FILES = {"v2": ("midas_v21_384.pt", "midas_v21-f6b98070.pt",
                      "model-f6b98070.pt"),
               "dpt": ("dpt_large_384.pt", "dpt_large-midas-2f21e586.pt")}
# timm's classifier under a DPT_Large checkpoint's backbone, which neither
# package reads
MIDAS_UNREAD = ("pretrained.model.head.*",)


def midas_dpt_from_state_dict(sd: dict, device="cpu") -> midas.MidasDPT:
    """A DPT_Large of the state_dict's widths (heads of 64 channels, the
    position grid from pos_embed), loaded with strict=True."""
    sd = _drop(sd, MIDAS_UNREAD)
    b = "pretrained.model."
    depth = 0
    while f"{b}blocks.{depth}.norm1.weight" in sd:
        depth += 1
    pe = sd[b + "patch_embed.proj.weight"]
    D, P = pe.shape[0], pe.shape[-1]
    grid = int(round((sd[b + "pos_embed"].shape[1] - 1) ** 0.5))
    cfg = pvit.ViTConfig(embed_dim=D, depth=depth, num_heads=max(1, D // 64),
                         patch_size=P, base_img_size=grid * P,
                         layerscale=False)
    model = midas.build_dpt(
        cfg, sd["scratch.layer1_rn.weight"].shape[0],
        tuple(sd[f"pretrained.act_postprocess{i}.3.weight"].shape[0]
              for i in range(1, 5)), device=device)
    model.load_state_dict(sd, strict=True)
    return model


def midas2_from_state_dict(sd: dict, device="cpu") -> midas.MidasNet:
    """A MiDaS v2.1 of the state_dict's widths, loaded with strict=True
    (batch-norm step counters it leaves out filled in)."""
    model = midas.build_v2(sd["scratch.layer1_rn.weight"].shape[0],
                           width=sd["pretrained.layer1.0.weight"].shape[0],
                           device=device)
    return _load_strict(model, sd)


@timed(SETUP_WEIGHTS)
def load_midas(runtime: RuntimeConfig, model_version: str = "midas3"):
    """-> (arch, model f32 on the CPU) for any reference model_version:
    "v2" (MiDaS v2.1) for midas2 / midas2-small, "dpt" (DPT_Large) for
    midas3 / midas3-small; random from the seed, or the hub checkpoint
    (`midas_v21_384.pt`, `dpt_large_384.pt` or their release names) loaded
    with strict=True."""
    if model_version not in MIDAS_VERSIONS:
        raise ValueError(f"unknown midas model_version '{model_version}'")
    arch = "v2" if model_version.startswith("midas2") else "dpt"
    if runtime.random_weights:
        gen = torch.Generator().manual_seed(RANDOM_SEED)
        if arch == "v2":
            return arch, midas.init_params_v2(midas.build_v2(), gen)
        return arch, midas.init_params(midas.build_dpt(), gen)
    for name in MIDAS_FILES[arch]:
        path = os.path.join(runtime.models_dir, name)
        if os.path.exists(path):
            sd = _load_torch_state_dict(path)
            return arch, (midas2_from_state_dict(sd) if arch == "v2"
                          else midas_dpt_from_state_dict(sd))
    raise FileNotFoundError(
        f"no MiDaS {'v2.1' if arch == 'v2' else 'DPT_Large'} checkpoint under "
        f"{runtime.models_dir}; place {MIDAS_FILES[arch][0]} there or set "
        "runtime.random_weights=True")


# the JAX package's tiny Marigold (PRISMA_MARIGOLD_TINY=1), with a text
# tower of its context width
TINY_UNET = sd2.UNetConfig(block_channels=(32, 64), cross_attention_dim=64,
                           head_dim=16, norm_groups=8)
TINY_VAE = sd2.VAEConfig(block_channels=(32, 64), norm_groups=8)
TINY_TEXT = mg.CLIPTextConfig(width=64, heads=2, layers=2)
# the text encoder's position ids (a buffer in older transformers), a
# function of max_len
TEXT_DERIVED = ("text_model.embeddings.position_ids",)
# the VAE mid-block attention's names before diffusers 0.14 (and the
# original LDM's) -> today's
_VAE_ATTN_NAMES = {"query": "to_q", "key": "to_k", "value": "to_v",
                   "proj_attn": "to_out.0", "q": "to_q", "k": "to_k",
                   "v": "to_v", "proj_out": "to_out.0", "norm": "group_norm"}


def _vae_current_names(sd: dict) -> dict:
    """A VAE state_dict with its mid-block attentions in today's diffusers
    names (1x1 conv weights as linear ones)."""
    out = {}
    for k, v in sd.items():
        parts = k.split(".")
        if ".mid_block.attentions.0." in k and parts[-2] in _VAE_ATTN_NAMES:
            parts[-2] = _VAE_ATTN_NAMES[parts[-2]]
            if v.dim() == 4:
                v = v[:, :, 0, 0]
            k = ".".join(parts)
        out[k] = v
    return out


def _snapshot_component(mdir: str, sub: str) -> dict:
    for pat in ("diffusion_pytorch_model.bin", "pytorch_model.bin", "*.bin"):
        matches = sorted(glob.glob(os.path.join(mdir, sub, pat)))
        if matches:
            return _load_torch_state_dict(matches[0])
    raise FileNotFoundError(f"no torch weights under {mdir}/{sub}")


def _snapshot_config(mdir: str, sub: str) -> dict:
    """A component's config.json (diffusers / transformers), {} if absent."""
    path = os.path.join(mdir, sub, "config.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def _unet_config(sd: dict, conf: dict) -> sd2.UNetConfig:
    """The UNet's widths from its state_dict; its heads (diffusers'
    `attention_head_dim`, SD2's [5, 10, 20, 20] heads a block) and groups
    from its config, SD2's where the config is absent."""
    bc, i = [], 0
    while f"down_blocks.{i}.resnets.0.conv1.weight" in sd:
        bc.append(sd[f"down_blocks.{i}.resnets.0.conv1.weight"].shape[0])
        i += 1
    heads = conf.get("attention_head_dim", 5)
    heads = heads[0] if isinstance(heads, (list, tuple)) else heads
    return sd2.UNetConfig(
        in_channels=sd["conv_in.weight"].shape[1],
        out_channels=sd["conv_out.weight"].shape[0], block_channels=tuple(bc),
        cross_attention_dim=sd["down_blocks.0.attentions.0.transformer_blocks."
                               "0.attn2.to_k.weight"].shape[1],
        head_dim=bc[0] // heads, norm_groups=conf.get("norm_num_groups", 32))


def marigold_from_snapshot(mdir: str, device="cpu") -> mg.Marigold:
    """A Marigold of the snapshot's widths: `unet/` and `vae/` loaded with
    strict=True, the empty prompt's embedding computed by `text_encoder/`
    (loaded strictly too) on `device`. The model stays f32 on the CPU."""
    unet_sd = _snapshot_component(mdir, "unet")
    vae_sd = _vae_current_names(_snapshot_component(mdir, "vae"))
    text_sd = {k: v for k, v in _snapshot_component(mdir, "text_encoder").items()
               if k not in TEXT_DERIVED}
    ucfg = _unet_config(unet_sd, _snapshot_config(mdir, "unet"))
    vc, i = [], 0
    while f"encoder.down_blocks.{i}.resnets.0.conv1.weight" in vae_sd:
        vc.append(vae_sd[f"encoder.down_blocks.{i}.resnets.0.conv1.weight"]
                  .shape[0])
        i += 1
    vcfg = sd2.VAEConfig(
        block_channels=tuple(vc), latent_channels=vae_sd[
            "post_quant_conv.weight"].shape[0],
        norm_groups=_snapshot_config(mdir, "vae").get("norm_num_groups", 32))
    model = mg.build(ucfg, vcfg)
    model.load_state_dict({**{"unet." + k: v for k, v in unet_sd.items()},
                           **{"vae." + k: v for k, v in vae_sd.items()}},
                          strict=True)
    layers = 0
    while f"text_model.encoder.layers.{layers}.layer_norm1.weight" in text_sd:
        layers += 1
    emb = "text_model.embeddings."
    tconf = _snapshot_config(mdir, "text_encoder")
    default = mg.CLIPTextConfig()
    text = mg.build_text(mg.CLIPTextConfig(
        vocab=text_sd[emb + "token_embedding.weight"].shape[0],
        width=text_sd[emb + "token_embedding.weight"].shape[1],
        heads=tconf.get("num_attention_heads", default.heads), layers=layers,
        max_len=text_sd[emb + "position_embedding.weight"].shape[0],
        bos=tconf.get("bos_token_id", default.bos),
        eos=tconf.get("eos_token_id", default.eos)))
    text.load_state_dict(text_sd, strict=True)
    return mg.set_text_embed(model, text.to(device))


@timed(SETUP_WEIGHTS)
def load_marigold(runtime: RuntimeConfig, device="cpu") -> mg.Marigold:
    """Marigold, f32 on the CPU, its empty prompt's embedding made by the
    text tower on `device`: random from the seed (the tower too, at full
    width, run once; tiny with PRISMA_MARIGOLD_TINY=1), or the
    Bingxin/Marigold diffusers snapshot under models/marigold/ (reference
    depth_marigold.py)."""
    if runtime.random_weights:
        tiny = os.environ.get("PRISMA_MARIGOLD_TINY", "0") == "1"
        gen = torch.Generator().manual_seed(RANDOM_SEED)
        model = mg.init_params(mg.build(*((TINY_UNET, TINY_VAE) if tiny
                                          else ())), gen)
        text = mg.init_text(mg.build_text(TINY_TEXT if tiny
                                          else mg.CLIPTextConfig()), gen)
        return mg.set_text_embed(model, text.to(device))
    mdir = os.path.join(runtime.models_dir, "marigold")
    if not os.path.isdir(mdir):
        raise FileNotFoundError(
            f"{mdir} not found; place the Bingxin/Marigold diffusers snapshot "
            "(unet/vae/text_encoder torch weights) there or set "
            "runtime.random_weights=True")
    return marigold_from_snapshot(mdir, device)
