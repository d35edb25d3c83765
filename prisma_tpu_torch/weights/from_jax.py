"""The JAX package's parameter trees as the port's state_dicts.

`depth_anything_state_dict`, `metric_depth_anything_state_dict`,
`gmflow_state_dict`, `raft_state_dict` and `solov2_state_dict` invert
`prisma_tpu.weights.torch_convert.convert_depth_anything`,
`convert_metric_depth_anything`, `convert_gmflow`, `convert_raft` and
`convert_solov2`: they take the JAX parameters as numpy arrays and return the
reference checkpoint's keys and layouts, so that tests can run both packages
on the same weights.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(sd: dict, key: str, p: dict) -> None:
    sd[key + ".weight"] = _t(np.asarray(p["w"]).T)  # [in, out] -> [out, in]
    if "b" in p:
        sd[key + ".bias"] = _t(p["b"])


def _conv(sd: dict, key: str, p: dict) -> None:
    sd[key + ".weight"] = _t(np.asarray(p["w"]).transpose(3, 2, 0, 1))  # HWIO -> OIHW
    if "b" in p:
        sd[key + ".bias"] = _t(p["b"])


def _conv_t(sd: dict, key: str, p: dict) -> None:
    # [k, k, in, out] -> [in, out, k, k]
    sd[key + ".weight"] = _t(np.asarray(p["w"]).transpose(2, 3, 0, 1))
    if "b" in p:
        sd[key + ".bias"] = _t(p["b"])


def _norm(sd: dict, key: str, p: dict) -> None:
    sd[key + ".weight"] = _t(p["scale"])
    sd[key + ".bias"] = _t(p["bias"])


def dino_vit_state_dict(params: dict, patch: int = 14) -> dict:
    sd: dict = {}
    w = np.asarray(params["patch_embed"]["w"])  # [(kh, kw, c), D]
    D = w.shape[1]
    sd["patch_embed.proj.weight"] = _t(
        w.reshape(patch, patch, -1, D).transpose(3, 2, 0, 1))
    sd["patch_embed.proj.bias"] = _t(params["patch_embed"]["b"])
    sd["cls_token"] = _t(params["cls_token"])
    sd["pos_embed"] = _t(params["pos_embed"])
    sd["mask_token"] = torch.zeros(1, D)  # not carried by the JAX tree
    _norm(sd, "norm", params["norm"])
    for i, b in enumerate(params["blocks"]):
        k = f"blocks.{i}."
        _norm(sd, k + "norm1", b["norm1"])
        _linear(sd, k + "attn.qkv", b["attn"]["qkv"])
        _linear(sd, k + "attn.proj", b["attn"]["proj"])
        sd[k + "ls1.gamma"] = _t(b["ls1"])
        _norm(sd, k + "norm2", b["norm2"])
        _linear(sd, k + "mlp.fc1", b["mlp"]["fc1"])
        _linear(sd, k + "mlp.fc2", b["mlp"]["fc2"])
        sd[k + "ls2.gamma"] = _t(b["ls2"])
    return sd


def dpt_head_state_dict(params: dict) -> dict:
    sd: dict = {}
    for i in range(4):
        _conv(sd, f"projects.{i}", params["projects"][i])
        _conv(sd, f"scratch.layer{i + 1}_rn", params["scratch"][i])
    _conv_t(sd, "resize_layers.0", params["resize0"])
    _conv_t(sd, "resize_layers.1", params["resize1"])
    _conv(sd, "resize_layers.3", params["resize3"])
    for i, r in enumerate(params["refinenet"]):
        k = f"scratch.refinenet{i + 1}."
        for unit, name in (("rcu1", "resConfUnit1"), ("rcu2", "resConfUnit2")):
            _conv(sd, k + name + ".conv1", r[unit]["conv1"])
            _conv(sd, k + name + ".conv2", r[unit]["conv2"])
        _conv(sd, k + "out_conv", r["out_conv"])
    _conv(sd, "scratch.output_conv1", params["output_conv1"])
    _conv(sd, "scratch.output_conv2.0", params["output_conv2_0"])
    _conv(sd, "scratch.output_conv2.2", params["output_conv2_2"])
    return sd


def depth_anything_state_dict(params_np: dict) -> dict[str, torch.Tensor]:
    """{"vit": ..., "dpt": ...} (numpy leaves) -> the checkpoint's
    `pretrained.*` / `depth_head.*` state_dict, f32 CPU tensors."""
    sd = {"pretrained." + k: v
          for k, v in dino_vit_state_dict(params_np["vit"]).items()}
    sd.update({"depth_head." + k: v
               for k, v in dpt_head_state_dict(params_np["dpt"]).items()})
    return sd


def metric_depth_anything_state_dict(params_np: dict) -> dict[str, torch.Tensor]:
    """{"core": {"vit", "dpt"}, "head": ...} (numpy leaves) -> the metric
    checkpoint's `core.core.pretrained.*` / `core.core.depth_head.*` and
    bins-head state_dict, f32 CPU tensors."""
    sd = {"core.core." + k: v
          for k, v in depth_anything_state_dict(params_np["core"]).items()}
    head = params_np["head"]

    def mlp(key, p):
        _conv(sd, key + ".0", p["fc1"])
        _conv(sd, key + ".2", p["fc2"])

    _conv(sd, "conv2", head["conv2"])
    mlp("seed_bin_regressor._net", head["seed_bin_regressor"])
    mlp("seed_projector._net", head["seed_projector"])
    for i, p in enumerate(head["projectors"]):
        mlp(f"projectors.{i}._net", p)
    for i, p in enumerate(head["attractors"]):
        mlp(f"attractors.{i}._net", p)
    mlp("conditional_log_binomial.mlp", head["conditional_log_binomial"])
    return sd


def gmflow_state_dict(params_np: dict) -> dict[str, torch.Tensor]:
    """The JAX GMFlow tree (numpy leaves) -> the reference checkpoint's
    `backbone.*` / `transformer.*` / `feature_flow_attn.*` / `upsampler.*`
    state_dict, f32 CPU tensors (instance norms carry no parameters)."""
    sd: dict = {}
    bb = params_np["backbone"]
    _conv(sd, "backbone.conv1", bb["conv1"])
    names = ("layer1.0", "layer1.1", "layer2.0", "layer2.1", "layer3.0",
             "layer3.1")
    for name, b in zip(names, bb["blocks"]):
        k = f"backbone.{name}."
        _conv(sd, k + "conv1", b["conv1"])
        _conv(sd, k + "conv2", b["conv2"])
        if "down" in b:
            _conv(sd, k + "downsample.0", b["down"])
    _conv(sd, "backbone.conv2", bb["conv2"])
    for i, layer in enumerate(params_np["transformer"]["layers"]):
        for part, name in (("self", "self_attn"), ("cross", "cross_attn_ffn")):
            p = layer[part]
            k = f"transformer.layers.{i}.{name}."
            for proj in ("q", "k", "v"):
                _linear(sd, k + proj + "_proj", p[proj])
            _linear(sd, k + "merge", p["merge"])
            _norm(sd, k + "norm1", p["norm1"])
            if "mlp1" in p:
                _linear(sd, k + "mlp.0", p["mlp1"])
                _linear(sd, k + "mlp.2", p["mlp2"])
                _norm(sd, k + "norm2", p["norm2"])
    fa = params_np["flow_attn"]
    _linear(sd, "feature_flow_attn.q_proj", fa["q"])
    _linear(sd, "feature_flow_attn.k_proj", fa["k"])
    _conv(sd, "upsampler.0", params_np["upsampler"]["conv1"])
    _conv(sd, "upsampler.2", params_np["upsampler"]["conv2"])
    return sd


def _unfold_bn(sd: dict, key: str, p: dict, eps: float = 1e-5) -> None:
    """A folded eval-mode batch norm (scale, bias) as a BatchNorm2d's state:
    weight = scale, bias = bias, running_mean = 0, running_var = 1 - eps, so
    that convert_raft's fold w / sqrt(var + eps) gives the scale back within
    an ulp."""
    scale = _t(p["scale"])
    sd[key + ".weight"] = scale
    sd[key + ".bias"] = _t(p["bias"])
    sd[key + ".running_mean"] = torch.zeros_like(scale)
    sd[key + ".running_var"] = torch.full_like(scale, 1.0 - eps)
    sd[key + ".num_batches_tracked"] = torch.zeros((), dtype=torch.int64)


def raft_state_dict(params_np: dict) -> dict[str, torch.Tensor]:
    """The JAX RAFT tree (numpy leaves) -> the reference checkpoint's
    `fnet.*` / `cnet.*` / `update_block.*` state_dict (without the
    DataParallel `module.` prefix), f32 CPU tensors. fnet's instance norms
    carry no parameters; cnet's folded batch norms are unfolded, and a
    strided block's norm3 appears under both of its names, `norm3` and
    `downsample.1`, as in the reference."""
    sd: dict = {}
    names = ("layer1.0", "layer1.1", "layer2.0", "layer2.1", "layer3.0",
             "layer3.1")
    for enc_name in ("fnet", "cnet"):
        enc = params_np[enc_name]
        _conv(sd, f"{enc_name}.conv1", enc["conv1"])
        _conv(sd, f"{enc_name}.conv2", enc["conv2"])
        if "norm1" in enc:
            _unfold_bn(sd, f"{enc_name}.norm1", enc["norm1"])
        for name, b in zip(names, enc["blocks"]):
            k = f"{enc_name}.{name}."
            _conv(sd, k + "conv1", b["conv1"])
            _conv(sd, k + "conv2", b["conv2"])
            for norm in ("norm1", "norm2"):
                if norm in b:
                    _unfold_bn(sd, k + norm, b[norm])
            if "down" in b:
                _conv(sd, k + "downsample.0", b["down"])
            if "norm3" in b:
                _unfold_bn(sd, k + "norm3", b["norm3"])
                _unfold_bn(sd, k + "downsample.1", b["norm3"])
    u = params_np["update"]
    for name, p in u["encoder"].items():
        _conv(sd, f"update_block.encoder.{name}", p)
    for name, p in u["gru"].items():
        _conv(sd, f"update_block.gru.{name}", p)
    for name, p in u["flow_head"].items():
        _conv(sd, f"update_block.flow_head.{name}", p)
    _conv(sd, "update_block.mask.0", u["mask"]["conv1"])
    _conv(sd, "update_block.mask.2", u["mask"]["conv2"])
    return sd


def resnet_state_dict(params_np: dict) -> dict[str, torch.Tensor]:
    """The JAX ResNet tree (folded batch norms) -> torchvision's keys, the
    batch norms unfolded as `_unfold_bn` does."""
    sd: dict = {}
    _conv(sd, "conv1", params_np["stem"])
    _unfold_bn(sd, "bn1", params_np["stem_bn"])
    for si, stage in enumerate(params_np["stages"]):
        for bi, b in enumerate(stage):
            k = f"layer{si + 1}.{bi}."
            for i in (1, 2, 3):
                _conv(sd, k + f"conv{i}", b[f"conv{i}"])
                _unfold_bn(sd, k + f"bn{i}", b[f"bn{i}"])
            if "down" in b:
                _conv(sd, k + "downsample.0", b["down"])
                _unfold_bn(sd, k + "downsample.1", b["down_bn"])
    return sd


def solov2_state_dict(params_np: dict) -> dict[str, torch.Tensor]:
    """The JAX SOLOv2 tree (numpy leaves) -> the mmdet checkpoint's
    `backbone.*` / `neck.*` / `mask_head.*` state_dict, f32 CPU tensors."""
    sd = {"backbone." + k: v
          for k, v in resnet_state_dict(params_np["backbone"]).items()}
    fpn = params_np["fpn"]
    for i, (lat, out) in enumerate(zip(fpn["lateral"], fpn["out"])):
        _conv(sd, f"neck.lateral_convs.{i}.conv", lat)
        _conv(sd, f"neck.fpn_convs.{i}.conv", out)
    head = params_np["head"]

    def cgn(key, p):
        _conv(sd, key + ".conv", p["conv"])
        _norm(sd, key + ".gn", p["gn"])

    mh = "mask_head."
    for i, branch in enumerate(head["mask_feat"]["branches"]):
        for j, p in enumerate(branch):
            cgn(f"{mh}mask_feature_head.convs_all_levels.{i}.conv{j}", p)
    cgn(mh + "mask_feature_head.conv_pred", head["mask_feat"]["pred"])
    for name in ("kernel_convs", "cls_convs"):
        for i, p in enumerate(head[name]):
            cgn(f"{mh}{name}.{i}", p)
    _conv(sd, mh + "conv_kernel", head["conv_kernel"])
    _conv(sd, mh + "conv_cls", head["conv_cls"])
    return sd
