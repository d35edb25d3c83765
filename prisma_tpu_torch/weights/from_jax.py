"""The JAX package's parameter trees as the port's state_dicts.

`depth_anything_state_dict` and `gmflow_state_dict` invert
`prisma_tpu.weights.torch_convert.convert_depth_anything` and
`convert_gmflow`: they take the JAX parameters as numpy arrays and return the
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
