"""The JAX package's parameter trees as the port's state_dicts.

`depth_anything_state_dict` inverts `prisma_tpu.weights.torch_convert.
convert_depth_anything`: it takes the JAX parameters as numpy arrays and
returns the reference checkpoint's keys and layouts, so that tests can run
both packages on the same weights.
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
