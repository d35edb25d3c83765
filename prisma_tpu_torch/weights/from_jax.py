"""The JAX package's parameter trees as the port's state_dicts.

`depth_anything_state_dict`, `metric_depth_anything_state_dict`,
`gmflow_state_dict`, `raft_state_dict`, `solov2_state_dict`,
`zoed_state_dict`, `patchfusion_state_dict`, `midas_dpt_state_dict`,
`midas2_state_dict`, `sd2_unet_state_dict`, `sd_vae_state_dict` and
`clip_text_state_dict` invert
`prisma_tpu.weights.torch_convert.convert_depth_anything`,
`convert_metric_depth_anything`, `convert_gmflow`, `convert_raft`,
`convert_solov2`, `convert_zoed`, `convert_patchfusion`,
`convert_midas_dpt`, `convert_midas2`, `convert_sd2_unet`,
`convert_sd_vae` and `convert_clip_text`: they take the JAX parameters as
numpy arrays and return the reference checkpoint's keys and layouts, so
that tests can run both packages on the same weights.
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
    sd.update(bins_head_state_dict(params_np["head"]))
    return sd


def bins_head_state_dict(head: dict) -> dict[str, torch.Tensor]:
    """The JAX ZoeDepth bins head -> its top-level checkpoint keys."""
    sd: dict = {}

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


def beit_state_dict(params_np: dict) -> dict[str, torch.Tensor]:
    """The JAX BEiT tree -> timm's keys (the MiDaS checkpoint's
    `pretrained.model.*` without the prefix)."""
    sd: dict = {}
    w = np.asarray(params_np["patch_embed"]["w"])  # [(kh, kw, c), D]
    sd["patch_embed.proj.weight"] = _t(
        w.reshape(16, 16, -1, w.shape[1]).transpose(3, 2, 0, 1))
    sd["patch_embed.proj.bias"] = _t(params_np["patch_embed"]["b"])
    sd["cls_token"] = _t(params_np["cls_token"])
    for i, b in enumerate(params_np["blocks"]):
        k = f"blocks.{i}."
        _norm(sd, k + "norm1", b["norm1"])
        sd[k + "attn.qkv.weight"] = _t(np.asarray(b["attn"]["qkv_w"]).T)
        sd[k + "attn.q_bias"] = _t(b["attn"]["q_bias"])
        sd[k + "attn.v_bias"] = _t(b["attn"]["v_bias"])
        sd[k + "attn.relative_position_bias_table"] = _t(b["rel_pos_table"])
        _linear(sd, k + "attn.proj", b["attn"]["proj"])
        sd[k + "gamma_1"] = _t(b["gamma1"])
        _norm(sd, k + "norm2", b["norm2"])
        _linear(sd, k + "mlp.fc1", b["mlp"]["fc1"])
        _linear(sd, k + "mlp.fc2", b["mlp"]["fc2"])
        sd[k + "gamma_2"] = _t(b["gamma2"])
    return sd


def midas_decoder_state_dict(params_np: dict) -> dict[str, torch.Tensor]:
    """The JAX MiDaS decoder tree -> the hub DPTDepthModel's
    `pretrained.act_postprocess*` and `scratch.*` keys."""
    sd: dict = {}
    for i in range(4):
        k = f"pretrained.act_postprocess{i + 1}."
        _linear(sd, k + "0.project.0", params_np["readout"][i])
        _conv(sd, k + "3", params_np["projects"][i])
        _conv(sd, f"scratch.layer{i + 1}_rn", params_np["scratch"][i])
    _conv_t(sd, "pretrained.act_postprocess1.4", params_np["resize0"])
    _conv_t(sd, "pretrained.act_postprocess2.4", params_np["resize1"])
    _conv(sd, "pretrained.act_postprocess4.4", params_np["resize3"])
    for i, r in enumerate(params_np["refinenet"]):
        k = f"scratch.refinenet{i + 1}."
        for unit, name in (("rcu1", "resConfUnit1"), ("rcu2", "resConfUnit2")):
            _conv(sd, k + name + ".conv1", r[unit]["conv1"])
            _conv(sd, k + name + ".conv2", r[unit]["conv2"])
        _conv(sd, k + "out_conv", r["out_conv"])
    for j, name in ((0, "head0"), (2, "head2"), (4, "head4")):
        _conv(sd, f"scratch.output_conv.{j}", params_np[name])
    return sd


def zoed_state_dict(params_np: dict) -> dict[str, torch.Tensor]:
    """The JAX ZoeD_N tree ({"core": {"beit", "decoder"}, "head"}) ->
    `ZoeD_M12_N.pt`'s keys (also each PatchFusion sub-model's)."""
    sd = {"core.core.pretrained.model." + k: v
          for k, v in beit_state_dict(params_np["core"]["beit"]).items()}
    sd.update({"core.core." + k: v for k, v in
               midas_decoder_state_dict(params_np["core"]["decoder"]).items()})
    sd.update(bins_head_state_dict(params_np["head"]))
    return sd


def patchfusion_state_dict(params_np: dict) -> dict[str, torch.Tensor]:
    """The JAX PatchFusion tree -> `patchfusion_u4k.pt`'s keys; the UNet's
    folded batch norms unfolded as `_unfold_bn` does."""
    sd: dict = {}
    for part in ("coarse", "fine"):
        sd.update({f"{part}_model." + k: v
                   for k, v in zoed_state_dict(params_np[part]).items()})
        for i, p in enumerate(params_np[f"{part}_input_proj"]):
            _conv(sd, f"{part}_input_proj.{i}", p)
    for i, p in enumerate(params_np["fusion_conv"]):
        _conv(sd, f"fusion_conv_list.{i}", p)
    u = params_np["unet"]
    fe = "fusion_extractor."

    def dconv_bn(key, p):
        _conv(sd, key + ".0", p["conv1"])
        _unfold_bn(sd, key + ".1", p["bn1"])
        _conv(sd, key + ".3", p["conv2"])
        _unfold_bn(sd, key + ".4", p["bn2"])

    def dconv(key, p):
        _conv(sd, key + ".0", p["conv1"])
        _conv(sd, key + ".2", p["conv2"])

    dconv_bn(fe + "inc.double_conv", u["inc"])
    for i, p in enumerate(u["down"]):
        dconv_bn(fe + f"down{i + 1}.maxpool_conv.1.double_conv", p)
    for i, p in enumerate(u["up"]):
        dconv(fe + f"up{i + 1}.conv.double_conv", p)
    for k, (conv, g2l) in enumerate(zip(u["conv"], u["g2l"])):
        dconv(fe + f"conv{5 - k}.double_conv", conv)
        g = fe + f"g2l{5 - k}."
        _conv(sd, g + "embed_proj", g2l["embed_proj"])
        sd[g + "absolute_pos_embed"] = _t(g2l["absolute_pos_embed"])
        for i, b in enumerate(g2l["blocks"]):
            kb = g + f"g2l_layer.blocks.{i}."
            _norm(sd, kb + "norm1", b["norm1"])
            _linear(sd, kb + "attn.qkv", b["qkv"])
            _linear(sd, kb + "attn.proj", b["proj"])
            sd[kb + "attn.relative_position_bias_table"] = _t(b["rel_pos_table"])
            _norm(sd, kb + "norm2", b["norm2"])
            _linear(sd, kb + "mlp.fc1", b["mlp"]["fc1"])
            _linear(sd, kb + "mlp.fc2", b["mlp"]["fc2"])
        _norm(sd, g + "g2l_layer_norm", g2l["norm"])
    sd.update(bins_head_state_dict(params_np["head"]))
    return sd


def midas_dpt_state_dict(params_np: dict) -> dict[str, torch.Tensor]:
    """The JAX DPT_Large tree ({"vit", "readout", ...}) -> the hub
    checkpoint's `pretrained.model.*` (timm's ViT, no LayerScale) and
    decoder keys."""
    v = params_np["vit"]
    sd: dict = {}
    w = np.asarray(v["patch_embed"]["w"])  # [(kh, kw, c), D]
    patch = int(round((w.shape[0] // 3) ** 0.5))
    sd["patch_embed.proj.weight"] = _t(
        w.reshape(patch, patch, -1, w.shape[1]).transpose(3, 2, 0, 1))
    sd["patch_embed.proj.bias"] = _t(v["patch_embed"]["b"])
    sd["cls_token"] = _t(v["cls_token"])
    sd["pos_embed"] = _t(v["pos_embed"])
    _norm(sd, "norm", v["norm"])
    for i, b in enumerate(v["blocks"]):
        k = f"blocks.{i}."
        _norm(sd, k + "norm1", b["norm1"])
        _linear(sd, k + "attn.qkv", b["attn"]["qkv"])
        _linear(sd, k + "attn.proj", b["attn"]["proj"])
        _norm(sd, k + "norm2", b["norm2"])
        _linear(sd, k + "mlp.fc1", b["mlp"]["fc1"])
        _linear(sd, k + "mlp.fc2", b["mlp"]["fc2"])
    out = {"pretrained.model." + k: t for k, t in sd.items()}
    out.update(midas_decoder_state_dict(params_np))
    return out


def midas2_state_dict(params_np: dict) -> dict[str, torch.Tensor]:
    """The JAX MiDaS v2.1 tree -> the hub MidasNet checkpoint's keys: the
    ResNeXt stem at `pretrained.layer1.{0,1}`, its first stage at
    `pretrained.layer1.4`, the others at `pretrained.layer{2-4}` (batch norms
    unfolded as `_unfold_bn` does); bias-free `scratch.layer{1-4}_rn`,
    `scratch.refinenet{1-4}.resConfUnit{1,2}`, `scratch.output_conv`."""
    sd: dict = {}
    for k, t in resnet_state_dict(params_np["backbone"]).items():
        if k.startswith("conv1."):
            k = "layer1.0." + k[len("conv1."):]
        elif k.startswith("bn1."):
            k = "layer1.1." + k[len("bn1."):]
        elif k.startswith("layer1."):
            k = "layer1.4." + k[len("layer1."):]
        sd["pretrained." + k] = t
    for i in range(4):
        _conv(sd, f"scratch.layer{i + 1}_rn", params_np["scratch"][i])
        r = params_np["refinenet"][i]
        k = f"scratch.refinenet{i + 1}."
        for unit, name in (("rcu1", "resConfUnit1"), ("rcu2", "resConfUnit2")):
            _conv(sd, k + name + ".conv1", r[unit]["conv1"])
            _conv(sd, k + name + ".conv2", r[unit]["conv2"])
    for j, name in ((0, "head0"), (2, "head2"), (4, "head4")):
        _conv(sd, f"scratch.output_conv.{j}", params_np[name])
    return sd


def _res_block(sd: dict, key: str, p: dict) -> None:
    _norm(sd, key + ".norm1", p["norm1"])
    _conv(sd, key + ".conv1", p["conv1"])
    _norm(sd, key + ".norm2", p["norm2"])
    _conv(sd, key + ".conv2", p["conv2"])
    if "time_emb" in p:
        _linear(sd, key + ".time_emb_proj", p["time_emb"])
    if "shortcut" in p:
        _conv(sd, key + ".conv_shortcut", p["shortcut"])


def _attn(sd: dict, key: str, p: dict) -> None:
    for name, proj in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"),
                       ("out", "to_out.0")):
        _linear(sd, f"{key}.{proj}", p[name])


def _spatial(sd: dict, key: str, p: dict) -> None:
    _norm(sd, key + ".norm", p["norm"])
    _linear(sd, key + ".proj_in", p["proj_in"])
    _linear(sd, key + ".proj_out", p["proj_out"])
    for i, b in enumerate(p["blocks"]):
        t = f"{key}.transformer_blocks.{i}"
        for n in ("norm1", "norm2", "norm3"):
            _norm(sd, f"{t}.{n}", b[n])
        _attn(sd, t + ".attn1", b["attn1"])
        _attn(sd, t + ".attn2", b["attn2"])
        _linear(sd, t + ".ff.net.0.proj", b["ff"]["proj"])
        _linear(sd, t + ".ff.net.2", b["ff"]["out"])


def _blocks(sd: dict, prefix: str, blocks: list) -> None:
    for bi, block in enumerate(blocks):
        b = f"{prefix}.{bi}"
        for j, r in enumerate(block["resnets"]):
            _res_block(sd, f"{b}.resnets.{j}", r)
        for j, a in enumerate(block.get("attns", [])):
            _spatial(sd, f"{b}.attentions.{j}", a)
        if "down" in block:
            _conv(sd, f"{b}.downsamplers.0.conv", block["down"])
        if "up" in block:
            _conv(sd, f"{b}.upsamplers.0.conv", block["up"])


def sd2_unet_state_dict(params_np: dict) -> dict[str, torch.Tensor]:
    """The JAX SD2 UNet tree -> the snapshot's `unet/` keys (diffusers)."""
    sd: dict = {}
    _linear(sd, "time_embedding.linear_1", params_np["time1"])
    _linear(sd, "time_embedding.linear_2", params_np["time2"])
    _conv(sd, "conv_in", params_np["conv_in"])
    _blocks(sd, "down_blocks", params_np["down"])
    mid = params_np["mid"]
    _res_block(sd, "mid_block.resnets.0", mid["res1"])
    _spatial(sd, "mid_block.attentions.0", mid["attn"])
    _res_block(sd, "mid_block.resnets.1", mid["res2"])
    _blocks(sd, "up_blocks", params_np["up"])
    _norm(sd, "conv_norm_out", params_np["norm_out"])
    _conv(sd, "conv_out", params_np["conv_out"])
    return sd


def sd_vae_state_dict(params_np: dict) -> dict[str, torch.Tensor]:
    """The JAX VAE tree ({"enc", "dec"}) -> the snapshot's `vae/` keys
    (diffusers, the mid-block attention as `group_norm` and `to_*`)."""
    sd: dict = {}
    for side, name in (("enc", "encoder"), ("dec", "decoder")):
        p = params_np[side]
        _conv(sd, name + ".conv_in", p["conv_in"])
        _blocks(sd, name + (".down_blocks" if side == "enc" else ".up_blocks"),
                p["down" if side == "enc" else "up"])
        _res_block(sd, name + ".mid_block.resnets.0", p["mid"]["res1"])
        _res_block(sd, name + ".mid_block.resnets.1", p["mid"]["res2"])
        a = name + ".mid_block.attentions.0"
        _norm(sd, a + ".group_norm", p["mid"]["attn"]["norm"])
        _attn(sd, a, p["mid"]["attn"])
        _norm(sd, name + ".conv_norm_out", p["norm_out"])
        _conv(sd, name + ".conv_out", p["conv_out"])
    _conv(sd, "quant_conv", params_np["enc"]["quant"])
    _conv(sd, "post_quant_conv", params_np["dec"]["post_quant"])
    return sd


def clip_text_state_dict(params_np: dict) -> dict[str, torch.Tensor]:
    """The JAX CLIP text tree -> the snapshot's `text_encoder/` keys
    (transformers' CLIPTextModel, `text_model.*`)."""
    sd: dict = {"text_model.embeddings.token_embedding.weight":
                _t(params_np["token_embed"]),
                "text_model.embeddings.position_embedding.weight":
                _t(params_np["pos_embed"])}
    for i, b in enumerate(params_np["blocks"]):
        k = f"text_model.encoder.layers.{i}."
        _norm(sd, k + "layer_norm1", b["norm1"])
        for name in ("q", "k", "v"):
            _linear(sd, f"{k}self_attn.{name}_proj", b[name])
        _linear(sd, k + "self_attn.out_proj", b["out"])
        _norm(sd, k + "layer_norm2", b["norm2"])
        _linear(sd, k + "mlp.fc1", b["fc1"])
        _linear(sd, k + "mlp.fc2", b["fc2"])
    _norm(sd, "text_model.final_layer_norm", params_np["final_norm"])
    return sd


def marigold_state_dict(params_np: dict) -> dict[str, torch.Tensor]:
    """The JAX Marigold tree's UNet and VAE -> the port's `unet.*` and
    `vae.*` keys (its empty prompt's embedding is a buffer, set apart)."""
    sd = {"unet." + k: v
          for k, v in sd2_unet_state_dict(params_np["unet"]).items()}
    sd.update({"vae." + k: v
               for k, v in sd_vae_state_dict(params_np["vae"]).items()})
    return sd
