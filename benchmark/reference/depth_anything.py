"""Plain float32 Depth-Anything (relative), over the state_dict of
`depth_anything_vit{s,b,l}14.pth` (LiheYang/Depth-Anything).

Published equations: the Depth-Anything transform (keep-aspect lower-bound
resize to a multiple of 14 with cv2 INTER_CUBIC, ImageNet normalisation),
DINOv2 (patch 14, the position grid resampled by bicubic at scale (n + 0.1)
/ 37, pre-norm blocks with LayerScale, exact GELU, the last four blocks'
patch tokens through the final LayerNorm), the DPT head (no class token,
bilinear align_corners fusion), ReLU, and the video band's bilinear resize
back to the frame with the flipped heat map. One frame at a time, so the
dense [heads, N, N] scores of the attention fit beside nothing else.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.common import Ops, cubic_resize, depth_heat

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def param_specs(cfg: dict) -> list:
    """[(name, shape, init)] of the checkpoint, init ('normal', std) or
    ('const', value): the port's random-weight rule (weights normal times
    fan_in^-0.5, biases zero, norms one, class token times 1e-6, position
    embedding times 0.02, mask token zero), with the LayerScales at
    cfg['init']['layerscale'] (the port's rule: 1)."""
    D, P, g = cfg["embed_dim"], cfg["patch_size"], cfg["pos_grid"]
    hid = cfg["mlp_ratio"] * D
    F_, oc = cfg["features"], cfg["out_channels"]
    ls = cfg.get("init", {}).get("layerscale", 1.0)
    specs = []

    def w(name, shape, fan_in):
        specs.append((name, tuple(shape), ("normal", fan_in ** -0.5)))

    def z(name, shape):
        specs.append((name, tuple(shape), ("const", 0.0)))

    def o(name, shape):
        specs.append((name, tuple(shape), ("const", 1.0)))

    p = "pretrained."
    specs.append((p + "cls_token", (1, 1, D), ("normal", 1e-6)))
    specs.append((p + "pos_embed", (1, g * g + 1, D), ("normal", 0.02)))
    z(p + "mask_token", (1, D))
    w(p + "patch_embed.proj.weight", (D, 3, P, P), 3 * P * P)
    z(p + "patch_embed.proj.bias", (D,))
    for i in range(cfg["depth"]):
        b = f"{p}blocks.{i}."
        o(b + "norm1.weight", (D,))
        z(b + "norm1.bias", (D,))
        w(b + "attn.qkv.weight", (3 * D, D), D)
        z(b + "attn.qkv.bias", (3 * D,))
        w(b + "attn.proj.weight", (D, D), D)
        z(b + "attn.proj.bias", (D,))
        specs.append((b + "ls1.gamma", (D,), ("const", ls)))
        o(b + "norm2.weight", (D,))
        z(b + "norm2.bias", (D,))
        w(b + "mlp.fc1.weight", (hid, D), D)
        z(b + "mlp.fc1.bias", (hid,))
        w(b + "mlp.fc2.weight", (D, hid), hid)
        z(b + "mlp.fc2.bias", (D,))
        specs.append((b + "ls2.gamma", (D,), ("const", ls)))
    o(p + "norm.weight", (D,))
    z(p + "norm.bias", (D,))

    h = "depth_head."
    for i, c in enumerate(oc):
        w(f"{h}projects.{i}.weight", (c, D, 1, 1), D)
        z(f"{h}projects.{i}.bias", (c,))
    # transposed convolutions store [in, out, k, k]; fan_in = in * k * k
    w(h + "resize_layers.0.weight", (oc[0], oc[0], 4, 4), oc[0] * 16)
    z(h + "resize_layers.0.bias", (oc[0],))
    w(h + "resize_layers.1.weight", (oc[1], oc[1], 2, 2), oc[1] * 4)
    z(h + "resize_layers.1.bias", (oc[1],))
    w(h + "resize_layers.3.weight", (oc[3], oc[3], 3, 3), oc[3] * 9)
    z(h + "resize_layers.3.bias", (oc[3],))
    s = h + "scratch."
    for i, c in enumerate(oc):
        w(f"{s}layer{i + 1}_rn.weight", (F_, c, 3, 3), c * 9)
    for i in range(1, 5):
        r = f"{s}refinenet{i}."
        w(r + "out_conv.weight", (F_, F_, 1, 1), F_)
        z(r + "out_conv.bias", (F_,))
        for u in (1, 2):
            for c in (1, 2):
                w(f"{r}resConfUnit{u}.conv{c}.weight", (F_, F_, 3, 3), F_ * 9)
                z(f"{r}resConfUnit{u}.conv{c}.bias", (F_,))
    w(s + "output_conv1.weight", (F_ // 2, F_, 3, 3), F_ * 9)
    z(s + "output_conv1.bias", (F_ // 2,))
    w(s + "output_conv2.0.weight", (32, F_ // 2, 3, 3), F_ // 2 * 9)
    z(s + "output_conv2.0.bias", (32,))
    w(s + "output_conv2.2.weight", (1, 32, 1, 1), 32)
    z(s + "output_conv2.2.bias", (1,))
    return specs


def _multiple(x: float, m: int, min_val: int) -> int:
    y = int(round(x / m) * m)
    return y if y >= min_val else int(-(-x // m) * m)


def input_size(width: int, height: int, target: int, multiple: int):
    """(h, w) of the transform's keep-aspect lower-bound resize."""
    s = max(target / width, target / height)
    return (_multiple(s * height, multiple, target),
            _multiple(s * width, multiple, target))


def prepare(frames_u8: torch.Tensor, cfg: dict) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> normalised float32 [B, 3, h, w]."""
    B, H, W, _ = frames_u8.shape
    hw = input_size(W, H, cfg["target"], cfg["patch_size"])
    img = cubic_resize(frames_u8.permute(0, 3, 1, 2).float() / 255.0, hw)
    mean = torch.tensor(IMAGENET_MEAN, device=img.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=img.device)[:, None, None]
    return (img - mean) / std


def _ln(x, sd, name, eps=1e-6):
    return F.layer_norm(x, x.shape[-1:], sd[name + ".weight"],
                        sd[name + ".bias"], eps)


def vit_features(sd: dict, x: torch.Tensor, cfg: dict, ops: Ops) -> list:
    """DINOv2 on x [B, 3, h, w] -> the last four blocks' patch tokens
    [B, N, D], each through the final LayerNorm."""
    D, P, g, nh = cfg["embed_dim"], cfg["patch_size"], cfg["pos_grid"], \
        cfg["num_heads"]
    p = "pretrained."
    B, _, H, W = x.shape
    ph, pw = H // P, W // P
    t = ops.conv2d(x, sd[p + "patch_embed.proj.weight"],
                   sd[p + "patch_embed.proj.bias"], stride=P)
    t = t.flatten(2).transpose(1, 2)
    t = torch.cat([sd[p + "cls_token"].expand(B, 1, D), t], dim=1)
    pos = sd[p + "pos_embed"]
    grid = pos[:, 1:].reshape(1, g, g, D).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, scale_factor=((ph + 0.1) / g, (pw + 0.1) / g),
                         mode="bicubic")
    t = t + torch.cat([pos[:, :1], grid.flatten(2).transpose(1, 2)], dim=1)

    hd = D // nh
    outs = []
    first = cfg["depth"] - 4
    for i in range(cfg["depth"]):
        b = f"{p}blocks.{i}."
        y = ops.linear(_ln(t, sd, b + "norm1"), sd[b + "attn.qkv.weight"],
                       sd[b + "attn.qkv.bias"])
        q, k, v = y.reshape(B, -1, 3, nh, hd).permute(2, 0, 3, 1, 4)
        a = torch.softmax(ops.matmul(q, k.transpose(-2, -1)) * hd ** -0.5, -1)
        y = ops.matmul(a, v).transpose(1, 2).reshape(B, -1, D)
        y = ops.linear(y, sd[b + "attn.proj.weight"], sd[b + "attn.proj.bias"])
        t = t + sd[b + "ls1.gamma"] * y
        y = ops.linear(_ln(t, sd, b + "norm2"), sd[b + "mlp.fc1.weight"],
                       sd[b + "mlp.fc1.bias"])
        y = ops.linear(F.gelu(y), sd[b + "mlp.fc2.weight"],
                       sd[b + "mlp.fc2.bias"])
        t = t + sd[b + "ls2.gamma"] * y
        if i >= first:
            outs.append(_ln(t, sd, p + "norm")[:, 1:])
    return outs


def _up(x, size):
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=True)


def _rcu(sd, name, x, ops):
    y = ops.conv2d(F.relu(x), sd[name + ".conv1.weight"],
                   sd[name + ".conv1.bias"], padding=1)
    y = ops.conv2d(F.relu(y), sd[name + ".conv2.weight"],
                   sd[name + ".conv2.bias"], padding=1)
    return x + y


def _fusion(sd, name, ops, x, skip=None, size=None):
    if skip is not None:
        x = x + _rcu(sd, name + ".resConfUnit1", skip, ops)
    x = _rcu(sd, name + ".resConfUnit2", x, ops)
    x = _up(x, size if size is not None else (x.shape[-2] * 2,
                                              x.shape[-1] * 2))
    return ops.conv2d(x, sd[name + ".out_conv.weight"],
                      sd[name + ".out_conv.bias"])


def dpt_head(sd: dict, feats: list, ph: int, pw: int, ops: Ops):
    """DPT over the four token maps -> relative depth [B, 1, 14 ph, 14 pw]."""
    h = "depth_head."
    maps = []
    for i, tok in enumerate(feats):
        B, N, D = tok.shape
        x = tok.transpose(1, 2).reshape(B, D, ph, pw)
        x = ops.conv2d(x, sd[f"{h}projects.{i}.weight"],
                       sd[f"{h}projects.{i}.bias"])
        r = f"{h}resize_layers.{i}."
        if i == 0:
            x = ops.conv_transpose2d(x, sd[r + "weight"], sd[r + "bias"], 4)
        elif i == 1:
            x = ops.conv_transpose2d(x, sd[r + "weight"], sd[r + "bias"], 2)
        elif i == 3:
            x = ops.conv2d(x, sd[r + "weight"], sd[r + "bias"], stride=2,
                           padding=1)
        maps.append(x)
    s = h + "scratch."
    l1, l2, l3, l4 = [ops.conv2d(m, sd[f"{s}layer{i + 1}_rn.weight"],
                                 padding=1) for i, m in enumerate(maps)]
    p4 = _fusion(sd, s + "refinenet4", ops, l4, size=l3.shape[-2:])
    p3 = _fusion(sd, s + "refinenet3", ops, p4, l3, size=l2.shape[-2:])
    p2 = _fusion(sd, s + "refinenet2", ops, p3, l2, size=l1.shape[-2:])
    p1 = _fusion(sd, s + "refinenet1", ops, p2, l1)
    out = ops.conv2d(p1, sd[s + "output_conv1.weight"],
                     sd[s + "output_conv1.bias"], padding=1)
    out = _up(out, (ph * 14, pw * 14))
    out = F.relu(ops.conv2d(out, sd[s + "output_conv2.0.weight"],
                            sd[s + "output_conv2.0.bias"], padding=1))
    return F.relu(ops.conv2d(out, sd[s + "output_conv2.2.weight"],
                             sd[s + "output_conv2.2.bias"]))


def depth(sd: dict, frames_u8: torch.Tensor, cfg: dict,
          ops: Ops = Ops()) -> torch.Tensor:
    """uint8 frames [B, H, W, 3] -> relative depth [B, H, W], frame by
    frame."""
    H, W = frames_u8.shape[1:3]
    P = cfg["patch_size"]
    out = []
    for b in range(frames_u8.shape[0]):
        x = prepare(frames_u8[b:b + 1], cfg)
        h, w = x.shape[-2:]
        d = dpt_head(sd, vit_features(sd, x, cfg, ops), h // P, w // P, ops)
        d = F.relu(_up(d, (h, w)))
        out.append(F.interpolate(d, size=(H, W), mode="bilinear",
                                 align_corners=False)[:, 0])
    return torch.cat(out)


def band_outputs(sd: dict, frames_u8: torch.Tensor, cfg: dict,
                 ops: Ops = Ops()) -> dict:
    """What the video band's step returns without --npy: 'heat', 'min',
    'max'."""
    heat, dmin, dmax = depth_heat(depth(sd, frames_u8, cfg, ops), cfg["flip"])
    return {"heat": heat, "min": dmin, "max": dmax}
