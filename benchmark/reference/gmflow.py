"""Plain float32 GMFlow (haofeixu/gmflow, one scale), over the state_dict
under 'model' of `gmflow_sintel-0c07dcb3.pth`.

Published equations: ImageNet normalisation of [0, 255] images, the 1/8 CNN
encoder (instance norms without affine parameters, residual stages), the
sine position embedding added inside each attention split, the 6-layer
single-head self + cross transformer over split windows (odd layers shifted
by half a window, with the -100 region mask), global correlation softmax
matching (the backward direction from the transposed correlation), global
flow propagation (the key projection applied on the projected query), and
RAFT's convex x8 upsampler. Around it the flow band: the frames cubic-resized
to the flow scale, padded centred to a multiple of 16 by edge replication,
the flow unpadded, HSV-encoded, and with `mask` the forward-backward
consistency masks. One pair at a time, so the [HW, HW] correlation of one
pair fits.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.common import (Ops, cubic_resize, flow_to_rgb,
                                        fwdbwd_masks)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
STAGES = ((64, 64, 1), (64, 64, 1), (64, 96, 2), (96, 96, 1), (96, 128, 2),
          (128, 128, 1))  # (in, out, stride) of layer1.0 ... layer3.1


def _block_name(i: int) -> str:
    return f"backbone.layer{i // 2 + 1}.{i % 2}."


def param_specs(cfg: dict) -> list:
    """[(name, shape, init)] of the checkpoint's 'model', with the port's
    random-weight rule: weights normal times fan_in^-0.5, biases zero, layer
    norms zero-shifted, their gains at cfg['init']['ln_gain'] (the port's
    rule: 1)."""
    C, e = cfg["feature_channels"], cfg["ffn_dim_expansion"]
    gain = cfg.get("init", {}).get("ln_gain", 1.0)
    specs = []

    def w(name, shape):
        fan_in = math.prod(shape[1:])
        specs.append((name, tuple(shape), ("normal", fan_in ** -0.5)))

    def z(name, shape):
        specs.append((name, tuple(shape), ("const", 0.0)))

    def ln(name):
        specs.append((name + ".weight", (C,), ("const", gain)))
        z(name + ".bias", (C,))

    w("backbone.conv1.weight", (64, 3, 7, 7))
    for i, (cin, cout, s) in enumerate(STAGES):
        b = _block_name(i)
        w(b + "conv1.weight", (cout, cin, 3, 3))
        w(b + "conv2.weight", (cout, cout, 3, 3))
        if s != 1 or cin != cout:
            w(b + "downsample.0.weight", (cout, cin, 1, 1))
            z(b + "downsample.0.bias", (cout,))
    w("backbone.conv2.weight", (C, 128, 1, 1))
    z("backbone.conv2.bias", (C,))
    for i in range(cfg["num_transformer_layers"]):
        for part in ("self_attn", "cross_attn_ffn"):
            p = f"transformer.layers.{i}.{part}."
            for proj in ("q_proj", "k_proj", "v_proj", "merge"):
                w(p + proj + ".weight", (C, C))
            ln(p + "norm1")
            if part == "cross_attn_ffn":
                w(p + "mlp.0.weight", (2 * C * e, 2 * C))
                w(p + "mlp.2.weight", (C, 2 * C * e))
                ln(p + "norm2")
    for proj in ("q_proj", "k_proj"):
        w(f"feature_flow_attn.{proj}.weight", (C, C))
        z(f"feature_flow_attn.{proj}.bias", (C,))
    u = cfg["upsample_factor"]
    w("upsampler.0.weight", (256, 2 + C, 3, 3))
    z("upsampler.0.bias", (256,))
    w("upsampler.2.weight", (u * u * 9, 256, 1, 1))
    z("upsampler.2.bias", (u * u * 9,))
    return specs


def _inorm_relu(x, relu=True):
    y = F.instance_norm(x, eps=1e-5)
    return F.relu(y) if relu else y


def backbone(sd: dict, x: torch.Tensor, ops: Ops) -> torch.Tensor:
    """[B, 3, H, W] normalised -> [B, C, H/8, W/8]."""
    x = _inorm_relu(ops.conv2d(x, sd["backbone.conv1.weight"], stride=2,
                               padding=3))
    for i, (cin, cout, s) in enumerate(STAGES):
        b = _block_name(i)
        y = _inorm_relu(ops.conv2d(x, sd[b + "conv1.weight"], stride=s,
                                   padding=1))
        y = _inorm_relu(ops.conv2d(y, sd[b + "conv2.weight"], padding=1))
        if s != 1 or cin != cout:
            x = _inorm_relu(ops.conv2d(x, sd[b + "downsample.0.weight"],
                                       sd[b + "downsample.0.bias"], stride=s),
                            relu=False)
        x = F.relu(x + y)
    return ops.conv2d(x, sd["backbone.conv2.weight"],
                      sd["backbone.conv2.bias"])


def split(x: torch.Tensor, ns: int) -> torch.Tensor:
    """[B, H, W, C] -> [B ns ns, H/ns, W/ns, C], windows row-major."""
    B, H, W, C = x.shape
    x = x.reshape(B, ns, H // ns, ns, W // ns, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B * ns * ns, H // ns, W // ns, C)


def merge(x: torch.Tensor, ns: int) -> torch.Tensor:
    Bk, h, w, C = x.shape
    x = x.reshape(Bk // (ns * ns), ns, ns, h, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(Bk // (ns * ns), ns * h, ns * w, C)


def sine_position(h: int, w: int, C: int, device) -> torch.Tensor:
    """DETR's normalised sine embedding of an h x w window -> [h, w, C]
    (C/2 y-channels, then C/2 x-channels)."""
    n = C // 2
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None] \
        .expand(h, w)
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :] \
        .expand(h, w)
    y = y / (h + 1e-6) * 2 * math.pi
    x = x / (w + 1e-6) * 2 * math.pi
    dim_t = torch.arange(n, dtype=torch.float32, device=device)
    dim_t = 10000.0 ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / n)

    def emb(v):
        p = v[..., None] / dim_t
        return torch.stack([p[..., 0::2].sin(), p[..., 1::2].cos()],
                           dim=3).flatten(2)

    return torch.cat([emb(y), emb(x)], dim=-1)


def shift_mask(h: int, w: int, ns: int, device) -> torch.Tensor:
    """[ns ns, win, win] additive mask of the shifted windows: -100 between
    tokens of different pre-shift regions."""
    wh, ww = h // ns, w // ns
    img = torch.zeros(1, h, w, 1, device=device)
    cnt = 0
    for hs in (slice(0, -wh), slice(-wh, -(wh // 2)), slice(-(wh // 2), None)):
        for ws in (slice(0, -ww), slice(-ww, -(ww // 2)),
                   slice(-(ww // 2), None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    win = split(img, ns).reshape(ns * ns, wh * ww)
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


def _layer(sd, p, source, target, h, w, ns, shifted, ops, mask):
    """One TransformerLayer: [B, h w, C] source attends to target."""
    B, L, C = source.shape
    q = ops.linear(source, sd[p + "q_proj.weight"])
    k = ops.linear(target, sd[p + "k_proj.weight"])
    v = ops.linear(target, sd[p + "v_proj.weight"])
    if ns > 1:
        t = [x.reshape(B, h, w, C) for x in (q, k, v)]
        if shifted:
            t = [torch.roll(x, (-(h // ns // 2), -(w // ns // 2)), (1, 2))
                 for x in t]
        q, k, v = [split(x, ns).reshape(B * ns * ns, -1, C) for x in t]
    s = ops.matmul(q, k.transpose(1, 2)) / C ** 0.5
    if shifted:
        s = s + mask.repeat(B, 1, 1)
    out = ops.matmul(torch.softmax(s, dim=-1), v)
    if ns > 1:
        out = merge(out.reshape(B * ns * ns, h // ns, w // ns, C), ns)
        if shifted:
            out = torch.roll(out, (h // ns // 2, w // ns // 2), (1, 2))
        out = out.reshape(B, L, C)
    msg = F.layer_norm(ops.linear(out, sd[p + "merge.weight"]), (C,),
                       sd[p + "norm1.weight"], sd[p + "norm1.bias"])
    if p + "mlp.0.weight" in sd:
        msg = ops.linear(torch.cat([source, msg], dim=-1),
                         sd[p + "mlp.0.weight"])
        msg = ops.linear(F.gelu(msg), sd[p + "mlp.2.weight"])
        msg = F.layer_norm(msg, (C,), sd[p + "norm2.weight"],
                           sd[p + "norm2.bias"])
    return source + msg


def transformer(sd, f0, f1, cfg, ops):
    """[B, h, w, C] x2 -> the transformed pair."""
    B, h, w, C = f0.shape
    ns = cfg["attn_splits"]
    if ns > 1:
        pos = sine_position(h // ns, w // ns, C, f0.device)
        f0 = merge(split(f0, ns) + pos, ns)
        f1 = merge(split(f1, ns) + pos, ns)
    else:
        pos = sine_position(h, w, C, f0.device)
        f0, f1 = f0 + pos, f1 + pos
    mask = shift_mask(h, w, ns, f0.device) if ns > 1 else None
    c0 = torch.cat([f0, f1]).reshape(2 * B, h * w, C)
    c1 = torch.cat([f1, f0]).reshape(2 * B, h * w, C)
    for i in range(cfg["num_transformer_layers"]):
        shifted = ns > 1 and i % 2 == 1
        p = f"transformer.layers.{i}."
        c0 = _layer(sd, p + "self_attn.", c0, c0, h, w, ns, shifted, ops, mask)
        c0 = _layer(sd, p + "cross_attn_ffn.", c0, c1, h, w, ns, shifted, ops,
                    mask)
        c1 = torch.cat(c0.chunk(2)[::-1])
    f0, f1 = c0.chunk(2)
    return f0.reshape(B, h, w, C), f1.reshape(B, h, w, C)


def _grid(h, w, device):
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([gx, gy], -1).reshape(h * w, 2)


def global_matching(f0, f1, ops):
    """-> flow [2B, h, w, 2]: forward rows, then backward from the
    transposed correlation."""
    B, h, w, C = f0.shape
    corr = ops.matmul(f0.reshape(B, h * w, C),
                      f1.reshape(B, h * w, C).transpose(1, 2)) / C ** 0.5
    grid = _grid(h, w, f0.device)
    flows = []
    for c in (corr, corr.transpose(1, 2)):
        corresp = ops.matmul(torch.softmax(c, dim=-1), grid)
        flows.append(corresp.reshape(B, h, w, 2) - grid.reshape(h, w, 2))
    return torch.cat(flows)


def propagation(sd, feature, flow, ops):
    """Global self-attention with the flow as the value."""
    B, h, w, C = feature.shape
    q = ops.linear(feature.reshape(B, h * w, C),
                   sd["feature_flow_attn.q_proj.weight"],
                   sd["feature_flow_attn.q_proj.bias"])
    k = ops.linear(q, sd["feature_flow_attn.k_proj.weight"],
                   sd["feature_flow_attn.k_proj.bias"])
    prob = torch.softmax(ops.matmul(q, k.transpose(1, 2)) / C ** 0.5, dim=-1)
    return ops.matmul(prob, flow.reshape(B, h * w, 2)).reshape(B, h, w, 2)


def upsample(sd, flow, feature, u, ops):
    """Convex upsampling: flow [B, h, w, 2] -> [B, u h, u w, 2]."""
    B, h, w, _ = flow.shape
    x = torch.cat([flow, feature], -1).permute(0, 3, 1, 2)
    x = F.relu(ops.conv2d(x, sd["upsampler.0.weight"], sd["upsampler.0.bias"],
                          padding=1))
    mask = ops.conv2d(x, sd["upsampler.2.weight"], sd["upsampler.2.bias"])
    mask = torch.softmax(mask.reshape(B, 1, 9, u, u, h, w), dim=2)
    up = F.unfold(u * flow.permute(0, 3, 1, 2), [3, 3], padding=1)
    up = (mask * up.reshape(B, 2, 9, 1, 1, h, w)).sum(dim=2)
    up = up.permute(0, 1, 4, 2, 5, 3).reshape(B, 2, u * h, u * w)
    return up.permute(0, 2, 3, 1)


def forward(sd, img0, img1, cfg, ops):
    """img0/1 [B, 3, H, W] in [0, 255], H and W multiples of 8 ns -> flow
    [2B, H, W, 2], forward rows first."""
    mean = torch.tensor(IMAGENET_MEAN, device=img0.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=img0.device)[:, None, None]
    x = (torch.cat([img0, img1]) / 255.0 - mean) / std
    feats = backbone(sd, x, ops).permute(0, 2, 3, 1)
    f0, f1 = feats.chunk(2)
    f0, f1 = transformer(sd, f0, f1, cfg, ops)
    flow = global_matching(f0, f1, ops)
    feature = torch.cat([f0, f1])
    flow = propagation(sd, feature, flow, ops)
    return upsample(sd, flow, feature, cfg["upsample_factor"], ops)


def pad_sintel(x: torch.Tensor, m: int):
    """Centred edge-replicating pad of [B, C, H, W] to multiples of m."""
    H, W = x.shape[-2:]
    ph, pw = (-H) % m, (-W) % m
    pads = (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2)
    return F.pad(x, pads, mode="replicate"), pads


def pair_flows(sd, frames_u8, cfg, ops: Ops = Ops()):
    """uint8 frames [T+1, H, W, 3] -> (fwd, bwd) [T, h, w, 2] at the flow
    scale, pair by pair."""
    H, W = frames_u8.shape[1:3]
    hw = (int(round(H * cfg["scale"])), int(round(W * cfg["scale"])))
    fwd, bwd = [], []
    for t in range(frames_u8.shape[0] - 1):
        img = cubic_resize(frames_u8[t:t + 2].permute(0, 3, 1, 2).float(), hw)
        img, (l, r, tp, bt) = pad_sintel(img, cfg["padding_factor"])
        flow = forward(sd, img[:1], img[1:], cfg, ops)
        flow = flow[:, tp:flow.shape[1] - bt, l:flow.shape[2] - r]
        fwd.append(flow[:1])
        bwd.append(flow[1:])
    return torch.cat(fwd), torch.cat(bwd)


def band_outputs(sd, frames_u8, cfg, backwards: bool, mask: bool,
                 ops: Ops = Ops()) -> dict:
    """What the flow band's step returns: 'fwd_rgb', 'max_disp'; with
    backwards or mask also 'fwd', 'bwd', 'bwd_rgb'; with mask 'fwd_mask',
    'bwd_mask'."""
    fwd, bwd = pair_flows(sd, frames_u8, cfg, ops)
    rgb, md = flow_to_rgb(fwd)
    out = {"fwd_rgb": rgb, "max_disp": md}
    if backwards or mask:
        out.update(fwd=fwd, bwd=bwd, bwd_rgb=flow_to_rgb(bwd)[0])
    if mask:
        out["fwd_mask"], out["bwd_mask"] = fwdbwd_masks(fwd, bwd)
    return out
