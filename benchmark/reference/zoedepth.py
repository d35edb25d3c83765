"""Plain float32 metric Depth-Anything: the ZoeDepth bins head over the
Depth-Anything core, over the state_dict of
`depth_anything_metric_depth_{indoor,outdoor}.pt` (LiheYang/Depth-Anything,
its `metric_depth` code; ZoeDepth, arXiv:2302.12288).

Published equations: the core's input (the frame over 255, resized
bilinearly with corners aligned to the core size, 392x518 by default, then
ImageNet-normalised), DINOv2 and the DPT head as in
benchmark/reference/depth_anything.py (the keys under `core.core.`), with the
features the metric head reads (the DPT's 32-channel activation after the
first output convolution, its fourth level's 3x3 projection and the four
refinenet outputs); the bins head: a 1x1 bottleneck convolution, the
softplus seed bin regressor (64 bins) and seed projector, four projectors
and inverse attractors (16, 8, 4, 1 attractors, mean over them, alpha 300
and gamma 2: the defaults the published forward calls them with), the
conditional log-binomial over the activation and the relative depth
(softplus probability and temperature, temperature in [0.0212, 50]), and
the expected depth over the bin centres, all resizes bilinear with corners
aligned; then PIL's antialiased bicubic back to the frame, as the published
band resizes the depth with PIL.

Departures: none of the equations; the port normalises before its resize
where the published transform resizes first (the two commute up to
rounding), and its log-binomial clamps n - k to 1e-7 where the published
code adds 1e-7 inside the logarithm (a difference of 2e-6 in a logit).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import depth_anything as da
from benchmark.reference.common import Ops

CORE = "core.core."
N_BINS, EMBED, ATTRACTORS, MIDAS_OUT = 64, 128, (16, 8, 4, 1), 32
MIN_TEMP, MAX_TEMP = 0.0212, 50.0
ALPHA, GAMMA = 300.0, 2


def param_specs(cfg: dict) -> list:
    """[(name, shape, init)]: the core's (benchmark/reference/
    depth_anything.param_specs under `core.core.`) and the bins head's,
    convolutions normal times fan_in^-0.5 with zero biases (the port's
    random-weight rule)."""
    specs = [(CORE + n, s, i) for n, s, i in da.param_specs(cfg)]
    c = cfg["features"]

    def conv(name, cout, cin):
        specs.append((name + ".weight", (cout, cin, 1, 1),
                      ("normal", cin ** -0.5)))
        specs.append((name + ".bias", (cout,), ("const", 0.0)))

    def mlp(name, cin, mid, cout):
        conv(name + ".0", mid, cin)
        conv(name + ".2", cout, mid)

    conv("conv2", c, c)
    mlp("seed_bin_regressor._net", c, 256, N_BINS)
    mlp("seed_projector._net", c, 128, EMBED)
    for i in range(4):
        mlp(f"projectors.{i}._net", c, 128, EMBED)
    for i, n in enumerate(ATTRACTORS):
        mlp(f"attractors.{i}._net", EMBED, 128, n)
    cin = MIDAS_OUT + 1 + EMBED
    mlp("conditional_log_binomial.mlp", cin, cin // 2, 4)
    return specs


def prepare(frames_u8: torch.Tensor, size) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> the core's input [B, 3, *size]."""
    img = F.interpolate(frames_u8.permute(0, 3, 1, 2).float() / 255.0,
                        size=tuple(size), mode="bilinear", align_corners=True)
    mean = torch.tensor(da.IMAGENET_MEAN, device=img.device)[:, None, None]
    std = torch.tensor(da.IMAGENET_STD, device=img.device)[:, None, None]
    return (img - mean) / std


def dpt_features(sd: dict, feats: list, ph: int, pw: int, ops: Ops):
    """The DPT head over the four token maps -> (relative depth [B, 14 ph,
    14 pw], {out_conv, l4_rn, r4, r3, r2, r1})."""
    h = "depth_head."
    maps = []
    for i, tok in enumerate(feats):
        B, N, D = tok.shape
        x = tok.transpose(1, 2).reshape(B, D, ph, pw)
        x = ops.conv2d(x, sd[f"{h}projects.{i}.weight"],
                       sd[f"{h}projects.{i}.bias"])
        r = f"{h}resize_layers.{i}."
        if i in (0, 1):
            x = ops.conv_transpose2d(x, sd[r + "weight"], sd[r + "bias"],
                                     4 if i == 0 else 2)
        elif i == 3:
            x = ops.conv2d(x, sd[r + "weight"], sd[r + "bias"], stride=2,
                           padding=1)
        maps.append(x)
    s = h + "scratch."
    l1, l2, l3, l4 = [ops.conv2d(m, sd[f"{s}layer{i + 1}_rn.weight"],
                                 padding=1) for i, m in enumerate(maps)]
    r4 = da._fusion(sd, s + "refinenet4", ops, l4, size=l3.shape[-2:])
    r3 = da._fusion(sd, s + "refinenet3", ops, r4, l3, size=l2.shape[-2:])
    r2 = da._fusion(sd, s + "refinenet2", ops, r3, l2, size=l1.shape[-2:])
    r1 = da._fusion(sd, s + "refinenet1", ops, r2, l1)
    out = ops.conv2d(r1, sd[s + "output_conv1.weight"],
                     sd[s + "output_conv1.bias"], padding=1)
    out = da._up(out, (ph * 14, pw * 14))
    act = F.relu(ops.conv2d(out, sd[s + "output_conv2.0.weight"],
                            sd[s + "output_conv2.0.bias"], padding=1))
    rel = F.relu(ops.conv2d(act, sd[s + "output_conv2.2.weight"],
                            sd[s + "output_conv2.2.bias"]))
    return rel, {"out_conv": act, "l4_rn": l4, "r4": r4, "r3": r3, "r2": r2,
                 "r1": r1}


def _mlp(sd, name, x, ops, act=None):
    y = ops.conv2d(x, sd[name + ".0.weight"], sd[name + ".0.bias"])
    y = ops.conv2d(F.relu(y), sd[name + ".2.weight"], sd[name + ".2.bias"])
    return act(y) if act is not None else y


def _up(x, size):
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=True)


def _log_binom(n, k, eps=1e-7):
    n, k = n + eps, k + eps
    return n * torch.log(n) - k * torch.log(k) \
        - (n - k) * torch.log(n - k + eps)


def bins_head(sd: dict, rel: torch.Tensor, feats: dict,
              ops: Ops) -> torch.Tensor:
    """The metric head -> depth [B, 1, h, w] at the activation's size."""
    x = ops.conv2d(feats["l4_rn"], sd["conv2.weight"], sd["conv2.bias"])
    b_prev = _mlp(sd, "seed_bin_regressor._net", x, ops, F.softplus)
    prev_emb = _mlp(sd, "seed_projector._net", x, ops)
    for i, key in enumerate(("r4", "r3", "r2", "r1")):
        emb = _mlp(sd, f"projectors.{i}._net", feats[key], ops)
        hw = emb.shape[-2:]
        a = _mlp(sd, f"attractors.{i}._net", emb + _up(prev_emb, hw), ops,
                 F.softplus)
        b_prev = _up(b_prev, hw)
        dx = a[:, :, None] - b_prev[:, None]
        b_prev = b_prev + (dx / (1 + ALPHA * dx ** GAMMA)).mean(dim=1)
        prev_emb = emb
    last = feats["out_conv"]
    cond = _up(rel, last.shape[-2:])
    emb = _up(prev_emb, last.shape[-2:])
    pt = ops.conv2d(torch.cat([last, cond, emb], dim=1),
                    sd["conditional_log_binomial.mlp.0.weight"],
                    sd["conditional_log_binomial.mlp.0.bias"])
    pt = F.softplus(ops.conv2d(F.gelu(pt),
                               sd["conditional_log_binomial.mlp.2.weight"],
                               sd["conditional_log_binomial.mlp.2.bias"]))
    p, t = pt[:, :2] + 1e-4, pt[:, 2:] + 1e-4
    p = p[:, :1] / (p[:, :1] + p[:, 1:])
    t = t[:, :1] / (t[:, :1] + t[:, 1:])
    t = (MAX_TEMP - MIN_TEMP) * t + MIN_TEMP
    k = torch.arange(N_BINS, dtype=p.dtype, device=p.device)[None, :, None,
                                                            None]
    K1 = torch.tensor(N_BINS - 1.0, device=p.device)
    y = _log_binom(K1, k) + k * torch.log(p.clamp(1e-4, 1.0)) \
        + (N_BINS - 1 - k) * torch.log((1 - p).clamp(1e-4, 1.0))
    probs = torch.softmax(y / t, dim=1)
    centers = _up(b_prev, probs.shape[-2:])
    return (probs * centers).sum(dim=1, keepdim=True)


def metric_depth(sd: dict, frames_u8: torch.Tensor, cfg: dict,
                 ops: Ops = Ops(), batch: int = 8) -> torch.Tensor:
    """uint8 frames [B, H, W, 3] -> metric depth [B, H, W]; sd holds the
    checkpoint's keys."""
    core = {k[len(CORE):]: v for k, v in sd.items() if k.startswith(CORE)}
    H, W = frames_u8.shape[1:3]
    P = cfg["patch_size"]
    h, w = cfg["img_size"]
    out = []
    for i in range(0, frames_u8.shape[0], batch):
        x = prepare(frames_u8[i:i + batch], (h, w))
        rel, feats = dpt_features(core, da.vit_features(core, x, cfg, ops),
                                  h // P, w // P, ops)
        d = bins_head(sd, _up(rel, (h, w)), feats, ops)
        out.append(F.interpolate(d, size=(H, W), mode="bicubic",
                                 antialias=True, align_corners=False)[:, 0])
    return torch.cat(out)
