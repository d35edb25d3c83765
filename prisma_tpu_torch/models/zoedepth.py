"""ZoeDepth metric-depth head over the Depth-Anything core (counterpart of
prisma_tpu/models/zoedepth.py).

Reference: the vendored ZoeDepth (`zoedepth_v1.py`, layers in
`localbins_layers.py`, `attractor.py`, `dist_layers.py`): bottleneck conv ->
seed bin regressor -> four attractor layers refining the bin centres over
the decoder's refinenet outputs -> conditional log-binomial probabilities
over the bins -> expected depth sum(p * c).

Module names are the metric checkpoint's
(`depth_anything_metric_depth_{indoor,outdoor}.pt`): the core under
`core.core.pretrained` / `core.core.depth_head`, the head at the top level as
`conv2`, `seed_bin_regressor._net`, `seed_projector._net`,
`projectors.{i}._net`, `attractors.{i}._net` and
`conditional_log_binomial.mlp` (Sequentials whose convs sit at 0 and 2).
NCHW throughout: the bins are the channel axis.

The numerics are the JAX package's, not the reference's where they part:
`_attract` always uses alpha 300 and gamma 2, the normed attractor keeps
A[..., 0], and `_log_binom` clamps n - k to eps. The head always runs in
f32: a bf16 model casts only its core (`cast_core`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from prisma_tpu_torch.models import depth_anything as da
from prisma_tpu_torch.models import dpt, vit
from prisma_tpu_torch.ops import nn as pnn
from prisma_tpu_torch.ops.resize import resize2d_nchw


@dataclass(frozen=True)
class ZoeDepthConfig:
    """Defaults = the vendored config_zoedepth.json (softplus/inv/mean)."""
    n_bins: int = 64
    bin_embedding_dim: int = 128
    bin_centers_type: str = "softplus"   # or "normed"
    n_attractors: tuple = (16, 8, 4, 1)
    attractor_alpha: float = 1000.0
    attractor_gamma: int = 2
    attractor_kind: str = "mean"         # "mean" | "sum"
    attractor_type: str = "inv"          # "inv" | "exp"
    min_depth: float = 1e-3
    max_depth: float = 10.0
    min_temp: float = 0.0212
    max_temp: float = 50.0
    midas_out_channels: int = 32         # N_MIDAS_OUT


def _mlp(cin: int, mid: int, cout: int) -> nn.Sequential:
    """Conv1x1 -> act -> Conv1x1: the layers' shared Sequential; its
    activations are applied by the functions below (they differ per layer)."""
    return nn.Sequential(nn.Conv2d(cin, mid, 1), nn.ReLU(), nn.Conv2d(mid, cout, 1))


class _Net(nn.Module):
    """A layer whose only parameters are its `_net` Sequential."""

    def __init__(self, cin: int, mid: int, cout: int):
        super().__init__()
        self._net = _mlp(cin, mid, cout)


class ConditionalLogBinomial(nn.Module):
    def __init__(self, cin: int, cout: int = 4):
        super().__init__()
        self.mlp = _mlp(cin, cin // 2, cout)


class _Core(nn.Module):
    """`core.core`: the reference's DepthAnythingCore wraps the relative
    model one level down."""

    def __init__(self, model: da.DepthAnything):
        super().__init__()
        self.core = model


class MetricDepthAnything(nn.Module):
    def __init__(self, vit_cfg: vit.ViTConfig, features: int = 256,
                 out_channels=dpt.DPT_OUT_CHANNELS,
                 cfg: ZoeDepthConfig = ZoeDepthConfig()):
        super().__init__()
        self.cfg = cfg
        self.core = _Core(da.DepthAnything(vit_cfg, features, out_channels))
        e, c = cfg.bin_embedding_dim, features
        per_attr = 2 if cfg.bin_centers_type == "normed" else 1
        self.conv2 = nn.Conv2d(c, c, 1)
        self.seed_bin_regressor = _Net(c, 256, cfg.n_bins)
        self.seed_projector = _Net(c, 128, e)
        self.projectors = nn.ModuleList(_Net(c, 128, e) for _ in range(4))
        self.attractors = nn.ModuleList(_Net(e, 128, n * per_attr)
                                        for n in cfg.n_attractors)
        self.conditional_log_binomial = ConditionalLogBinomial(
            cfg.midas_out_channels + 1 + e)

    def cast_core(self, dtype: torch.dtype) -> "MetricDepthAnything":
        """The core in dtype; the bins head stays f32."""
        self.core.to(dtype=dtype)
        return self


def _mlp2(seq: nn.Sequential, x: torch.Tensor, act=None) -> torch.Tensor:
    y = pnn.conv2d(seq[2], F.relu(pnn.conv2d(seq[0], x)))
    return act(y) if act is not None else y


def seed_bin_regressor(p: _Net, x: torch.Tensor, cfg: ZoeDepthConfig):
    """-> (b_prev for the attractor chain, seed bin centres)."""
    if cfg.bin_centers_type == "softplus":
        centers = _mlp2(p._net, x, F.softplus)
        return centers, centers
    # normed: relu + eps -> widths normalised -> cumulative edges -> centres
    b = F.relu(_mlp2(p._net, x)) + 1e-3
    widths = (cfg.max_depth - cfg.min_depth) * (b / b.sum(dim=1, keepdim=True))
    edges = torch.cumsum(F.pad(widths, (0, 0, 0, 0, 1, 0), value=cfg.min_depth),
                         dim=1)
    centers = 0.5 * (edges[:, :-1] + edges[:, 1:])
    b_prev = (centers - cfg.min_depth) / (cfg.max_depth - cfg.min_depth)
    return b_prev, centers


def _attract(dx: torch.Tensor, cfg: ZoeDepthConfig) -> torch.Tensor:
    # the reference's forward calls exp_/inv_attractor without the configured
    # alpha/gamma, so their defaults (300, 2) always apply
    alpha = 300.0
    if cfg.attractor_type == "exp":
        return torch.exp(-alpha * dx.abs() ** 2) * dx
    return dx / (1 + alpha * dx ** 2)


def attractor_layer(p: _Net, x, b_prev, prev_b_embedding, cfg: ZoeDepthConfig):
    """One attractor refinement over [B, C, H, W] features; bins on dim 1.

    Returns (b_new for the next layer, metric bin centres at this scale)."""
    hw = x.shape[-2:]
    if prev_b_embedding is not None:
        x = x + resize2d_nchw(prev_b_embedding, hw, method="linear",
                              align_corners=True)
    b_prev = resize2d_nchw(b_prev, hw, method="linear", align_corners=True)

    if cfg.bin_centers_type == "softplus":
        a = _mlp2(p._net, x, F.softplus)                 # [B, n_attr, H, W]
        delta = _attract(a[:, None] - b_prev[:, :, None], cfg).sum(dim=2)
        if cfg.attractor_kind == "mean":
            delta = delta / a.shape[1]
        b_new = b_prev + delta
        return b_new, b_new
    # normed: 2x channels, only the first of each pair is used
    a = F.relu(_mlp2(p._net, x)) + 1e-3
    n_attr = a.shape[1] // 2
    a = a.view(a.shape[0], n_attr, 2, *hw)[:, :, 0]
    delta = _attract(a[:, None] - b_prev[:, :, None], cfg).sum(dim=2)
    if cfg.attractor_kind == "mean":
        delta = delta / n_attr
    b_new = b_prev + delta
    centers = (cfg.max_depth - cfg.min_depth) * b_new + cfg.min_depth
    centers = torch.sort(centers, dim=1).values.clamp(cfg.min_depth,
                                                      cfg.max_depth)
    return b_new, centers


def _log_binom(n: torch.Tensor, k: torch.Tensor, eps: float = 1e-7):
    # n - k clamped to eps (the JAX package's guard against 0 * log 0): at
    # n == k the term is eps * log(eps), not the reference's exact 0
    n = n + eps
    k = k + eps
    nk = torch.clamp(n - k, min=eps)
    return n * torch.log(n) - k * torch.log(k) - nk * torch.log(nk)


def conditional_log_binomial(p: ConditionalLogBinomial, x, cond,
                             cfg: ZoeDepthConfig) -> torch.Tensor:
    """[B, Cx, H, W] main + [B, Cc, H, W] condition -> probs [B, bins, H, W]."""
    pt = pnn.conv2d(p.mlp[0], torch.cat([x, cond], dim=1))
    pt = F.softplus(pnn.conv2d(p.mlp[2], pnn.gelu(pt)))
    prob = pt[:, :2] + 1e-4
    temp = pt[:, 2:] + 1e-4
    prob = prob[:, 0] / (prob[:, 0] + prob[:, 1])
    temp = temp[:, 0] / (temp[:, 0] + temp[:, 1])
    temp = (cfg.max_temp - cfg.min_temp) * temp + cfg.min_temp

    K = cfg.n_bins
    k_idx = torch.arange(K, dtype=x.dtype, device=x.device)[:, None, None]
    prob = prob.clamp(1e-4, 1.0)[:, None]
    one_minus = (1 - prob).clamp(1e-4, 1.0)
    y = (_log_binom(torch.tensor(K - 1.0, dtype=x.dtype, device=x.device), k_idx)
         + k_idx * torch.log(prob) + (K - 1 - k_idx) * torch.log(one_minus))
    return torch.softmax(y / temp[:, None], dim=1)


def bins_head(model: MetricDepthAnything, rel_depth: torch.Tensor,
              core_feats: dict) -> torch.Tensor:
    """The metric head over the core's features, in f32.

    rel_depth [B, h, w]; core_feats: out_conv [B, 32, h, w], l4_rn, r4..r1
    (NCHW), as dpt_head(return_features=True) gives them. Returns metric
    depth [B, h, w] at the out_conv resolution."""
    cfg = model.cfg
    feats = {k: v.float() for k, v in core_feats.items()}
    btlnck = pnn.conv2d(model.conv2, feats["l4_rn"])
    b_prev, _seed_centers = seed_bin_regressor(model.seed_bin_regressor,
                                               btlnck, cfg)
    prev_b_embedding = _mlp2(model.seed_projector._net, btlnck)

    b_centers = None
    b_embedding = prev_b_embedding
    for proj, attr, name in zip(model.projectors, model.attractors,
                                ("r4", "r3", "r2", "r1")):
        b_embedding = _mlp2(proj._net, feats[name])
        b_prev, b_centers = attractor_layer(attr, b_embedding, b_prev,
                                            prev_b_embedding, cfg)
        prev_b_embedding = b_embedding

    last = feats["out_conv"]
    hw = last.shape[-2:]
    rel_cond = resize2d_nchw(rel_depth.float()[:, None], hw, method="linear",
                             align_corners=True)
    last = torch.cat([last, rel_cond], dim=1)
    b_embedding = resize2d_nchw(b_embedding, hw, method="linear",
                                align_corners=True)
    probs = conditional_log_binomial(model.conditional_log_binomial, last,
                                     b_embedding, cfg)
    b_centers = resize2d_nchw(b_centers, probs.shape[-2:], method="linear",
                              align_corners=True)
    return (probs * b_centers).sum(dim=1)


def prepare(frames_u8: torch.Tensor, img_size=(392, 518),
            compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 frames [B, H, W, 3] -> the core's input [B, 3, *img_size] in
    compute_dtype: /255, ImageNet normalise, bilinear align_corners resize."""
    img = frames_u8.permute(0, 3, 1, 2).float() / 255.0
    mean = torch.tensor(da.IMAGENET_MEAN, device=img.device)[:, None, None]
    std = torch.tensor(da.IMAGENET_STD, device=img.device)[:, None, None]
    # normalise then resize: the two commute (a per-channel affine against a
    # linear filter), and the JAX package does it in this order
    return resize2d_nchw((img - mean) / std, tuple(img_size), method="linear",
                         align_corners=True).to(compute_dtype)


def metric_depth_anything_infer(model: MetricDepthAnything,
                                frames_u8: torch.Tensor, img_size=(392, 518),
                                compute_dtype: torch.dtype = torch.float32):
    """uint8 frames [B, H, W, 3] -> metric depth [B, H, W] f32.

    The reference pipeline (bands/depth_anything.py:106-119 with the
    DepthAnythingCore): /255, ImageNet normalise, bilinear align_corners
    resize to img_size (multiples of 14), the core with its feature hooks,
    the bins head in f32, and PIL's antialiased bicubic back to (H, W)."""
    B, H, W, _ = frames_u8.shape
    h2, w2 = img_size
    img = prepare(frames_u8, img_size, compute_dtype)
    core = model.core.core
    patch = core.pretrained.cfg.patch_size
    feats = vit.get_intermediate_layers(core.pretrained, img, n=4)
    rel_depth, core_feats = dpt.dpt_head(core.depth_head, feats, h2 // patch,
                                         w2 // patch, return_features=True)
    depth = bins_head(model, rel_depth, core_feats)
    return resize2d_nchw(depth, (H, W), method="cubic_aa")


def build(vit_cfg: vit.ViTConfig, features: int = 256,
          out_channels=dpt.DPT_OUT_CHANNELS, cfg: ZoeDepthConfig = ZoeDepthConfig(),
          device: str | torch.device = "cpu") -> MetricDepthAnything:
    """A model with uninitialised storage on `device` (filled by init_params
    or load_state_dict)."""
    with torch.device("meta"):
        model = MetricDepthAnything(vit_cfg, features, out_channels, cfg)
    return model.to_empty(device=device).eval()


@torch.no_grad()
def init_params(model: MetricDepthAnything,
                generator: torch.Generator) -> MetricDepthAnything:
    """Random init in place with the JAX package's distributions
    (`init_head_params`; its weights differ: they come from jax.random): the
    core as `depth_anything.init_params`, the head's convs normal ·
    fan_in^-0.5 with zero biases."""
    da.init_params(model.core.core, generator)
    for name, m in model.named_modules():
        if isinstance(m, nn.Conv2d) and not name.startswith("core."):
            m.weight.normal_(generator=generator).mul_(m.weight[0].numel() ** -0.5)
            m.bias.zero_()
    return model
