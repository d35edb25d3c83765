"""RAFT optical flow (counterpart of prisma_tpu/models/raft.py), and the
RAFT helpers GMFlow shares (convex_upsample, pad_to_multiple, unpad).

The reference's vendored RAFT (`bands/raft/raft.py`, `extractor.py`,
`update.py`, `corr.py`): BasicEncoder features (instance norm) and context
(eval-mode batch norm) at 1/8, an all-pairs correlation pyramid of four
levels, a radius-4 bilinear window lookup, 20 SepConvGRU refinement
iterations, and 9-tap convex x8 upsampling; forward and backward flow in one
doubled batch (`flow_raft.py:105-107`).

The modules carry the reference checkpoint's names (`fnet.*`, `cnet.*`,
`update_block.*`, with cnet's `norm3` also registered as `downsample.1`), so
`raft-sintel.pth` loads with strict=True. The public functions keep the JAX
layout at their boundary ([B, H, W, C] images, coords and flows); the
convolutions run NCHW. The kernels carry the model on a CUDA device:
- fnet's 15 instance norms are K4 (`ops/cuda/instance_norm.py`);
- the window lookup of every iteration is K5 (`ops/cuda/raft_lookup.py`),
  one launch for all four levels.
On the CPU each wrapper takes its plain version. The correlation pyramid is
a plain matrix product (the JAX package leaves it to XLA too), and the
refinement loop runs eagerly in Python. `corr_impl="fused"` (the
reference's alt_cuda_corr) skips the pyramid of volumes for inputs whose
volume does not fit the card: each iteration samples a pooled pyramid of
fmap2 and dots it with fmap1, in plain torch as the JAX package computes it
outside any Pallas kernel, so that path launches no K5. The GRU is the reference's concat
form; the mask head and the convex upsampling run once, after the loop.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from prisma_tpu_torch.ops import nn as pnn
from prisma_tpu_torch.ops.cuda.instance_norm import instance_norm_relu
from prisma_tpu_torch.ops.cuda.raft_lookup import window_lookup

BN_EPS = 1e-5
# the JAX band's --corr_impl names: "fused" is the O(HW)-memory lookup; the
# others are TPU formulations of the one volume lookup, K5 here
CORR_IMPLS = ("volume_onehot", "volume_onehot_xf", "volume_onehot_packed",
              "volume", "fused", "volume_pallas", "volume_gk")
TAP_CHUNK = 9  # window taps the fused lookup samples at once


@dataclass(frozen=True)
class RAFTConfig:
    hidden_dim: int = 128
    context_dim: int = 128
    corr_levels: int = 4
    corr_radius: int = 4
    iters: int = 20


# ---------------------------------------------------------------------------
# Modules (the reference checkpoint's names)
# ---------------------------------------------------------------------------

def _norm(kind: str, planes: int) -> nn.Module:
    return nn.InstanceNorm2d(planes) if kind == "instance" else nn.BatchNorm2d(planes)


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, cout: int, kind: str, stride: int):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1)
        self.norm1 = _norm(kind, cout)
        self.norm2 = _norm(kind, cout)
        self.downsample = None
        if stride != 1:
            # one module under two names, as the reference (extractor.py:44-45)
            self.norm3 = _norm(kind, cout)
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride),
                                            self.norm3)


class BasicEncoder(nn.Module):
    def __init__(self, out_dim: int, kind: str):
        super().__init__()
        self.kind = kind
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3)
        self.norm1 = _norm(kind, 64)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, kind, 1),
                                    ResidualBlock(64, 64, kind, 1))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, kind, 2),
                                    ResidualBlock(96, 96, kind, 1))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, kind, 2),
                                    ResidualBlock(128, 128, kind, 1))
        self.conv2 = nn.Conv2d(128, out_dim, 1)


class BasicMotionEncoder(nn.Module):
    def __init__(self, cfg: RAFTConfig):
        super().__init__()
        cor_planes = cfg.corr_levels * (2 * cfg.corr_radius + 1) ** 2
        self.convc1 = nn.Conv2d(cor_planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)


class SepConvGRU(nn.Module):
    def __init__(self, hidden_dim: int, input_dim: int):
        super().__init__()
        c = hidden_dim + input_dim
        for g in "zrq":
            setattr(self, f"conv{g}1", nn.Conv2d(c, hidden_dim, (1, 5), padding=(0, 2)))
        for g in "zrq":
            setattr(self, f"conv{g}2", nn.Conv2d(c, hidden_dim, (5, 1), padding=(2, 0)))


class FlowHead(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, padding=1)


class BasicUpdateBlock(nn.Module):
    def __init__(self, cfg: RAFTConfig):
        super().__init__()
        self.encoder = BasicMotionEncoder(cfg)
        self.gru = SepConvGRU(cfg.hidden_dim, 128 + cfg.hidden_dim)
        self.flow_head = FlowHead(cfg.hidden_dim, 256)
        self.mask = nn.Sequential(nn.Conv2d(128, 256, 3, padding=1),
                                  nn.ReLU(inplace=True),
                                  nn.Conv2d(256, 64 * 9, 1))


class RAFT(nn.Module):
    def __init__(self, cfg: RAFTConfig = RAFTConfig()):
        super().__init__()
        self.cfg = cfg
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(cfg.hidden_dim + cfg.context_dim, "batch")
        self.update_block = BasicUpdateBlock(cfg)


def build(cfg: RAFTConfig = RAFTConfig(), device: str | torch.device = "cpu") -> RAFT:
    """A model with uninitialised storage on `device` (the caller fills it
    with `init_params` or `load_state_dict`)."""
    with torch.device("meta"):
        model = RAFT(cfg)
    return model.to_empty(device=device).eval()


@torch.no_grad()
def init_params(model: RAFT, generator: torch.Generator) -> RAFT:
    """Random init in place with the JAX package's distributions (its
    weights differ: they come from jax.random): conv weights normal ·
    fan_in^-0.5, biases zero, batch norms the identity (weight 1, bias 0,
    mean 0, variance 1 - eps, so that the folded scale is 1 as the JAX
    package's identity affine)."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            m.weight.normal_(generator=generator).mul_(m.weight[0].numel() ** -0.5)
            m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0 - BN_EPS)
            m.num_batches_tracked.zero_()
    return model


# ---------------------------------------------------------------------------
# Encoders, NCHW
# ---------------------------------------------------------------------------

def _norm_relu(norm: nn.Module, x: torch.Tensor, relu: bool) -> torch.Tensor:
    if isinstance(norm, nn.InstanceNorm2d):
        return instance_norm_relu(x, relu=relu)
    y = pnn.batch_norm(norm, x)
    return F.relu(y) if relu else y


def encoder_forward(enc: BasicEncoder, x: torch.Tensor) -> torch.Tensor:
    """x [B, 3, H, W] in [-1, 1], contiguous -> [B, out, H/8, W/8]. fnet's
    instance norms go through `instance_norm_relu` (K4 on the card), 15 of
    them; cnet's batch norms are folded affines. The residual ReLU follows
    the add; the downsample's norm takes none."""
    x = _norm_relu(enc.norm1, pnn.conv2d(enc.conv1, x, stride=2, padding=3), True)
    for block in (*enc.layer1, *enc.layer2, *enc.layer3):
        s = block.stride
        y = _norm_relu(block.norm1, pnn.conv2d(block.conv1, x, stride=s, padding=1),
                       True)
        y = _norm_relu(block.norm2, pnn.conv2d(block.conv2, y, padding=1), True)
        if block.downsample is not None:
            x = _norm_relu(block.norm3, pnn.conv2d(block.downsample[0], x, stride=s),
                           False)
        x = F.relu(x + y)
    return pnn.conv2d(enc.conv2, x)


# ---------------------------------------------------------------------------
# Correlation pyramid + window lookup
# ---------------------------------------------------------------------------

def build_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                       num_levels: int) -> list[torch.Tensor]:
    """fmaps [B, C, H, W] -> num_levels volumes [B·H·W, Hl, Wl] in the fmap
    dtype, as the JAX package's build_corr_pyramid: level l is fmap1 ·
    avgpool^l(fmap2) / sqrt(C) (pooling is linear, so it commutes with the
    dot product, and no [HW, HW] volume is pooled); each 2x2 average pool
    drops an odd last row or column, as the reference's avg_pool2d does.
    The 1/sqrt(C) scale is folded into fmap1 (for C = 256 it is 1/16, exact
    in any float type), so no scaled copy of the volume is made."""
    B, C, H, W = fmap1.shape
    f1 = (fmap1 * C ** -0.5).flatten(2).transpose(1, 2)   # [B, HW, C]
    pyramid = []
    f2 = fmap2
    for level in range(num_levels):
        if level:
            h, w = f2.shape[-2:]
            f2 = f2[:, :, :h - h % 2, :w - w % 2].reshape(
                B, C, h // 2, 2, w // 2, 2).mean(dim=(3, 5))
        h2, w2 = f2.shape[-2:]
        corr = torch.matmul(f1, f2.reshape(B, C, h2 * w2))
        pyramid.append(corr.reshape(B * H * W, h2, w2))
    return pyramid


def corr_lookup(pyramid: list[torch.Tensor], coords: torch.Tensor,
                radius: int) -> torch.Tensor:
    """coords [B, H1, W1, 2] f32 (x, y) -> [B, H1, W1, levels·(2r+1)²]:
    `window_lookup` (K5 on the card, one launch for all levels)."""
    B, H1, W1, _ = coords.shape
    out = window_lookup(pyramid, coords.reshape(B * H1 * W1, 2).contiguous(),
                        radius)
    return out.reshape(B, H1, W1, -1)


def build_fmap_pyramid(fmap2: torch.Tensor,
                       num_levels: int) -> list[torch.Tensor]:
    """fmap2 [B, H, W, C] -> num_levels maps, each a 2x2 average pool of the
    last with an odd last row or column dropped first (the fused lookup's
    pyramid: pooling commutes with the dot product, so no volume is
    built)."""
    pyramid = [fmap2]
    f = fmap2
    for _ in range(num_levels - 1):
        B, h, w, C = f.shape
        f = f[:, :h - h % 2, :w - w % 2].reshape(
            B, h // 2, 2, w // 2, 2, C).mean(dim=(2, 4))
        pyramid.append(f)
    return pyramid


def _bilinear_gather_feat(fmap: torch.Tensor, x: torch.Tensor,
                          y: torch.Tensor) -> torch.Tensor:
    """fmap [B, H, W, C]; x, y [B, K] f32 -> [B, K, C] f32 bilinear samples,
    a corner off the map contributing zero."""
    B, H, W, C = fmap.shape
    x0, y0 = x.floor(), y.floor()
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    flat = fmap.reshape(B * H * W, C)
    base = (torch.arange(B, device=fmap.device) * (H * W))[:, None]

    def corner(xi, yi, wgt):
        valid = ((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H))[..., None]
        idx = base + yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        vals = flat.index_select(0, idx.reshape(-1)).view(*idx.shape, C)
        # the JAX package's vals * wgt * valid: the same values (valid is 0
        # or 1), one pass over [B, K, C] fewer
        return vals * (wgt * valid)

    out = corner(x0, y0, (1 - fx) * (1 - fy))
    out += corner(x0 + 1, y0, fx * (1 - fy))  # in place: one buffer, same sums
    out += corner(x0, y0 + 1, (1 - fx) * fy)
    out += corner(x0 + 1, y0 + 1, fx * fy)
    return out


def corr_lookup_fused(fmap1: torch.Tensor, fmap2_pyramid: list[torch.Tensor],
                      coords: torch.Tensor, radius: int) -> torch.Tensor:
    """The O(HW)-memory window lookup (JAX `corr_lookup_fused`, the
    reference's alt_cuda_corr): per level and tap, a bilinear sample of the
    pooled fmap2 dotted with fmap1, the (2r+1)² taps in chunks of TAP_CHUNK
    so that peak memory stays O(HW·TAP_CHUNK·C). fmap1 [B, H1, W1, C],
    pyramid levels [B, h, w, C], coords [B, H1, W1, 2] f32 (x, y) ->
    [B, H1, W1, levels·(2r+1)²] f32, each window in the reference's order (x
    on the slow axis), as K5's volume path lays it out. 1/sqrt(C) is folded
    into fmap1 as the volume path folds it."""
    B, H1, W1, C = fmap1.shape
    n = 2 * radius + 1
    if (n * n) % TAP_CHUNK:
        raise ValueError(f"{TAP_CHUNK} taps a chunk do not divide {n * n} taps")
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32,
                        device=fmap1.device)
    ox, oy = offs.repeat_interleave(n), offs.repeat(n)
    cx = coords[..., 0].reshape(B, H1 * W1, 1)
    cy = coords[..., 1].reshape(B, H1 * W1, 1)
    f1 = (fmap1.float() * C ** -0.5).reshape(B, H1 * W1, C, 1)
    out = []
    for level, f2 in enumerate(fmap2_pyramid):
        if f2.shape[1] * f2.shape[2] == 0:  # a level pooled to nothing
            out.append(f1.new_zeros(B, H1 * W1, n * n))
            continue
        for t0 in range(0, n * n, TAP_CHUNK):
            sx = (cx / 2 ** level + ox[t0:t0 + TAP_CHUNK]).reshape(B, -1)
            sy = (cy / 2 ** level + oy[t0:t0 + TAP_CHUNK]).reshape(B, -1)
            samples = _bilinear_gather_feat(f2, sx, sy).reshape(
                B, H1 * W1, TAP_CHUNK, C)
            out.append(torch.matmul(samples, f1)[..., 0])
    return torch.cat(out, dim=-1).reshape(B, H1, W1, -1)


# ---------------------------------------------------------------------------
# Update block, NCHW
# ---------------------------------------------------------------------------

def motion_encoder(p: BasicMotionEncoder, flow: torch.Tensor,
                   corr: torch.Tensor) -> torch.Tensor:
    """flow [B, 2, H, W], corr [B, levels·81, H, W] -> [B, 128, H, W]."""
    cor = F.relu(pnn.conv2d(p.convc1, corr))
    cor = F.relu(pnn.conv2d(p.convc2, cor, padding=1))
    flo = F.relu(pnn.conv2d(p.convf1, flow, padding=3))
    flo = F.relu(pnn.conv2d(p.convf2, flo, padding=1))
    out = F.relu(pnn.conv2d(p.conv, torch.cat([cor, flo], dim=1), padding=1))
    return torch.cat([out, flow], dim=1)


def gru_weights(p: SepConvGRU):
    """Per direction, the z and r convs as one conv (output channels
    concatenated: each is its own dot product, so nothing changes) and the q
    conv; made once per forward, outside the loop."""
    out = []
    for suffix, pad in (("1", (0, 2)), ("2", (2, 0))):
        z, r, q = (getattr(p, f"conv{g}{suffix}") for g in "zrq")
        out.append((torch.cat([z.weight, r.weight]), torch.cat([z.bias, r.bias]),
                    q.weight, q.bias, pad))
    return out


def sep_conv_gru(weights, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The reference SepConvGRU (update.py:33-56), a horizontal (1x5) then a
    vertical (5x1) pass over the concat [h, x]."""
    C = h.shape[1]
    for w_zr, b_zr, w_q, b_q, pad in weights:
        zr = torch.sigmoid(F.conv2d(torch.cat([h, x], dim=1), w_zr, b_zr,
                                    padding=pad))
        z, r = zr[:, :C], zr[:, C:]
        q = torch.tanh(F.conv2d(torch.cat([r * h, x], dim=1), w_q, b_q,
                                padding=pad))
        h = (1 - z) * h + z * q
    return h


def flow_head(p: FlowHead, net: torch.Tensor) -> torch.Tensor:
    return pnn.conv2d(p.conv2, F.relu(pnn.conv2d(p.conv1, net, padding=1)),
                      padding=1)


def mask_head(p: nn.Sequential, net: torch.Tensor) -> torch.Tensor:
    return 0.25 * pnn.conv2d(p[2], F.relu(pnn.conv2d(p[0], net, padding=1)))


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def coords_grid(B: int, H: int, W: int, device) -> torch.Tensor:
    """[B, H, W, 2] f32 pixel centres (x, y)."""
    gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                            torch.arange(W, dtype=torch.float32, device=device),
                            indexing="ij")
    return torch.stack([gx, gy], dim=-1).expand(B, H, W, 2)


def forward(model: RAFT, image1: torch.Tensor, image2: torch.Tensor,
            iters: int | None = None, fmaps=None, corr_impl: str = "volume"):
    """image1/2 [B, H, W, 3] in [0, 255], in the model's dtype, H and W
    multiples of 8 -> (flow_low [B, H/8, W/8, 2], flow_up [B, H, W, 2]),
    both f32: the reference's test-mode outputs (raft.py:143-144).

    fmaps: optional precomputed NCHW (fmap1, fmap2), so that a caller whose
    doubled batch repeats images (infer_pairs) runs fnet once per image.
    corr_impl: "fused" for the O(HW)-memory lookup (`corr_lookup_fused`);
    any other name of CORR_IMPLS for the correlation volume and K5.
    Coordinates stay f32; the correlation and the flow are cast to the
    feature dtype before the motion encoder."""
    if corr_impl not in CORR_IMPLS:
        raise ValueError(f"corr_impl {corr_impl!r} not in {CORR_IMPLS}")
    cfg = model.cfg
    iters = cfg.iters if iters is None else iters
    B = image1.shape[0]
    img1 = _nchw(2.0 * (image1 / 255.0) - 1.0)
    if fmaps is None:
        img2 = _nchw(2.0 * (image2 / 255.0) - 1.0)
        fm = encoder_forward(model.fnet, torch.cat([img1, img2]))
        fmaps = fm[:B], fm[B:]
    fmap1, fmap2 = fmaps
    if corr_impl == "fused":
        f1 = fmap1.permute(0, 2, 3, 1)
        f2_pyramid = build_fmap_pyramid(fmap2.permute(0, 2, 3, 1),
                                        cfg.corr_levels)

        def lookup(coords):
            return corr_lookup_fused(f1, f2_pyramid, coords, cfg.corr_radius)
    else:
        pyramid = build_corr_pyramid(fmap1, fmap2, cfg.corr_levels)

        def lookup(coords):
            return corr_lookup(pyramid, coords, cfg.corr_radius)

    cnet = encoder_forward(model.cnet, img1)
    net = torch.tanh(cnet[:, :cfg.hidden_dim])
    inp = F.relu(cnet[:, cfg.hidden_dim:])
    ub = model.update_block
    gru = gru_weights(ub.gru)

    H8, W8 = fmap1.shape[-2:]
    coords0 = coords_grid(B, H8, W8, fmap1.device)
    coords1 = coords0
    dtype = fmap1.dtype
    for _ in range(iters):
        corr = lookup(coords1)
        flow = coords1 - coords0
        motion = motion_encoder(ub.encoder, flow.to(dtype).permute(0, 3, 1, 2),
                                corr.to(dtype).permute(0, 3, 1, 2))
        net = sep_conv_gru(gru, net, torch.cat([inp, motion], dim=1))
        delta = flow_head(ub.flow_head, net)
        coords1 = coords1 + delta.float().permute(0, 2, 3, 1)

    flow_low = coords1 - coords0
    up_mask = mask_head(ub.mask, net).float().permute(0, 2, 3, 1)
    return flow_low, convex_upsample(flow_low, up_mask)


def infer_pairs(model: RAFT, image1: torch.Tensor, image2: torch.Tensor,
                iters: int | None = None, corr_impl: str = "volume"):
    """Bidirectional inference in one doubled batch (reference
    flow_raft.py:105-107): image1/2 [B, H, W, 3] in [0, 255] -> (fwd, bwd)
    [B, H, W, 2] f32. Pads to a multiple of 8 (centred, edge-replicated) and
    back; fnet runs once over the 2B images of the doubled batch. corr_impl:
    see forward."""
    B = image1.shape[0]
    i1, pads = pad_to_multiple(image1)
    i2, _ = pad_to_multiple(image2)
    a = torch.cat([i1, i2])
    b = torch.cat([i2, i1])
    fm = encoder_forward(model.fnet, _nchw(2.0 * (a / 255.0) - 1.0))
    fmaps = (fm, torch.cat([fm[B:], fm[:B]]))
    _, flow_up = forward(model, a, b, iters, fmaps=fmaps, corr_impl=corr_impl)
    flow_up = unpad(flow_up, pads)
    return flow_up[:B], flow_up[B:]


# ---------------------------------------------------------------------------
# Helpers GMFlow shares, [B, H, W, C]
# ---------------------------------------------------------------------------

def convex_upsample(flow: torch.Tensor, mask: torch.Tensor,
                    factor: int = 8) -> torch.Tensor:
    """flow [B, H, W, 2], mask [B, H, W, 9·f²] -> [B, f·H, f·W, 2].

    The mask channel layout follows the reference's view(N, 1, 9, f, f, H,
    W): channel c = (k·f + i)·f + j with k the 3x3 neighbour (row-major) and
    (i, j) the subpixel; a softmax over the 9 neighbours weighs f·flow at
    each of them (zero outside the image)."""
    B, H, W, _ = flow.shape
    f = factor
    m = mask.reshape(B, H, W, 9, f, f)
    m = torch.exp(m - m.amax(dim=3, keepdim=True))
    m = m / m.sum(dim=3, keepdim=True)
    fp = F.pad(float(f) * flow, (0, 0, 1, 1, 1, 1))
    neighbors = torch.stack([fp[:, ky:ky + H, kx:kx + W] for ky in range(3)
                             for kx in range(3)], dim=3)  # [B, H, W, 9, 2]
    up = torch.einsum("bhwkij,bhwkc->bhwijc", m, neighbors)
    up = up.permute(0, 1, 3, 2, 4, 5)  # (b, h, i, w, j, c)
    return up.reshape(B, f * H, f * W, 2)


def pad_to_multiple(x: torch.Tensor, multiple: int = 8):
    """Sintel-mode InputPadder (reference common/flow.py:43-61): pad
    [B, H, W, C] to multiples of `multiple`, centred, replicating the edge.
    -> (padded, (top, bottom, left, right))."""
    H, W = x.shape[1], x.shape[2]
    ph = (-H) % multiple
    pw = (-W) % multiple
    top, bottom = ph // 2, ph - ph // 2
    left, right = pw // 2, pw - pw // 2
    x = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom),
              mode="replicate").permute(0, 2, 3, 1)
    return x, (top, bottom, left, right)


def unpad(x: torch.Tensor, pads) -> torch.Tensor:
    top, bottom, left, right = pads
    return x[:, top:x.shape[1] - bottom, left:x.shape[2] - right]
