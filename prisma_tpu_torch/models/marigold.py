"""Marigold diffusion depth: the SD2 UNet and VAE, DDIM and the ensembling
(counterpart of prisma_tpu/models/marigold.py).

The pipeline of the reference (`bands/marigold/marigold_pipeline.py`):
- resize the max edge to 768 (PIL's antialiased bicubic), RGB in [0, 1]
  (the reference's quirk: no [-1, 1] scaling), VAE-encode x 0.18215, once
  for all members;
- each ensemble member: a random depth latent, the DDIM loop of
  unet(cat[rgb_latent, depth_latent], t, the empty prompt's embedding), 10
  steps, v-prediction; the members ride the batch axis of one UNet call;
- VAE-decode, the mean of the 3 channels, clipped to [-1, 1] -> [0, 1];
- scale/shift ensembling: a BFGS over the members' affine maps (max 2
  iterations), the median and its absolute deviation, on the device
  (`ensemble_depths_device`); `ensemble_depths` is the host scipy oracle;
- min/max rescale and PIL's antialiased bicubic back to the input size.

`Marigold` holds the snapshot's `unet` and `vae` and the empty prompt's
embedding, which its CLIP text tower (`CLIPTextModel`, the snapshot's
`text_encoder`, `text_model.*` keys) computes once, at load. Medians of an
even member count are the mean of the two middle values, as numpy's and
jax.numpy's are (torch.median would give the lower one).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from prisma_tpu_torch.models import sd2
from prisma_tpu_torch.ops import nn as pnn
from prisma_tpu_torch.ops.resize import resize2d

RGB_LATENT_SCALE = 0.18215
DEPTH_LATENT_SCALE = 0.18215


# ------------------------------------------------------- CLIP text encoder

@dataclass(frozen=True)
class CLIPTextConfig:
    """OpenCLIP-H's text tower as SD2 keeps it (23 of its 24 layers)."""
    vocab: int = 49408
    width: int = 1024
    heads: int = 16
    layers: int = 23
    max_len: int = 77
    bos: int = 49406
    eos: int = 49407


class CLIPAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)


class CLIPMlp(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.self_attn = CLIPAttention(dim)
        self.layer_norm1 = nn.LayerNorm(dim)
        self.mlp = CLIPMlp(dim)
        self.layer_norm2 = nn.LayerNorm(dim)


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab, cfg.width)
        self.position_embedding = nn.Embedding(cfg.max_len, cfg.width)


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg.width)
                                    for _ in range(cfg.layers))


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.width)


class CLIPTextModel(nn.Module):
    """transformers' CLIPTextModel: `text_model.*`."""

    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.cfg = cfg
        self.text_model = CLIPTextTransformer(cfg)


def clip_text_forward(model: CLIPTextModel,
                      token_ids: torch.Tensor) -> torch.Tensor:
    """token_ids [B, L] -> hidden states [B, L, width], the final layer norm
    applied; causal self-attention, quick-gelu MLPs."""
    cfg, tm = model.cfg, model.text_model
    B, L = token_ids.shape
    emb = tm.embeddings
    x = emb.token_embedding.weight[token_ids] + emb.position_embedding.weight[:L]
    mask = torch.triu(torch.full((L, L), float("-inf"), dtype=x.dtype,
                                 device=x.device), diagonal=1)
    h_, d = cfg.heads, cfg.width // cfg.heads
    for layer in tm.encoder.layers:
        a = layer.self_attn
        h = pnn.layer_norm(layer.layer_norm1, x, eps=1e-5)
        q, k, v = (pnn.linear(p, h).reshape(B, L, h_, d).transpose(1, 2)
                   for p in (a.q_proj, a.k_proj, a.v_proj))
        attn = torch.softmax(torch.matmul(q * d ** -0.5, k.transpose(-1, -2))
                             + mask, dim=-1)
        o = torch.matmul(attn, v).transpose(1, 2).reshape(B, L, cfg.width)
        x = x + pnn.linear(a.out_proj, o)
        h = pnn.linear(layer.mlp.fc1, pnn.layer_norm(layer.layer_norm2, x,
                                                     eps=1e-5))
        x = x + pnn.linear(layer.mlp.fc2, h * torch.sigmoid(1.702 * h))
    return pnn.layer_norm(tm.final_layer_norm, x, eps=1e-5)


def empty_text_embed(model: CLIPTextModel) -> torch.Tensor:
    """The empty prompt's embedding [1, 2, width]: [BOS, EOS], unpadded."""
    ids = torch.tensor([[model.cfg.bos, model.cfg.eos]],
                       device=model.text_model.final_layer_norm.weight.device)
    return clip_text_forward(model, ids)


# ------------------------------------------------------------------ model

class Marigold(nn.Module):
    """The snapshot's `unet` and `vae`, and the empty prompt's embedding
    (a buffer, not in the state_dict: made by the text tower at load)."""

    def __init__(self, unet_cfg: sd2.UNetConfig = sd2.UNetConfig(),
                 vae_cfg: sd2.VAEConfig = sd2.VAEConfig()):
        super().__init__()
        self.unet = sd2.UNet2DConditionModel(unet_cfg)
        self.vae = sd2.AutoencoderKL(vae_cfg)
        self.register_buffer("empty_text_embed", torch.zeros(
            1, 2, unet_cfg.cross_attention_dim), persistent=False)


def build(unet_cfg: sd2.UNetConfig = sd2.UNetConfig(),
          vae_cfg: sd2.VAEConfig = sd2.VAEConfig(),
          device: str | torch.device = "cpu") -> Marigold:
    """A model with uninitialised storage on `device` (filled by init_params
    or load_state_dict, the embedding by `set_text_embed`)."""
    with torch.device("meta"):
        model = Marigold(unet_cfg, vae_cfg)
    return model.to_empty(device=device).eval()


def build_text(cfg: CLIPTextConfig = CLIPTextConfig(),
               device: str | torch.device = "cpu") -> CLIPTextModel:
    with torch.device("meta"):
        model = CLIPTextModel(cfg)
    return model.to_empty(device=device).eval()


@torch.no_grad()
def set_text_embed(model: Marigold, text: CLIPTextModel) -> Marigold:
    """Run the text tower once and keep the empty prompt's embedding."""
    model.empty_text_embed = empty_text_embed(text).to(
        model.empty_text_embed.device, torch.float32)
    return model


@torch.no_grad()
def init_params(model: Marigold, generator: torch.Generator) -> Marigold:
    """UNet and VAE at random with the JAX package's distributions."""
    sd2.init_params(model, generator)
    return model


@torch.no_grad()
def init_text(model: CLIPTextModel, generator: torch.Generator) -> CLIPTextModel:
    """The text tower at random: linear weights normal * fan_in^-0.5,
    biases zero, norms one, embeddings normal * 0.02."""
    sd2.init_params(model, generator)
    emb = model.text_model.embeddings
    for e in (emb.token_embedding, emb.position_embedding):
        e.weight.normal_(generator=generator).mul_(0.02)
    return model


# ------------------------------------------------------------------- DDIM

@dataclass(frozen=True)
class DDIMConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    steps_offset: int = 1
    prediction_type: str = "v_prediction"  # Marigold is SD2 (v-pred) derived


def ddim_alphas(cfg: DDIMConfig = DDIMConfig()) -> np.ndarray:
    """The scaled-linear schedule's cumulative alphas (float64)."""
    betas = np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5,
                        cfg.num_train_timesteps) ** 2
    return np.cumprod(1.0 - betas)


def ddim_timesteps(num_steps: int, cfg: DDIMConfig = DDIMConfig()) -> np.ndarray:
    """diffusers' 'leading' spacing: 901, 801, ..., 1 for 10 steps."""
    ratio = cfg.num_train_timesteps // num_steps
    return (np.arange(num_steps) * ratio).round()[::-1].astype(np.int64) \
        + cfg.steps_offset


def ddim_step(model_out: torch.Tensor, t: int, t_prev: int,
              sample: torch.Tensor, alphas_cumprod: torch.Tensor,
              cfg: DDIMConfig = DDIMConfig()) -> torch.Tensor:
    """One deterministic DDIM step (eta 0); the last step (t_prev < 0) goes
    to alphas_cumprod[0]. The arithmetic is in alphas_cumprod's dtype."""
    a_t = alphas_cumprod[t]
    a_prev = alphas_cumprod[t_prev if t_prev >= 0 else 0]
    sqrt_at, sqrt_1mat = torch.sqrt(a_t), torch.sqrt(1.0 - a_t)
    if cfg.prediction_type == "v_prediction":
        x0 = sqrt_at * sample - sqrt_1mat * model_out
        eps = sqrt_at * model_out + sqrt_1mat * sample
    else:  # epsilon
        x0 = (sample - sqrt_1mat * model_out) / sqrt_at
        eps = model_out
    return torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps


# --------------------------------------------------------------- pipeline

def resize_max_res_size(w: int, h: int, max_edge: int = 768):
    """PIL resize_max_res (marigold/util/image_util.py): scale by the max
    edge, the new sizes truncated with int()."""
    scale = min(max_edge / w, max_edge / h)
    return int(w * scale), int(h * scale)


def processing_size(W: int, H: int, processing_res: int):
    """(w, h) the pipeline runs at: the max-edge resize, rounded down to
    multiples of 8 (the VAE's)."""
    w2, h2 = resize_max_res_size(W, H, processing_res) if processing_res > 0 \
        else (W, H)
    return max(8, w2 - w2 % 8), max(8, h2 - h2 % 8)


def member_latents(seed: int, n: int, shape: tuple,
                   device: str | torch.device = "cpu") -> torch.Tensor:
    """The n members' initial depth latents [n, *shape], f32: drawn on the
    CPU from a torch.Generator seeded by `seed` (the frame's index), then
    moved to `device`, so the CPU and the card draw the same ones."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randn((n, *shape), generator=gen).to(device)


def single_infer(model: Marigold, rgb01: torch.Tensor,
                 depth_latent: torch.Tensor, num_steps: int = 10,
                 ddim_cfg: DDIMConfig = DDIMConfig()) -> torch.Tensor:
    """rgb01 [1, 3, H, W] in [0, 1] (H, W multiples of 8), depth_latent
    [E, 4, H/8, W/8] -> the members' depths [E, H, W] in [0, 1].

    The RGB latent is encoded once and broadcast over the E members; the
    DDIM steps run as an eager loop, each one UNet call over all members."""
    rgb_latent = sd2.vae_encode(model.vae, rgb01) * RGB_LATENT_SCALE
    E = depth_latent.shape[0]
    depth_latent = depth_latent.to(rgb_latent.dtype)
    rgb_latent = rgb_latent.expand(E, *rgb_latent.shape[1:])
    context = model.empty_text_embed.to(rgb_latent.dtype).expand(
        E, *model.empty_text_embed.shape[1:])
    alphas = torch.tensor(ddim_alphas(ddim_cfg), dtype=torch.float32,
                          device=rgb_latent.device).to(rgb_latent.dtype)
    ts = ddim_timesteps(num_steps, ddim_cfg)
    ts_prev = np.concatenate([ts[1:], [-1]])  # t - ratio; last -> final alpha
    for t, t_prev in zip(ts.tolist(), ts_prev.tolist()):
        unet_in = torch.cat([rgb_latent, depth_latent], dim=1)
        tb = torch.full((E,), t, dtype=torch.int32, device=unet_in.device)
        noise_pred = sd2.unet_forward(model.unet, unet_in, tb, context)
        depth_latent = ddim_step(noise_pred, t, t_prev, depth_latent, alphas,
                                 ddim_cfg)
    stacked = sd2.vae_decode(model.vae, depth_latent / DEPTH_LATENT_SCALE)
    depth = stacked.mean(dim=1).clamp(-1.0, 1.0)
    return (depth + 1.0) / 2.0


# ------------------------------------------------------------- ensembling

def ensemble_depths(depth_preds: np.ndarray, regularizer_strength: float = 0.02,
                    max_iter: int = 2, tol: float = 1e-3):
    """Scale/shift alignment and the median (reference ensemble.py:41-133),
    on the host with scipy's BFGS and numeric gradients: the oracle."""
    from scipy.optimize import minimize

    n = depth_preds.shape[0]
    flat = depth_preds.reshape(n, -1)
    _min = flat.min(axis=1)
    _max = flat.max(axis=1)
    s_init = 1.0 / (_max - _min)
    t_init = -s_init * _min
    x0 = np.concatenate([s_init, t_init]).astype(np.float32)

    def closure(x):
        s = x[:n].reshape(-1, 1, 1)
        t = x[n:].reshape(-1, 1, 1)
        transformed = depth_preds * s + t
        dists = []
        for i in range(n):
            for j in range(i + 1, n):
                dists.append(transformed[i] - transformed[j])
        sqrt_dist = np.sqrt(np.mean(np.square(np.stack(dists)))) if dists else 0.0
        pred = np.median(transformed, axis=0)
        near_err = np.sqrt((0 - pred.min()) ** 2)
        far_err = np.sqrt((1 - pred.max()) ** 2)
        return np.float32(sqrt_dist
                          + (near_err + far_err) * regularizer_strength)

    res = minimize(closure, x0, method="BFGS", tol=tol,
                   options={"maxiter": max_iter, "disp": False})
    s = res.x[:n].reshape(-1, 1, 1)
    t = res.x[n:].reshape(-1, 1, 1)
    transformed = depth_preds * s + t
    aligned = np.median(transformed, axis=0)
    mad = np.median(np.abs(transformed - aligned), axis=0)
    _mn, _mx = aligned.min(), aligned.max()
    aligned = (aligned - _mn) / (_mx - _mn)
    mad = mad / (_mx - _mn)
    return aligned, mad


def median0(x: torch.Tensor) -> torch.Tensor:
    """The median over axis 0, the mean of the two middle values for an
    even count (numpy's); differentiable through the sort."""
    n = x.shape[0]
    s = torch.sort(x, dim=0).values
    return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2


def _abs(v: torch.Tensor) -> torch.Tensor:
    """|v| with the derivative +1 at 0, as jax.numpy's abs has it (torch.abs
    has 0 there)."""
    return torch.where(v >= 0, v, -v)


def ensemble_objective(x: torch.Tensor, preds: torch.Tensor,
                       regularizer_strength: float = 0.02) -> torch.Tensor:
    """The reference closure (ensemble.py:78-101): the RMS of the pairwise
    distances of the affine-mapped members, plus the median map's distance
    from [0, 1] at its ends; |.| in place of sqrt((.)²) (the same value, a
    finite gradient at 0: the initial maps put the median's ends exactly at
    0 and 1, where the JAX package's gradient is jax.numpy's abs's)."""
    n = preds.shape[0]
    transformed = preds * x[:n, None, None] + x[n:, None, None]
    ii, jj = torch.triu_indices(n, n, offset=1, device=preds.device)
    dists = transformed[ii] - transformed[jj]
    sqrt_dist = torch.sqrt(torch.mean(dists * dists))
    pred = median0(transformed)
    near_err = _abs(0.0 - pred.min())
    far_err = _abs(1.0 - pred.max())
    return sqrt_dist + (near_err + far_err) * regularizer_strength


def _value_and_grad(fun, x: torch.Tensor):
    with torch.inference_mode(False), torch.enable_grad():
        x = x.detach().clone().requires_grad_(True)
        f = fun(x)
        (g,) = torch.autograd.grad(f, x)
    return f.detach(), g


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    d1 = np.array([[dc ** 2, -db ** 2], [-dc ** 3, db ** 3]], np.float32)
    d2 = np.array([fb - fa - C * db, fc - fa - C * dc], np.float32)
    A, B = (d1 @ d2) / denom
    return a + (-B + np.sqrt(B * B - 3.0 * A * C)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


def _zoom(phi, wolfe_one, wolfe_two, a_lo, phi_lo, dphi_lo, a_hi, phi_hi,
          dphi_hi, g_0):
    """Algorithm 3.6 of Nocedal and Wright, step for step as
    jax.scipy.optimize's `_zoom`: -> (a_star, phi_star, g_star, failed)."""
    f32 = np.float32
    a_rec, phi_rec = (a_lo + a_hi) / f32(2), (phi_lo + phi_hi) / f32(2)
    a_star, phi_star, g_star = f32(1), phi_lo, g_0
    done = failed = False
    j = 0
    while not (done or failed):
        dalpha = a_hi - a_lo
        a, b = min(a_hi, a_lo), max(a_hi, a_lo)
        cchk, qchk = f32(0.2) * dalpha, f32(0.1) * dalpha
        failed = failed or dalpha <= f32(1e-5)
        a_cubic = _cubicmin(a_lo, phi_lo, dphi_lo, a_hi, phi_hi, a_rec, phi_rec)
        use_cubic = j > 0 and a + cchk < a_cubic < b - cchk
        a_quad = _quadmin(a_lo, phi_lo, dphi_lo, a_hi, phi_hi)
        use_quad = not use_cubic and a + qchk < a_quad < b - qchk
        a_j = a_cubic if use_cubic else a_quad if use_quad \
            else (a_lo + a_hi) / f32(2)
        phi_j, dphi_j, g_j = phi(a_j)
        hi_to_j = wolfe_one(a_j, phi_j) or phi_j >= phi_lo
        star_to_j = wolfe_two(dphi_j) and not hi_to_j
        hi_to_lo = (dphi_j * (a_hi - a_lo) >= 0 and not hi_to_j
                    and not star_to_j)
        lo_to_j = not hi_to_j and not star_to_j
        if hi_to_j:
            a_rec, phi_rec = a_hi, phi_hi
            a_hi, phi_hi, dphi_hi = a_j, phi_j, dphi_j
        if star_to_j:
            done = True
            a_star, phi_star, g_star = a_j, phi_j, g_j
        if hi_to_lo:
            a_rec, phi_rec = a_hi, phi_hi
            a_hi, phi_hi, dphi_hi = a_lo, phi_lo, dphi_lo
        if lo_to_j and not hi_to_lo:
            a_rec, phi_rec = a_lo, phi_lo
        if lo_to_j:
            a_lo, phi_lo, dphi_lo = a_j, phi_j, dphi_j
        j += 1
        failed = failed or j >= 30
    return a_star, phi_star, g_star, failed


def _line_search(fun, xk, pk, old_fval, old_old_fval, gfk, c1=1e-4, c2=0.9,
                 maxiter=10):
    """A strong-Wolfe line search (Algorithm 3.5 of Nocedal and Wright) as
    jax.scipy.optimize's: -> (a_k, f_k, g_k, failed). Scalars in f32 on the
    host; each evaluation of `fun` and its gradient runs on xk's device."""
    f32 = np.float32

    def phi(t):
        f, g = _value_and_grad(fun, xk + float(t) * pk)
        return f32(f.item()), f32((g * pk).sum().item()), g

    phi_0 = f32(old_fval)
    dphi_0 = f32((gfk * pk).sum().item())
    cand = f32(1.01) * f32(2) * (phi_0 - f32(old_old_fval)) / dphi_0
    start = f32(1) if cand > 1 else cand

    def wolfe_one(a_i, phi_i):
        return phi_i > phi_0 + f32(c1) * a_i * dphi_0

    def wolfe_two(dphi_i):
        return abs(dphi_i) <= -f32(c2) * dphi_0

    a_i1, phi_i1, dphi_i1 = f32(0), phi_0, dphi_0
    a_star, phi_star, g_star = f32(0), phi_0, gfk
    done = failed = False
    i = 1
    while not done and i <= maxiter and not failed:
        a_i = start if i == 1 else a_i1 * f32(2)
        phi_i, dphi_i, g_i = phi(a_i)
        to_zoom1 = wolfe_one(a_i, phi_i) or (phi_i >= phi_i1 and i > 1)
        to_i = wolfe_two(dphi_i) and not to_zoom1
        to_zoom2 = dphi_i >= 0 and not to_zoom1 and not to_i
        if to_zoom1:
            a_star, phi_star, g_star, z_failed = _zoom(
                phi, wolfe_one, wolfe_two, a_i1, phi_i1, dphi_i1, a_i, phi_i,
                dphi_i, gfk)
            done, failed = True, z_failed
        elif to_i:
            done = True
            a_star, phi_star, g_star = a_i, phi_i, g_i
        elif to_zoom2:
            a_star, phi_star, g_star, z_failed = _zoom(
                phi, wolfe_one, wolfe_two, a_i, phi_i, dphi_i, a_i1, phi_i1,
                dphi_i1, gfk)
            done, failed = True, z_failed
        i += 1
        a_i1, phi_i1, dphi_i1 = a_i, phi_i, dphi_i
    if abs(a_star) < 1e-8:
        a_star = f32(np.sign(a_star) * 1e-8)
    return a_star, phi_star, g_star, failed or not done


def minimize_bfgs(fun, x0: torch.Tensor, maxiter: int, gtol: float = 1e-5):
    """BFGS (Algorithm 6.1 of Nocedal and Wright) as jax.scipy.optimize.
    minimize(method="BFGS") runs it: the identity as the initial inverse
    Hessian, the strong-Wolfe line search above, at most `maxiter`
    iterations, stop when max |g| < gtol or the line search fails (its step
    is taken first). x and the inverse Hessian stay on x0's device; the
    gradients come from autograd. -> x."""
    f, g_k = _value_and_grad(fun, x0)
    f_k = np.float32(f.item())
    x_k = x0.detach()
    eye = torch.eye(x0.shape[0], dtype=x0.dtype, device=x0.device)
    H_k = eye
    old_old = f_k + np.float32(torch.linalg.vector_norm(g_k).item()) / 2
    failed, k = False, 0
    with np.errstate(all="ignore"):
        while k < maxiter and not failed and float(g_k.abs().max()) >= gtol:
            p_k = -(H_k @ g_k)
            a_k, f_kp1, g_kp1, failed = _line_search(fun, x_k, p_k, f_k,
                                                     old_old, g_k)
            s_k = float(a_k) * p_k
            y_k = g_kp1 - g_k
            rho = 1.0 / (y_k * s_k).sum()
            w = eye - rho * s_k[:, None] * y_k[None, :]
            if bool(torch.isfinite(rho)):
                H_k = w @ H_k @ w.T + rho * s_k[:, None] * s_k[None, :]
            x_k, old_old, f_k, g_k = x_k + s_k, f_k, f_kp1, g_kp1
            k += 1
    return x_k


def ensemble_depths_device(preds: torch.Tensor, regularizer_strength: float = 0.02,
                           max_iter: int = 2, gtol: float = 1e-5):
    """The production ensembling, on preds' device: preds [n, H, W] f32 ->
    (aligned [H, W] in [0, 1], mad [H, W]). The objective and reduction of
    `ensemble_depths`, solved by `minimize_bfgs` with autograd gradients in
    place of host scipy's numeric ones (the two take other 2-iteration
    trajectories; jax.scipy's minimize, whose BFGS this follows, stops on
    gtol 1e-5 and ignores the reference's tol)."""
    n = preds.shape[0]
    with torch.inference_mode(False):
        preds = preds.float().clone()
        flat = preds.reshape(n, -1)
        lo, hi = flat.min(dim=1).values, flat.max(dim=1).values
        s0 = 1.0 / (hi - lo)
        x = minimize_bfgs(
            lambda x: ensemble_objective(x, preds, regularizer_strength),
            torch.cat([s0, -s0 * lo]), max_iter, gtol)
        transformed = preds * x[:n, None, None] + x[n:, None, None]
        aligned = median0(transformed)
        mad = median0((transformed - aligned).abs())
        mn, mx = aligned.min(), aligned.max()
        return (aligned - mn) / (mx - mn), mad / (mx - mn)


def epilogue(aligned: torch.Tensor, out_hw) -> torch.Tensor:
    """Min/max rescale, PIL's antialiased bicubic to out_hw, the range
    restored (marigold_pipeline.py:226-233): [h, w] -> [H, W] f32."""
    mn, mx = aligned.min(), aligned.max()
    d = (aligned - mn) / (mx - mn)
    r = resize2d(d[None, :, :, None], tuple(out_hw), method="cubic_aa")[0, ..., 0]
    return mn + r * (mx - mn)


def infer(model: Marigold, frame_u8: torch.Tensor, denoising_steps: int = 10,
          ensemble_size: int = 10, processing_res: int = 768, seed: int = 0,
          compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One frame [H, W, 3] uint8 on the model's device -> relative depth
    [H, W] f32 (the pipeline's min..max-rescaled output). The model must
    already be in compute_dtype. The members' initial latents come from
    `member_latents` (tests replace it)."""
    H, W = frame_u8.shape[:2]
    w2, h2 = processing_size(W, H, processing_res)
    rgb = frame_u8.float()[None] / 255.0
    # the reference's resize_max_res: PIL's default, antialiased bicubic
    rgb = resize2d(rgb, (h2, w2), method="cubic_aa").to(compute_dtype)
    ds = 2 ** (len(model.vae.encoder.down_blocks) - 1)
    lat_ch = model.vae.post_quant_conv.weight.shape[0]
    depth_latent = member_latents(seed, ensemble_size,
                                  (lat_ch, h2 // ds, w2 // ds), frame_u8.device)
    preds = single_infer(model, rgb.permute(0, 3, 1, 2), depth_latent,
                         denoising_steps).float()
    if ensemble_size > 1:
        aligned, _mad = ensemble_depths_device(preds)
    else:
        aligned = preds[0]
    return epilogue(aligned, (H, W))
