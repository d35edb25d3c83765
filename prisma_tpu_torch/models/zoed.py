"""ZoeD_N: the ZoeDepth bins head over the MiDaS BEiT-L core (counterpart
of prisma_tpu/models/zoed.py).

The hub's ZoeD_N as bands/depth_zoedepth.py runs it (`infer_pil`):
reflect-pad by (3 sqrt(h/2), 3 sqrt(w/2)); a bilinear align_corners resize
to img_size (384, 512) and ImageNet normalisation; the BEiT-L DPT core with
its feature hooks; the bins head in f32; bicubic back to the padded size;
the same on the horizontally flipped image, averaged in; then the crop.

`ZoeDepth` is also each of PatchFusion's two sub-models (ZoeDepthCustom).
Parameter names are the checkpoints' (`ZoeD_M12_N.pt`'s model): the core
at `core.core.pretrained.model.*` (BEiT), `core.core.pretrained.
act_postprocess*` and `core.core.scratch.*` (the MiDaS decoder), the bins
head at the top level (`conv2`, `seed_bin_regressor`, ...). The head stays
f32 when the core is cast (`cast_core`); so do the BEiT bias tables.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from prisma_tpu_torch.models import beit, midas
from prisma_tpu_torch.models import zoedepth as zoe
from prisma_tpu_torch.ops import nn as pnn
from prisma_tpu_torch.ops.resize import resize2d_nchw

IMG_SIZE = (384, 512)  # config_zoedepth.json img_size for the BEiT core
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class ZoeDepth(nn.Module):
    def __init__(self, beit_cfg: beit.BEiTConfig = beit.BEiTConfig(),
                 features: int = 256, out_channels=midas.OUT_CHANNELS,
                 cfg: zoe.ZoeDepthConfig = zoe.ZoeDepthConfig()):
        super().__init__()
        self.core = zoe._Core(midas.MidasDPT(beit.BEiT(beit_cfg),
                                             beit_cfg.embed_dim, features,
                                             out_channels))
        zoe.add_bins_head(self, features, cfg)

    def cast_core(self, dtype: torch.dtype) -> "ZoeDepth":
        """The core in dtype; the bins head and the BEiT bias tables stay
        f32."""
        pnn.cast_floating(self.core, dtype, keep=lambda name: name.endswith(
            "relative_position_bias_table"))
        return self


def core_forward(model: midas.MidasDPT, x: torch.Tensor):
    """The BEiT DPT core: normalised [B, 3, H, W] -> (relative depth
    [B, H, W], the MidasCore hooks)."""
    H, W = x.shape[-2:]
    P = model.pretrained.model.cfg.patch_size
    feats = beit.get_intermediate_layers(model.pretrained.model, x)
    return midas.decoder_forward(model, feats, H // P, W // P,
                                 return_features=True)


def _metric_once(model: ZoeDepth, img01: torch.Tensor, img_size,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    """One pass at the padded size: [B, 3, Hp, Wp] in [0, 1] -> [B, Hp, Wp]."""
    Hp, Wp = img01.shape[-2:]
    mean = torch.tensor(IMAGENET_MEAN, device=img01.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=img01.device)[:, None, None]
    x = resize2d_nchw(img01, tuple(img_size), method="linear",
                      align_corners=True)
    x = ((x - mean) / std).to(compute_dtype)
    rel, feats = core_forward(model.core.core, x)
    depth = zoe.bins_head(model, rel, feats)
    if depth.shape[-2:] != (Hp, Wp):
        depth = resize2d_nchw(depth[:, None], (Hp, Wp), method="cubic")[:, 0]
    return depth


def infer(model: ZoeDepth, frames_u8: torch.Tensor, img_size=IMG_SIZE,
          pad_input: bool = True, with_flip_aug: bool = True,
          compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """infer_pil: uint8 frames [B, H, W, 3] -> metric depth [B, H, W] f32.
    The model's core must already be in compute_dtype."""
    H, W = frames_u8.shape[1:3]
    img = frames_u8.permute(0, 3, 1, 2).float() / 255.0
    pad_h = pad_w = 0
    if pad_input:
        pad_h = int(math.sqrt(H / 2) * 3)
        pad_w = int(math.sqrt(W / 2) * 3)
        img = F.pad(img, (pad_w, pad_w, pad_h, pad_h), mode="reflect")
    out = _metric_once(model, img, img_size, compute_dtype)
    if with_flip_aug:
        out_flip = _metric_once(model, img.flip(-1), img_size, compute_dtype)
        out = (out + out_flip.flip(-1)) / 2
    return out[:, pad_h:out.shape[1] - pad_h, pad_w:out.shape[2] - pad_w]


def build(beit_cfg: beit.BEiTConfig = beit.BEiTConfig(), features: int = 256,
          out_channels=midas.OUT_CHANNELS,
          cfg: zoe.ZoeDepthConfig = zoe.ZoeDepthConfig(),
          device: str | torch.device = "cpu") -> ZoeDepth:
    """A model with uninitialised storage on `device` (filled by init_params
    or load_state_dict)."""
    with torch.device("meta"):
        model = ZoeDepth(beit_cfg, features, out_channels, cfg)
    return model.to_empty(device=device).eval()


@torch.no_grad()
def init_params(model: ZoeDepth, generator: torch.Generator) -> ZoeDepth:
    """Random init in place with the JAX package's distributions (its
    weights differ: they come from jax.random)."""
    core = model.core.core
    beit.init_params(core.pretrained.model, generator)
    midas.init_decoder(core, generator)
    return zoe.init_bins_head(model, generator)
