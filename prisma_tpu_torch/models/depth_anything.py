"""Depth-Anything (relative): DINOv2 ViT + DPT head, with the full pre/post
chain (counterpart of prisma_tpu/models/depth_anything.py).

The module's parameter names are the checkpoint's (`pretrained.*`,
`depth_head.*`). The public functions keep the JAX layout at their boundary:
`forward` takes a prepared [B, H, W, 3] image, `infer` and
`infer_video_batch` take uint8 frames [B, H, W, 3]; the module runs NCHW.
`infer` opens the spans `prisma.model.prepare`, `.encoder` (the ViT),
`.head` (DPT, with its resize to the input size) and `.resize_back`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from prisma_tpu_torch.models import dpt, vit
from prisma_tpu_torch.ops import encode as enc
from prisma_tpu_torch.ops.resize import dpt_input_size, resize2d_nchw
from prisma_tpu_torch.runtime.profiling import span

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class DepthAnything(nn.Module):
    def __init__(self, cfg: vit.ViTConfig, features: int = 256,
                 out_channels=dpt.DPT_OUT_CHANNELS):
        super().__init__()
        self.pretrained = vit.DinoVisionTransformer(cfg)
        self.depth_head = dpt.DPTHead(cfg.embed_dim, features, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Prepared input [B, 3, H, W] -> relative depth [B, H, W]."""
        cfg = self.pretrained.cfg
        H, W = x.shape[-2:]
        ph, pw = H // cfg.patch_size, W // cfg.patch_size
        with span("prisma.model.encoder"):
            feats = vit.get_intermediate_layers(self.pretrained, x, n=4)
        with span("prisma.model.head"):
            depth = dpt.dpt_head(self.depth_head, feats, ph, pw)
            depth = resize2d_nchw(depth[:, None], (H, W), method="linear",
                                  align_corners=True)[:, 0]
            return F.relu(depth)


def build(cfg: vit.ViTConfig, features: int = 256,
          out_channels=dpt.DPT_OUT_CHANNELS,
          device: str | torch.device = "cpu") -> DepthAnything:
    """A model with uninitialised storage on `device` (no default init: the
    caller fills it with `init_params` or `load_state_dict`)."""
    with torch.device("meta"):
        model = DepthAnything(cfg, features, out_channels)
    return model.to_empty(device=device).eval()


@torch.no_grad()
def init_params(model: DepthAnything,
                generator: torch.Generator) -> DepthAnything:
    """Random init in place with the JAX package's distributions (its weights
    differ: they come from jax.random): weights normal * fan_in^-0.5, biases
    zero, norms and LayerScales one, cls token normal * 1e-6, pos embed
    normal * 0.02, mask token zero."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            fan_in = w.shape[1] if isinstance(m, nn.Linear) \
                else w[0].numel() if isinstance(m, nn.Conv2d) \
                else w.shape[0] * w.shape[2] * w.shape[3]
            w.normal_(generator=generator).mul_(fan_in ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, vit.LayerScale):
            m.gamma.fill_(1.0)
    p = model.pretrained
    p.cls_token.normal_(generator=generator).mul_(1e-6)
    p.pos_embed.normal_(generator=generator).mul_(0.02)
    p.mask_token.zero_()
    return model


def forward(model: DepthAnything, x: torch.Tensor) -> torch.Tensor:
    """Model forward on a prepared input [B, h', w', 3] -> depth [B, h', w']."""
    return model(x.permute(0, 3, 1, 2))


def prepare(frames_u8: torch.Tensor, compute_dtype: torch.dtype,
            target: int = 518) -> torch.Tensor:
    """uint8 frames [B, H, W, 3] -> the model's normalised input
    [B, 3, h', w'] in compute_dtype (cubic resize to the ViT budget)."""
    B, H, W, _ = frames_u8.shape
    w2, h2 = dpt_input_size(W, H, target=target)
    # cast before /255 and resize in the compute dtype, as the JAX package does
    img = frames_u8.permute(0, 3, 1, 2).to(compute_dtype) / 255.0
    img = resize2d_nchw(img, (h2, w2), method="cubic", align_corners=False)
    mean = torch.tensor(IMAGENET_MEAN, dtype=compute_dtype, device=img.device)
    std = torch.tensor(IMAGENET_STD, dtype=compute_dtype, device=img.device)
    return (img - mean[:, None, None]) / std[:, None, None]


def infer(model: DepthAnything, frames_u8: torch.Tensor,
          compute_dtype: torch.dtype = torch.float32,
          target: int = 518) -> torch.Tensor:
    """Full driver-equivalent inference: uint8 frames [B, H, W, 3] -> depth
    [B, H, W] f32. The model must already be in compute_dtype.

    target: ViT input budget (lower_bound resize target, default 518).
    """
    H, W = frames_u8.shape[1:3]
    with span("prisma.model.prepare"):
        img = prepare(frames_u8, compute_dtype, target)
    depth = model(img)
    with span("prisma.model.resize_back"):
        depth = resize2d_nchw(depth[:, None], (H, W), method="linear",
                              align_corners=False)[:, 0]
        return depth.float()


def infer_video_batch(model: DepthAnything, frames_u8: torch.Tensor,
                      flip: bool = True,
                      compute_dtype: torch.dtype = torch.float32,
                      target: int = 518):
    """Batched video step with the heatmap epilogue.

    Returns (heat_rgb_u8 [B, H, W, 3], mins [B], maxs [B]): per-frame min/max
    normalize, optional flip, heat_to_rgb, no edge desaturation.
    """
    depth = infer(model, frames_u8, compute_dtype=compute_dtype, target=target)
    return enc.depth_heat(depth, flip)
