"""Where the time of a band's video step goes, on one CUDA card.

    python -m prisma_tpu_torch.runtime.profile_step [--band depth_anything]
        [--steps 5] [--out FILE]

    --band: depth_anything, depth_anything_metric, depth_marigold,
    depth_midas, depth_patchfusion, depth_zoedepth, mask, flow_gmflow,
    flow_gmflow_refine (--num_scales 2) or flow_raft

Builds the band's step as chip_smoke.py does (bf16, random weights from a
seed, uint8 1080p frames at batch 8; depth_patchfusion one frame a step, at
p49; depth_marigold one frame a step, 10 steps x 10 members at 768) and
prints:

- the host-clock time of whole steps (H2D and D2H included);
- for depth_anything and flow_gmflow, the device time of each stage of
  the profiled steps, from the step's spans (`runtime.profiling`: the
  kernels and copies launched inside `prisma.step.inputs`, `.model`,
  `.epilogue`, `.outputs`, and the model's `prisma.model.*` ranges:
  depth_anything prepare, encoder, head, resize_back; flow_gmflow
  backbone, transformer, matching, propagation, upsample);
- for the other bands, the device time of each stage on a batch already on
  the card, from CUDA events (depth_anything_metric: the input resize +
  normalize, the ViT-L core, the DPT head with features, the bins head
  (f32), the antialiased bicubic back to 1080p, the heat; depth_zoedepth: the
  reflect pad, the BEiT-L core, the MiDaS decoder, the bins head (f32) and
  the bicubic back, each over both passes; depth_patchfusion: the coarse
  pass, then on one batch of 8 tiles the fine core, its projections, the
  ROIs and fusion convs, UNet + G2L and the bins head, and the whole frame;
  depth_midas (DPT_Large, midas3): the input resize + normalize, the
  ViT-L/16, the MiDaS decoder, the bicubic back, the heat; depth_marigold:
  the resize to 768 and the VAE encode, one UNet call over the 10 members
  and all 10, the VAE decode, the ensembling (BFGS, medians), the epilogue,
  the whole frame; mask: preprocess,
  ResNet-101, FPN, head, the eight frames' slabs (top-K, dynamic convs,
  matrix NMS, the upsample to 1080p), composite and SDF;
  flow_gmflow_refine: input resize, the 2-scale backbone, the 1/8 scale's
  transformer, matching and propagation, the flow upsample and warp, the
  1/4 scale's transformer, local matching and local propagation, upsampler
  + convex x4, the epilogue;
  flow_raft: input resize, fnet + cnet, the correlation pyramid, the 20
  iterations' K5 lookup, motion encoder, GRU and flow head, mask head +
  convex upsample, the epilogue);
- torch.profiler's device time per step, grouped by kernel family (K1 to
  K6, GEMM, convolution, host copies, the rest), and the share of the step
  the card is busy. The full per-kernel table goes to --out.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import time

import numpy as np
import torch

from prisma_tpu_torch.ops.resize import resize2d_nchw
from prisma_tpu_torch.runtime.config import RuntimeConfig

BATCH, FRAME_HW = 8, (1080, 1920)
FLOW_SCALE = 0.75


def cuda_ms(fn, iters: int = 5) -> float:
    """Mean device time of fn over iters calls, from CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_family(name: str) -> str:
    """The family of a device kernel, by the symbol each kernel of the port
    carries (flash_fwd K1, flash_region K2, flash_streamed K3,
    instance_norm_relu K4, raft_window_lookup K5, lane_gather K6a,
    minor_transpose K6b)."""
    low = name.lower()
    for symbol, family in (("flash_region", "K2 flash attention, region bias"),
                           ("flash_streamed", "K3 streamed global attention"),
                           ("flash_fwd", "K1 flash attention"),
                           ("instance_norm_relu", "K4 instance norm"),
                           ("raft_window_lookup", "K5 RAFT window lookup"),
                           ("lane_gather", "K6a lane gather"),
                           ("minor_transpose", "K6b minor transpose")):
        if symbol in low:
            return family
    if name.startswith("Memcpy"):
        return "host copies (" + name.split()[1] + ")"
    if any(s in low for s in ("fprop", "cudnn", "nhwc", "conv")):
        return "convolution (cuDNN)"
    if any(s in low for s in ("gemm", "nvjet", "cutlass", "magma", "cublas")):
        return "GEMM"
    return "elementwise, reductions, device copies"


def depth_anything_step(runtime: RuntimeConfig, frames: np.ndarray):
    """-> (step, None): the stages come from the step's spans."""
    from prisma_tpu_torch.bands import depth_anything_band, depth_base

    model, infer, flip = depth_anything_band.build_infer(runtime,
                                                         encoder="vitl")
    step = depth_base.make_step(model, infer, flip, need_depth=False)
    step(frames)  # warm-up: builds the kernel, cuDNN and cuBLAS choices
    return step, None


def depth_anything_metric_step(runtime: RuntimeConfig, frames: np.ndarray):
    """-> (step, {stage: device ms on the batch already on the card}): the
    metric model (ViT-L core at 392x518, bins head in f32), as process.py
    runs it."""
    from prisma_tpu_torch.bands import depth_anything_band, depth_base
    from prisma_tpu_torch.models import dpt, vit
    from prisma_tpu_torch.models import zoedepth as zoe
    from prisma_tpu_torch.ops import encode as enc

    model, infer, flip = depth_anything_band.build_infer(
        runtime, encoder="vitl", metric="outdoor")
    step = depth_base.make_step(model, infer, flip, need_depth=False)
    step(frames)  # warm-up
    H, W = frames.shape[1:3]
    x = torch.from_numpy(frames).cuda()
    core = model.core.core
    size = infer.keywords["img_size"]
    ph, pw = (s // core.pretrained.cfg.patch_size for s in size)
    dtype = runtime.resolve_dtype()

    def prepare():
        return zoe.prepare(x, size, dtype)

    with torch.inference_mode():
        img = prepare()
        feats = vit.get_intermediate_layers(core.pretrained, img, n=4)
        rel, cf = dpt.dpt_head(core.depth_head, feats, ph, pw,
                               return_features=True)
        metric = zoe.bins_head(model, rel, cf)
        depth = infer(model, x)
        stages = {
            "input resize + normalize": cuda_ms(prepare),
            "ViT-L core (24 K1)": cuda_ms(lambda: vit.get_intermediate_layers(
                core.pretrained, img, n=4)),
            "DPT head with features": cuda_ms(lambda: dpt.dpt_head(
                core.depth_head, feats, ph, pw, return_features=True)),
            "bins head (f32)": cuda_ms(lambda: zoe.bins_head(model, rel, cf)),
            "antialiased bicubic to 1080p": cuda_ms(lambda: resize2d_nchw(
                metric, (H, W), method="cubic_aa")),
            "heat epilogue": cuda_ms(lambda: enc.depth_heat(depth, flip)),
        }
    return step, stages


def mask_step(runtime: RuntimeConfig, frames: np.ndarray):
    """-> (step, {stage: device ms on the batch already on the card}): the
    mask band's step with the SDF, as process.py runs it."""
    from prisma_tpu_torch.bands import mask_band
    from prisma_tpu_torch.models import resnet, solov2
    from prisma_tpu_torch.ops.cuda import mask_epilogue

    H, W = frames.shape[1:3]
    model = mask_band.load_model(runtime)
    step = mask_band._make_step(model, (H, W),
                                mask_band.CONFIDENCE_THRESHOLD, sdf=True)
    step(frames)  # warm-up
    cfg = model.cfg
    x = torch.from_numpy(frames).cuda()
    dtype = runtime.resolve_dtype()
    with torch.inference_mode():
        img, hw = solov2.preprocess(x, dtype=dtype, scale=cfg.scale)
        feats = resnet.forward(model.backbone, img)
        fpn = solov2.fpn_forward(model.neck, feats)
        kernels, cls, mask_feats = solov2.head_forward(model.mask_head, fpn, cfg)

        def slabs():
            return [solov2.get_results([k[b:b + 1] for k in kernels],
                                       [c[b:b + 1] for c in cls],
                                       mask_feats[b:b + 1], hw, (H, W), cfg)
                    for b in range(x.shape[0])]

        ids = torch.tensor(mask_band.CLASS_IDS, device=x.device)
        out = slabs()
        masks = [o["masks"] for o in out]
        keep = [mask_band.kept(o, mask_band.CONFIDENCE_THRESHOLD, ids)
                for o in out]
        marked = mask_epilogue.kept_composite(masks, keep)[1]
        stages = {
            "preprocess (resize, normalize, pad)": cuda_ms(
                lambda: solov2.preprocess(x, dtype=dtype, scale=cfg.scale)),
            "ResNet-101": cuda_ms(lambda: resnet.forward(model.backbone, img)),
            "FPN": cuda_ms(lambda: solov2.fpn_forward(model.neck, feats)),
            "head (mask features, kernel and class branches)": cuda_ms(
                lambda: solov2.head_forward(model.mask_head, fpn, cfg)),
            f"{x.shape[0]} slabs (top-K, dynamic convs, matrix NMS, "
            "upsample to 1080p)": cuda_ms(slabs, 3),
            "kept composite": cuda_ms(
                lambda: mask_epilogue.kept_composite(masks, keep)),
            "SDF green channel": cuda_ms(
                lambda: mask_epilogue.sdf_green(marked)),
        }
    return step, stages


def depth_zoedepth_step(runtime: RuntimeConfig, frames: np.ndarray):
    """-> (step, {stage: device ms on the batch already on the card}):
    ZoeD_N as the fused video step runs it (pad, two passes, BEiT-L at
    384x512, bins head in f32)."""
    import math

    import torch.nn.functional as F

    from prisma_tpu_torch.bands import depth_base, depth_zoedepth_band
    from prisma_tpu_torch.models import beit, midas, zoed
    from prisma_tpu_torch.models import zoedepth as zoe
    from prisma_tpu_torch.ops import encode as enc

    model, infer, flip = depth_zoedepth_band.build_infer(runtime)
    step = depth_base.make_step(model, infer, flip, need_depth=False)
    step(frames)  # warm-up
    H, W = frames.shape[1:3]
    dev = runtime.resolve_device()
    x = torch.from_numpy(frames).to(dev)
    dtype = runtime.resolve_dtype()
    core = model.core.core
    size = zoed.IMG_SIZE
    ph, pw = size[0] // 16, size[1] // 16
    pad_h, pad_w = int(math.sqrt(H / 2) * 3), int(math.sqrt(W / 2) * 3)
    mean = torch.tensor(zoed.IMAGENET_MEAN, device=dev)[:, None, None]
    std = torch.tensor(zoed.IMAGENET_STD, device=dev)[:, None, None]

    def pad():
        img = x.permute(0, 3, 1, 2).float() / 255.0
        return F.pad(img, (pad_w, pad_w, pad_h, pad_h), mode="reflect")

    with torch.inference_mode():
        img = pad()
        inp = ((resize2d_nchw(img, size, method="linear", align_corners=True)
                - mean) / std).to(dtype)
        feats = beit.get_intermediate_layers(core.pretrained.model, inp)
        rel, cf = midas.decoder_forward(core, feats, ph, pw,
                                        return_features=True)
        metric = zoe.bins_head(model, rel, cf)
        depth = infer(model, x)
        t = {"pad": cuda_ms(pad),
             "beit": cuda_ms(lambda: beit.get_intermediate_layers(
                 core.pretrained.model, inp)),
             "decoder": cuda_ms(lambda: midas.decoder_forward(
                 core, feats, ph, pw, return_features=True)),
             "bins": cuda_ms(lambda: zoe.bins_head(model, rel, cf)),
             "back": cuda_ms(lambda: resize2d_nchw(
                 metric[:, None], img.shape[-2:], method="cubic")),
             "infer": cuda_ms(lambda: infer(model, x), 3),
             "heat": cuda_ms(lambda: enc.depth_heat(depth, flip))}
    passes = {"BEiT-L core (x2 passes)": 2 * t["beit"],
              "MiDaS decoder (x2)": 2 * t["decoder"],
              "bins head, f32 (x2)": 2 * t["bins"],
              "bicubic back to the padded size (x2)": 2 * t["back"]}
    return step, {"reflect pad": t["pad"], **passes,
                  "the rest of infer (resize in, normalize, flip, average, "
                  "crop)": t["infer"] - t["pad"] - sum(passes.values()),
                  "heat epilogue": t["heat"]}


def depth_patchfusion_step(runtime: RuntimeConfig, frames: np.ndarray):
    """-> (step, {stage: device ms}): PatchFusion's p49 step on the first
    frame (the video default), stages from one batch of 8 tiles of it."""
    from prisma_tpu_torch.bands import depth_base, depth_patchfusion_band
    from prisma_tpu_torch.models import patchfusion as pf
    from prisma_tpu_torch.models import zoedepth as zoe
    from prisma_tpu_torch.ops import nn as pnn
    from prisma_tpu_torch.ops.resize import resize2d
    from prisma_tpu_torch.ops.roi_align import roi_align

    model, infer, flip = depth_patchfusion_band.build_infer(runtime, mode="p49")
    one = frames[:1]
    band_step = depth_base.make_step(model, infer, flip, need_depth=False,
                                     fused=False)
    band_step(one)  # warm-up

    def step(_frames):
        return band_step(one)

    dtype = runtime.resolve_dtype()
    dev = runtime.resolve_device()
    mh, mw = model.model_hw
    lv = pf.level_hw(model.model_hw)
    x = torch.from_numpy(one).to(dev)
    resolution = pf.pick_resolution(*one.shape[1:3])
    crop = (resolution[0] // 4, resolution[1] // 4)
    tiles = pf.tile_passes("p49", resolution, crop)[0][:8]
    areas, bboxes = pf._pass_areas(tuple(tiles), resolution, crop,
                                   model.model_hw)
    bbox = torch.tensor(bboxes, device=dev)
    area = torch.tensor(areas[:, None], device=dev)
    zeros = torch.zeros(len(tiles), dtype=torch.long, device=dev)
    with torch.inference_mode():
        img_t = resize2d(x.float() / 255.0, resolution, method="cubic",
                         align_corners=True)[0].permute(2, 0, 1)
        img_lr = resize2d_nchw(img_t[None], model.model_hw, method="linear",
                               align_corners=True).to(dtype)
        crops = pf._crop_resize(img_t, tiles, crop, model.model_hw).to(dtype)
        coarse = pf.coarse_pass(model, img_lr)
        fine_depth, hooks = pf.zoedepth_custom_forward(model.fine_model,
                                                       pf._normalize(crops))
        fine_feats = pf._proj6(model.fine_input_proj, hooks)
        hh, hw = coarse[1].shape[-2:]
        scale = torch.tensor([hw / mw, hh / mh, hw / mw, hh / mh],
                             device=dev)

        def rois_fusion():
            rois = [roi_align(coarse[0][i], bbox, zeros, lv[i],
                              lv[i][0] / mh, pf._roi_sampling(lv[i][0], mh))
                    for i in range(6)]
            whole = roi_align(coarse[1], bbox * scale, zeros, (mh, mw), 1.0, 5)
            guides = [pnn.conv2d(model.fusion_conv_list[i], torch.cat(
                [rois[i], fine_feats[i]], 1), padding=1) for i in range(6)]
            return whole.to(dtype), guides

        whole, guides = rois_fusion()
        inp = torch.cat([whole, fine_depth[:, None].to(dtype), crops], 1)
        areas_lv = [resize2d_nchw(area, hw2, method="linear",
                                  align_corners=True).to(dtype) for hw2 in lv]

        def unet():
            return pf.unet_v1(model.fusion_extractor, inp, guides, coarse[0],
                              areas_lv, bbox, model.model_hw)

        out = unet()
        zero_cond = torch.zeros_like(out[5][:, :1], dtype=torch.float32)
        t = {"coarse": cuda_ms(lambda: pf.coarse_pass(model, img_lr), 3),
             "fine": cuda_ms(lambda: pf.zoedepth_custom_forward(
                 model.fine_model, pf._normalize(crops)), 3),
             "proj": cuda_ms(lambda: pf._proj6(model.fine_input_proj, hooks)),
             "rois": cuda_ms(rois_fusion, 3),
             "unet": cuda_ms(unet, 3),
             "bins": cuda_ms(lambda: zoe.bins_from_bottleneck(
                 model, out[0], out[1:5], out[5], zero_cond), 3),
             "frame": cuda_ms(lambda: infer(model, x), 1)}
    batch = t["fine"] + t["proj"] + t["rois"] + t["unet"] + t["bins"]
    return step, {
        "coarse pass (BEiT-L, decoder, bins, projections, HR upsample)":
            t["coarse"],
        "fine core, a batch of 8 tiles": t["fine"],
        "fine projections, a batch": t["proj"],
        "ROIs + fusion convs, a batch": t["rois"],
        "UNet + G2L, a batch": t["unet"],
        "bins head (f32), a batch": t["bins"],
        "the whole p49 frame": t["frame"],
        "prep + accumulation + the rest (frame - coarse - 49/8 batches)":
            t["frame"] - t["coarse"] - 49 / 8 * batch}


def _gmflow_setup(runtime: RuntimeConfig, frames: np.ndarray, cfg):
    """The GMFlow band's step for cfg, warmed up, and its inputs on the
    card: -> (model, infer, step, (x, ds, xin, B), stage helpers). x: the
    uint8 frames; ds: resized to the band's scale; xin: the backbone's
    normalised, padded NCHW input of the 2B images; the helpers time the
    shared stages: input resize, upsampler + convex upsample, epilogue."""
    import torch.nn.functional as F

    from prisma_tpu_torch.bands import flow_base, flow_gmflow_band
    from prisma_tpu_torch.models import gmflow as gm
    from prisma_tpu_torch.models import raft
    from prisma_tpu_torch.ops import encode as enc
    from prisma_tpu_torch.ops import nn as pnn
    from prisma_tpu_torch.ops.flow import compute_fwdbwd_mask
    from prisma_tpu_torch.ops.resize import resize2d

    lazy_model, infer = flow_gmflow_band.build_pairs(runtime, cfg=cfg)
    model = lazy_model().to(device=runtime.resolve_device(),
                            dtype=runtime.resolve_dtype())
    H, W = frames.shape[1:3]
    dh, dw = round(H * FLOW_SCALE), round(W * FLOW_SCALE)
    step = flow_base.make_flow_step(model, infer, (dh, dw), need_masks=True,
                                    need_flow=True)
    step(frames)  # warm-up

    dtype = runtime.resolve_dtype()
    x = torch.from_numpy(frames).to(runtime.resolve_device())
    with torch.inference_mode():
        ds = resize2d(x.float(), (dh, dw), method="cubic").to(dtype)
        i1, _ = raft.pad_to_multiple(ds[:-1], model.cfg.padding_factor)
        i2, _ = raft.pad_to_multiple(ds[1:], model.cfg.padding_factor)
        mean = torch.tensor(gm.IMAGENET_MEAN, dtype=dtype, device=x.device)
        std = torch.tensor(gm.IMAGENET_STD, dtype=dtype, device=x.device)
        xin = ((torch.cat([i1, i2]) / 255.0 - mean) / std).permute(0, 3, 1, 2) \
            .contiguous()
        fwd, bwd = (f.float() for f in infer(model, ds[:-1], ds[1:]))

    def resize():
        return resize2d(x.float(), (dh, dw), method="cubic")

    def upsample(flow, feature):
        concat = torch.cat([flow, feature], dim=-1).permute(0, 3, 1, 2)
        y = F.relu(pnn.conv2d(model.upsampler[0], concat, padding=1))
        mask = pnn.conv2d(model.upsampler[2], y).permute(0, 2, 3, 1)
        return raft.convex_upsample(flow, mask, model.cfg.upsample_factor)

    def epilogue():
        enc.process_flow(fwd)
        enc.process_flow(bwd)
        compute_fwdbwd_mask(fwd, bwd)

    return model, infer, step, (x, ds, xin, i1.shape[0]), \
        (resize, upsample, epilogue)


def _rest_of_infer(stages: dict, total: float) -> dict:
    """stages with infer_pairs' time outside the timed stages added."""
    stages["the rest of infer_pairs (pad, position, casts)"] = total - sum(
        v for k, v in stages.items() if not k.startswith(("input", "HSV")))
    return stages


def flow_gmflow_step(runtime: RuntimeConfig, frames: np.ndarray):
    """-> (step, None): the band's step over 7 bidirectional pairs with
    masks and flows returned; the stages come from the step's spans."""
    from prisma_tpu_torch.bands import flow_base, flow_gmflow_band

    lazy_model, infer = flow_gmflow_band.build_pairs(runtime)
    H, W = frames.shape[1:3]
    step = flow_base.build_flow_step(lazy_model(), infer, FLOW_SCALE, W, H,
                                     runtime, backwards=True, mask=True)
    step(frames)  # warm-up
    return step, None


def flow_gmflow_refine_step(runtime: RuntimeConfig, frames: np.ndarray):
    """-> (step, {stage: device ms on the window already on the card}): the
    band's --num_scales 2 step over 7 bidirectional pairs with masks and
    flows returned."""
    from prisma_tpu_torch.models import gmflow as gm
    from prisma_tpu_torch.ops.resize import resize2d

    cfg = gm.refine_config()
    model, infer, step, (x, ds, xin, B), (resize, upsample, epilogue) = \
        _gmflow_setup(runtime, frames, cfg)
    dtype = runtime.resolve_dtype()
    (s0, s1), (_, r1), (_, p1) = cfg.scale_lists()
    with torch.inference_mode():
        lo, hi = (f.permute(0, 2, 3, 1)
                  for f in gm.backbone_forward(model.backbone, xin))
        f0, f1 = gm.add_position(lo[:B], lo[B:], s0)
        t0, t1 = gm.transformer_forward(model.transformer, f0, f1, s0)
        flow = gm.global_correlation_softmax(t0, t1, True).to(dtype)
        both = torch.cat([t0, t1])
        prop = gm.flow_propagation(model.feature_flow_attn, both, flow)
        g0, g1 = torch.cat([hi[:B], hi[B:]]), torch.cat([hi[B:], hi[:B]])

        def up_warp():
            up = (resize2d(prop.float(), g0.shape[1:3], method="linear",
                           align_corners=True) * 2.0).to(dtype)
            return up, gm._flow_warp(g1, up)

        up, w1 = up_warp()
        h0, h1 = gm.add_position(g0, w1, s1)
        u0, u1 = gm.transformer_forward(model.transformer, h0, h1, s1)
        flow1 = up + gm.local_correlation_softmax(u0, u1, r1)
        prop1 = gm.flow_propagation_local(model.feature_flow_attn, u0, flow1,
                                          p1)
        stages = {
            "input resize (cubic, f32)": cuda_ms(resize),
            "backbone, 2 scales (convs + 15 K4)": cuda_ms(
                lambda: gm.backbone_forward(model.backbone, xin)),
            "1/8 transformer (6 K1 + 6 K2)": cuda_ms(
                lambda: gm.transformer_forward(model.transformer, f0, f1, s0)),
            "1/8 global matching (2 K3)": cuda_ms(
                lambda: gm.global_correlation_softmax(t0, t1, True)),
            "1/8 propagation (1 K3)": cuda_ms(
                lambda: gm.flow_propagation(model.feature_flow_attn, both,
                                            flow)),
            "flow upsample x2 + warp": cuda_ms(up_warp),
            "1/4 transformer (6 K1 + 6 K2)": cuda_ms(
                lambda: gm.transformer_forward(model.transformer, h0, h1, s1)),
            "1/4 local matching (r=4)": cuda_ms(
                lambda: gm.local_correlation_softmax(u0, u1, r1)),
            "1/4 local propagation (r=1)": cuda_ms(
                lambda: gm.flow_propagation_local(model.feature_flow_attn,
                                                  u0, flow1, p1)),
            "upsampler + convex x4": cuda_ms(lambda: upsample(prop1, u0)),
            "HSV + consistency epilogue": cuda_ms(epilogue),
        }
        total = cuda_ms(lambda: infer(model, ds[:-1], ds[1:]))
    return step, _rest_of_infer(stages, total)


def flow_raft_step(runtime: RuntimeConfig, frames: np.ndarray):
    """-> (step, {stage: device ms on the window already on the card}): the
    band's step over 7 bidirectional pairs, 20 iterations, with masks and
    flows returned. A refinement stage is timed once on its real inputs and
    counted 20 times."""
    import torch.nn.functional as F

    from prisma_tpu_torch.bands import flow_base, flow_raft_band
    from prisma_tpu_torch.models import raft
    from prisma_tpu_torch.ops import encode as enc
    from prisma_tpu_torch.ops.flow import compute_fwdbwd_mask
    from prisma_tpu_torch.ops.resize import resize2d

    iters = flow_raft_band.ITERATIONS
    lazy_model, infer = flow_raft_band.build_pairs(runtime, iterations=iters)
    model = lazy_model().to(device=runtime.resolve_device(),
                            dtype=runtime.resolve_dtype())
    H, W = frames.shape[1:3]
    dh, dw = round(H * FLOW_SCALE), round(W * FLOW_SCALE)
    step = flow_base.make_flow_step(model, infer, (dh, dw), need_masks=True,
                                    need_flow=True)
    step(frames)  # warm-up

    dtype = runtime.resolve_dtype()
    cfg = model.cfg
    ub = model.update_block
    x = torch.from_numpy(frames).to(runtime.resolve_device())
    with torch.inference_mode():
        ds = resize2d(x.float(), (dh, dw), method="cubic").to(dtype)
        i1, _ = raft.pad_to_multiple(ds[:-1])
        i2, _ = raft.pad_to_multiple(ds[1:])
        B = i1.shape[0]
        a = torch.cat([i1, i2])
        xin = (2.0 * (a / 255.0) - 1.0).permute(0, 3, 1, 2).contiguous()

        def encoders():
            fm = raft.encoder_forward(model.fnet, xin)
            return fm, raft.encoder_forward(model.cnet, xin)

        fm, cnet = encoders()
        fmap2 = torch.cat([fm[B:], fm[:B]])
        pyramid = raft.build_corr_pyramid(fm, fmap2, cfg.corr_levels)
        net = torch.tanh(cnet[:, :cfg.hidden_dim])
        inp = F.relu(cnet[:, cfg.hidden_dim:])
        gru = raft.gru_weights(ub.gru)
        coords = raft.coords_grid(2 * B, *fm.shape[-2:], fm.device)
        coords = coords + torch.randn_like(coords)  # a moved flow field
        flow = (coords - raft.coords_grid(2 * B, *fm.shape[-2:], fm.device))
        flow = flow.to(dtype).permute(0, 3, 1, 2)
        corr = raft.corr_lookup(pyramid, coords, cfg.corr_radius)
        corr = corr.permute(0, 3, 1, 2)
        motion = raft.motion_encoder(ub.encoder, flow, corr)
        gru_in = torch.cat([inp, motion], dim=1)
        net1 = raft.sep_conv_gru(gru, net, gru_in)
        flow_low = flow.float().permute(0, 2, 3, 1)

        def upsample():
            mask = raft.mask_head(ub.mask, net1).float().permute(0, 2, 3, 1)
            return raft.convex_upsample(flow_low, mask)

        fwd, bwd = (f.float() for f in infer(model, ds[:-1], ds[1:]))

        def epilogue():
            enc.process_flow(fwd)
            enc.process_flow(bwd)
            compute_fwdbwd_mask(fwd, bwd)

        per_iter = {
            "K5 lookup": cuda_ms(lambda: raft.corr_lookup(pyramid, coords,
                                                          cfg.corr_radius)),
            "motion encoder": cuda_ms(lambda: raft.motion_encoder(
                ub.encoder, flow, corr)),
            "GRU": cuda_ms(lambda: raft.sep_conv_gru(gru, net, gru_in)),
            "flow head": cuda_ms(lambda: raft.flow_head(ub.flow_head, net1)),
        }
        stages = {
            "input resize (cubic, f32)": cuda_ms(
                lambda: resize2d(x.float(), (dh, dw), method="cubic")),
            "fnet + cnet (convs, 15 K4)": cuda_ms(encoders),
            "correlation pyramid (4 matmuls)": cuda_ms(
                lambda: raft.build_corr_pyramid(fm, fmap2, cfg.corr_levels), 3),
            **{f"{iters} x {k} ({v:.2f} ms each)": iters * v
               for k, v in per_iter.items()},
            "mask head + convex x8": cuda_ms(upsample),
            "HSV + consistency epilogue": cuda_ms(epilogue),
        }
        total = cuda_ms(lambda: infer(model, ds[:-1], ds[1:]), 3)
    stages["the rest of infer_pairs (pad, loop glue, casts)"] = total - sum(
        v for k, v in stages.items() if not k.startswith(("input", "HSV")))
    return step, stages


def depth_midas_step(runtime: RuntimeConfig, frames: np.ndarray):
    """-> (step, {stage: device ms on the batch already on the card}):
    DPT_Large (midas3) as the fused video step runs it (384x224 at 1080p:
    24x14 patches + cls, 24 K1 a step)."""
    from prisma_tpu_torch.bands import depth_base, depth_midas_band
    from prisma_tpu_torch.models import midas, vit
    from prisma_tpu_torch.ops import encode as enc

    model, infer, flip = depth_midas_band.build_infer(runtime, "midas3")
    step = depth_base.make_step(model, infer, flip, need_depth=False)
    step(frames)  # warm-up
    dtype = runtime.resolve_dtype()
    x = torch.from_numpy(frames).cuda()
    v = model.pretrained.model
    with torch.inference_mode():
        img = midas.prepare(x, dtype)
        depth = infer(model, x)
        t = {"prepare": cuda_ms(lambda: midas.prepare(x, dtype)),
             "vit": cuda_ms(lambda: vit.get_intermediate_layers(
                 v, img, indices=midas.hooks(model), norm=False,
                 pos_embed_method="linear")),
             "model": cuda_ms(lambda: midas.forward(model, img)),
             "infer": cuda_ms(lambda: infer(model, x)),
             "heat": cuda_ms(lambda: enc.depth_heat(depth, flip))}
    return step, {"input resize + normalize": t["prepare"],
                  "ViT-L/16 (24 K1)": t["vit"],
                  "MiDaS decoder": t["model"] - t["vit"],
                  "bicubic back": t["infer"] - t["prepare"] - t["model"],
                  "heat epilogue": t["heat"]}


def depth_marigold_step(runtime: RuntimeConfig, frames: np.ndarray):
    """-> (step, {stage: device ms}): Marigold on the first frame, 10 DDIM
    steps x 10 members at 768 (768x432, a 96x54 latent)."""
    from prisma_tpu_torch.bands import depth_base, depth_marigold_band
    from prisma_tpu_torch.models import marigold as mg
    from prisma_tpu_torch.models import sd2
    from prisma_tpu_torch.ops.resize import resize2d

    band = depth_marigold_band
    model, infer, flip = band.build_infer(runtime)
    one = frames[:1]
    band_step = depth_base.make_step(model, infer, flip, need_depth=False,
                                     fused=False)
    band_step(one)  # warm-up

    def step(_frames):
        return band_step(one)

    dtype = runtime.resolve_dtype()
    H, W = one.shape[1:3]
    w2, h2 = mg.processing_size(W, H, band.PROCESSING_RESOLUTION)
    E, steps = band.ENSEMBLE_SIZE, band.DENOISE_STEPS
    x = torch.from_numpy(one).cuda()

    def encode():
        rgb = resize2d(x[:1].float() / 255.0, (h2, w2), method="cubic_aa")
        return sd2.vae_encode(model.vae, rgb.to(dtype).permute(0, 3, 1, 2))

    with torch.inference_mode():
        rgb_latent = encode() * mg.RGB_LATENT_SCALE
        lat = mg.member_latents(0, E, (4, h2 // 8, w2 // 8), "cuda").to(dtype)
        unet_in = torch.cat([rgb_latent.expand(E, -1, -1, -1), lat], 1)
        ctx = model.empty_text_embed.to(dtype).expand(E, -1, -1)
        tb = torch.full((E,), 501, dtype=torch.int32, device="cuda")
        preds = (sd2.vae_decode(model.vae, lat).float().mean(1)
                 .clamp(-1, 1) + 1) / 2
        aligned, _ = mg.ensemble_depths_device(preds)
        t = {"encode": cuda_ms(encode, 3),
             "unet": cuda_ms(lambda: sd2.unet_forward(model.unet, unet_in, tb,
                                                      ctx), 3),
             "decode": cuda_ms(lambda: sd2.vae_decode(
                 model.vae, lat / mg.DEPTH_LATENT_SCALE), 2),
             "ensemble": cuda_ms(lambda: mg.ensemble_depths_device(preds), 2),
             "epilogue": cuda_ms(lambda: mg.epilogue(aligned, (H, W))),
             "frame": cuda_ms(lambda: infer(model, x), 1)}
    return step, {
        "resize to 768 + VAE encode": t["encode"],
        f"one UNet call, {E} members": t["unet"],
        f"{steps} UNet calls": steps * t["unet"],
        f"VAE decode, {E} members": t["decode"],
        "ensembling (BFGS, medians)": t["ensemble"],
        "epilogue (rescale, bicubic AA to 1080p)": t["epilogue"],
        "the whole frame": t["frame"],
        "the rest (DDIM updates, casts, latents)":
            t["frame"] - t["encode"] - steps * t["unet"] - t["decode"]
            - t["ensemble"] - t["epilogue"]}


def span_stages(prof, steps: int) -> tuple[dict, float]:
    """({prisma.* range: device ms a step}, all device ms a step) of a
    profile: each kernel, copy and set on the card goes to every prisma.*
    range open on its launching thread when the CUDA runtime or driver call
    of its correlation id was made. (key_averages() puts a kernel under the
    torch operator that launched it, and so misses the port's kernels,
    launched through ctypes outside any operator.)"""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    ranges = [(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
              for e in events
              if e.device_type() == cpu and e.name().startswith("prisma.")]
    launches = {e.correlation_id(): (e.start_ns(), e.start_thread_id())
                for e in events
                if e.device_type() == cpu and e.name().startswith("cu")}
    out: dict[str, float] = {}
    total = 0.0
    for e in events:
        if e.device_type() != cuda or e.is_user_annotation() \
                or e.name().startswith("prisma."):
            continue
        ms = (e.end_ns() - e.start_ns()) / 1e6 / steps
        total += ms
        if e.correlation_id() not in launches:
            continue
        t, thread = launches[e.correlation_id()]
        for name, start, end, th in ranges:
            if th == thread and start <= t <= end:
                out[name] = out.get(name, 0.0) + ms
    return out, total


def print_span_stages(prof, steps: int) -> None:
    """The step's stages from its spans, the model's ranges under
    prisma.step.model, and the stages' sum against the device time."""
    ms, device = span_stages(prof, steps)
    stages = [k for k in ("prisma.step.inputs", "prisma.step.model",
                          "prisma.step.epilogue", "prisma.step.outputs")
              if k in ms]
    print("stages from the step's spans (device time launched in each, per "
          "step):")
    for k in stages:
        print(f"  {k:<42} {ms[k]:8.2f} ms")
        if k == "prisma.step.model":
            for m in sorted(n for n in ms if n.startswith("prisma.model.")):
                print(f"    {m:<40} {ms[m]:8.2f} ms")
    total = sum(ms[k] for k in stages)
    print(f"  the stages together {total:.2f} ms; prisma.step "
          f"{ms.get('prisma.step', 0.0):.2f} ms; the profile's device time "
          f"{device:.2f} ms ({100 * total / device:.1f}%)")


# band: (step builder, unit, items a step)
STEPS = {"depth_anything": (depth_anything_step, "frames", BATCH),
         "depth_anything_metric": (depth_anything_metric_step, "frames", BATCH),
         "depth_marigold": (depth_marigold_step, "frames", 1),
         "depth_midas": (depth_midas_step, "frames", BATCH),
         "depth_patchfusion": (depth_patchfusion_step, "frames", 1),
         "depth_zoedepth": (depth_zoedepth_step, "frames", BATCH),
         "mask": (mask_step, "frames", BATCH),
         "flow_gmflow": (flow_gmflow_step, "pairs", BATCH - 1),
         "flow_gmflow_refine": (flow_gmflow_refine_step, "pairs", BATCH - 1),
         "flow_raft": (flow_raft_step, "pairs", BATCH - 1)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--band", choices=sorted(STEPS), default="depth_anything")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/profile_step.txt")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    runtime = RuntimeConfig(random_weights=True, compute_dtype="bfloat16",
                            device="cuda")
    frames = np.random.default_rng(args.seed).integers(
        0, 256, size=(BATCH, *FRAME_HW, 3), dtype=np.uint8)
    build_step, unit, items = STEPS[args.band]
    step, stages = build_step(runtime, frames)

    times = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step(frames)
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"{args.band} step, host clock, {args.steps} steps of "
          f"{items} {unit}: " + ", ".join(f"{t:.2f}" for t in times)
          + f" ms; mean {np.mean(times):.2f} ms "
          f"({items * 1e3 / np.mean(times):.2f} {unit}/s)")
    if stages is not None:
        print("stages on a batch already on the card (CUDA events): "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in stages.items()))

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(frames)
        host_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    groups: dict[str, float] = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA \
                or evt.key.startswith("prisma."):  # a span's annotation
            continue
        ms = evt.self_device_time_total / 1e3 / args.steps
        fam = kernel_family(evt.key)
        groups[fam] = groups.get(fam, 0.0) + ms
    busy = sum(groups.values())
    print(f"torch.profiler, per step over {args.steps} steps: device time "
          f"{busy:.2f} ms over a {host_ms:.2f} ms step "
          f"({100 * busy / host_ms:.1f}% busy)")
    for fam, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {fam:<42} {ms:8.2f} ms  {100 * ms / busy:5.1f}%")
    if stages is None:
        print_span_stages(prof, args.steps)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(f"{card}\n")
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=100, max_name_column_width=100))
    print(f"per-kernel table: {args.out}")


if __name__ == "__main__":
    main()
