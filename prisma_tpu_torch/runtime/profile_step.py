"""Where the time of a band's video step goes, on one CUDA card.

    python -m prisma_tpu_torch.runtime.profile_step [--band depth_anything]
        [--steps 5] [--out FILE]

Builds the band's step as chip_smoke.py does (bf16, random weights from a
seed, uint8 1080p frames at batch 8) and prints:

- the host-clock time of whole steps (H2D and D2H included);
- the device time of each stage on a batch already on the card, from CUDA
  events (depth_anything: input resize + normalize, ViT, DPT head, resize
  back, heat; flow_gmflow: input resize, backbone, transformer, global
  matching, propagation, upsampler, the HSV and consistency epilogue);
- torch.profiler's device time per step, grouped by kernel family (K1 to
  K4, GEMM, convolution, host copies, the rest), and the share of the step
  the card is busy. The full per-kernel table goes to --out.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import time

import numpy as np
import torch

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
    instance_norm_relu K4)."""
    low = name.lower()
    for symbol, family in (("flash_region", "K2 flash attention, region bias"),
                           ("flash_streamed", "K3 streamed global attention"),
                           ("flash_fwd", "K1 flash attention"),
                           ("instance_norm_relu", "K4 instance norm")):
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
    """-> (step, {stage: device ms on the batch already on the card})."""
    from prisma_tpu_torch.bands import depth_anything_band, depth_base
    from prisma_tpu_torch.models import depth_anything as da
    from prisma_tpu_torch.models import vit
    from prisma_tpu_torch.ops import encode as enc

    model, infer, flip = depth_anything_band.build_infer(runtime,
                                                         encoder="vitl")
    step = depth_base.make_step(model, infer, flip, need_depth=False)
    step(frames)  # warm-up: builds the kernel, cuDNN and cuBLAS choices
    dtype = runtime.resolve_dtype()
    x = torch.from_numpy(frames).cuda()
    with torch.inference_mode():
        img = da.prepare(x, dtype)
        depth = infer(model, x)
        t = {"prepare": cuda_ms(lambda: da.prepare(x, dtype)),
             "vit": cuda_ms(lambda: vit.get_intermediate_layers(
                 model.pretrained, img, n=4)),
             "model": cuda_ms(lambda: model(img)),
             "infer": cuda_ms(lambda: infer(model, x)),
             "heat": cuda_ms(lambda: enc.depth_heat(depth, flip))}
    return step, {"input resize + normalize": t["prepare"], "ViT-L": t["vit"],
                  "DPT head": t["model"] - t["vit"],
                  "resize back": t["infer"] - t["prepare"] - t["model"],
                  "heat epilogue": t["heat"]}


def flow_gmflow_step(runtime: RuntimeConfig, frames: np.ndarray):
    """-> (step, {stage: device ms on the window already on the card}): the
    band's step over 7 bidirectional pairs with masks and flows returned."""
    import torch.nn.functional as F

    from prisma_tpu_torch.bands import flow_base, flow_gmflow_band
    from prisma_tpu_torch.models import gmflow as gm
    from prisma_tpu_torch.models import raft
    from prisma_tpu_torch.ops import encode as enc
    from prisma_tpu_torch.ops import nn as pnn
    from prisma_tpu_torch.ops.flow import compute_fwdbwd_mask
    from prisma_tpu_torch.ops.resize import resize2d

    lazy_model, infer = flow_gmflow_band.build_pairs(runtime)
    model = lazy_model().to(device=runtime.resolve_device(),
                            dtype=runtime.resolve_dtype())
    H, W = frames.shape[1:3]
    dh, dw = round(H * FLOW_SCALE), round(W * FLOW_SCALE)
    step = flow_base.make_flow_step(model, infer, (dh, dw), need_masks=True,
                                    need_flow=True)
    step(frames)  # warm-up

    dtype = runtime.resolve_dtype()
    cfg = model.cfg
    x = torch.from_numpy(frames).to(runtime.resolve_device())
    with torch.inference_mode():
        ds = resize2d(x.float(), (dh, dw), method="cubic").to(dtype)
        i1, _ = raft.pad_to_multiple(ds[:-1], cfg.padding_factor)
        i2, _ = raft.pad_to_multiple(ds[1:], cfg.padding_factor)
        B = i1.shape[0]
        mean = torch.tensor(gm.IMAGENET_MEAN, dtype=dtype, device=x.device)
        std = torch.tensor(gm.IMAGENET_STD, dtype=dtype, device=x.device)
        xin = ((torch.cat([i1, i2]) / 255.0 - mean) / std).permute(0, 3, 1, 2) \
            .contiguous()
        feats = gm.backbone_forward(model.backbone, xin).permute(0, 2, 3, 1)
        f0, f1 = gm.add_position(feats[:B], feats[B:], cfg.attn_splits)
        t0, t1 = gm.transformer_forward(model.transformer, f0, f1,
                                        cfg.attn_splits)
        flow = gm.global_correlation_softmax(t0, t1, True).to(dtype)
        both = torch.cat([t0, t1])
        prop = gm.flow_propagation(model.feature_flow_attn, both, flow)

        def upsample():
            concat = torch.cat([prop, both], dim=-1).permute(0, 3, 1, 2)
            y = F.relu(pnn.conv2d(model.upsampler[0], concat, padding=1))
            mask = pnn.conv2d(model.upsampler[2], y).permute(0, 2, 3, 1)
            return raft.convex_upsample(prop, mask, cfg.upsample_factor)

        fwd, bwd = (f.float() for f in infer(model, ds[:-1], ds[1:]))

        def epilogue():
            enc.process_flow(fwd)
            enc.process_flow(bwd)
            compute_fwdbwd_mask(fwd, bwd)

        stages = {
            "input resize (cubic, f32)": cuda_ms(
                lambda: resize2d(x.float(), (dh, dw), method="cubic")),
            "backbone (convs + 15 K4)": cuda_ms(
                lambda: gm.backbone_forward(model.backbone, xin)),
            "transformer (6 K1 + 6 K2)": cuda_ms(
                lambda: gm.transformer_forward(model.transformer, f0, f1,
                                               cfg.attn_splits)),
            "global matching (2 K3)": cuda_ms(
                lambda: gm.global_correlation_softmax(t0, t1, True)),
            "propagation (1 K3)": cuda_ms(
                lambda: gm.flow_propagation(model.feature_flow_attn, both,
                                            flow)),
            "upsampler + convex x8": cuda_ms(upsample),
            "HSV + consistency epilogue": cuda_ms(epilogue),
        }
        total = cuda_ms(lambda: infer(model, ds[:-1], ds[1:]))
    stages["the rest of infer_pairs (pad, position, casts)"] = total - sum(
        v for k, v in stages.items() if not k.startswith(("input", "HSV")))
    return step, stages


STEPS = {"depth_anything": (depth_anything_step, "frames"),
         "flow_gmflow": (flow_gmflow_step, "pairs")}


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
    build_step, unit = STEPS[args.band]
    step, stages = build_step(runtime, frames)
    items = BATCH - 1 if unit == "pairs" else BATCH

    times = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step(frames)
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"{args.band} step, host clock, {args.steps} steps of {BATCH} "
          f"frames ({items} {unit}): " + ", ".join(f"{t:.2f}" for t in times)
          + f" ms; mean {np.mean(times):.2f} ms "
          f"({items * 1e3 / np.mean(times):.2f} {unit}/s)")
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
        if evt.device_type != torch.autograd.DeviceType.CUDA:
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

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(f"{card}\n")
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=100, max_name_column_width=100))
    print(f"per-kernel table: {args.out}")


if __name__ == "__main__":
    main()
