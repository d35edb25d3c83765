"""Where the time of the Depth-Anything video step goes, on one CUDA card.

    python -m prisma_tpu_torch.runtime.profile_step [--steps 5] [--out FILE]

Builds the band's step as chip_smoke.py does (ViT-L, bf16, random weights
from a seed, uint8 1080p frames at batch 8) and prints:

- the host-clock time of whole steps (H2D and D2H included);
- the device time of each stage on a batch already on the card, from CUDA
  events: input resize + normalize, ViT, DPT head, resize back, heat;
- torch.profiler's device time per step, grouped by kernel family (K1,
  GEMM, convolution, host copies, the rest), and the share of the step the
  card is busy. The full per-kernel table goes to --out.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import time

import numpy as np
import torch

from prisma_tpu_torch.bands import depth_anything_band, depth_base
from prisma_tpu_torch.models import depth_anything as da
from prisma_tpu_torch.models import vit
from prisma_tpu_torch.ops import encode as enc
from prisma_tpu_torch.runtime.config import RuntimeConfig

BATCH, FRAME_HW = 8, (1080, 1920)


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
    low = name.lower()
    if "flash_fwd" in low:
        return "K1 flash attention"
    if name.startswith("Memcpy"):
        return "host copies (" + name.split()[1] + ")"
    if any(s in low for s in ("fprop", "cudnn", "nhwc", "conv")):
        return "convolution (cuDNN)"
    if any(s in low for s in ("gemm", "nvjet", "cutlass", "magma", "cublas")):
        return "GEMM"
    return "elementwise, reductions, device copies"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
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
    model, infer, flip = depth_anything_band.build_infer(runtime,
                                                         encoder="vitl")
    step = depth_base.make_step(model, infer, flip, need_depth=False)
    frames = np.random.default_rng(args.seed).integers(
        0, 256, size=(BATCH, *FRAME_HW, 3), dtype=np.uint8)
    step(frames)  # warm-up: builds the kernel, cuDNN and cuBLAS choices

    times = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step(frames)
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"step, host clock, {args.steps} steps of {BATCH} frames: "
          + ", ".join(f"{t:.2f}" for t in times) + " ms; mean "
          f"{np.mean(times):.2f} ms ({BATCH * 1e3 / np.mean(times):.2f} "
          f"frames/s)")

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
    stages = {"input resize + normalize": t["prepare"], "ViT-L": t["vit"],
              "DPT head": t["model"] - t["vit"],
              "resize back": t["infer"] - t["prepare"] - t["model"],
              "heat epilogue": t["heat"]}
    print(f"stages on a device-resident batch (CUDA events): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in stages.items())
          + f"; sum {t['infer'] + t['heat']:.2f} ms")

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
