#!/usr/bin/env python3
"""Bring-up check of prisma_tpu_torch on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It drives the port's main path, the Depth-Anything ViT-L video step on uint8
1080p frames at batch 8 (random weights from a seed), through the band's own
entry points, and holds every kernel of that path against its plain PyTorch
version. Each phase prints a line; a failed phase ends the run with a
non-zero exit. Without a CUDA device it exits non-zero at once.

  1. environment: torch and CUDA versions, the card's name and power limit
  2. build: the kernels from prisma_tpu_torch/csrc/ with nvcc
  3. K1 flash attention against its plain version on the card, four shapes,
     and both timed at the main-path shape with CUDA events
  4. a tiny Depth-Anything in f32 with TF32 off on the card against the CPU
  5. the main path at full width: counts the kernel's launches, checks the
     outputs, holds K1 to the plain version at every layer of one frame and
     that frame's depth to the plain attention's, prints frames/s

The line before the last is one JSON object describing each kernel of the
path; the last line is {"ok": true, "device": {...}}.
"""

import copy
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
MAIN_SHAPE = (128, 2443, 64)  # ViT-L at 1080p, batch 8: [B*heads, tokens, d]
BATCH, FRAME_HW, TIMED_STEPS = 8, (1080, 1920), 3
ATOL_F32 = 2e-5  # f32 K1 against the plain version: f32 both sides, sums in another order


def k1_error(out, ref):
    """-> (max |err|, mean |err|, max tol, mean tol, ok) of K1's out. bf16 is
    held to `flash_attention.bf16_bounds`, f32 to ATOL_F32."""
    from prisma_tpu_torch.ops.cuda.flash_attention import bf16_bounds
    err = (out.float() - ref.float()).abs()
    max_err, mean_err = float(err.max()), float(err.mean())
    if out.dtype == torch.bfloat16:
        max_tol, mean_tol = bf16_bounds(ref)
    else:
        max_tol = mean_tol = ATOL_F32
    ok = bool(out.isfinite().all()) and max_err <= max_tol \
        and mean_err <= mean_tol
    return max_err, mean_err, max_tol, mean_tol, ok


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, iters, warmup=2):
    """Mean device time of fn over iters launches, from CUDA events."""
    for _ in range(warmup):
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


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: this check runs only on the card")
    sys.path.insert(0, HERE)
    from prisma_tpu_torch.bands import depth_anything_band, depth_base
    from prisma_tpu_torch.models import depth_anything as da
    from prisma_tpu_torch.models.vit import ViTConfig
    from prisma_tpu_torch.ops import nn as pnn
    from prisma_tpu_torch.ops.cuda import build
    from prisma_tpu_torch.ops.cuda import flash_attention as fa
    from prisma_tpu_torch.runtime.config import RuntimeConfig
    plain_p_bf16 = functools.partial(fa.flash_attention_ref, round_p=True)

    # 1. environment
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    say("env", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s), "
        f"card: {card}")

    # 2. build
    t0 = time.perf_counter()
    lib_path = build.build("flash_attention")
    build.load("flash_attention")
    with open(lib_path + ".log") as f:
        regs = [ln.split("info    :")[-1].strip() for ln in f
                if "registers" in ln]
    say("build", f"{os.path.relpath(lib_path, HERE)} from "
        f"{os.path.relpath(build.CSRC_DIR, HERE)}/flash_attention.cu in "
        f"{time.perf_counter() - t0:.2f} s; ptxas: {' | '.join(regs)}")

    # 3. K1 against its plain version on the card. bf16 is held to the plain
    # version that rounds P to bf16 before P·V, as K1 does; f32 to the plain
    # version itself.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("k1", "TF32 off for matmul and cuDNN in every f32 comparison")
    say("k1", "tolerances: bf16 against the plain version with P rounded to "
        "bf16 as K1 does, max |err| <= 2 bf16 ulp of max |ref| (the output "
        "rounding, and P rounded at a running max) and mean |err| <= 2^-8 of "
        "mean |ref| (those average out; a lost or unmasked key moves a whole "
        "row); f32 max and mean <= 2e-5 (f32 both sides, sums in another order)")
    rng = np.random.default_rng(0)
    k1 = {}
    for shape, dtype in ((MAIN_SHAPE, torch.bfloat16),
                         ((6, 100, 32), torch.float32),
                         ((6, 100, 32), torch.bfloat16),  # ragged bf16, d=32
                         ((4, 1024, 128), torch.bfloat16)):
        q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                   .to("cuda", dtype) for _ in range(3))
        out = fa.flash_attention(q, k, v)
        ref = (plain_p_bf16 if dtype == torch.bfloat16
               else fa.flash_attention_ref)(q, k, v)
        max_err, mean_err, max_tol, mean_tol, ok = k1_error(out, ref)
        say("k1", f"{list(shape)} {str(dtype)[6:]}: |err| max {max_err:.3e} "
            f"(tol {max_tol:.3e}), mean {mean_err:.3e} (tol {mean_tol:.3e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"K1 disagrees with its plain version at {list(shape)} {dtype}")
        if shape == MAIN_SHAPE:
            B, N, d = shape
            ms = cuda_ms(lambda: fa.flash_attention(q, k, v), 20)
            plain_ms = cuda_ms(lambda: fa.flash_attention_ref(q, k, v), 5)
            tflops = 4 * B * N * N * d / (ms * 1e-3) / 1e12
            k1 = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms)
            say("k1", f"time at {list(shape)} bf16: kernel {ms:.3f} ms "
                f"({tflops:.1f} TFLOP/s), plain {plain_ms:.3f} ms, on {card}")
        del q, k, v, out, ref
    torch.cuda.empty_cache()

    # 4. the slice in f32 on the card (TF32 off) against the CPU
    cfg = ViTConfig(embed_dim=64, depth=4, num_heads=2)
    cpu_model = da.init_params(da.build(cfg, 32, (32, 64, 128, 128)),
                               torch.Generator().manual_seed(0))
    gpu_model = copy.deepcopy(cpu_model).cuda()
    frames = torch.from_numpy(rng.integers(0, 256, size=(2, 64, 96, 3),
                                           dtype=np.uint8))
    with torch.inference_mode():
        d_cpu = da.infer(cpu_model, frames, target=126)
        before = fa.flash_attention.launches
        d_gpu = da.infer(gpu_model, frames.cuda(), target=126).cpu()
    n_launch = fa.flash_attention.launches - before
    err = float((d_gpu - d_cpu).abs().max())
    tol = 1e-4 * float(d_cpu.abs().max())
    ok = n_launch == cfg.depth and bool(torch.isfinite(d_gpu).all()) and err <= tol
    say("f32", f"tiny ViT (64 wide, 4 blocks, 2 heads, DPT 32) 2x64x96 at 126: "
        f"max |depth_gpu - depth_cpu| {err:.3e}, tol {tol:.3e} (1e-4 of the "
        f"depth scale: f32 on both sides, sums in another order); "
        f"{n_launch} K1 launches {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the f32 slice on the card disagrees with the CPU")
    del cpu_model, gpu_model

    # 5. the main path at full width
    t0 = time.perf_counter()
    runtime = RuntimeConfig(random_weights=True, compute_dtype="bfloat16",
                            device="cuda")
    model, infer, flip = depth_anything_band.build_infer(runtime,
                                                         encoder="vitl")
    step = depth_base.make_step(model, infer, flip, need_depth=False)
    frames = rng.integers(0, 256, size=(BATCH, *FRAME_HW, 3), dtype=np.uint8)
    step(frames)  # warm-up
    say("main", f"ViT-L (1024 wide, 24 blocks, 16 heads) + DPT 256 "
        f"(256, 512, 1024, 1024), bf16, random weights: set-up and warm-up "
        f"{time.perf_counter() - t0:.2f} s")
    fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    outs = [step(frames) for _ in range(TIMED_STEPS)]
    elapsed = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    for out in outs:
        heat, dmin, dmax = out["heat"], out["min"], out["max"]
        if heat.shape != (BATCH, *FRAME_HW, 3) or heat.dtype != np.uint8:
            fail(f"heat {heat.shape} {heat.dtype}")
        if not (np.isfinite(dmin).all() and np.isfinite(dmax).all()
                and (dmin < dmax).all()):
            fail(f"per-frame min/max not finite or not min < max: {dmin} {dmax}")
    if launches != 24 * TIMED_STEPS:
        fail(f"K1 launched {launches} times in {TIMED_STEPS} steps, "
             f"expected {24 * TIMED_STEPS}")
    step_ms = elapsed / TIMED_STEPS * 1e3
    say("main", f"{TIMED_STEPS} steps of {BATCH} uint8 {FRAME_HW[0]}x"
        f"{FRAME_HW[1]} frames: heat {list(outs[0]['heat'].shape)} uint8, "
        f"min < max and finite per frame; K1 launches {launches} "
        f"(24 per step) ok")

    say("main", f"{BATCH * TIMED_STEPS / elapsed:.2f} frames/s "
        f"({step_ms:.1f} ms per batch-8 step, host clock, H2D and D2H "
        f"included; K1 {24 * k1['ms']:.1f} ms of it at its own time) "
        f"on {card}")

    # One frame through the same model, first with K1 held to the plain
    # version with P rounded to bf16 at every layer, on the layer's real
    # activations and with phase 3's bounds; then with the plain attention
    # in place of K1. bf16 activations run through 24 random blocks, so
    # last-bit differences grow at scattered pixels. The yardstick is the
    # plain attention with P rounded to bf16: K1's distance to the plain
    # version must stay within twice its distance in mean, 99.9th percentile
    # and max.
    layers = []

    def k1_checked(q, k, v):
        out = fa.flash_attention(q, k, v)
        max_err, mean_err, max_tol, mean_tol, ok = k1_error(out, plain_p_bf16(q, k, v))
        layers.append((max_err / max_tol, mean_err / mean_tol, ok))
        return out

    x1 = torch.from_numpy(frames[:1]).cuda()
    depth = {}
    with torch.inference_mode():
        for name, attn in (("k1", k1_checked),
                           ("plain", fa.flash_attention_ref),
                           ("plain_p_bf16", plain_p_bf16)):
            pnn.flash_attention = attn
            try:
                depth[name] = infer(model, x1)
            finally:
                pnn.flash_attention = fa.flash_attention
    ok = len(layers) == 24 and all(ok for _, _, ok in layers)
    say("main", f"frame 0, K1 against the plain version with P rounded to "
        f"bf16 at each of {len(layers)} layers: worst |err| / tol, max "
        f"{max(r[0] for r in layers):.3f}, mean {max(r[1] for r in layers):.3f}"
        f" {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("K1 disagrees with its plain version on the main path's activations")

    span = float(depth["plain"].max() - depth["plain"].min())

    def stats(name):
        e = (depth[name] - depth["plain"]).abs().flatten() / span
        return (float(e.mean()), float(torch.quantile(e, 0.999)),
                float(e.max()))

    got, null = stats("k1"), stats("plain_p_bf16")
    ok = bool(torch.isfinite(depth["k1"]).all()) and \
        all(g <= 2 * n for g, n in zip(got, null))
    say("main", "frame 0, |depth - depth with the plain attention| / depth "
        "range (mean, 99.9th pct, max): K1 " + ", ".join(f"{g:.3e}" for g in got)
        + "; plain attention with P rounded to bf16 "
        + ", ".join(f"{n:.3e}" for n in null)
        + f"; tol 2x the latter {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the main path with K1 disagrees with the plain attention")

    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "prisma_tpu_torch/csrc/flash_attention.cu",
        "replaces": "prisma_tpu/ops/pallas/flash_attention.py:58",
        "launches": launches, "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
