#!/usr/bin/env python3
"""Bring-up check of prisma_tpu_torch on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It drives the port's three main paths through the bands' own entry points,
with random weights from a seed: the Depth-Anything ViT-L video step on
uint8 1080p frames at batch 8, and the GMFlow and RAFT flow steps on the
same frames (7 bidirectional pairs at 810x1440, masks on), and the two probe
kernels as their probe ran them. It holds every kernel against its plain
PyTorch version. Each phase prints a line; a
failed phase ends the run with a non-zero exit. Without a CUDA device it
exits non-zero at once.

  1. env: torch and CUDA versions, the card's name and power limit
  2. build: every kernel of prisma_tpu_torch/csrc/, one nvcc each, together
  3. k1: K1 flash attention against its plain version, four shapes; kernel,
     plain, library call and bound at the ViT-L shape
  4. f32: a tiny Depth-Anything in f32 with TF32 off on the card against
     the CPU
  5. main: the Depth-Anything path at full width (K1 launches counted,
     outputs checked, K1 held to the plain version at every layer of one
     frame, that frame's depth to the plain attention's), frames/s
  6. k2: K2 (the shifted-window region bias) against its plain version at
     the GMFlow window shape and two ragged cases; the bound shown to fail
     with the band moved by one token row; K1 and K2 times at that shape
  7. k3: K3 (streamed global attention) at the matching and propagation
     shapes and a ragged key count; the bound shown to fail with the
     ragged tail unmasked; times
  8. k4: K4 (instance norm) at the largest backbone norm and a ragged f32
     case; the f32 bound shown to fail on an eps and a ddof slip; times
  9. gmflow-f32: a small-image GMFlow (full 128 channels, 6 layers) in f32
     with TF32 off on the card against the CPU, each kernel launched
 10. flow: the GMFlow path at full width: launches of K1-K4 per step
     counted, outputs checked, pairs/s; then on one pair's real
     activations every kernel call held to its plain version, and the flow
     held within 2x the null distance of a plain path that rounds P as
     K1/K2 do
 11. k5: K5 (RAFT's window lookup) against its plain version on the
     pyramid of seeded bf16 fmaps at the RAFT main shape, centres off the
     plane and not finite among them, and on a ragged f32 pyramid; the
     bounds shown to fail on three deliberate faults; kernel, plain,
     grid_sample and bound times
 12. raft-f32: a small-image RAFT (full widths, 4 iterations) in f32 with
     TF32 off on the card against the CPU
 13. raft: the RAFT path at full width (20 iterations): launches of K4 and
     K5 per step counted, outputs checked, pairs/s; then on one pair's real
     activations every K4 and K5 call held to its plain version, and the
     flow held within 2x the null distance of a plain path whose lookup
     blends in bf16 as the JAX package does
 14. k6: the probe kernels K6a (lane gather) and K6b (minor transpose) at
     the probe's shapes in f32 and bf16, equal to their plain versions;
     times

The line before the last is one JSON object describing each kernel of the
paths; the last line is {"ok": true, "device": {...}}.
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
FLOW_HW, FEAT_HW = (810, 1440), (102, 180)  # 0.75x 1080p; its 1/8 features (/16 pad)
WIN_SHAPE = (56, 4590, 128)    # 7 pairs doubled x 4 windows of 51x90 tokens, C=128
MATCH_SHAPE = (7, 18360, 128)  # global matching: 7 pairs, 102x180 tokens
NORM_SHAPE = (14, 64, 408, 720)  # the backbone's largest instance norm
ATOL_F32 = 2e-5  # f32 K1/K2 against the plain version: sums in another order
RAFT_ITERS = 20
K5_OFFSET = 40.0  # K5's test centres: the pixel grid plus up to this many px
PEAK_BF16, PEAK_F32, HBM_BYTES_S, SFU_PER_CLOCK_SM = 989e12, 67e12, 3.35e12, 16


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


def library_ms(fn, iters=10):
    """cuda_ms of one PyTorch call, or None where no backend takes it."""
    try:
        return cuda_ms(fn, iters)
    except RuntimeError as e:
        say("library", f"no backend takes it: {str(e).splitlines()[0]}")
        return None


def bound(flops, nbytes):
    """(ms, 'operations' or 'bytes'): the least time the card could take,
    the larger of the operations at the bf16 tensor-core peak and the bytes
    (each input read once, each output written once) at the HBM rate."""
    t_ops, t_bytes = flops / PEAK_BF16, nbytes / HBM_BYTES_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def within(out, ref, tols):
    """-> (max |err|, mean |err|, ok) of out against ref under (max, mean)
    bounds; ok also needs finite values."""
    err = (out.float() - ref.float()).abs()
    max_err, mean_err = float(err.max()), float(err.mean())
    ok = bool(out.isfinite().all()) and max_err <= tols[0] and mean_err <= tols[1]
    return max_err, mean_err, ok


def report(phase, label, out, ref, tols):
    max_err, mean_err, ok = within(out, ref, tols)
    say(phase, f"{label}: |err| max {max_err:.3e} (tol {tols[0]:.3e}), mean "
        f"{mean_err:.3e} (tol {tols[1]:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{phase} {label} disagrees with its plain version")
    return max_err


def must_fail(phase, label, out, wrong_ref, tols):
    """A deliberate fault: out held to a plain version computed with the
    fault must break the bound, or the bound could not see it."""
    max_err, mean_err, ok = within(out, wrong_ref, tols)
    say(phase, f"fault check, {label}: |err| max {max_err:.3e}, mean "
        f"{mean_err:.3e} against tol {tols[0]:.3e}, {tols[1]:.3e}: "
        f"{'caught' if not ok else 'NOT CAUGHT'}")
    if ok:
        fail(f"{phase}: the bound does not see {label}")


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: this check runs only on the card")
    sys.path.insert(0, HERE)
    from prisma_tpu_torch.bands import (depth_anything_band, depth_base,
                                        flow_base, flow_gmflow_band,
                                        flow_raft_band)
    from prisma_tpu_torch.models import depth_anything as da
    from prisma_tpu_torch.models import gmflow as gm
    from prisma_tpu_torch.models import raft
    from prisma_tpu_torch.models.vit import ViTConfig
    from prisma_tpu_torch.ops import nn as pnn
    from prisma_tpu_torch.ops.cuda import build
    from prisma_tpu_torch.ops.cuda import flash_attention as fa
    from prisma_tpu_torch.ops.cuda import instance_norm as inorm
    from prisma_tpu_torch.ops.cuda import probe_gather as pg
    from prisma_tpu_torch.ops.cuda import raft_lookup as rl
    from prisma_tpu_torch.ops.resize import resize2d
    from prisma_tpu_torch.runtime.config import RuntimeConfig
    from prisma_tpu_torch.weights import store
    import torch.nn.functional as F
    plain_p_bf16 = functools.partial(fa.flash_attention_ref, round_p=True)
    counters = {"K1": (fa.flash_attention, "launches"),
                "K2": (fa.flash_attention, "region_launches"),
                "K3": (fa.flash_attention_streamed, "launches"),
                "K4": (inorm.instance_norm_relu, "launches"),
                "K5": (rl.window_lookup, "launches"),
                "K6a": (pg.lane_gather, "launches"),
                "K6b": (pg.minor_transpose, "launches")}

    def per_path(**n):
        """Expected launches: n for the named kernels, 0 for the others."""
        return {key: n.get(key, 0) for key in counters}

    def zero_counts():
        for obj, attr in counters.values():
            setattr(obj, attr, 0)

    def read_counts():
        return {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}

    def attn_tols(ref):
        return fa.bf16_bounds(ref) if ref.dtype == torch.bfloat16 \
            else (ATOL_F32, ATOL_F32)

    # 1. environment
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    fields = [f.strip() for f in smi.stdout.strip().splitlines()[0].split(",")]
    card = f"{fields[0]}, {fields[1]}"
    max_sm_hz = float(fields[2].split()[0]) * 1e6
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    print(card)
    say("env", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s), "
        f"card: {card}, {n_sm} SMs, max SM clock {max_sm_hz / 1e6:.0f} MHz")

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    libs = build.build_all()
    for name in libs:
        build.load(name)
    say("build", f"{len(libs)} libraries from "
        f"{os.path.relpath(build.CSRC_DIR, HERE)}/ "
        f"({', '.join(n + '.cu' for n in libs)}) in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, path in libs.items():
        with open(path + ".log") as f:
            regs = [ln.split("info    :")[-1].strip() for ln in f
                    if "registers" in ln]
        say("build", f"{os.path.relpath(path, HERE)}; ptxas: {' | '.join(regs)}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def normal(shape, dtype, scale=1.0):
        """Seeded normal values made on the card, in f32, cast to dtype."""
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    # 3. K1 against its plain version on the card
    say("k1", "TF32 off for matmul and cuDNN in every f32 comparison")
    say("k1", "tolerances: bf16 against the plain version with P rounded to "
        "bf16 as K1 does, max |err| <= 2 bf16 ulp of max |ref| (the output "
        "rounding, and P rounded at a running max) and mean |err| <= 2^-8 of "
        "mean |ref| (those average out; a lost or unmasked key moves a whole "
        "row); f32 max and mean <= 2e-5 (f32 both sides, sums in another order)")
    k1 = {}
    for shape, dtype in ((MAIN_SHAPE, torch.bfloat16),
                         ((6, 100, 32), torch.float32),
                         ((6, 100, 32), torch.bfloat16),  # ragged bf16, d=32
                         ((4, 1024, 128), torch.bfloat16)):
        q, k, v = (normal(shape, dtype) for _ in range(3))
        out = fa.flash_attention(q, k, v)
        ref = (plain_p_bf16 if dtype == torch.bfloat16
               else fa.flash_attention_ref)(q, k, v)
        max_err = report("k1", f"{list(shape)} {str(dtype)[6:]}", out, ref,
                         attn_tols(ref))
        if shape == MAIN_SHAPE:
            B, N, d = shape
            ms = cuda_ms(lambda: fa.flash_attention(q, k, v), 20)
            plain_ms = cuda_ms(lambda: fa.flash_attention_ref(q, k, v), 5)
            q4, k4, v4 = (t.view(8, 16, N, d) for t in (q, k, v))
            lib_ms = library_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4))
            bound_ms, bound_by = bound(4 * B * N * N * d, nbytes(q, k, v, out))
            k1 = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                      bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)
            say("k1", f"time at {list(shape)} bf16: kernel {ms:.3f} ms "
                f"({4 * B * N * N * d / (ms * 1e-3) / 1e12:.1f} TFLOP/s), plain "
                f"{plain_ms:.3f} ms, scaled_dot_product_attention "
                f"{lib_ms} ms on [8, 16, {N}, {d}], bound {bound_ms:.3f} ms "
                f"({bound_by}), on {card}")
        del q, k, v, out, ref
    torch.cuda.empty_cache()

    # 4. the Depth-Anything slice in f32 on the card (TF32 off) against the CPU
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

    # 5. the Depth-Anything path at full width
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
    zero_counts()
    t0 = time.perf_counter()
    outs = [step(frames) for _ in range(TIMED_STEPS)]
    elapsed = time.perf_counter() - t0
    vit_counts = read_counts()
    for out in outs:
        heat, dmin, dmax = out["heat"], out["min"], out["max"]
        if heat.shape != (BATCH, *FRAME_HW, 3) or heat.dtype != np.uint8:
            fail(f"heat {heat.shape} {heat.dtype}")
        if not (np.isfinite(dmin).all() and np.isfinite(dmax).all()
                and (dmin < dmax).all()):
            fail(f"per-frame min/max not finite or not min < max: {dmin} {dmax}")
    expect = per_path(K1=24 * TIMED_STEPS)
    if vit_counts != expect:
        fail(f"launches in {TIMED_STEPS} steps: {vit_counts}, expected {expect}")
    step_ms = elapsed / TIMED_STEPS * 1e3
    say("main", f"{TIMED_STEPS} steps of {BATCH} uint8 {FRAME_HW[0]}x"
        f"{FRAME_HW[1]} frames: heat {list(outs[0]['heat'].shape)} uint8, "
        f"min < max and finite per frame; launches {vit_counts} "
        f"(24 K1 per step) ok")
    say("main", f"{BATCH * TIMED_STEPS / elapsed:.2f} frames/s "
        f"({step_ms:.1f} ms per batch-8 step, host clock, H2D and D2H "
        f"included; K1 {24 * k1['ms']:.1f} ms of it at its own time) "
        f"on {card}")

    # One frame through the same model, first with K1 held to the plain
    # version with P rounded to bf16 at every layer, on the layer's real
    # activations and with phase 3's bounds; then with the plain attention
    # in place of K1. The yardstick is the plain attention with P rounded
    # to bf16: K1's distance to the plain version must stay within twice its
    # distance in mean, 99.9th percentile and max.
    layers = []

    def k1_checked(q, k, v):
        out = fa.flash_attention(q, k, v)
        ref = plain_p_bf16(q, k, v)
        tols = fa.bf16_bounds(ref)
        max_err, mean_err, ok = within(out, ref, tols)
        layers.append((max_err / tols[0], mean_err / tols[1], ok))
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
    null_check("main", "depth", depth["k1"], depth["plain"],
               depth["plain_p_bf16"],
               float(depth["plain"].max() - depth["plain"].min()))
    del model, step, outs, depth
    torch.cuda.empty_cache()

    # 6. K2: the region bias, at the GMFlow window shape
    bands_np = gm.shift_window_region_bands(*FEAT_HW, 2)
    bands = torch.from_numpy(bands_np).cuda()
    win_w = FEAT_HW[1] // 2
    say("k2", f"shifted-window bands (bh, bw) per window at {FEAT_HW[0]}x"
        f"{FEAT_HW[1]} features: {bands_np.tolist()}, win_w {win_w}; bounds "
        f"as K1's")
    B, N, d = WIN_SHAPE
    q, k, v = (normal(WIN_SHAPE, torch.bfloat16) for _ in range(3))
    out = fa.flash_attention(q, k, v, region_bands=bands, win_w=win_w)
    ref = plain_p_bf16(q, k, v, region_bands=bands, win_w=win_w)
    k2_err = report("k2", f"{list(WIN_SHAPE)} bf16, bands", out, ref,
                    attn_tols(ref))
    shifted = bands.clone()
    shifted[:, 0] += 1
    must_fail("k2", "bh moved down one token row (90 tokens)", out,
              plain_p_bf16(q, k, v, region_bands=shifted, win_w=win_w),
              attn_tols(ref))
    del ref
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, region_bands=bands,
                                            win_w=win_w), 10)
    plain_ms = cuda_ms(lambda: fa.flash_attention_ref(
        q, k, v, region_bands=bands, win_w=win_w), 3)
    codes = fa.region_codes(4, N, bands, win_w)
    mask = torch.where(codes[:, :, None] != codes[:, None, :],
                       -fa.REGION_PENALTY, 0.0).to(torch.bfloat16)[None]
    q4, k4, v4 = (t.view(B // 4, 4, N, d) for t in (q, k, v))
    lib_ms = library_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask), 5)
    bound_ms, bound_by = bound(4 * B * N * N * d, nbytes(q, k, v, out, bands))
    k2 = dict(max_abs_err=k2_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
              bound_by=bound_by, library_ms=lib_ms)
    say("k2", f"time at {list(WIN_SHAPE)} bf16: kernel {ms:.3f} ms "
        f"({4 * B * N * N * d / (ms * 1e-3) / 1e12:.1f} TFLOP/s), plain "
        f"{plain_ms:.3f} ms, scaled_dot_product_attention with a float "
        f"[1, 4, N, N] mask {lib_ms} ms, bound {bound_ms:.3f} ms ({bound_by})")
    del mask
    # K1 at the unshifted windows' shape
    out = fa.flash_attention(q, k, v)
    ref = plain_p_bf16(q, k, v)
    k1_win_err = report("k1", f"{list(WIN_SHAPE)} bf16 (GMFlow unshifted "
                        f"windows)", out, ref, attn_tols(ref))
    del ref
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v), 10)
    plain_ms = cuda_ms(lambda: fa.flash_attention_ref(q, k, v), 3)
    lib_ms = library_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4), 5)
    k1["at_gmflow_windows"] = dict(shape=list(WIN_SHAPE), max_abs_err=k1_win_err,
                                   ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                   bound_by=bound_by, library_ms=lib_ms)
    say("k1", f"time at {list(WIN_SHAPE)} bf16: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, scaled_dot_product_attention {lib_ms} ms, bound "
        f"{bound_ms:.3f} ms ({bound_by})")
    del q, k, v, q4, k4, v4, out
    torch.cuda.empty_cache()
    # ragged: ids labels at N = 300 (bf16) and bands on a small map (f32)
    ids = torch.from_numpy(rng.integers(0, 4, size=(6, 300)).astype(np.int32)).cuda()
    q, k, v = (normal((6, 300, 64), torch.bfloat16) for _ in range(3))
    ref = plain_p_bf16(q, k, v, ids=ids)
    report("k2", "[6, 300, 64] bf16, ids (ragged last tile)",
           fa.flash_attention(q, k, v, ids=ids), ref, attn_tols(ref))
    small = torch.from_numpy(gm.shift_window_region_bands(20, 26, 2)).cuda()
    q, k, v = (normal((8, 130, 32), torch.float32) for _ in range(3))
    report("k2", "[8, 130, 32] f32, bands of a 20x26 map (ragged)",
           fa.flash_attention(q, k, v, region_bands=small, win_w=13),
           fa.flash_attention_ref(q, k, v, region_bands=small, win_w=13),
           (ATOL_F32, ATOL_F32))

    # 7. K3: streamed global attention
    say("k3", "tolerances: max |err| <= 2^-14 and mean |err| <= 2^-18 of max "
        "|v| (f32 scores and unrounded f32 P on both sides; they part by sum "
        "order and exp2 against exp, ~1e-6 of a weight)")
    Bm, Nm, dm = MATCH_SHAPE
    grid = gm._coords_grid_flat(*FEAT_HW, "cuda")
    q, k = (normal(MATCH_SHAPE, torch.bfloat16) for _ in range(2))
    v = grid[None].expand(Bm, Nm, 2).contiguous()
    scale = dm ** -0.5
    out = fa.flash_attention_streamed(q, k, v, scale)
    k3_err = report("k3", f"matching {list(MATCH_SHAPE)} bf16, v = the "
                    f"{FEAT_HW[0]}x{FEAT_HW[1]} pixel grid f32", out,
                    fa.flash_attention_streamed_ref(q, k, v, scale),
                    fa.streamed_bounds(v))
    ms = cuda_ms(lambda: fa.flash_attention_streamed(q, k, v, scale), 10)
    plain_ms = cuda_ms(lambda: fa.flash_attention_streamed_ref(q, k, v, scale), 3)
    vpad = F.pad(v.to(torch.bfloat16), (0, dm - 2))[:, None]
    lib_ms = library_ms(lambda: F.scaled_dot_product_attention(
        q[:, None], k[:, None], vpad), 5)
    bound_ms, bound_by = bound(2 * Bm * Nm * Nm * (dm + 2), nbytes(q, k, v, out))
    exp_ms = 1e3 * Bm * Nm * Nm / (n_sm * SFU_PER_CLOCK_SM * max_sm_hz)
    k3 = dict(max_abs_err=k3_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
              bound_by=bound_by, library_ms=lib_ms, exp_bound_ms=exp_ms)
    say("k3", f"time at matching {list(MATCH_SHAPE)}: kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, scaled_dot_product_attention with v cast "
        f"to bf16 and padded to 128 (not the same numerics) {lib_ms} ms, "
        f"bound {bound_ms:.3f} ms ({bound_by}: tensor cores); the "
        f"{Bm * Nm * Nm:.3e} exp2 at {SFU_PER_CLOCK_SM}/clock/SM take "
        f"{exp_ms:.3f} ms")
    del q, k, v, vpad, out
    torch.cuda.empty_cache()
    # propagation: 14 rows, q and k projected features, v the f32 flow
    q, k = (normal((14, Nm, dm), torch.bfloat16) for _ in range(2))
    v = normal((14, Nm, 2), torch.float32, scale=40.0)
    out = fa.flash_attention_streamed(q, k, v, scale)
    report("k3", f"propagation [14, {Nm}, {dm}] bf16, v = a flow f32", out,
           fa.flash_attention_streamed_ref(q, k, v, scale), fa.streamed_bounds(v))
    ms = cuda_ms(lambda: fa.flash_attention_streamed(q, k, v, scale), 5)
    k3["at_propagation"] = dict(
        shape=[14, Nm, dm], ms=ms,
        bound_ms=bound(2 * 14 * Nm * Nm * (dm + 2), nbytes(q, k, v, out))[0])
    say("k3", f"time at propagation [14, {Nm}, {dm}]: kernel {ms:.3f} ms, "
        f"bound {k3['at_propagation']['bound_ms']:.3f} ms")
    del q, k, v, out
    # ragged keys, and the same keys with the tail left unmasked
    M = Nm + 37
    q = normal(MATCH_SHAPE, torch.bfloat16)
    k = normal((Bm, M, dm), torch.bfloat16)
    v = torch.from_numpy(rng.uniform(0, 1440, size=(Bm, M, 2))
                         .astype(np.float32)).cuda()
    ref = fa.flash_attention_streamed_ref(q, k, v, scale)
    report("k3", f"ragged M = {M} (a last tile of {M % 64} keys)",
           fa.flash_attention_streamed(q, k, v, scale), ref,
           fa.streamed_bounds(v))
    pad = (-M) % 64
    unmasked = fa.flash_attention_streamed(q, F.pad(k, (0, 0, 0, pad)),
                                           F.pad(v, (0, 0, 0, pad)), scale)
    must_fail("k3", f"the ragged tail unmasked ({pad} zero keys let in)",
              unmasked, ref, fa.streamed_bounds(v))
    del q, k, v, ref, unmasked
    torch.cuda.empty_cache()

    # 8. K4: instance norm
    say("k4", "tolerances: bf16 max |err| <= 1 ulp of max |ref|, mean <= "
        "2^-12 of mean |ref| (f32 on both sides, one cast); f32 max and mean "
        "<= 2e-5")
    x = normal(NORM_SHAPE, torch.bfloat16, scale=2.0) + 1.0
    out = inorm.instance_norm_relu(x, relu=True)
    ref = inorm.instance_norm_relu_ref(x, relu=True)
    k4_err = report("k4", f"{list(NORM_SHAPE)} bf16 + relu", out, ref,
                    inorm.bounds(ref))
    ms = cuda_ms(lambda: inorm.instance_norm_relu(x, relu=True), 20)
    plain_ms = cuda_ms(lambda: inorm.instance_norm_relu_ref(x, relu=True), 5)
    lib_ms = library_ms(lambda: F.instance_norm(x, eps=inorm.EPS), 20)
    bound_ms, bound_by = bound(0, nbytes(x, out))
    k4 = dict(max_abs_err=k4_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
              bound_by=bound_by, library_ms=lib_ms)
    say("k4", f"time at {list(NORM_SHAPE)} bf16: kernel {ms:.3f} ms "
        f"({nbytes(x, out) / (ms * 1e-3) / 1e12:.2f} TB/s), plain "
        f"{plain_ms:.3f} ms, F.instance_norm {lib_ms} ms, bound "
        f"{bound_ms:.3f} ms ({bound_by})")
    del x, out, ref
    x = normal((3, 5, 13, 17), torch.float32, scale=2.0) + 1.0
    out = inorm.instance_norm_relu(x)
    tols = inorm.bounds(out)
    report("k4", "[3, 5, 13, 17] f32 (ragged planes)", out,
           inorm.instance_norm_relu_ref(x), tols)
    xf = x.float()
    mu = xf.mean(dim=(-2, -1), keepdim=True)
    var1 = ((xf - mu) ** 2).sum(dim=(-2, -1), keepdim=True) / (13 * 17 - 1)
    must_fail("k4", "ddof slip (unbiased variance)", out,
              (xf - mu) * torch.rsqrt(var1 + inorm.EPS), tols)
    must_fail("k4", "eps slip (1e-3)", out,
              inorm.instance_norm_relu_ref(x, eps=1e-3), tols)
    torch.cuda.empty_cache()

    # 9. GMFlow in f32 on the card (TF32 off) against the CPU
    cpu_rt = RuntimeConfig(random_weights=True, device="cpu")
    cpu_gm = store.load_gmflow(cpu_rt)
    gpu_gm = copy.deepcopy(cpu_gm).cuda()
    imgs = torch.from_numpy(rng.uniform(0, 255, size=(3, 128, 192, 3))
                            .astype(np.float32))
    with torch.inference_mode():
        f_cpu = torch.cat(gm.infer_pairs(cpu_gm, imgs[:-1], imgs[1:]))
        zero_counts()
        g = imgs.cuda()
        f_gpu = torch.cat(gm.infer_pairs(gpu_gm, g[:-1], g[1:])).cpu()
    counts = read_counts()
    err = float((f_gpu - f_cpu).abs().max())
    tol = 1e-4 * float(f_cpu.abs().max())
    ok = (counts == per_path(K1=6, K2=6, K3=3, K4=15)
          and bool(torch.isfinite(f_gpu).all()) and err <= tol)
    say("gmflow-f32", f"GMFlow (128 channels, 6 layers) 2 pairs at 128x192, "
        f"f32: max |flow_gpu - flow_cpu| {err:.3e} px, tol {tol:.3e} px (1e-4 "
        f"of the flow scale, max |flow| {float(f_cpu.abs().max()):.2f}: f32 "
        f"both sides, sums in another order through 6 layers and two global "
        f"softmaxes); launches {counts} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the f32 GMFlow on the card disagrees with the CPU")
    del cpu_gm, gpu_gm

    # 10. the GMFlow path at full width
    t0 = time.perf_counter()
    lazy_model, infer = flow_gmflow_band.build_pairs(runtime)
    model = lazy_model().to(device=runtime.resolve_device(),
                            dtype=runtime.resolve_dtype())
    step = flow_base.make_flow_step(model, infer, FLOW_HW, need_masks=True,
                                    need_flow=True)
    step(frames)  # warm-up
    say("flow", f"GMFlow (128 channels, 6 layers, 2x2 windows), bf16, random "
        f"weights, {BATCH} frames = {BATCH - 1} bidirectional pairs at "
        f"{FLOW_HW[0]}x{FLOW_HW[1]}, masks and flows returned: set-up and "
        f"warm-up {time.perf_counter() - t0:.2f} s")
    zero_counts()
    t0 = time.perf_counter()
    outs = [step(frames) for _ in range(TIMED_STEPS)]
    elapsed = time.perf_counter() - t0
    flow_counts = read_counts()
    P = BATCH - 1
    check_flow_outputs(outs)
    per_step = {"K1": 6, "K2": 6, "K3": 3, "K4": 15}
    expect = per_path(**{key: n * TIMED_STEPS for key, n in per_step.items()})
    if flow_counts != expect:
        fail(f"launches in {TIMED_STEPS} steps: {flow_counts}, expected {expect}")
    say("flow", f"{TIMED_STEPS} steps: fwd_rgb/bwd_rgb {list(outs[0]['fwd_rgb'].shape)} "
        f"uint8, masks {list(outs[0]['fwd_mask'].shape)} bool (fwd valid "
        f"{float(outs[0]['fwd_mask'].mean()):.3f}), max-disp finite "
        f"({', '.join(f'{m:.2f}' for m in outs[0]['max_disp'])}); launches "
        f"{flow_counts} ({per_step} per step) ok")
    say("flow", f"{P * TIMED_STEPS / elapsed:.2f} pairs/s "
        f"({elapsed / TIMED_STEPS * 1e3:.1f} ms per step of {P} pairs, host "
        f"clock, H2D and D2H included) on {card}")

    # One pair's real activations: every kernel call held to its plain
    # version with its bounds; then the pair's flow with the plain versions
    # in place of the kernels, and with a plain path that rounds P to bf16
    # as K1/K2 do (the null distance).
    x = torch.from_numpy(frames[:2]).cuda()
    with torch.inference_mode():
        ds = resize2d(x.float(), FLOW_HW, method="cubic").to(torch.bfloat16)
    calls = {"K1": [], "K2": [], "K3": [], "K4": []}

    def ratios(key, out, ref, tols):
        max_err, mean_err, ok = within(out, ref, tols)
        calls[key].append((max_err / tols[0], mean_err / tols[1], ok))
        return out

    def fa_checked(q, k, v, region_bands=None, win_w=0):
        out = fa.flash_attention(q, k, v, region_bands=region_bands, win_w=win_w)
        ref = plain_p_bf16(q, k, v, region_bands=region_bands, win_w=win_w)
        return ratios("K1" if region_bands is None else "K2", out, ref,
                      attn_tols(ref))

    def streamed_checked(q, k, v, scale):
        return ratios("K3", fa.flash_attention_streamed(q, k, v, scale),
                      fa.flash_attention_streamed_ref(q, k, v, scale),
                      fa.streamed_bounds(v))

    def norm_checked(x, eps=inorm.EPS, relu=False):
        ref = inorm.instance_norm_relu_ref(x, eps, relu)
        return ratios("K4", inorm.instance_norm_relu(x, eps, relu), ref,
                      inorm.bounds(ref))

    paths = {
        "kernels": (fa_checked, streamed_checked, norm_checked),
        "plain": (fa.flash_attention_ref, fa.flash_attention_streamed_ref,
                  inorm.instance_norm_relu_ref),
        "plain_p_bf16": (plain_p_bf16, fa.flash_attention_streamed_ref,
                         inorm.instance_norm_relu_ref)}
    flows = {}
    with torch.inference_mode():
        for name, (attn, streamed, norm) in paths.items():
            gm.flash_attention, gm.flash_attention_streamed, \
                gm.instance_norm_relu = attn, streamed, norm
            try:
                flows[name] = torch.cat(infer(model, ds[:1], ds[1:])).float()
            finally:
                gm.flash_attention, gm.flash_attention_streamed, \
                    gm.instance_norm_relu = (fa.flash_attention,
                                             fa.flash_attention_streamed,
                                             inorm.instance_norm_relu)
    n_calls = {key: len(v) for key, v in calls.items()}
    ok = n_calls == per_step and all(r[2] for v in calls.values() for r in v)
    say("flow", "pair 0, every kernel call against its plain version on the "
        "real activations, worst |err| / tol (max, mean): " + "; ".join(
            f"{key} x{len(v)} {max(r[0] for r in v):.3f}, "
            f"{max(r[1] for r in v):.3f}" for key, v in calls.items())
        + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"a kernel disagrees with its plain version on the flow path's "
             f"activations ({n_calls} calls)")
    null_check("flow", "flow", flows["kernels"], flows["plain"],
               flows["plain_p_bf16"], 1.0, unit="px")
    del model, step, outs, flows, ds
    torch.cuda.empty_cache()

    # 11. K5: RAFT's window lookup, on the pyramid of the RAFT main shape
    say("k5", "tolerances: bf16 max |err| <= 1 ulp of max |ref|, mean <= "
        "2^-12 of mean |ref|; f32 max <= 1e-6 of max |ref|, mean <= 2^-20 of "
        "mean |ref| (the same f32 blend in the same order on both sides, one "
        "cast)")
    B5 = 2 * (BATCH - 1)
    f1, f2 = (normal((B5, 256, *FEAT_HW), torch.bfloat16) for _ in range(2))
    pyr = raft.build_corr_pyramid(f1, f2, 4)
    del f1, f2
    N5 = B5 * FEAT_HW[0] * FEAT_HW[1]
    grid5 = raft.coords_grid(B5, *FEAT_HW, "cuda").reshape(N5, 2)
    coords = (grid5 + (torch.rand((N5, 2), generator=gen, device="cuda") * 2 - 1)
              * K5_OFFSET).contiguous()
    specials = torch.tensor([[1e6, 5.0], [-1e6, 5.0], [5.0, 1e6], [5.0, -1e6],
                             [float("inf"), 5.0], [float("-inf"), 5.0],
                             [5.0, float("nan")], [float("nan"), float("nan")]],
                            device="cuda")
    coords[:len(specials)] = specials
    shapes = " ".join(f"{h}x{w}" for h, w in (v.shape[1:] for v in pyr))
    out = rl.window_lookup(pyr, coords)
    torch.cuda.synchronize()
    ref = rl.window_lookup_ref(pyr, coords)
    k5_err = report("k5", f"N = {N5} ({B5} x {FEAT_HW[0]}x{FEAT_HW[1]}), levels "
                    f"{shapes} bf16, centres the grid +- {K5_OFFSET:.0f} px",
                    out, ref, rl.bounds(ref))
    if not bool((out[:len(specials)] == 0).all()):
        fail("k5: a centre at +-1e6, +-inf or NaN gave a nonzero window")
    say("k5", f"centres at +-1e6, +-inf and NaN: all-zero windows ok")
    # the faults, on the first image's pixels
    M = FEAT_HW[0] * FEAT_HW[1]
    sub, cs, sref = [v[:M] for v in pyr], coords[:M], ref[:M]
    tols = rl.bounds(sref)
    must_fail("k5", "window in y-slow order", out[:M],
              sref.view(M, 4, 9, 9).transpose(2, 3).reshape(M, -1), tols)
    pad = 10
    clamped = torch.cat([rl.window_lookup_ref(
        [F.pad(v[:, None].float(), (pad,) * 4, mode="replicate")[:, 0]
         .to(v.dtype)], cs / 2 ** level + pad) for level, v in enumerate(sub)],
        dim=1)
    must_fail("k5", "edge taps clamped instead of zeroed", out[:M], clamped,
              tols)
    undivided = torch.cat([sref[:, :81]] + [rl.window_lookup_ref([v], cs)
                                            for v in sub[1:]], dim=1)
    must_fail("k5", "centre not divided by 2^l on levels 1-3", out[:M],
              undivided, tols)
    del sub, cs, sref, clamped, undivided, ref
    ms = cuda_ms(lambda: rl.window_lookup(pyr, coords), 20)
    plain_ms = cuda_ms(lambda: rl.window_lookup_ref(pyr, coords), 3)
    # the reference's form (corr.py:30-43): grid_sample of each level at the
    # 9x9 window, align_corners=True, zero padding; its grid must take the
    # volume's dtype (bf16: not the same numerics)
    d = torch.arange(-4, 5, dtype=torch.float32, device="cuda")
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    delta = torch.stack([dy, dx], dim=-1)  # the reference's quirk: x slow
    grids = []
    for level, v in enumerate(pyr):
        h, w = v.shape[1:]
        g = coords[:, None, None].nan_to_num(0.0).clamp(-1e4, 1e4) / 2 ** level \
            + delta
        g = torch.stack([2 * g[..., 0] / (w - 1) - 1, 2 * g[..., 1] / (h - 1) - 1],
                        dim=-1)
        grids.append(g.to(v.dtype))
    lib_ms = library_ms(lambda: [F.grid_sample(v[:, None], g, align_corners=True)
                                 for v, g in zip(pyr, grids)], 5)
    del grids
    sectors = 0
    for level, v in enumerate(pyr):
        h, w = v.shape[1:]
        x0, y0, _, _ = rl.clamped_centres(coords / 2 ** level, (h, w), 4)
        xs, xe = (x0 - 4).clamp(0, w), (x0 + 6).clamp(0, w)
        ys = y0[:, None] - 4 + torch.arange(10, device="cuda")
        row = torch.arange(N5, device="cuda")[:, None] * (h * w) + ys * w
        es = v.element_size()
        first, last = (row + xs[:, None]) * es // 32, \
            ((row + xe[:, None]) * es - 1) // 32
        live = (ys >= 0) & (ys < h) & (xe > xs)[:, None]
        sectors += int(torch.where(live, last - first + 1, 0).sum())
    k5_bytes = 32 * sectors + nbytes(out, coords)
    k5_ops = 11 * out.numel()  # per tap 4 weights, 4 products, 3 sums (f32)
    t_ops, t_bytes = k5_ops / PEAK_F32, k5_bytes / HBM_BYTES_S
    k5 = dict(max_abs_err=k5_err, ms=ms, plain_ms=plain_ms,
              bound_ms=1e3 * max(t_ops, t_bytes),
              bound_by="operations" if t_ops >= t_bytes else "bytes",
              library_ms=lib_ms, bound_bytes=k5_bytes)
    say("k5", f"time at N = {N5}, four levels, bf16: kernel {ms:.3f} ms "
        f"({k5_bytes / (ms * 1e-3) / 1e12:.2f} TB/s of the bytes the windows "
        f"touch), plain {plain_ms:.3f} ms, grid_sample (4 levels, bf16 grid) "
        f"{lib_ms} ms, bound {k5['bound_ms']:.3f} ms ({k5['bound_by']}: "
        f"{sectors} 32-byte sectors of in-range patch rows, {k5_bytes / 1e9:.3f} "
        f"GB with the outputs and coords; the whole pyramid is "
        f"{nbytes(*pyr) / 1e9:.2f} GB)")
    del pyr, out, coords, grid5
    torch.cuda.empty_cache()
    # ragged: odd levels in f32, and bf16 with an empty level
    for hws, dtype in ((((41, 57), (20, 28), (10, 14), (5, 7)), torch.float32),
                       (((6, 9), (3, 4), (1, 2), (0, 1)), torch.bfloat16)):
        n = 3001
        rag = [normal((n, h, w), dtype) for h, w in hws]
        h0, w0 = hws[0]
        c = torch.stack([torch.rand(n, generator=gen, device="cuda") * (w0 + 20) - 10,
                         torch.rand(n, generator=gen, device="cuda") * (h0 + 20) - 10],
                        dim=1)
        c[:len(specials)] = specials
        out = rl.window_lookup(rag, c)
        ref = rl.window_lookup_ref(rag, c)
        report("k5", f"[{n}] {str(dtype)[6:]}, levels "
               + " ".join(f"{h}x{w}" for h, w in hws), out, ref, rl.bounds(ref))
        if not bool((out[:len(specials)] == 0).all()):
            fail("k5: a non-finite or far centre gave a nonzero window")

    # 12. RAFT in f32 on the card (TF32 off) against the CPU
    cpu_raft = store.load_raft(cpu_rt)
    gpu_raft = copy.deepcopy(cpu_raft).cuda()
    with torch.inference_mode():
        f_cpu = torch.cat(raft.infer_pairs(cpu_raft, imgs[:-1], imgs[1:], iters=4))
        zero_counts()
        g = imgs.cuda()
        f_gpu = torch.cat(raft.infer_pairs(gpu_raft, g[:-1], g[1:], iters=4)).cpu()
    counts = read_counts()
    err = float((f_gpu - f_cpu).abs().max())
    tol = 1e-4 * float(f_cpu.abs().max())
    ok = (counts == per_path(K4=15, K5=4) and bool(torch.isfinite(f_gpu).all())
          and err <= tol)
    say("raft-f32", f"RAFT (full widths) 2 pairs at 128x192, 4 iterations, "
        f"f32: max |flow_gpu - flow_cpu| {err:.3e} px, tol {tol:.3e} px (1e-4 "
        f"of the flow scale, max |flow| {float(f_cpu.abs().max()):.2f}); "
        f"launches {counts} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the f32 RAFT on the card disagrees with the CPU")
    del cpu_raft, gpu_raft

    # 13. the RAFT path at full width
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lazy_model, infer = flow_raft_band.build_pairs(runtime, iterations=RAFT_ITERS)
    model = lazy_model().to(device=runtime.resolve_device(),
                            dtype=runtime.resolve_dtype())
    step = flow_base.make_flow_step(model, infer, FLOW_HW, need_masks=True,
                                    need_flow=True)
    step(frames)  # warm-up
    say("raft", f"RAFT (fnet 256, cnet 128+128, 4 levels, r=4, {RAFT_ITERS} "
        f"iterations), bf16, random weights, {BATCH} frames = {BATCH - 1} "
        f"bidirectional pairs at {FLOW_HW[0]}x{FLOW_HW[1]} (padded to "
        f"{-(-FLOW_HW[0] // 8) * 8}x{-(-FLOW_HW[1] // 8) * 8}), masks and flows "
        f"returned: set-up and warm-up {time.perf_counter() - t0:.2f} s; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
    zero_counts()
    t0 = time.perf_counter()
    outs = [step(frames) for _ in range(TIMED_STEPS)]
    elapsed = time.perf_counter() - t0
    raft_counts = read_counts()
    check_flow_outputs(outs)
    raft_step = {"K4": 15, "K5": RAFT_ITERS}
    expect = per_path(**{key: n * TIMED_STEPS for key, n in raft_step.items()})
    if raft_counts != expect:
        fail(f"launches in {TIMED_STEPS} steps: {raft_counts}, expected {expect}")
    say("raft", f"{TIMED_STEPS} steps: fwd_rgb/bwd_rgb {list(outs[0]['fwd_rgb'].shape)} "
        f"uint8, masks {list(outs[0]['fwd_mask'].shape)} bool (fwd valid "
        f"{float(outs[0]['fwd_mask'].mean()):.3f}), max-disp finite "
        f"({', '.join(f'{m:.2f}' for m in outs[0]['max_disp'])}); launches "
        f"{raft_counts} ({raft_step} per step, no K1-K3) ok")
    say("raft", f"{P * TIMED_STEPS / elapsed:.2f} pairs/s "
        f"({elapsed / TIMED_STEPS * 1e3:.1f} ms per step of {P} pairs, host "
        f"clock, H2D and D2H included) on {card}")

    # One pair's real activations: every K4 and K5 call held to its plain
    # version; then the pair's flow with the plain versions in place of the
    # kernels, and with a plain path whose lookup blends in bf16 as the JAX
    # package does (the null distance).
    x = torch.from_numpy(frames[:2]).cuda()
    with torch.inference_mode():
        ds = resize2d(x.float(), FLOW_HW, method="cubic").to(torch.bfloat16)
    calls = {"K4": [], "K5": []}

    def lookup_checked(pyramid, coords, r=4):
        ref = rl.window_lookup_ref(pyramid, coords, r)
        return ratios("K5", rl.window_lookup(pyramid, coords, r), ref,
                      rl.bounds(ref))

    paths = {
        "kernels": (lookup_checked, norm_checked),
        "plain": (rl.window_lookup_ref, inorm.instance_norm_relu_ref),
        "plain_bf16_blend": (functools.partial(rl.window_lookup_ref,
                                               blend_dtype=torch.bfloat16),
                             inorm.instance_norm_relu_ref)}
    flows = {}
    with torch.inference_mode():
        for name, (lookup, norm) in paths.items():
            raft.window_lookup, raft.instance_norm_relu = lookup, norm
            try:
                flows[name] = torch.cat(infer(model, ds[:1], ds[1:])).float()
            finally:
                raft.window_lookup, raft.instance_norm_relu = (
                    rl.window_lookup, inorm.instance_norm_relu)
    n_calls = {key: len(v) for key, v in calls.items()}
    ok = n_calls == raft_step and all(r[2] for v in calls.values() for r in v)
    say("raft", "pair 0, every K4 and K5 call against its plain version on the "
        "real activations, worst |err| / tol (max, mean): " + "; ".join(
            f"{key} x{len(v)} {max(r[0] for r in v):.3f}, "
            f"{max(r[1] for r in v):.3f}" for key, v in calls.items())
        + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"a kernel disagrees with its plain version on the RAFT path's "
             f"activations ({n_calls} calls)")
    null_check("raft", "flow", flows["kernels"], flows["plain"],
               flows["plain_bf16_blend"], 1.0, unit="px",
               null_label="plain with the lookup blended in bf16")
    del model, step, outs, flows, ds
    torch.cuda.empty_cache()

    # 14. K6: the probe kernels, as the probe ran them
    cases_a = []
    for (S, H), lo, hi in (((16, 128), -4, 124), ((16, 256), 0, 246),
                           ((5760, 102), 0, 92)):
        off = torch.from_numpy(rng.integers(lo, hi, S).astype(np.int32)).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            cases_a.append((torch.rand((S, H), generator=gen, device="cuda")
                            .to(dtype), off))
    cases_b = [torch.rand((8, 180, 16), generator=gen, device="cuda").to(dtype)
               for dtype in (torch.float32, torch.bfloat16)]
    zero_counts()
    outs_a = [pg.lane_gather(x, off, 10) for x, off in cases_a]
    outs_b = [pg.minor_transpose(x) for x in cases_b]
    torch.cuda.synchronize()
    probe_counts = read_counts()
    if probe_counts != per_path(K6a=len(cases_a), K6b=len(cases_b)):
        fail(f"probe launches {probe_counts}")
    for (x, off), out in zip(cases_a, outs_a):
        if not torch.equal(out, pg.lane_gather_ref(x, off, 10)):
            fail(f"k6: lane_gather at {list(x.shape)} {x.dtype} differs from "
                 f"its plain version")
    for x, out in zip(cases_b, outs_b):
        if not torch.equal(out, pg.minor_transpose_ref(x)):
            fail(f"k6: minor_transpose at {list(x.shape)} {x.dtype} differs")
    say("k6", "lane_gather at [16, 128], [16, 256], [5760, 102] and "
        "minor_transpose at [8, 180, 16], f32 and bf16: equal to the plain "
        f"versions; launches {probe_counts} ok")
    x, off = cases_a[4]  # the probe's perf shape [5760, 102], f32
    li = torch.arange(x.shape[1], device="cuda").clamp_max(9)
    idx = (off.long()[:, None] + li).clamp(0, x.shape[1] - 1)
    t_bytes = nbytes(x, outs_a[4], off) / HBM_BYTES_S
    k6a = dict(max_abs_err=0.0,
               ms=cuda_ms(lambda: pg.lane_gather(x, off, 10), 50),
               plain_ms=cuda_ms(lambda: pg.lane_gather_ref(x, off, 10), 50),
               bound_ms=1e3 * t_bytes, bound_by="bytes",
               library_ms=library_ms(lambda: torch.gather(x, 1, idx), 50))
    x = cases_b[0]
    k6b = dict(max_abs_err=0.0,
               ms=cuda_ms(lambda: pg.minor_transpose(x), 50),
               plain_ms=cuda_ms(lambda: pg.minor_transpose_ref(x), 50),
               bound_ms=1e3 * nbytes(x, outs_b[0]) / HBM_BYTES_S,
               bound_by="bytes",
               library_ms=library_ms(lambda: x.transpose(1, 2).contiguous(), 50))
    say("k6", f"time, lane_gather [5760, 102] f32: kernel {k6a['ms']:.4f} ms, "
        f"plain {k6a['plain_ms']:.4f} ms, torch.gather {k6a['library_ms']} ms, "
        f"bound {k6a['bound_ms']:.4f} ms; minor_transpose [8, 180, 16] f32: "
        f"kernel {k6b['ms']:.4f} ms, plain {k6b['plain_ms']:.4f} ms, "
        f".transpose(1, 2).contiguous() {k6b['library_ms']} ms, bound "
        f"{k6b['bound_ms']:.4f} ms (both launch-bound at these sizes)")

    runs = {"depth_anything_vitl": vit_counts, "flow_gmflow": flow_counts,
            "flow_raft": raft_counts, "probe": probe_counts}
    launches = {key: sum(c[key] for c in runs.values()) for key in counters}
    by_path = {key: {path: c[key] for path, c in runs.items()}
               for key in counters}
    rows = [("flash_attention", "K1", "flash_attention.cu",
             "prisma_tpu/ops/pallas/flash_attention.py:58", k1),
            ("flash_attention_region", "K2", "flash_attention.cu",
             "prisma_tpu/ops/pallas/flash_attention.py:73", k2),
            ("flash_attention_streamed", "K3", "flash_attention_streamed.cu",
             "prisma_tpu/ops/pallas/flash_attention.py:273", k3),
            ("instance_norm_relu", "K4", "instance_norm.cu",
             "prisma_tpu/ops/pallas/instance_norm.py:35", k4),
            ("raft_window_lookup", "K5", "raft_lookup.cu",
             "prisma_tpu/ops/pallas/raft_lookup.py:53",
             dict(k5, also_replaces="prisma_tpu/ops/pallas/raft_window.py:80")),
            ("lane_gather", "K6a", "probe_gather.cu",
             "scripts/probe_gather_kernel.py:31", k6a),
            ("minor_transpose", "K6b", "probe_gather.cu",
             "scripts/probe_gather_kernel.py:53", k6b)]
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"prisma_tpu_torch/csrc/{src}", "replaces": replaces,
        "launches": launches[key], "launches_by_path": by_path[key], **row}
        for name, key, src, replaces, row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def check_flow_outputs(outs):
    """A flow step's outputs for BATCH - 1 pairs at FLOW_HW: HSV frames,
    masks, finite max-disp and flows."""
    P = BATCH - 1
    for out in outs:
        for key in ("fwd_rgb", "bwd_rgb"):
            if out[key].shape != (P, *FLOW_HW, 3) or out[key].dtype != np.uint8:
                fail(f"{key} {out[key].shape} {out[key].dtype}")
        for key in ("fwd_mask", "bwd_mask"):
            if out[key].shape != (P, *FLOW_HW) or out[key].dtype != np.bool_:
                fail(f"{key} {out[key].shape} {out[key].dtype}")
        if not (out["max_disp"].shape == (P,) and np.isfinite(out["max_disp"]).all()
                and np.isfinite(out["fwd"]).all() and np.isfinite(out["bwd"]).all()):
            fail(f"max_disp or flows not finite: {out['max_disp']}")


def null_check(phase, what, kernels, plain, null_path, span,
               unit="of the range", null_label="plain with P rounded to bf16"):
    """The kernels' output must stay within twice the distance to the plain
    path of `null_path` (a plain path with the kernels' own roundings, or
    the JAX package's), in mean, 99.9th percentile and max (bf16
    activations amplify last-bit differences at scattered pixels)."""
    def stats(out):
        e = (out - plain).abs().flatten() / span
        return (float(e.mean()), float(torch.quantile(e, 0.999)),
                float(e.max()))

    got, null = stats(kernels), stats(null_path)
    ok = bool(torch.isfinite(kernels).all()) and \
        all(g <= 2 * n for g, n in zip(got, null))
    say(phase, f"|{what} - {what} with the plain versions| ({unit}; mean, "
        f"99.9th pct, max): kernels " + ", ".join(f"{g:.3e}" for g in got)
        + f"; {null_label} " + ", ".join(f"{n:.3e}" for n in null)
        + f"; tol 2x the latter {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"the {what} through the kernels disagrees with the plain path")


if __name__ == "__main__":
    main()
