#!/usr/bin/env python3
"""Bring-up check of prisma_tpu_torch on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It drives the port's main paths through the bands' own entry points, with
random weights from a seed: the Depth-Anything ViT-L video step on uint8
1080p frames at batch 8, the GMFlow and RAFT flow steps on the same frames
(7 bidirectional pairs at 810x1440, masks on), the two probe kernels as
their probe ran them, the steps of process.py's default video run on the
same frames: metric Depth-Anything, the SOLOv2 mask with its SDF, and the
three steps of one batch of the fused pipeline; then the BEiT-L depth
family: PatchFusion on a 1080p frame at p49, ZoeD_N's video step, and an
image's default run (mask, PatchFusion at r128); then MiDaS (DPT_Large
and v2.1 video steps at batch 8) and Marigold (one 1080p frame, 10 steps x
10 members at 768); then GMFlow's refinement (--num_scales 2) and RAFT's
fused lookup (--corr_impl fused) on the flow frames; then the ViT-L step
under the depth loop's device trace (PRISMA_TPU_TRACE), the depth and flow
steps split over replicas (parallel/mesh.py) and the host tools (concat,
the viewer's helpers, the io helpers). It holds every kernel against its
plain PyTorch version. The band folders' loops (decode, x264, colmap) are
not driven here; phase 34 drives the codec where it loads and says so
where its libav libraries are missing. Each phase prints a line; a failed
phase ends the run with a non-zero exit. Without a CUDA device it exits
non-zero at once.

  1. env: torch and CUDA versions, the card's name and power limit
  2. build: every kernel of prisma_tpu_torch/csrc/, one nvcc each, together;
     each kernel's registers and spills (ptxas), and the HGMMA, UTMALDG,
     LDGSTS and HMMA counts of the bf16 kernels of flash_attention.cu and
     flash_attention_streamed.cu (cuobjdump -sass): each must use wgmma
     (HGMMA > 0) and no legacy HMMA, and ptxas must serialize the wgmma of
     none (C7514/C7515); the same counts of raft_lookup.cu's kernels, which
     must load with cp.async (LDGSTS > 0); the bulk copies (UBLKCP) of
     probe_gather.cu's kernels, which K6a's and K6b's must have
  3. k1: K1 flash attention against its plain version, eleven shapes (the
     128-row tile edges at d=128, the metric core's ragged 1037 tokens,
     DPT_Large's [128, 337, 64] and the Marigold UNet's [50, 5184, 64] and
     [100, 1296, 64] among them); at the last three the bound shown to fail
     with the ragged key tile left unmasked; kernel, plain, SDPA and bound
     at the ViT-L shape, the metric core's and those three
  4. f32: a tiny Depth-Anything in f32 with TF32 off on the card against
     the CPU
  5. main: the Depth-Anything path at full width (K1 launches counted,
     outputs checked, K1 held to the plain version at every layer of one
     frame, that frame's depth to the plain attention's), frames/s
  6. k2: K2 (the shifted-window region bias) against its plain version at
     the GMFlow window shape and two ragged cases; the bound shown to fail
     with the band moved by one token row; K1 and K2 times at that shape
  7. k3: K3 (streamed global attention) at the matching and propagation
     shapes, a peaked case (keys a permutation of the queries times 4: each
     softmax nearly one-hot) and a ragged key count; the bound shown to fail
     with v shifted by one key tile (the neighbouring ring slot) on the
     peaked case and with the ragged tail unmasked; kernel, plain, SDPA (v
     padded) and bound times at both shapes, and a model of the L2 bytes of
     a call (from the tile schedule)
  8. k4: K4 (instance norm) at the largest backbone norm and a ragged f32
     case; the f32 bound shown to fail on an eps and a ddof slip; times
  9. gmflow-f32: a small-image GMFlow (full 128 channels, 6 layers) in f32
     with TF32 off on the card against the CPU, each kernel launched
 10. flow: the GMFlow path at full width: launches of K1-K4 per step
     counted, outputs checked, pairs/s; then on one pair's real
     activations every kernel call held to its plain version, and the flow
     held within 2x the null distance of a plain path that rounds P as
     K1/K2 do
 11. k5: K5 (RAFT's window lookup) equal to its plain version on the
     pyramid of seeded bf16 fmaps at the RAFT main shape, centres off the
     plane and not finite among them, on a ragged f32 pyramid, a bf16 one
     with an empty level and a bf16 one of odd widths whose 1001 pixels are
     no multiple of the kernel's pixel group, at centres on both edges of
     every plane and at every row start mod 8; the bounds shown to fail on
     three deliberate faults; kernel, plain, grid_sample and bound times,
     the kernel's occupancy; it must take no more than 3x its bound and no
     longer than grid_sample
 12. raft-f32: a small-image RAFT (full widths, 4 iterations) in f32 with
     TF32 off on the card against the CPU
 13. raft: the RAFT path at full width (20 iterations): launches of K4 and
     K5 per step counted, outputs checked, pairs/s; then on one pair's real
     activations every K4 and K5 call held to its plain version, and the
     flow held within 2x the null distance of a plain path whose lookup
     blends in bf16 as the JAX package does
 14. k6: the probe kernels K6a (lane gather) and K6b (minor transpose),
     each equal bit for bit to its plain version in f32 and bf16, launches
     counted: at the probe's shapes, at ragged ones (taps of 1 and past the
     row, offsets past both ends, rows longer than a span; odd W and T,
     slabs larger than a buffer) and at one RAFT level-0 iteration's size
     (the probe's block 2295 times: K6a [13219200, 102], K6b [18360, 180,
     16]) and past the previous grid's 65535 batches (K6b [70000, 180,
     16]); at those sizes the kernel and the previous design in turns,
     torch.gather or .transpose(1, 2).contiguous(), the plain version and
     the bound (K6a's both ways: the windows its outputs need, and all of
     x); at the probe's shapes times back to back, device time alone
     (torch.profiler), host µs per wrapper call, and an empty kernel
     through the same launch path
 15. metric-f32: a small metric Depth-Anything (vits core, the full bins
     head) in f32 with TF32 off on the card against the CPU
 16. metric: the metric ViT-L step (392x518 core, bins head in f32) as
     process.py runs it: 24 K1 launches per step, outputs checked, K1 held
     to its plain version at every layer of one frame, that frame's depth
     within 2x the null distance; frames/s and peak memory
 17. mask-f32: a small-image SOLOv2 (full R101 and head widths) in f32
     with TF32 off on the card against the CPU: the slab on the same head
     outputs (decayed scores within 1e-5), the whole network's slab matched
     instance by instance, the valid count (> 0); the SDF green channel
     equal on both sides; the mask epilogue's kernels (composite, SDF) on
     the slab's masks equal to their plain versions
 18. mask: the mask step (SDF on) at 1080p, test scale 1333x750: outputs
     checked, one composite and one SDF launch of the mask epilogue a step
     and no other kernel; frames/s and peak memory; then on the slabs of
     the 8 frames (SOLOv2 on the card, bf16) the epilogue's kernels equal
     to their plain versions (torch.equal; the step's keep flags and every
     valid slot kept), and the kernels, the plain versions and the bytes
     bound timed
 19. fused: the three steps the fused pipeline dispatches for one batch
     (mask, metric depth, GMFlow over the 8-frame window), launches
     counted (30 K1, 6 K2, 3 K3, 15 K4, one composite and one SDF a
     batch), frames/s
 20. pf-f32, zoed-f32: PatchFusion (BEiT-L at 4 blocks, 64 features) at
     model size 64x96 on a 128x192 image, at p16 and r3, and ZoeD_N (BEiT-L
     at 4 blocks) at img_size 64x96, in f32 with TF32 off on the card
     against the CPU, within 1e-4 of the depth's scale, the same tile passes
 21. pf: PatchFusion at full width (two BEiT-L cores at 384x512, UNet, six
     G2L levels; bf16, the bins heads f32) on one 1080p frame at p49 (49
     tiles in batches of 8): s/frame, peak memory, the depth finite and in
     [1e-3, 10] m; bf16 against the same run in f32 on the card, on the
     same weights (within 2% of the depth's scale)
 22. zoed: ZoeD_N's video step (reflect pad, two passes, BEiT-L at
     384x512, bins head f32) on the 8 frames: frames/s, peak memory, depths
     in [1e-3, 10] m
 23. image: an image through process.py's band calls, in memory: rgba (no
     device work), the mask with its SDF, PatchFusion at r128 (177 tiles)
     and the depth PNG's heatmap: s/image, peak memory
     Phases 20-22 run no kernel of csrc/ (the JAX package has no Pallas
     kernel there): their launch counts must stay 0; phase 23 runs only the
     mask epilogue's two, once each.
 24. midas-f32: DPT_Large (ViT-L/16, 24 f32 K1) and MiDaS v2.1
     (ResNeXt-101 32x8d, no kernel) at full width on one 1080p frame, in
     f32 with TF32 off on the card against the CPU, within 1e-4 of the
     disparity's scale
 25. midas: the fused video steps at batch 8: midas3 (DPT_Large at
     384x224, 24 K1 a step, K1 held to its plain version at every layer of
     one frame, that frame's disparity within 2x the null distance) and
     midas2 (no kernel): frames/s, peak memory
 26. marigold: one 1080p frame through the band's non-fused infer, 10 DDIM
     steps x 10 members at 768 (100 K1 a frame: [50, 5184, 64] and [100,
     1296, 64]), s/frame, peak memory; every K1 call of one frame held to
     its plain version; the depth within 2x the null distance
 27. marigold-f32: the full-width UNet, VAE and ensembling (phase 26's
     weights, widened) on a 256x256 frame at 256, 2 members x 2 steps, in
     f32 on the card against the CPU (the same member latents), within
     1e-4 of the depth's scale, 10 f32 K1
 28. k1-refine, k2-refine: K1 and K2 at the refinement's 1/4-scale windows
     [1792, 1170, 128] bf16 (26x45 tokens, 8x8 splits: a ragged key tile in
     every window, an odd window width) against their plain versions,
     computed in window chunks; the bound shown to fail with the ragged key
     tile unmasked (K1) and with a band moved by one token row (K2);
     kernel, plain, SDPA and bound times; K3 at [7, 18720, 128] and [14,
     18720, 128] and K4 at [14, 64, 416, 720] (the /32-padded shapes) held
     and timed
 29. gmflow-refine-f32: the full-width refinement model (weights at half
     scale, as the CPU tests take them) in f32 with TF32 off on a 128x192
     pair, on the card against the CPU, 12 K1, 12 K2, 3 K3, 15 K4
 30. flow-refine: the refinement step at full width on the 8 frames (7
     pairs, 832x1440 padded): exactly 12 K1, 12 K2, 3 K3 and 15 K4 a step,
     outputs checked, pairs/s and peak memory; every kernel call of one
     pair's real activations held to its plain version; the flow within 2x
     the null distance of a plain path that rounds P as K1/K2 do
 31. raft-fused: the fused lookup in f32 on the card against the volume
     path (2 pairs at 128x192, 4 iterations: 15 K4, no K5 against 15 K4 +
     4 K5); one full-width step at 810x1440, 20 iterations, with exactly 15
     K4 and 0 K5: pairs/s and peak memory beside the volume path's
 32. trace: the ViT-L step (bf16, 8 uint8 1080p frames) twice between
     StageProfiler.start_device_trace and stop_device_trace with
     PRISMA_TPU_TRACE set: the written Chrome trace must name K1
     (flash_fwd_*) exactly 24 x 2 times and the launch counts agree; the
     traced steps' heat, min, max and depth equal the untraced steps' bit
     for bit; host ms a step with and without the trace
 33. data-parallel: the depth and GMFlow steps with devices= over every
     visible card, or two replicas on the one card where only one is
     visible (it says which), against one replica: exactly 24 K1 a replica
     (depth) and 6 K1, 6 K2, 3 K3, 15 K4 a replica with pairs (flow); the
     bf16 depth and flows within 2x the null distance of one replica with
     the plain attention (P rounded to bf16) for K1/K2, the f32 depth and
     flows (TF32 off, the band's weights) within 1e-4 of their scale, and
     the f32 split flow within that of the replicas' frames run through
     the whole step one after the other (the witness that a difference
     between split and whole comes from the batch sizes); host ms a step
     split and whole. `python3 chip_smoke.py --data-parallel` runs this
     phase alone, over two cards and over every visible card where there
     are several
 34. tools: concat_image, copy_folder, to_float_rgb and decode_depth_band
     on a synthetic folder; concat_video and a make_video /
     extract_frames_from_video round trip where the native codec loads. A
     machine without the codec's libav libraries is named with the
     loader's error, and the kernels line says "host_tools_codec": "not
     run: libav missing"; any other load error fails the phase

The line before the last is one JSON object describing each kernel of the
paths; the last line is {"ok": true, "device": {...}}.
"""

import copy
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
MAIN_SHAPE = (128, 2443, 64)  # ViT-L at 1080p, batch 8: [B*heads, tokens, d]
METRIC_SHAPE = (128, 1037, 64)  # the metric core at 392x518: 28x37 patches + cls
MIDAS_SHAPE = (128, 337, 64)  # DPT_Large at 384x224: 24x14 patches + cls
# Marigold's UNet at 768x432 (a 96x54 latent), 10 members: 5 heads over
# 5184 tokens, 10 heads over 1296 (27x48)
UNET_SHAPES = ((50, 5184, 64), (100, 1296, 64))
# [B*heads, N, d] -> the [batch, heads, N, d] an SDPA call takes
SDPA_VIEW = {MAIN_SHAPE: (8, 16), METRIC_SHAPE: (8, 16), MIDAS_SHAPE: (8, 16),
             UNET_SHAPES[0]: (10, 5), UNET_SHAPES[1]: (10, 10)}
K1_TILE_K = 128  # K1's keys per tile (csrc/flash_attention.cu)
BATCH, FRAME_HW, TIMED_STEPS = 8, (1080, 1920), 3
FLOW_HW, FEAT_HW = (810, 1440), (102, 180)  # 0.75x 1080p; its 1/8 features (/16 pad)
WIN_SHAPE = (56, 4590, 128)    # 7 pairs doubled x 4 windows of 51x90 tokens, C=128
MATCH_SHAPE = (7, 18360, 128)  # global matching: 7 pairs, 102x180 tokens
NORM_SHAPE = (14, 64, 408, 720)  # the backbone's largest instance norm
ATOL_F32 = 2e-5  # f32 K1/K2 against the plain version: sums in another order
RAFT_ITERS = 20
FUSED_STEPS = 2
MASK_F32_SCALE = (320, 192)  # SOLOv2's test-scale budget in the f32 check
MIN_DEPTH, MAX_DEPTH = 1e-3, 10.0  # the ZoeDepth config's metric range
PF_SMALL_HW, PF_SMALL_IMAGE = (64, 96), (128, 192)  # PatchFusion's f32 check
PF_TIMED = 2  # timed p49 frames
MARIGOLD_TIMED = 2  # timed Marigold frames
MIDAS_K1_PER_STEP = 24  # DPT_Large: one K1 a ViT-L block
MARIGOLD_K1_PER_FRAME = 10 * (5 + 5)  # 10 UNet calls, 5 + 5 long self-attentions
MARIGOLD_F32_HW = 256  # the f32 check's frame and processing size: 32x32 latent
# GMFlow's refinement at 0.75x 1080p padded to /32 (832x1440): 1/8 features
# 104x180 in 2x2 splits (52x90 = 4680 tokens), 1/4 features 208x360 in 8x8
# splits (26x45 = 1170 tokens); 7 pairs doubled (bidir) and doubled again
# (self + cross concat) x 64 windows
REFINE_FEAT_HW = (208, 360)
REFINE_WIN_SHAPE = (1792, 1170, 128)
REFINE_MATCH_SHAPE = (7, 18720, 128)  # 1/8 global matching, 104x180 tokens
REFINE_NORM_SHAPE = (14, 64, 416, 720)  # conv1's instance norm at 832x1440
REFINE_STEP = {"K1": 12, "K2": 12, "K3": 3, "K4": 15}
REFINE_WEIGHT_SCALE = 0.5  # the f32 flow checks' weights (tests/test_torch_gmflow.py)
ATTN_CHUNK = 256  # windows a chunk of the plain attention: 4 x 64 at ns = 8
TRACE_STEPS = 2  # traced ViT-L steps (phase 32)
K1_SYMBOL = re.compile(r"\bflash_fwd_\w+")  # K1's kernels in a trace
# the loader's error when the codec's libav libraries are not installed
LIBAV_MISSING = re.compile(r"\blib(av\w+|swscale|swresample)\.so[.\d]*: "
                           r"cannot open shared object file")
TOOLS_HW, TOOLS_FRAMES = (64, 96), 6  # phase 34's synthetic clip
# x264 at crf 15 in yuv420p loses ~1.4 levels in mean on these RGB ramps and
# ~2 on the saturated heatmap a generation (the chroma subsampling)
X264_LEVELS = 3.0
PEAK_BF16, PEAK_F32, HBM_BYTES_S, SFU_PER_CLOCK_SM = 989e12, 67e12, 3.35e12, 16
# K3's query rows per CTA and keys per tile (csrc/flash_attention_streamed.cu)
K3_TILE_Q, K3_TILE_K = 256, 128
# each row of the kernels line: its kernel symbols in csrc/ and its design
KERNEL_SYMBOLS = {
    "K1": ("flash_fwd_bf16", "flash_fwd_f32"),
    "K2": ("flash_region_bf16", "flash_region_f32"),
    "K3": ("flash_streamed_bf16", "flash_streamed_f32"),
    "K4": ("instance_norm_relu_kernel",),
    "K5": ("raft_window_lookup_kernel",),
    "K6a": ("lane_gather_kernel",),
    "K6b": ("minor_transpose_kernel", "minor_transpose_tiled_kernel"),
    "mask_composite": ("kept_composite_kernel",),
    "mask_sdf": ("sdf_green_kernel",)}
DESIGNS = {
    "K1": "wgmma+tma", "K2": "wgmma+tma",  # the bf16 kernels; f32 by FMA
    "K3": "wgmma+tma, two S in flight", "K4": "block-reduction",
    "K5": "cp.async 16-byte row chunks, two buffers of 16-pixel groups",
    "K6a": "taps windows only, spans of whole rows built in shared memory and "
           "stored with one bulk copy, two buffers, persistent grid",
    "mask_composite": "keep flags in shared memory, 16 pixels a thread, only the "
                      "kept masks read, packed byte sums, f32 and marked bytes out",
    "mask_sdf": "tiles of 32x192 with a 66-column halo: column sweeps to capped "
                "vertical distances, their squares packed in shared memory, a "
                "133-tap integer minimum a pixel, 16 columns a thread",
    "K6b": "whole slabs in and out by bulk copy, two buffers each way, a "
           "bank-shifted transpose in shared memory, persistent 1-D grid"}
SASS_OPS = ("HGMMA", "UTMALDG", "LDGSTS", "HMMA", "UBLKCP")


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


def device_us(fns, symbols, calls=50):
    """{key: device microseconds per call} of fns[key] from torch.profiler:
    the device time of the kernels whose name holds symbols[key]."""
    prof_kw = dict(activities=[torch.profiler.ProfilerActivity.CPU,
                               torch.profiler.ProfilerActivity.CUDA])
    out = {}
    for key, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(**prof_kw) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and symbols[key] in e.key)
        out[key] = total / calls
    return out


def bound(flops, nbytes):
    """(ms, 'operations' or 'bytes'): the least time the card could take,
    the larger of the operations at the bf16 tensor-core peak and the bytes
    (each input read once, each output written once) at the HBM rate."""
    t_ops, t_bytes = flops / PEAK_BF16, nbytes / HBM_BYTES_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def attn_tols(ref):
    """K1/K2's (max, mean) bounds against their plain version: bf16_bounds
    for bf16, ATOL_F32 for f32."""
    from prisma_tpu_torch.ops.cuda import flash_attention as fa
    return fa.bf16_bounds(ref) if ref.dtype == torch.bfloat16 \
        else (ATOL_F32, ATOL_F32)


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


def kernel_label(mangled):
    """'flash_fwd_bf16<64>' from a mangled kernel symbol of csrc/, or None."""
    for symbols in KERNEL_SYMBOLS.values():
        for sym in symbols:
            m = re.search(rf"\d{sym}(?:I(.+?)E)?E", mangled)
            if m:
                args = [re.sub(r"^(Li|Lb|\d+)", "", a) for a in (m[1] or "").split("E")]
                args = [{"f": "float", "j": "uint32", "t": "uint16",
                         "__nv_bfloat16": "bf16"}.get(a, a)
                        for a in args if a]
                return f"{sym}<{', '.join(args)}>" if args else sym
    return None


def ptxas_table(log_path):
    """{kernel label: {registers, spill_stores, spill_loads}} from the
    -Xptxas -v lines nvcc left beside a library."""
    table, label = {}, None
    with open(log_path) as f:
        for line in f:
            if "Compiling entry function" in line:
                label = kernel_label(line.split("'")[1])  # None: not a path's kernel
                if label:
                    table[label] = {}
            elif label and "spill stores" in line:
                table[label].update(
                    spill_stores=int(re.search(r"(\d+) bytes spill stores", line)[1]),
                    spill_loads=int(re.search(r"(\d+) bytes spill loads", line)[1]))
            elif label and re.search(r"Used \d+ registers", line):
                table[label]["registers"] = int(re.search(r"Used (\d+) registers",
                                                          line)[1])
    return table


def sass_counts(lib_path):
    """{kernel label: {opcode: count}} of SASS_OPS in a built library, from
    the toolkit's cuobjdump (or Triton's copy of it)."""
    cands = [shutil.which("cuobjdump"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                          "cuobjdump")]
    try:
        import triton
        cands.append(os.path.join(os.path.dirname(triton.__file__), "backends",
                                  "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    tool = next((c for c in cands if c and os.path.exists(c)), None)
    if tool is None:
        fail("no cuobjdump (toolkit or Triton) to read the kernels' SASS")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, label = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            label = kernel_label(line.split("Function :")[1].strip())
            if label:
                counts[label] = dict.fromkeys(SASS_OPS, 0)
        elif label:
            m = re.search(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
            if m and m[1] in SASS_OPS:
                counts[label][m[1]] += 1
    return counts


def launch_counters():
    """The kernel wrappers' launch counters -> (counters, per_path,
    zero_counts, read_counts)."""
    from prisma_tpu_torch.ops.cuda import flash_attention as fa
    from prisma_tpu_torch.ops.cuda import instance_norm as inorm
    from prisma_tpu_torch.ops.cuda import mask_epilogue as me
    from prisma_tpu_torch.ops.cuda import probe_gather as pg
    from prisma_tpu_torch.ops.cuda import raft_lookup as rl
    counters = {"K1": (fa.flash_attention, "launches"),
                "K2": (fa.flash_attention, "region_launches"),
                "K3": (fa.flash_attention_streamed, "launches"),
                "K4": (inorm.instance_norm_relu, "launches"),
                "K5": (rl.window_lookup, "launches"),
                "K6a": (pg.lane_gather, "launches"),
                "K6b": (pg.minor_transpose, "launches"),
                "mask_composite": (me.kept_composite, "launches"),
                "mask_sdf": (me.sdf_green, "launches")}

    def per_path(**n):
        """Expected launches: n for the named kernels, 0 for the others."""
        return {key: n.get(key, 0) for key in counters}

    def zero_counts():
        for obj, attr in counters.values():
            setattr(obj, attr, 0)

    def read_counts():
        return {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}

    return counters, per_path, zero_counts, read_counts


def card_info():
    """("name, power limit" of the first card as nvidia-smi gives them, its
    max SM clock in Hz)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    fields = [f.strip() for f in smi.stdout.strip().splitlines()[0].split(",")]
    return f"{fields[0]}, {fields[1]}", float(fields[2].split()[0]) * 1e6


def data_parallel_main():
    """`python3 chip_smoke.py --data-parallel`: phase 33 alone, over two
    cards and over every visible card (`parallel.mesh.data_devices`) where
    more than one is visible, else over two replicas on the one card.
    Prints its lines and no result line."""
    if not torch.cuda.is_available():
        fail("no CUDA device: this check runs only on the card")
    sys.path.insert(0, HERE)
    from prisma_tpu_torch.ops.cuda import build
    from prisma_tpu_torch.parallel import mesh
    from prisma_tpu_torch.runtime.config import RuntimeConfig

    _, per_path, zero_counts, read_counts = launch_counters()
    card, _ = card_info()
    print(card)
    n_cards = torch.cuda.device_count()
    say("env", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{n_cards} device(s): " + "; ".join(
            torch.cuda.get_device_name(i) for i in range(n_cards)))
    t0 = time.perf_counter()
    for name in build.build_all():
        build.load(name)
    say("build", f"in {time.perf_counter() - t0:.2f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runtime = RuntimeConfig(random_weights=True, compute_dtype="bfloat16",
                            device="cuda")
    frames = np.random.default_rng(0).integers(
        0, 256, size=(BATCH, *FRAME_HW, 3), dtype=np.uint8)
    if n_cards > 1:
        every = mesh.data_devices(runtime.device)
        configs = [(every[:2], "2 cards, one replica each", "_2cards")]
        if len(every) > 2 and BATCH % len(every) == 0:
            configs.append((every, f"every visible card ({len(every)}, "
                            f"mesh.data_devices), one replica each",
                            f"_{len(every)}cards"))
    else:
        configs = [(*default_devices(), "")]
    for devices, where, tag in configs:
        data_parallel_paths(runtime, frames, card, zero_counts, read_counts,
                            per_path, devices, where, tag)
    say("data-parallel", f"every configuration passed; on {card}")


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: this check runs only on the card")
    sys.path.insert(0, HERE)
    from prisma_tpu_torch.bands import (depth_anything_band, depth_base,
                                        flow_base, flow_gmflow_band,
                                        flow_raft_band, mask_band, multiband)
    from prisma_tpu_torch.models import depth_anything as da
    from prisma_tpu_torch.models import gmflow as gm
    from prisma_tpu_torch.models import raft, solov2, vit
    from prisma_tpu_torch.models import zoedepth as zoe
    from prisma_tpu_torch.models.vit import ViTConfig
    from prisma_tpu_torch.ops import nn as pnn
    from prisma_tpu_torch.ops import sdf
    from prisma_tpu_torch.ops.cuda import build
    from prisma_tpu_torch.ops.cuda import flash_attention as fa
    from prisma_tpu_torch.ops.cuda import instance_norm as inorm
    from prisma_tpu_torch.ops.cuda import probe_gather as pg
    from prisma_tpu_torch.ops.cuda import raft_lookup as rl
    from prisma_tpu_torch.ops.resize import resize2d
    from prisma_tpu_torch.runtime import check_gather, check_lookup, launch_cost
    from prisma_tpu_torch.runtime import check_mask_epilogue as cme
    from prisma_tpu_torch.runtime.config import RuntimeConfig
    from prisma_tpu_torch.weights import store
    import torch.nn.functional as F
    plain_p_bf16 = functools.partial(fa.flash_attention_ref, round_p=True)
    counters, per_path, zero_counts, read_counts = launch_counters()

    # 1. environment
    card, max_sm_hz = card_info()
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
    regs = {}
    for name, path in libs.items():
        table = ptxas_table(path + ".log")
        regs.update(table)
        say("build", f"{os.path.relpath(path, HERE)}; ptxas (registers, spill "
            f"stores/loads in bytes): " + " | ".join(
                f"{label} {r['registers']}, {r['spill_stores']}/{r['spill_loads']}"
                for label, r in table.items()))
    sass = {**sass_counts(libs["flash_attention"]),
            **sass_counts(libs["flash_attention_streamed"])}
    bf16_sass = {label: c for label, c in sass.items() if "_bf16" in label}
    for label, c in bf16_sass.items():
        say("build", f"SASS of {label}: " + ", ".join(f"{op} {n}" for op, n in c.items())
            + f"; {regs[label]['registers']} registers a thread at launch (the "
            f"consumer warpgroups raise theirs with setmaxnreg), "
            f"{regs[label]['spill_stores']} bytes of spill stores")
    # flash_fwd_bf16 and flash_region_bf16 at d = 32, 64 and 128, and
    # flash_streamed_bf16 at d = 32, 64, 128 and dv padded to 2 or 4
    if len(bf16_sass) != 12 or any(c["HGMMA"] == 0 or c["HMMA"] for c in bf16_sass.values()):
        fail(f"the bf16 attention kernels must run on wgmma (HGMMA) and not on "
             f"the legacy mma.sync path (HMMA): {bf16_sass}")
    for name in ("flash_attention", "flash_attention_streamed"):
        with open(libs[name] + ".log") as f:
            serialized = f.read().count("wgmma.mma_async instructions are serialized")
        say("build", f"{name}.cu: ptxas serialized the wgmma of {serialized} "
            f"kernel(s) (C7514/C7515)")
        if serialized:
            fail(f"ptxas serialized the wgmma of {serialized} kernel(s) of "
                 f"{name}.cu: a wgmma group's accumulator is touched, or a "
                 f"branch taken, between its issue and its wait")
    k5_sass = sass_counts(libs["raft_lookup"])
    say("build", "SASS of raft_lookup.cu: " + " | ".join(
        f"{label} " + ", ".join(f"{op} {n}" for op, n in c.items())
        for label, c in k5_sass.items()))
    # raft_window_lookup_kernel<L, T> for L = 1..4 levels, T = float, bf16
    if len(k5_sass) != 8 or any(c["LDGSTS"] == 0 for c in k5_sass.values()):
        fail(f"K5's kernels must load their patch rows with cp.async (LDGSTS): "
             f"{k5_sass}")
    k6_sass = sass_counts(libs["probe_gather"])
    say("build", "probe_gather.cu (registers, spill stores/loads in bytes; "
        "bulk copies): " + " | ".join(
            f"{label} {regs[label]['registers']}, {regs[label]['spill_stores']}/"
            f"{regs[label]['spill_loads']}; UBLKCP {c['UBLKCP']}"
            for label, c in k6_sass.items()))
    # lane_gather_kernel and minor_transpose_kernel for 4- and 2-byte values
    # (the tiled path of slabs larger than a buffer has none)
    bulk = {label: c for label, c in k6_sass.items()
            if label.split("<")[0] in ("lane_gather_kernel", "minor_transpose_kernel")}
    if len(bulk) != 4 or any(c["UBLKCP"] == 0 for c in bulk.values()):
        fail(f"K6a's and K6b's kernels must move their spans and slabs with bulk "
             f"copies (UBLKCP): {k6_sass}")

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
    k1 = {"at_midas_marigold": []}
    for shape, dtype in ((MAIN_SHAPE, torch.bfloat16),
                         (METRIC_SHAPE, torch.bfloat16),  # 8 rows past a tile
                         (MIDAS_SHAPE, torch.bfloat16),  # ragged: 337 rows
                         *((s_, torch.bfloat16) for s_ in UNET_SHAPES),
                         ((6, 100, 32), torch.float32),
                         ((6, 100, 32), torch.bfloat16),  # ragged bf16, d=32
                         ((4, 1024, 128), torch.bfloat16),
                         # the 128-row tiles' edges at d=128: one key, one
                         # short of a tile, one over (two tiles)
                         ((4, 1, 128), torch.bfloat16),
                         ((4, 127, 128), torch.bfloat16),
                         ((4, 129, 128), torch.bfloat16)):
        q, k, v = (normal(shape, dtype) for _ in range(3))
        out = fa.flash_attention(q, k, v)
        ref = (plain_p_bf16 if dtype == torch.bfloat16
               else fa.flash_attention_ref)(q, k, v)
        max_err = report("k1", f"{list(shape)} {str(dtype)[6:]}", out, ref,
                         attn_tols(ref))
        if shape in (MIDAS_SHAPE, *UNET_SHAPES):
            # the ragged key tile left unmasked: zero keys and values up to
            # the next multiple of K1's key tile join every row's softmax
            pad = -shape[1] % K1_TILE_K
            kp, vp = (F.pad(t, (0, 0, 0, pad)) for t in (k, v))
            must_fail("k1", f"{list(shape)} with its last key tile unmasked "
                      f"({pad} zero keys)", out,
                      plain_p_bf16(F.pad(q, (0, 0, 0, pad)), kp, vp)[:, :shape[1]],
                      attn_tols(ref))
        if shape in SDPA_VIEW:
            B, N, d = shape
            ms = cuda_ms(lambda: fa.flash_attention(q, k, v), 20)
            plain_ms = cuda_ms(lambda: fa.flash_attention_ref(q, k, v), 5)
            q4, k4, v4 = (t.view(*SDPA_VIEW[shape], N, d) for t in (q, k, v))
            lib_ms = library_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4))
            bound_ms, bound_by = bound(4 * B * N * N * d, nbytes(q, k, v, out))
            timing = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)
            if shape == MAIN_SHAPE:
                k1.update(timing)
            elif shape == METRIC_SHAPE:
                k1["at_metric_core"] = dict(shape=list(shape), **timing)
            else:
                k1["at_midas_marigold"].append(dict(shape=list(shape), **timing))
            say("k1", f"time at {list(shape)} bf16: kernel {ms:.4f} ms "
                f"({4 * B * N * N * d / (ms * 1e-3) / 1e12:.1f} TFLOP/s, "
                f"{bound_ms / ms:.1%} of the bound), plain "
                f"{plain_ms:.4f} ms, scaled_dot_product_attention "
                f"{lib_ms} ms on {[*SDPA_VIEW[shape], N, d]}, bound "
                f"{bound_ms:.4f} ms ({bound_by}), on {card}")
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
    k1_checked = layer_checked(layers, plain_p_bf16)

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
        f"({4 * B * N * N * d / (ms * 1e-3) / 1e12:.1f} TFLOP/s, "
        f"{bound_ms / ms:.1%} of the bound), plain "
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
    say("k1", f"time at {list(WIN_SHAPE)} bf16: kernel {ms:.3f} ms "
        f"({4 * B * N * N * d / (ms * 1e-3) / 1e12:.1f} TFLOP/s, "
        f"{bound_ms / ms:.1%} of the bound), plain {plain_ms:.3f} ms, "
        f"scaled_dot_product_attention {lib_ms} ms, bound {bound_ms:.3f} ms "
        f"({bound_by})")
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
    scale = dm ** -0.5

    def k3_l2_bytes(B, N, M, d, dv):
        """A model, not a measurement, of the bytes a K3 call reads through
        L2, from the tile schedule: each 256-query CTA reads its batch row's
        whole K and v, plus Q once and out once."""
        tiles = -(-N // K3_TILE_Q)
        return B * tiles * M * (2 * d + 4 * dv) + B * N * (2 * d + 4 * dv)

    def k3_times(label, q, k, v, iters):
        """Kernel, plain, SDPA (v cast to bf16 and padded to d: not the same
        numerics) and bound times at one shape; the exp2 time and the L2
        bytes, both modeled, only in the printed line."""
        B, N, d = q.shape
        M, dv = k.shape[1], v.shape[-1]
        out = fa.flash_attention_streamed(q, k, v, scale)
        ms = cuda_ms(lambda: fa.flash_attention_streamed(q, k, v, scale), iters)
        plain_ms = cuda_ms(lambda: fa.flash_attention_streamed_ref(q, k, v, scale), 3)
        vpad = F.pad(v.to(torch.bfloat16), (0, d - dv))[:, None]
        lib_ms = library_ms(lambda: F.scaled_dot_product_attention(
            q[:, None], k[:, None], vpad), 5)
        bound_ms, bound_by = bound(2 * B * N * M * (d + dv), nbytes(q, k, v, out))
        exp_ms = 1e3 * B * N * M / (n_sm * SFU_PER_CLOCK_SM * max_sm_hz)
        l2 = k3_l2_bytes(B, N, M, d, dv)
        say("k3", f"time at {label} {[B, N, d]}, dv {dv}: kernel {ms:.3f} ms "
            f"({2 * B * N * M * (d + dv) / (ms * 1e-3) / 1e12:.1f} TFLOP/s, "
            f"{bound_ms / ms:.1%} of the bound), plain {plain_ms:.3f} ms, "
            f"scaled_dot_product_attention with v cast to bf16 and padded to "
            f"{d} (not the same numerics) {lib_ms} ms, bound {bound_ms:.3f} ms "
            f"({bound_by}: tensor cores); modeled, not measured: the "
            f"{B * N * M:.3e} exp2 at {SFU_PER_CLOCK_SM}/clock/SM take "
            f"{exp_ms:.3f} ms, and the tile schedule reads {l2 / 1e9:.2f} GB "
            f"through L2 ({K3_TILE_Q}-query CTAs each reading their row's K "
            f"and v; {l2 / (ms * 1e-3) / 1e12:.2f} TB/s at the kernel's time)")
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=lib_ms)

    q, k = (normal(MATCH_SHAPE, torch.bfloat16) for _ in range(2))
    v = grid[None].expand(Bm, Nm, 2).contiguous()
    k3_err = report("k3", f"matching {list(MATCH_SHAPE)} bf16, v = the "
                    f"{FEAT_HW[0]}x{FEAT_HW[1]} pixel grid f32",
                    fa.flash_attention_streamed(q, k, v, scale),
                    fa.flash_attention_streamed_ref(q, k, v, scale),
                    fa.streamed_bounds(v))
    k3 = dict(max_abs_err=k3_err, **k3_times("matching", q, k, v, 10))
    # peaked: keys a permutation of the queries times 4, each softmax nearly
    # one-hot (out ~ v of the query's own key), so a v row taken from the
    # wrong key tile moves the output by whole pixels; with v shifted by one
    # key tile (the neighbouring ring slot) the bound must fail
    perm = torch.randperm(Nm, generator=gen, device="cuda")
    k = (q[:, perm].float() * 4).to(torch.bfloat16)
    ref = fa.flash_attention_streamed_ref(q, k, v, scale)
    report("k3", "peaked (keys = 4 x the queries permuted)",
           fa.flash_attention_streamed(q, k, v, scale), ref, fa.streamed_bounds(v))
    must_fail("k3", f"v shifted by one key tile ({K3_TILE_K} keys) on the peaked case",
              fa.flash_attention_streamed(q, k, v.roll(K3_TILE_K, dims=1), scale),
              ref, fa.streamed_bounds(v))
    del q, k, v, ref
    torch.cuda.empty_cache()
    # propagation: 14 rows, q and k projected features, v the f32 flow
    q, k = (normal((14, Nm, dm), torch.bfloat16) for _ in range(2))
    v = normal((14, Nm, 2), torch.float32, scale=40.0)
    report("k3", f"propagation [14, {Nm}, {dm}] bf16, v = a flow f32",
           fa.flash_attention_streamed(q, k, v, scale),
           fa.flash_attention_streamed_ref(q, k, v, scale), fa.streamed_bounds(v))
    k3["at_propagation"] = dict(shape=[14, Nm, dm],
                                **k3_times("propagation", q, k, v, 5))
    del q, k, v
    torch.cuda.empty_cache()
    # ragged keys, and the same keys with the tail left unmasked
    M = Nm + 37
    q = normal(MATCH_SHAPE, torch.bfloat16)
    k = normal((Bm, M, dm), torch.bfloat16)
    v = torch.from_numpy(rng.uniform(0, 1440, size=(Bm, M, 2))
                         .astype(np.float32)).cuda()
    ref = fa.flash_attention_streamed_ref(q, k, v, scale)
    report("k3", f"ragged M = {M} (a last tile of {M % K3_TILE_K} keys)",
           fa.flash_attention_streamed(q, k, v, scale), ref,
           fa.streamed_bounds(v))
    pad = (-M) % K3_TILE_K
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

    # one pair's real activations, each kernel call held; the null check
    x = torch.from_numpy(frames[:2]).cuda()
    with torch.inference_mode():
        ds = resize2d(x.float(), FLOW_HW, method="cubic").to(torch.bfloat16)
    gmflow_pair("flow", infer, model, ds, per_step)
    del model, step, outs, ds
    torch.cuda.empty_cache()

    # 11. K5: RAFT's window lookup, on the pyramid of the RAFT main shape
    say("k5", "tolerances: equal to the plain version value for value (the "
        "same f32 blend in the same order on both sides, one cast); the bounds "
        "of the fault checks: bf16 max |err| <= 1 ulp of max |ref|, mean <= "
        "2^-12 of mean |ref|; f32 max <= 1e-6 of max |ref|, mean <= 2^-20 of "
        "mean |ref|")

    def k5_equal(label, pyr, coords):
        out = rl.window_lookup(pyr, coords)
        torch.cuda.synchronize()
        ref = rl.window_lookup_ref(pyr, coords)
        max_err = report("k5", label, out, ref, rl.bounds(ref))
        if not torch.equal(out, ref):
            fail(f"k5 {label}: the kernel is not equal to its plain version")
        far = ~torch.isfinite(coords).all(1) | (coords.abs() > 1e5).any(1)
        if not bool((out[far] == 0).all()):
            fail(f"k5 {label}: a centre at +-1e6, +-inf or NaN gave a nonzero "
                 f"window")
        return out, ref, max_err

    pyr, coords = check_lookup.main_case(gen)
    N5 = coords.shape[0]
    shapes = " ".join(f"{h}x{w}" for h, w in (v.shape[1:] for v in pyr))
    out, ref, k5_err = k5_equal(
        f"N = {N5} ({check_lookup.IMAGES} x {FEAT_HW[0]}x{FEAT_HW[1]}), levels "
        f"{shapes} bf16, centres the grid +- {check_lookup.OFFSET:.0f} px, "
        f"{len(check_lookup.SPECIALS)} at +-1e6, +-inf or NaN", pyr, coords)
    say("k5", "equal to the plain version; centres at +-1e6, +-inf and NaN: "
        "all-zero windows ok")
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
    lib_ms = library_ms(check_lookup.grid_sample_lookup(pyr, coords), 5)
    sectors, k5_bytes = check_lookup.touched_bytes(pyr, coords)
    k5_ops = 11 * out.numel()  # per tap 4 weights, 4 products, 3 sums (f32)
    t_ops, t_bytes = k5_ops / PEAK_F32, k5_bytes / HBM_BYTES_S
    k5 = dict(max_abs_err=k5_err, ms=ms, plain_ms=plain_ms,
              bound_ms=1e3 * max(t_ops, t_bytes),
              bound_by="operations" if t_ops >= t_bytes else "bytes",
              library_ms=lib_ms, bound_bytes=k5_bytes,
              blocks_per_sm=rl.blocks_per_sm(torch.bfloat16, len(pyr)))
    say("k5", f"time at N = {N5}, four levels, bf16: kernel {ms:.4f} ms "
        f"({k5_bytes / (ms * 1e-3) / 1e12:.2f} TB/s of the bytes the windows "
        f"touch, {100 * k5['bound_ms'] / ms:.1f}% of the bound), plain "
        f"{plain_ms:.3f} ms, grid_sample (4 levels, bf16 grid) {lib_ms} ms, "
        f"bound {k5['bound_ms']:.4f} ms ({k5['bound_by']}: {sectors} 32-byte "
        f"sectors of in-range patch rows, {k5_bytes / 1e9:.3f} GB with the "
        f"outputs and coords; the whole pyramid is {nbytes(*pyr) / 1e9:.2f} "
        f"GB); {k5['blocks_per_sm']} blocks of 256 threads an SM")
    if ms > 3 * k5["bound_ms"]:
        fail(f"k5: {ms:.4f} ms is over 3x its bound ({3 * k5['bound_ms']:.4f} ms)")
    if lib_ms is not None and ms > lib_ms:
        fail(f"k5: {ms:.4f} ms is slower than grid_sample's {lib_ms:.4f} ms")
    del pyr, out, coords
    torch.cuda.empty_cache()
    # ragged: odd levels in f32, bf16 with an empty level, and bf16 of odd
    # widths at centres on every edge and row start
    for label, rag, c in check_lookup.ragged_cases(gen):
        k5_equal(label, rag, c)

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
    raft_volume = {"peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    zero_counts()
    t0 = time.perf_counter()
    outs = [step(frames) for _ in range(TIMED_STEPS)]
    elapsed = time.perf_counter() - t0
    raft_counts = read_counts()
    raft_volume["pairs_s"] = P * TIMED_STEPS / elapsed
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
    ratios = held(calls)
    k5_equal_calls = []

    def lookup_checked(pyramid, coords, r=4):
        ref = rl.window_lookup_ref(pyramid, coords, r)
        out = rl.window_lookup(pyramid, coords, r)
        k5_equal_calls.append(torch.equal(out, ref))
        return ratios("K5", out, ref, rl.bounds(ref))

    paths = {
        "kernels": (lookup_checked, norm_held(ratios)),
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
    ok = n_calls == raft_step and all(r[2] for v in calls.values() for r in v) \
        and all(k5_equal_calls)
    say("raft", "pair 0, every K4 and K5 call against its plain version on the "
        "real activations, worst |err| / tol (max, mean): " + "; ".join(
            f"{key} x{len(v)} {max(r[0] for r in v):.3f}, "
            f"{max(r[1] for r in v):.3f}" for key, v in calls.items())
        + f"; K5 equal to it in {sum(k5_equal_calls)} of "
        f"{len(k5_equal_calls)} calls {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"a kernel disagrees with its plain version on the RAFT path's "
             f"activations ({n_calls} calls)")
    null_check("raft", "flow", flows["kernels"], flows["plain"],
               flows["plain_bf16_blend"], 1.0, unit="px",
               null_label="plain with the lookup blended in bf16")
    del model, step, outs, flows, ds
    torch.cuda.empty_cache()

    # 14. K6: the probe kernels at the probe's shapes, ragged ones and one
    # RAFT level-0 iteration's size
    # the probe's offsets come from the run's numpy stream, as this phase has
    # always drawn them, so that the later phases' inputs stay as they were
    probe_offsets = [torch.from_numpy(rng.integers(lo, hi, shape[0]).astype(np.int32))
                     .cuda() for shape, lo, hi in check_gather.PROBE_A]
    cases_a, cases_b = check_gather.small_cases(gen, probe_offsets)
    zero_counts()
    outs_a = [pg.lane_gather(x, off, taps) for _, x, off, taps in cases_a]
    outs_b = [pg.minor_transpose(x) for _, x in cases_b]
    torch.cuda.synchronize()
    probe_counts = read_counts()
    if probe_counts != per_path(K6a=len(cases_a), K6b=len(cases_b)):
        fail(f"probe launches {probe_counts}")
    for (label, x, off, taps), out in zip(cases_a, outs_a):
        if not check_gather.gather_equal(x, off, taps, out):
            fail(f"k6: lane_gather at {label} differs from its plain version")
    for (label, x), out in zip(cases_b, outs_b):
        if not check_gather.transpose_equal(x, out):
            fail(f"k6: minor_transpose at {label} differs from its plain version")
    say("k6", "lane_gather at " + ", ".join(c[0] for c in cases_a)
        + "; minor_transpose at " + ", ".join(c[0] for c in cases_b)
        + f": equal to the plain versions bit for bit; launches {probe_counts} ok")
    _, x, off, _ = cases_a[4]  # the probe's perf shape [5760, 102], f32
    li = torch.arange(x.shape[1], device="cuda").clamp_max(9)
    idx = (off.long()[:, None] + li).clamp(0, x.shape[1] - 1)
    xt = cases_b[0][1]  # [8, 180, 16] f32
    probe_calls = {"K6a": lambda: pg.lane_gather(x, off, 10),
                   "K6b": lambda: pg.minor_transpose(xt),
                   "empty": lambda: launch_cost.empty_launch(x.get_device())}
    host = {key: launch_cost.host_us(fn) for key, fn in probe_calls.items()}
    device = device_us(probe_calls, {"K6a": "lane_gather_kernel",
                                     "K6b": "minor_transpose_kernel",
                                     "empty": "empty_kernel"})
    empty_ms = cuda_ms(probe_calls["empty"], 50)
    at_probe = {
        "K6a": dict(shape=list(x.shape), ms=cuda_ms(probe_calls["K6a"], 50),
                    plain_ms=cuda_ms(lambda: pg.lane_gather_ref(x, off, 10), 50),
                    bound_ms=1e3 * check_gather.gather_bytes(x, 10)["windows"]
                    / HBM_BYTES_S,
                    library_ms=library_ms(lambda: torch.gather(x, 1, idx), 50),
                    host_us=host["K6a"], device_ms=device["K6a"] / 1e3,
                    empty_launch_ms=empty_ms),
        "K6b": dict(shape=list(xt.shape), ms=cuda_ms(probe_calls["K6b"], 50),
                    plain_ms=cuda_ms(lambda: pg.minor_transpose_ref(xt), 50),
                    bound_ms=1e3 * check_gather.transpose_bytes(xt) / HBM_BYTES_S,
                    library_ms=library_ms(lambda: xt.transpose(1, 2).contiguous(), 50),
                    host_us=host["K6b"], device_ms=device["K6b"] / 1e3,
                    empty_launch_ms=empty_ms)}
    pa, pb = at_probe["K6a"], at_probe["K6b"]
    say("k6", f"time at the probe's shapes, lane_gather [5760, 102] f32: kernel "
        f"{pa['ms']:.4f} ms, plain {pa['plain_ms']:.4f} ms, torch.gather "
        f"{pa['library_ms']} ms, bound {pa['bound_ms']:.4f} ms; minor_transpose "
        f"[8, 180, 16] f32: kernel {pb['ms']:.4f} ms, plain {pb['plain_ms']:.4f} ms, "
        f".transpose(1, 2).contiguous() {pb['library_ms']} ms, bound "
        f"{pb['bound_ms']:.4f} ms (CUDA events over 50 launches back to back)")
    say("k6", f"the launch path: an empty kernel {empty_ms:.4f} ms back to "
        f"back; host time per wrapper call (1000 calls, no sync): lane_gather "
        f"{host['K6a']:.2f} us, minor_transpose {host['K6b']:.2f} us, empty "
        f"{host['empty']:.2f} us; device time alone (torch.profiler): "
        f"lane_gather {device['K6a']:.2f} us, minor_transpose "
        f"{device['K6b']:.2f} us, empty {device['empty']:.2f} us")
    del cases_a, cases_b, outs_a, outs_b, x, off, idx, xt, probe_calls
    torch.cuda.empty_cache()
    # one RAFT level-0 iteration's size, one case at a time (up to 5.4 GB an
    # input): counts zeroed before each case's launch and read after it
    say("k6", f"at scale: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB of the "
        f"card held by earlier phases")
    at_scale = {"K6a": [], "K6b": []}
    for kernel, label, make in check_gather.scale_cases(gen):
        inputs = make()
        zero_counts()
        out = (pg.lane_gather(*inputs, check_gather.TAPS) if kernel == "K6a"
               else pg.minor_transpose(*inputs))
        torch.cuda.synchronize()
        counts = read_counts()
        if counts != per_path(**{kernel: 1}):
            fail(f"k6: launches at {label}: {counts}")
        probe_counts = {key: probe_counts[key] + counts[key] for key in counts}
        if not (check_gather.gather_equal(*inputs, check_gather.TAPS, out)
                if kernel == "K6a" else check_gather.transpose_equal(*inputs, out)):
            fail(f"k6: {label} differs from its plain version")
        del out
        t = (check_gather.time_gather(*inputs, check_gather.TAPS) if kernel == "K6a"
             else check_gather.time_transpose(*inputs))
        say("k6", check_gather.describe(f"{label}, equal bit for bit", t)
            + f" (CUDA events, back to back, inputs far past the 50 MB L2); on {card}")
        at_scale[kernel].append(dict(shape=list(inputs[0].shape),
                                     dtype=str(inputs[0].dtype)[6:], **t))
        del inputs
        torch.cuda.empty_cache()

    def k6_row(key):
        """The kernels line's row: this run's numbers at the first at-scale
        case (f32), the others and the probe's shape beside them; the
        previous design's times stay in the phase's lines."""
        cases = [{k: v for k, v in c.items() if not k.startswith("previous")}
                 for c in at_scale[key]]
        first = cases[0]
        return dict(max_abs_err=0.0, **{k: first[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            shape=first["shape"], at_scale=cases[1:], at_probe_shape=at_probe[key],
            **({"bound_whole_x_ms": first["bound_whole_x_ms"],
                "bound_counts": "windows: each row's taps window, the output and "
                                "the offsets (bound_ms); whole_x: all of x read"}
               if key == "K6a" else {}))
    k6a, k6b = k6_row("K6a"), k6_row("K6b")
    say("k6", f"launches over the phase {probe_counts} ok")

    # 15. metric Depth-Anything in f32 on the card (TF32 off) against the CPU
    vits = vit.VIT_CONFIGS["vits"]
    cpu_metric = zoe.init_params(zoe.build(vits, 64),
                                 torch.Generator().manual_seed(0))
    gpu_metric = copy.deepcopy(cpu_metric).cuda()
    small = torch.from_numpy(rng.integers(0, 256, size=(2, 64, 96, 3),
                                          dtype=np.uint8))
    with torch.inference_mode():
        d_cpu = zoe.metric_depth_anything_infer(cpu_metric, small,
                                                img_size=(126, 168))
        zero_counts()
        d_gpu = zoe.metric_depth_anything_infer(gpu_metric, small.cuda(),
                                                img_size=(126, 168)).cpu()
    counts = read_counts()
    err = float((d_gpu - d_cpu).abs().max())
    tol = 1e-4 * float(d_cpu.abs().max())
    ok = (counts == per_path(K1=vits.depth) and bool(torch.isfinite(d_gpu).all())
          and err <= tol)
    say("metric-f32", f"metric Depth-Anything (vits core, DPT 64, the full "
        f"bins head: 64 bins, attractors 16/8/4/1) 2x64x96 at 126x168, f32: "
        f"max |depth_gpu - depth_cpu| {err:.3e} m, tol {tol:.3e} m (1e-4 of "
        f"the depth scale, max {float(d_cpu.abs().max()):.3f} m: f32 both "
        f"sides, sums in another order); launches {counts} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the f32 metric model on the card disagrees with the CPU")
    del cpu_metric, gpu_metric

    # 16. the metric Depth-Anything path at full width (process.py's depth)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metric_model, metric_infer, metric_flip = depth_anything_band.build_infer(
        runtime, encoder="vitl", metric="outdoor")
    metric_step = depth_base.make_step(metric_model, metric_infer, metric_flip,
                                       need_depth=False)
    metric_step(frames)  # warm-up
    say("metric", f"metric Depth-Anything: ViT-L core (1024 wide, 24 blocks, "
        f"16 heads) + DPT 256 at 392x518 (28x37 patches) in bf16, the bins "
        f"head in f32, random weights: set-up and warm-up "
        f"{time.perf_counter() - t0:.2f} s")
    zero_counts()
    t0 = time.perf_counter()
    outs = [metric_step(frames) for _ in range(TIMED_STEPS)]
    elapsed = time.perf_counter() - t0
    metric_counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for out in outs:
        heat, dmin, dmax = out["heat"], out["min"], out["max"]
        if heat.shape != (BATCH, *FRAME_HW, 3) or heat.dtype != np.uint8:
            fail(f"metric heat {heat.shape} {heat.dtype}")
        if not (np.isfinite(dmin).all() and np.isfinite(dmax).all()
                and (dmin <= dmax).all()):
            fail(f"metric min/max not finite or not min <= max: {dmin} {dmax}")
    expect = per_path(K1=24 * TIMED_STEPS)
    if metric_counts != expect:
        fail(f"metric launches in {TIMED_STEPS} steps: {metric_counts}, "
             f"expected {expect}")
    metric_ms = elapsed / TIMED_STEPS * 1e3
    say("metric", f"{TIMED_STEPS} steps: heat {list(outs[0]['heat'].shape)} "
        f"uint8, min <= max and finite per frame (frame 0: "
        f"{outs[0]['min'][0]:.4f}-{outs[0]['max'][0]:.4f} m); launches "
        f"{metric_counts} (24 K1 per step) ok")
    say("metric", f"{BATCH * TIMED_STEPS / elapsed:.2f} frames/s "
        f"({metric_ms:.1f} ms per batch-8 step, host clock, H2D and D2H "
        f"included; K1 at [128, 1037, 64] {24 * k1['at_metric_core']['ms']:.1f}"
        f" ms of it at its own time); peak memory {peak:.2f} GiB; on {card}")
    layers.clear()
    depth = {}
    with torch.inference_mode():
        for name, attn in (("k1", k1_checked),
                           ("plain", fa.flash_attention_ref),
                           ("plain_p_bf16", plain_p_bf16)):
            pnn.flash_attention = attn
            try:
                depth[name] = metric_infer(metric_model, x1)
            finally:
                pnn.flash_attention = fa.flash_attention
    ok = len(layers) == 24 and all(ok for _, _, ok in layers)
    say("metric", f"frame 0, K1 against the plain version with P rounded to "
        f"bf16 at each of {len(layers)} layers of the core: worst |err| / tol, "
        f"max {max(r[0] for r in layers):.3f}, mean "
        f"{max(r[1] for r in layers):.3f} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("K1 disagrees with its plain version on the metric core's activations")
    null_check("metric", "depth", depth["k1"], depth["plain"],
               depth["plain_p_bf16"],
               float(depth["plain"].max() - depth["plain"].min()))
    del outs, depth
    torch.cuda.empty_cache()

    # 17. SOLOv2 in f32 on the card (TF32 off) against the CPU
    small_cfg = solov2.SOLOv2Config(scale=MASK_F32_SCALE)
    cpu_solo = solov2.init_params(solov2.build(small_cfg),
                                  torch.Generator().manual_seed(0))
    gpu_solo = copy.deepcopy(cpu_solo).cuda()
    hw = (192, 256)
    small = torch.from_numpy(rng.integers(0, 256, size=(1, *hw, 3),
                                          dtype=np.uint8))
    with torch.inference_mode():
        img, img_hw = solov2.preprocess(small, scale=MASK_F32_SCALE)
        cpu_heads = solov2.network(cpu_solo, img)
        slab_cpu = solov2.get_results(*cpu_heads, img_hw, hw, small_cfg)
        gpu_heads = solov2.network(gpu_solo, img.cuda())
        head_err = max(float((g.cpu() - c).abs().max() / c.abs().max())
                       for g, c in zip([*gpu_heads[0], *gpu_heads[1],
                                        gpu_heads[2]],
                                       [*cpu_heads[0], *cpu_heads[1],
                                        cpu_heads[2]]))
        slab_gpu = solov2.get_results(*gpu_heads, img_hw, hw, small_cfg)
        # the slab on the CPU's own head outputs, moved to the card
        same = solov2.get_results([t.cuda() for t in cpu_heads[0]],
                                  [t.cuda() for t in cpu_heads[1]],
                                  cpu_heads[2].cuda(), img_hw, hw, small_cfg)
    same = {k: v.cpu() for k, v in same.items()}
    slab_gpu = {k: v.cpu() for k, v in slab_gpu.items()}
    n_valid = int(slab_cpu["valid"].sum())
    valid = slab_cpu["valid"]
    flipped = float((same["masks"][valid] != slab_cpu["masks"][valid])
                    .float().mean()) if n_valid else 1.0
    ok = (n_valid > 0 and head_err <= 1e-4
          and torch.equal(same["valid"], valid)
          and torch.equal(same["labels"][valid], slab_cpu["labels"][valid])
          and float((same["scores"] - slab_cpu["scores"]).abs().max()) <= 1e-5
          and float((same["probs"][valid] - slab_cpu["probs"][valid])
                    .abs().max()) <= 1e-4
          and flipped <= 1e-3)
    matched = match_slabs(slab_gpu, slab_cpu)
    ok = ok and matched is not None
    say("mask-f32", f"SOLOv2 (R101, FPN 256, head 512, 80 classes) {hw[0]}x"
        f"{hw[1]} at test scale {MASK_F32_SCALE}, f32: head outputs within "
        f"{head_err:.2e} of their scale (tol 1e-4); {n_valid} valid instances "
        f"of {valid.numel()}; the slab on the same head outputs: valid and "
        f"labels equal, decayed scores within "
        f"{float((same['scores'] - slab_cpu['scores']).abs().max()):.2e} (tol "
        f"1e-5), probabilities of the valid within "
        f"{float((same['probs'][valid] - slab_cpu['probs'][valid]).abs().max()) if n_valid else float('nan'):.2e}"
        f" (tol 1e-4), {flipped:.2e} of their mask pixels flipped (tol 1e-3); "
        f"the whole network's slab, each CPU instance matched to one on the "
        f"card with its label, probabilities within 1e-4 and a decayed score "
        f"within 5e-3 (a flipped mask pixel moves an IoU): "
        f"{matched} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the f32 SOLOv2 on the card disagrees with the CPU")
    composite = (slab_cpu["masks"] & valid[:, None, None]).any(dim=0)
    g_cpu = sdf.sdf_green_device(composite)
    g_gpu = sdf.sdf_green_device(composite.cuda()).cpu()
    ok = torch.equal(g_cpu, g_gpu) and bool(composite.any())
    say("mask-f32", f"SDF green channel of the valid instances' union "
        f"({float(composite.float().mean()):.3f} of the pixels): equal on "
        f"both sides {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the SDF green channel on the card differs from the CPU's")
    on_card = {k: v.cuda() for k, v in slab_cpu.items()}
    h = cme.held([on_card["masks"]], [on_card["valid"]])
    ok = h["composite"] and h["marked"] and h["green"] and h["launches"] == (1, 1)
    say("mask-f32", f"the epilogue's kernels on the slab's masks, the valid "
        f"instances kept: composite, marked pixels and green equal to the plain "
        f"versions on the card: {h} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the mask epilogue's kernels differ from their plain versions")
    del cpu_solo, gpu_solo, on_card

    # 18. the mask path at full width (process.py runs it with the SDF)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mask_model = mask_band.load_model(runtime)
    mask_step = mask_band._make_step(mask_model, FRAME_HW,
                                     mask_band.CONFIDENCE_THRESHOLD, sdf=True)
    mask_step(frames)  # warm-up
    mh, mw = solov2.test_scale(*FRAME_HW)
    say("mask", f"SOLOv2 R101 + FPN + head, bf16 (group norms in f32), random "
        f"weights, {BATCH} frames at {FRAME_HW[0]}x{FRAME_HW[1]} -> test scale "
        f"{mh}x{mw} padded to {-(-mh // 32) * 32}x{-(-mw // 32) * 32}, SDF on: "
        f"set-up and warm-up {time.perf_counter() - t0:.2f} s")
    zero_counts()
    t0 = time.perf_counter()
    outs = [mask_step(frames) for _ in range(TIMED_STEPS)]
    elapsed = time.perf_counter() - t0
    mask_counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for out in outs:
        comp, green = out["composite"], out["green"]
        if comp.shape != (BATCH, *FRAME_HW) or green.shape != comp.shape:
            fail(f"mask composite {comp.shape}, green {green.shape}")
        if not (np.isfinite(green).all() and green.min() >= 0
                and green.max() <= 1 and (comp % 255 == 0).all()):
            fail("mask green outside [0, 1] or composite not a sum of 255s")
    if mask_counts != per_path(mask_composite=TIMED_STEPS, mask_sdf=TIMED_STEPS):
        fail(f"the mask step's launches: {mask_counts}, expected one composite "
             f"and one SDF a step")
    mask_ms = elapsed / TIMED_STEPS * 1e3
    say("mask", f"{TIMED_STEPS} steps: composite {list(outs[0]['composite'].shape)}"
        f" (kept pixels {float((outs[0]['composite'] > 0).mean()):.3f}), green "
        f"in [0, 1]; launches {mask_counts} (the mask epilogue's kernels, no "
        f"other of csrc/) ok")
    say("mask", f"{BATCH * TIMED_STEPS / elapsed:.2f} frames/s ({mask_ms:.1f} "
        f"ms per batch-8 step, host clock, H2D and D2H included; "
        f"mask_solov2_sdf_1080p_fps_per_chip); peak memory {peak:.2f} GiB; "
        f"on {card}")
    del outs
    # the epilogue's kernels on the real slabs of the 8 frames
    with torch.inference_mode():
        x = torch.from_numpy(frames).cuda()
        img, img_hw = solov2.preprocess(x, dtype=runtime.resolve_dtype(),
                                        scale=mask_model.cfg.scale)
        slabs = solov2.forward(mask_model, img, img_hw, FRAME_HW)
    ids = torch.tensor(mask_band.CLASS_IDS, device="cuda")
    slab_masks = [o["masks"] for o in slabs]
    step_keep = [mask_band.kept(o, mask_band.CONFIDENCE_THRESHOLD, ids)
                 for o in slabs]
    for what, keep in (("the step's keep flags", step_keep),
                       ("every valid slot kept", [o["valid"] for o in slabs])):
        h = cme.held(slab_masks, keep)
        ok = h["composite"] and h["marked"] and h["green"] and h["launches"] == (1, 1)
        say("mask", f"epilogue kernels on the {BATCH} frames' slabs "
            f"({list(slab_masks[0].shape)} a frame), {what} "
            f"({sum(int(k.sum()) for k in keep)} instances): composite, marked "
            f"pixels and green equal to the plain versions: {h} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail("the mask epilogue's kernels differ from their plain versions "
                 "on the real slabs")
    mask_epi = cme.timed(slab_masks, step_keep)
    say("mask", cme.describe(f"epilogue at {BATCH} x {list(slab_masks[0].shape)}, "
                             "the step's keep flags", mask_epi) + f"; on {card}")
    del slabs, slab_masks, step_keep, x, img, mask_model

    # 19. the fused default run: the three steps run_fused dispatches for one
    # batch (built by multiband.build_steps with process.py's default
    # options), back to back, without its reader and writers
    del mask_step, metric_step, metric_model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mask_step, metric_step, fused_flow, _ = multiband.build_steps(
        runtime, *FRAME_HW,
        depth_build={"metric": "outdoor", "encoder": "vitl"})

    def fused_batch():
        return mask_step(frames), metric_step(frames), fused_flow(frames)

    fused_batch()  # warm-up
    say("fused", f"multiband.build_steps (mask with SDF, metric ViT-L, "
        f"GMFlow at scale 0.75), set-up and warm-up "
        f"{time.perf_counter() - t0:.2f} s")
    zero_counts()
    t0 = time.perf_counter()
    outs = [fused_batch() for _ in range(FUSED_STEPS)]
    elapsed = time.perf_counter() - t0
    fused_counts = read_counts()
    fused_expect = {"K1": 24 + 6, "K2": 6, "K3": 3, "K4": 15,
                    "mask_composite": 1, "mask_sdf": 1}
    if fused_counts != per_path(**{k: n * FUSED_STEPS
                                   for k, n in fused_expect.items()}):
        fail(f"fused launches in {FUSED_STEPS} batches: {fused_counts}, "
             f"expected {fused_expect} a batch")
    for m_out, d_out, f_out in outs:
        if (m_out["composite"].shape != (BATCH, *FRAME_HW)
                or d_out["heat"].shape != (BATCH, *FRAME_HW, 3)
                or f_out["fwd_rgb"].shape != (BATCH - 1, *FLOW_HW, 3)
                or not np.isfinite(f_out["max_disp"]).all()):
            fail("fused outputs of the wrong shape or not finite")
    fused_ms = elapsed / FUSED_STEPS * 1e3
    say("fused", f"{FUSED_STEPS} batches of mask (SDF) + metric depth + "
        f"GMFlow ({BATCH - 1} pairs) on the same {BATCH} frames: launches "
        f"{fused_counts} ({fused_expect} a batch) ok")
    say("fused", f"{BATCH * FUSED_STEPS / elapsed:.2f} frames/s for the three "
        f"bands together ({fused_ms:.1f} ms a batch, host clock, H2D and D2H "
        f"included; the card's counterpart of measured_3band_fps_per_chip, "
        f"with the host decode, the x264 encodes and the file writers left "
        f"out; in steady state the loop runs 8/7 flow windows a batch); on "
        f"{card}")
    del outs, mask_step, metric_step, fused_flow
    torch.cuda.empty_cache()

    beit_counts = beit_paths(runtime, frames, card, rng, zero_counts,
                             read_counts, per_path)
    depth_counts = depth_band_paths(runtime, frames, card, rng, zero_counts,
                                    read_counts, per_path, k1)
    refine_counts = flow_refine_paths(runtime, frames, card, rng, zero_counts,
                                      read_counts, per_path,
                                      dict(k1=k1, k2=k2, k3=k3, k4=k4),
                                      raft_volume)
    tools_counts = port_tools_paths(runtime, frames, card, zero_counts,
                                    read_counts, per_path)
    codec = host_tools_phase()

    runs = {"depth_anything_vitl": vit_counts, "flow_gmflow": flow_counts,
            "flow_raft": raft_counts, "probe": probe_counts,
            "depth_anything_metric": metric_counts, "mask": mask_counts,
            "fused_3band": fused_counts, **beit_counts, **depth_counts,
            **refine_counts, **tools_counts}
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
             "scripts/probe_gather_kernel.py:53", k6b),
            ("kept_composite", "mask_composite", "mask_epilogue.cu",
             "none: prisma_tpu/ops/sdf.py and bands/mask_band.py are jnp ops",
             {k: mask_epi[k] for k in ("composite_ms", "composite_bound_ms",
                                       "plain_composite_ms", "kept_instances")}),
            ("sdf_green", "mask_sdf", "mask_epilogue.cu",
             "none: prisma_tpu/ops/sdf.py is jnp ops",
             {k: mask_epi[k] for k in ("sdf_ms", "sdf_bound_ms", "plain_sdf_ms",
                                       "kernels_ms", "bound_ms", "plain_ms")})]

    def compiled(key, table):
        return {label: v for label, v in table.items()
                if label and label.split("<")[0] in KERNEL_SYMBOLS[key]}

    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"prisma_tpu_torch/csrc/{src}", "replaces": replaces,
        "launches": launches[key], "launches_by_path": by_path[key], **row,
        "design": DESIGNS[key], "registers": compiled(key, regs),
        **({"sass": compiled(key, bf16_sass)} if key in ("K1", "K2", "K3") else {}),
        **({"sass": k5_sass} if key == "K5" else {}),
        **({"sass": compiled(key, k6_sass)} if key in ("K6a", "K6b") else {})}
        for name, key, src, replaces, row in rows],
        "host_tools_codec": codec}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def check_depth(phase, what, depth):
    """A metric depth must be finite and inside [MIN_DEPTH, MAX_DEPTH]."""
    lo, hi = float(depth.min()), float(depth.max())
    ok = bool(torch.isfinite(depth).all()) and MIN_DEPTH <= lo and hi <= MAX_DEPTH
    say(phase, f"{what}: finite, in [{lo:.4f}, {hi:.4f}] m within "
        f"[{MIN_DEPTH}, {MAX_DEPTH}] {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{what}: not finite or outside the configured depth range")


def sync_all():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def synced(fn):
    """(fn(), host seconds) with every visible card synchronised on both
    sides."""
    sync_all()
    t0 = time.perf_counter()
    out = fn()
    sync_all()
    return out, time.perf_counter() - t0


def beit_paths(runtime, frames, card, rng, zero_counts, read_counts, per_path):
    """Phases 20-23: the BEiT-L depth family and an image's process run.
    -> {path: launch counts} (no kernel of csrc/ runs on these paths but
    the mask epilogue's in the image's run)."""
    import functools

    from prisma_tpu_torch.bands import (depth_base, depth_patchfusion_band,
                                        depth_zoedepth_band, mask_band)
    from prisma_tpu_torch.models import beit, zoed
    from prisma_tpu_torch.models import patchfusion as pf
    from prisma_tpu_torch.ops import encode as enc

    counts = {}

    def no_kernel(phase, key, **allowed):
        """No kernel of csrc/ launched but the `allowed` counts."""
        counts[key] = read_counts()
        if counts[key] != per_path(**allowed):
            fail(f"{phase}: kernels of csrc/ launched: {counts[key]}, expected "
                 f"{allowed or 'none'}")

    # 20. PatchFusion and ZoeD_N in f32 on the card (TF32 off) against the CPU
    cfg = beit.BEiTConfig(depth=4)
    cpu_pf = pf.init_params(pf.build(cfg, features=64, model_hw=PF_SMALL_HW),
                            torch.Generator().manual_seed(0))
    gpu_pf = copy.deepcopy(cpu_pf).cuda()
    img = torch.from_numpy(rng.integers(0, 256, size=(*PF_SMALL_IMAGE, 3),
                                        dtype=np.uint8))
    res = pf.pick_resolution(*PF_SMALL_IMAGE)
    crop = (res[0] // 4, res[1] // 4)
    zero_counts()
    for mode in ("p16", "r3"):
        d_cpu = pf.infer(cpu_pf, img, mode=mode)
        d_gpu = pf.infer(gpu_pf, img.cuda(), mode=mode).cpu()
        err = float((d_gpu - d_cpu).abs().max())
        tol = 1e-4 * float(d_cpu.abs().max())
        tiles = [len(p) for p in pf.tile_passes(mode, res, crop)]
        ok = bool(torch.isfinite(d_gpu).all()) and err <= tol
        say("pf-f32", f"PatchFusion (BEiT-L 1024 wide, 4 blocks; 64 features) "
            f"at {PF_SMALL_HW[0]}x{PF_SMALL_HW[1]}, {PF_SMALL_IMAGE[0]}x"
            f"{PF_SMALL_IMAGE[1]} image -> {res[0]}x{res[1]}, {mode}: passes "
            f"of {tiles} tiles (one tile_passes on both sides), max |depth_gpu "
            f"- depth_cpu| {err:.3e} m, tol {tol:.3e} m (1e-4 of the depth "
            f"scale, max {float(d_cpu.abs().max()):.3f} m: f32 both sides, "
            f"sums in another order) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"the f32 PatchFusion at {mode} on the card disagrees with the CPU")
    del cpu_pf, gpu_pf
    cpu_z = zoed.init_params(zoed.build(cfg), torch.Generator().manual_seed(1))
    gpu_z = copy.deepcopy(cpu_z).cuda()
    small = torch.from_numpy(rng.integers(0, 256, size=(2, 64, 96, 3),
                                          dtype=np.uint8))
    with torch.inference_mode():
        d_cpu = zoed.infer(cpu_z, small, img_size=PF_SMALL_HW)
        d_gpu = zoed.infer(gpu_z, small.cuda(), img_size=PF_SMALL_HW).cpu()
    err = float((d_gpu - d_cpu).abs().max())
    tol = 1e-4 * float(d_cpu.abs().max())
    ok = bool(torch.isfinite(d_gpu).all()) and err <= tol
    say("zoed-f32", f"ZoeD_N (BEiT-L 1024 wide, 4 blocks; DPT 256; the full "
        f"bins head) 2x64x96 at img_size {PF_SMALL_HW}, pad and flip: max "
        f"|depth_gpu - depth_cpu| {err:.3e} m, tol {tol:.3e} m (1e-4 of the "
        f"depth scale) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the f32 ZoeD_N on the card disagrees with the CPU")
    no_kernel("pf-f32", "f32_checks")
    del cpu_z, gpu_z

    # 21. PatchFusion at full width on a 1080p frame, p49 (the video mode)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, infer, _flip = depth_patchfusion_band.build_infer(runtime, mode="p49")
    res = pf.pick_resolution(*FRAME_HW)
    x1 = torch.from_numpy(frames[:1]).cuda()
    with torch.inference_mode():
        infer(model, x1)  # warm-up
    say("pf", f"PatchFusion: two BEiT-L cores (1024 wide, 24 blocks, 16 "
        f"heads, 769 tokens at 384x512) + MiDaS decoders, UNet and six G2L "
        f"levels, bf16 (the bins heads, batch norms and BEiT bias tables "
        f"f32), random weights; {FRAME_HW[0]}x{FRAME_HW[1]} -> crops of "
        f"{res[0] // 4}x{res[1] // 4}, tile_batch 8: set-up and warm-up "
        f"{time.perf_counter() - t0:.2f} s")
    zero_counts()
    times = []
    with torch.inference_mode():
        for _ in range(PF_TIMED):
            depth, sec = synced(lambda: infer(model, x1))
            times.append(sec)
    no_kernel("pf", "depth_patchfusion_p49")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if depth.shape != (1, *FRAME_HW) or depth.dtype != torch.float32:
        fail(f"PatchFusion depth {tuple(depth.shape)} {depth.dtype}")
    check_depth("pf", "p49 depth, bf16", depth)
    say("pf", f"p49 (16 + 12 + 12 + 9 = 49 tiles + the coarse pass): "
        f"{', '.join(f'{t:.3f}' for t in times)} s a frame, mean "
        f"{np.mean(times):.3f} s (host clock, synchronised, H2D and the "
        f"1080p depth included); no kernel of csrc/; peak memory {peak:.2f} "
        f"GiB; on {card}")
    # the same run in f32 (TF32 off), on the same weights (the bf16 ones
    # widened): what the compute dtype alone moves
    f32_model = copy.deepcopy(model).float()
    with torch.inference_mode():
        d32, sec32 = synced(lambda: pf.infer(f32_model, x1[0], mode="p49"))
    del f32_model
    torch.cuda.empty_cache()
    diff = (depth[0] - d32).abs()
    scale = float(d32.abs().max())
    ok = float(diff.max()) <= 0.02 * scale
    say("pf", f"bf16 against the same p49 in f32 on the card, same weights "
        f"({sec32:.2f} s): "
        f"|diff| max {float(diff.max()):.3e} m, mean {float(diff.mean()):.3e} m "
        f"({float(diff.max()) / scale:.2e} and {float(diff.mean()) / scale:.2e}"
        f" of the depth scale {scale:.3f} m; tol 2e-2 of it) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("PatchFusion in bf16 is not within 2% of the f32 run")

    # 22. ZoeD_N at full width: 1080p frames at batch 8, fused video step
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    zmodel, zinfer, zflip = depth_zoedepth_band.build_infer(runtime)
    zstep = depth_base.make_step(zmodel, zinfer, zflip, need_depth=False)
    zstep(frames)  # warm-up
    say("zoed", f"ZoeD_N: BEiT-L (1024 wide, 24 blocks, 16 heads) + MiDaS "
        f"decoder at 384x512 in bf16, the bins head in f32, random weights; "
        f"reflect pad, two passes (plain, flipped): set-up and warm-up "
        f"{time.perf_counter() - t0:.2f} s")
    zero_counts()
    t0 = time.perf_counter()
    outs = [zstep(frames) for _ in range(TIMED_STEPS)]
    elapsed = time.perf_counter() - t0
    no_kernel("zoed", "depth_zoedepth")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for out in outs:
        if out["heat"].shape != (BATCH, *FRAME_HW, 3):
            fail(f"ZoeD_N heat {out['heat'].shape}")
        check_depth("zoed", "per-frame min and max",
                    torch.from_numpy(np.concatenate([out["min"], out["max"]])))
    say("zoed", f"{BATCH * TIMED_STEPS / elapsed:.2f} frames/s "
        f"({elapsed / TIMED_STEPS * 1e3:.1f} ms per batch-8 step, host clock, "
        f"H2D and D2H included); no kernel of csrc/; peak memory {peak:.2f} "
        f"GiB; on {card}")
    del zmodel, zstep, outs
    torch.cuda.empty_cache()

    # 23. an image through process.py's band calls, in memory: rgba (a
    # file copy for an image: no device work), the mask with its SDF, then
    # PatchFusion at r128 (the image default) and the depth PNG's heatmap
    frame = frames[:1]
    mstep = mask_band.build_step(runtime, FRAME_HW,
                                 mask_band.CONFIDENCE_THRESHOLD, sdf=True)
    mstep(frame)  # warm-up
    image_infer = functools.partial(depth_patchfusion_band.infer_frames,
                                    mode="r128", dtype=runtime.resolve_dtype())
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mout = mstep(frame)
    with torch.inference_mode():
        depth, sec = synced(lambda: image_infer(model, x1))
        heat, _, _ = enc.depth_to_heatmap(depth[0], normalize=True, flip=False,
                                          encode_range=False)
    total = time.perf_counter() - t0
    no_kernel("image", "image_r128", mask_composite=1, mask_sdf=1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if mout["composite"].shape != (1, *FRAME_HW) or heat.shape != (*FRAME_HW, 3):
        fail(f"image outputs: mask {mout['composite'].shape}, heat "
             f"{tuple(heat.shape)}")
    check_depth("image", "r128 depth, bf16", depth)
    say("image", f"rgba (no device work), mask + SDF (kept pixels "
        f"{float((mout['composite'] > 0).mean()):.3f}), PatchFusion r128 (4 "
        f"grid passes + 128 random tiles in passes of 8 = 177 tiles): "
        f"{sec:.3f} s an image for the depth, {total:.3f} s for the three "
        f"bands; heat {list(heat.shape)} {heat.dtype}; of csrc/ only the mask "
        f"epilogue's two kernels; peak memory {peak:.2f} GiB; on {card}")
    del model, mstep
    torch.cuda.empty_cache()
    return counts


def layer_checked(layers, plain_p_bf16):
    """K1 that holds each call to the plain version with P rounded to bf16
    under its bounds, recording (max/tol, mean/tol, ok) in `layers`."""
    from prisma_tpu_torch.ops.cuda import flash_attention as fa

    def k1_checked(q, k, v):
        out = fa.flash_attention(q, k, v)
        ref = plain_p_bf16(q, k, v)
        tols = fa.bf16_bounds(ref)
        max_err, mean_err, ok = within(out, ref, tols)
        layers.append((max_err / tols[0], mean_err / tols[1], ok))
        return out

    return k1_checked


def depth_band_paths(runtime, frames, card, rng, zero_counts, read_counts,
                     per_path, k1):
    """Phases 24-27: MiDaS (DPT_Large, v2.1) and Marigold.
    -> {path: launch counts}."""
    import functools

    from prisma_tpu_torch.bands import (depth_base, depth_marigold_band,
                                        depth_midas_band)
    from prisma_tpu_torch.models import marigold as mg
    from prisma_tpu_torch.models import midas, sd2
    from prisma_tpu_torch.ops import nn as pnn
    from prisma_tpu_torch.ops.cuda import flash_attention as fa
    from prisma_tpu_torch.weights import store

    from prisma_tpu_torch.runtime.config import RuntimeConfig

    plain_p_bf16 = functools.partial(fa.flash_attention_ref, round_p=True)
    counts = {}
    x1 = torch.from_numpy(frames[:1])
    names = {"midas3": "DPT_Large, ViT-L/16 at 384x224: 337 tokens",
             "midas2": "MiDaS v2.1, ResNeXt-101 32x8d at 384x224"}
    cpu_rt = RuntimeConfig(random_weights=True, device="cpu")

    def f32_check(phase, what, cpu_fn, gpu_fn, expect):
        with torch.inference_mode():
            d_cpu = cpu_fn()
            zero_counts()
            d_gpu = gpu_fn().cpu()
        got = read_counts()
        err = float((d_gpu - d_cpu).abs().max())
        tol = 1e-4 * float(d_cpu.abs().max())
        ok = (got == expect and bool(torch.isfinite(d_gpu).all())
              and err <= tol)
        say(phase, f"{what}: max |gpu - cpu| {err:.3e}, tol {tol:.3e} (1e-4 "
            f"of the scale {float(d_cpu.abs().max()):.4f}: f32 both sides, "
            f"sums in another order); launches {got} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{phase}: {what} on the card disagrees with the CPU")
        return err

    # 24. MiDaS in f32 on the card (TF32 off) against the CPU, full width,
    # one 1080p frame: DPT_Large (24 f32 K1) and v2.1 (no kernel)
    for version, infer_fn, n_k1 in (("midas3", midas.infer, MIDAS_K1_PER_STEP),
                                    ("midas2", midas.infer_v2, 0)):
        _arch, cpu_m = store.load_midas(cpu_rt, version)
        gpu_m = copy.deepcopy(cpu_m).cuda()
        f32_check("midas-f32", f"{version} ({names[version]}; decoder 256) "
                  f"on one {FRAME_HW[0]}x{FRAME_HW[1]} frame, f32",
                  lambda: infer_fn(cpu_m, x1), lambda: infer_fn(gpu_m, x1.cuda()),
                  per_path(K1=n_k1))
        del cpu_m, gpu_m
    torch.cuda.empty_cache()

    # 25. MiDaS at full width: the fused video step at batch 8, DPT_Large
    # (midas3) then v2.1 (midas2)
    for version, key, n_k1 in (("midas3", "depth_midas_dpt", MIDAS_K1_PER_STEP),
                               ("midas2", "depth_midas_v2", 0)):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model, infer, flip = depth_midas_band.build_infer(runtime, version)
        step = depth_base.make_step(model, infer, flip, need_depth=False)
        step(frames)  # warm-up
        setup = time.perf_counter() - t0
        zero_counts()
        t0 = time.perf_counter()
        outs = [step(frames) for _ in range(TIMED_STEPS)]
        elapsed = time.perf_counter() - t0
        counts[key] = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if counts[key] != per_path(K1=n_k1 * TIMED_STEPS):
            fail(f"{version} launches in {TIMED_STEPS} steps: {counts[key]}, "
                 f"expected {n_k1} K1 a step")
        for out in outs:
            if (out["heat"].shape != (BATCH, *FRAME_HW, 3)
                    or not (np.isfinite(out["min"]).all()
                            and (out["min"] < out["max"]).all())):
                fail(f"{version} outputs: heat {out['heat'].shape}, min/max "
                     f"{out['min']} {out['max']}")
        say("midas", f"{version} ({names[version]}; bf16, random weights; "
            f"set-up and warm-up {setup:.2f} s): "
            f"{BATCH * TIMED_STEPS / elapsed:.2f} frames/s "
            f"({elapsed / TIMED_STEPS * 1e3:.1f} ms per batch-8 step, host "
            f"clock, H2D and D2H included); launches {counts[key]} "
            f"({n_k1} K1 a step) ok; peak memory {peak:.2f} GiB; on {card}")
        if n_k1:
            layers = []
            depth = {}
            with torch.inference_mode():
                for name, attn in (("k1", layer_checked(layers, plain_p_bf16)),
                                   ("plain", fa.flash_attention_ref),
                                   ("plain_p_bf16", plain_p_bf16)):
                    pnn.flash_attention = attn
                    try:
                        depth[name] = infer(model, x1.cuda())
                    finally:
                        pnn.flash_attention = fa.flash_attention
            ok = len(layers) == n_k1 and all(r[2] for r in layers)
            say("midas", f"frame 0, K1 against the plain version with P "
                f"rounded to bf16 at each of {len(layers)} layers: worst "
                f"|err| / tol, max {max(r[0] for r in layers):.3f}, mean "
                f"{max(r[1] for r in layers):.3f} {'ok' if ok else 'FAIL'}")
            if not ok:
                fail("K1 disagrees with its plain version on DPT_Large's "
                     "activations")
            null_check("midas", "disparity", depth["k1"], depth["plain"],
                       depth["plain_p_bf16"],
                       float(depth["plain"].max() - depth["plain"].min()))
        del model, step, outs
        torch.cuda.empty_cache()

    # 26. Marigold at full width on one 1080p frame: 10 DDIM steps x 10
    # members at 768 (768x432, a 96x54 latent), bf16
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, infer, _flip = depth_marigold_band.build_infer(runtime)
    say("marigold", f"SD2 UNet (320, 640, 1280, 1280) + VAE (128, 256, 512, "
        f"512), bf16; the CLIP text tower (1024 wide, 23 layers) run once "
        f"on the card for the empty prompt; random weights: set-up "
        f"{time.perf_counter() - t0:.2f} s")
    xg = x1.cuda()
    with torch.inference_mode():
        infer(model, xg)  # warm-up
    zero_counts()
    times = []
    with torch.inference_mode():
        for _ in range(MARIGOLD_TIMED):
            depth, sec = synced(lambda: infer(model, xg))
            times.append(sec)
    counts["depth_marigold"] = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_frame = MARIGOLD_K1_PER_FRAME
    if counts["depth_marigold"] != per_path(K1=per_frame * MARIGOLD_TIMED):
        fail(f"Marigold launches in {MARIGOLD_TIMED} frames: "
             f"{counts['depth_marigold']}, expected {per_frame} K1 a frame")
    if (depth.shape != (1, *FRAME_HW) or not bool(torch.isfinite(depth).all())
            or float(depth.max() - depth.min()) <= 0):
        fail(f"Marigold depth {tuple(depth.shape)}, range "
             f"{float(depth.min())}-{float(depth.max())}")
    say("marigold", f"1080p frame, 10 steps x 10 members at 768: "
        f"{', '.join(f'{t:.3f}' for t in times)} s a frame, mean "
        f"{np.mean(times):.3f} s (host clock, synchronised, H2D and the "
        f"1080p depth included); launches {counts['depth_marigold']} "
        f"({per_frame} K1 a frame: [50, 5184, 64] and [100, 1296, 64], 50 "
        f"each; K1 there {50 * sum(r['ms'] for r in k1['at_midas_marigold'][1:]):.1f}"
        f" ms at its own times); depth finite, in [{float(depth.min()):.4f}, "
        f"{float(depth.max()):.4f}]; peak memory {peak:.2f} GiB; on {card}")
    # one frame again: every K1 call of its 10 UNet calls held to the plain
    # version; then the depth with the plain attention in place of K1, and
    # with the plain attention that rounds P to bf16 (the null distance)
    layers = []
    depth = {}
    with torch.inference_mode():
        for name, attn in (("k1", layer_checked(layers, plain_p_bf16)),
                           ("plain", fa.flash_attention_ref),
                           ("plain_p_bf16", plain_p_bf16)):
            sd2.flash_attention = attn
            try:
                depth[name] = infer(model, xg)
            finally:
                sd2.flash_attention = fa.flash_attention
    ok = len(layers) == per_frame and all(r[2] for r in layers)
    say("marigold", f"K1 against the plain version with P rounded to bf16 at "
        f"each of its {len(layers)} calls of one frame: worst |err| / tol, max "
        f"{max(r[0] for r in layers):.3f}, mean {max(r[1] for r in layers):.3f}"
        f" {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("K1 disagrees with its plain version on the UNet's activations")
    null_check("marigold", "depth", depth["k1"], depth["plain"],
               depth["plain_p_bf16"],
               float(depth["plain"].max() - depth["plain"].min()))

    # 27. Marigold in f32 on the card (TF32 off) against the CPU: the
    # full-width UNet, VAE and ensembling (the weights above, widened) on a
    # 256x256 frame at 256 (a 32x32 latent: 1024 tokens, so the f32 K1
    # runs), 2 members, 2 steps; the same member latents on both sides
    cpu_mg = copy.deepcopy(model).cpu().float()
    del model
    torch.cuda.empty_cache()
    gpu_mg = copy.deepcopy(cpu_mg).cuda()
    hw = MARIGOLD_F32_HW
    small = torch.from_numpy(rng.integers(0, 256, size=(hw, hw, 3),
                                          dtype=np.uint8))
    run = functools.partial(mg.infer, denoising_steps=2, ensemble_size=2,
                            processing_res=hw, seed=7)
    f32_check("marigold-f32", f"Marigold (full UNet and VAE) on a {hw}x{hw} "
              f"frame at {hw}, 2 members x 2 steps, f32",
              lambda: run(cpu_mg, small), lambda: run(gpu_mg, small.cuda()),
              per_path(K1=2 * 5))
    del cpu_mg, gpu_mg
    torch.cuda.empty_cache()
    return counts


def attn_chunked(fn, q, k, v, **kw):
    """fn over the batch rows in chunks of ATTN_CHUNK windows (a multiple of
    the window count, so region bands stay aligned): a plain attention whose
    scores would not fit at once ([1792, 1170, 1170] f32 is 9.8 GB)."""
    return torch.cat([fn(q[i:i + ATTN_CHUNK], k[i:i + ATTN_CHUNK],
                         v[i:i + ATTN_CHUNK], **kw)
                      for i in range(0, q.shape[0], ATTN_CHUNK)])


def flow_refine_paths(runtime, frames, card, rng, zero_counts, read_counts,
                      per_path, rows, raft_volume):
    """Phases 28-31: GMFlow's refinement (--num_scales 2) and RAFT's fused
    lookup (--corr_impl fused). rows: the kernels line's K1-K4 entries, which
    take the refinement's shapes; raft_volume: the volume path's pairs/s and
    peak memory (phase 13). -> {path: launch counts}."""
    import torch.nn.functional as F

    from prisma_tpu_torch.bands import flow_base, flow_gmflow_band, flow_raft_band
    from prisma_tpu_torch.models import gmflow as gm
    from prisma_tpu_torch.models import raft
    from prisma_tpu_torch.ops.cuda import flash_attention as fa
    from prisma_tpu_torch.ops.cuda import instance_norm as inorm
    from prisma_tpu_torch.ops.resize import resize2d
    from prisma_tpu_torch.runtime.config import RuntimeConfig
    from prisma_tpu_torch.weights import store

    plain_p_bf16 = functools.partial(fa.flash_attention_ref, round_p=True)
    gen = torch.Generator(device="cuda").manual_seed(28)
    counts = {}
    P = BATCH - 1

    def normal(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    # 28. K1 and K2 at the 1/4-scale windows, K3 and K4 at the /32 shapes
    B, N, d = REFINE_WIN_SHAPE
    nwin = 64
    bands = torch.from_numpy(gm.shift_window_region_bands(*REFINE_FEAT_HW, 8)).cuda()
    win_w = REFINE_FEAT_HW[1] // 8
    say("k1-refine", f"[{B}, {N}, {d}] bf16: 26x45-token windows of the "
        f"{REFINE_FEAT_HW[0]}x{REFINE_FEAT_HW[1]} features in 8x8 splits "
        f"({N} = {N // K1_TILE_K} x {K1_TILE_K} + {N % K1_TILE_K}: a ragged key "
        f"tile in every window); shifted bands (bh, bw) "
        f"{sorted({tuple(b) for b in bands.tolist()})}, win_w {win_w} (shift "
        f"{win_w // 2}); bounds as K1's; the plain versions in chunks of "
        f"{ATTN_CHUNK} windows")
    q, k, v = (normal(REFINE_WIN_SHAPE, torch.bfloat16) for _ in range(3))
    q4, k4, v4 = (t.view(B // nwin, nwin, N, d) for t in (q, k, v))
    bound_ms, bound_by = bound(4 * B * N * N * d, 4 * nbytes(q))  # q, k, v, out
    for key, phase, kw in (("k1", "k1-refine", {}),
                           ("k2", "k2-refine", dict(region_bands=bands,
                                                    win_w=win_w))):
        out = fa.flash_attention(q, k, v, **kw)
        ref = attn_chunked(plain_p_bf16, q, k, v, **kw)
        err = report(phase, f"{list(REFINE_WIN_SHAPE)} bf16"
                     + (", bands" if kw else ""), out, ref, fa.bf16_bounds(ref))
        if kw:
            moved = bands.clone()
            moved[:, 0] += 1
            wrong = attn_chunked(plain_p_bf16, q, k, v, region_bands=moved,
                                 win_w=win_w)
            must_fail(phase, f"bh moved down one token row ({win_w} tokens)",
                      out, wrong, fa.bf16_bounds(ref))
            codes = fa.region_codes(nwin, N, bands, win_w)
            mask = torch.where(codes[:, :, None] != codes[:, None, :],
                               -fa.REGION_PENALTY, 0.0).to(torch.bfloat16)[None]
            lib = lambda: F.scaled_dot_product_attention(q4, k4, v4,  # noqa: E731
                                                         attn_mask=mask)
        else:
            pad = -N % K1_TILE_K
            kp, vp = (F.pad(t, (0, 0, 0, pad)) for t in (k, v))
            wrong = attn_chunked(plain_p_bf16, F.pad(q, (0, 0, 0, pad)), kp,
                                 vp)[:, :N]
            must_fail(phase, f"its last key tile unmasked ({pad} zero keys)",
                      out, wrong, fa.bf16_bounds(ref))
            del kp, vp
            lib = lambda: F.scaled_dot_product_attention(q4, k4, v4)  # noqa: E731
        del ref, wrong
        torch.cuda.empty_cache()
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, **kw), 10)
        plain_ms = cuda_ms(lambda: attn_chunked(fa.flash_attention_ref, q, k, v,
                                                **kw), 2)
        lib_ms = library_ms(lib, 5)
        rows[key]["at_refine_windows"] = dict(
            shape=list(REFINE_WIN_SHAPE), max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=lib_ms)
        say(phase, f"time at {list(REFINE_WIN_SHAPE)} bf16: kernel {ms:.4f} ms "
            f"({4 * B * N * N * d / (ms * 1e-3) / 1e12:.1f} TFLOP/s, "
            f"{bound_ms / ms:.1%} of the bound), plain (chunked) {plain_ms:.3f} "
            f"ms, scaled_dot_product_attention on [{B // nwin}, {nwin}, {N}, {d}]"
            + (" with a float [1, 64, N, N] mask" if kw else "")
            + f" {lib_ms} ms, bound {bound_ms:.4f} ms ({bound_by}); on {card}")
        if kw:
            del mask
    del q, k, v, q4, k4, v4, out
    torch.cuda.empty_cache()
    Bm, Nm, dm = REFINE_MATCH_SHAPE
    grid = gm._coords_grid_flat(REFINE_FEAT_HW[0] // 2, REFINE_FEAT_HW[1] // 2,
                                "cuda")
    for label, shape, v in (
            ("matching", REFINE_MATCH_SHAPE, grid[None].expand(Bm, Nm, 2).contiguous()),
            ("propagation", (2 * Bm, Nm, dm), None)):
        q, k = (normal(shape, torch.bfloat16) for _ in range(2))
        if v is None:
            v = normal((2 * Bm, Nm, 2), torch.float32, scale=40.0)
        out = fa.flash_attention_streamed(q, k, v, dm ** -0.5)
        err = report("k3-refine", f"{label} {list(shape)} bf16, dv 2", out,
                     fa.flash_attention_streamed_ref(q, k, v, dm ** -0.5),
                     fa.streamed_bounds(v))
        ms = cuda_ms(lambda: fa.flash_attention_streamed(q, k, v, dm ** -0.5), 5)
        plain_ms = cuda_ms(lambda: fa.flash_attention_streamed_ref(
            q, k, v, dm ** -0.5), 2)
        vpad = F.pad(v.to(torch.bfloat16), (0, dm - 2))[:, None]
        lib_ms = library_ms(lambda: F.scaled_dot_product_attention(
            q[:, None], k[:, None], vpad), 3)
        b_ms, b_by = bound(2 * shape[0] * Nm * Nm * (dm + 2), nbytes(q, k, v, out))
        rows["k3"][f"at_refine_{label}"] = dict(
            shape=list(shape), max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        say("k3-refine", f"time at {label} {list(shape)}: kernel {ms:.3f} ms "
            f"({b_ms / ms:.1%} of the bound), plain {plain_ms:.3f} ms, "
            f"scaled_dot_product_attention with v padded (bf16) {lib_ms} ms, "
            f"bound {b_ms:.3f} ms ({b_by}); on {card}")
        del q, k, v, out, vpad
    x = normal(REFINE_NORM_SHAPE, torch.bfloat16, scale=2.0) + 1.0
    out = inorm.instance_norm_relu(x, relu=True)
    ref = inorm.instance_norm_relu_ref(x, relu=True)
    err = report("k4-refine", f"{list(REFINE_NORM_SHAPE)} bf16 + relu", out,
                 ref, inorm.bounds(ref))
    ms = cuda_ms(lambda: inorm.instance_norm_relu(x, relu=True), 20)
    plain_ms = cuda_ms(lambda: inorm.instance_norm_relu_ref(x, relu=True), 5)
    lib_ms = library_ms(lambda: F.instance_norm(x, eps=inorm.EPS), 20)
    b_ms, b_by = bound(0, nbytes(x, out))
    rows["k4"]["at_refine_conv1"] = dict(
        shape=list(REFINE_NORM_SHAPE), max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    say("k4-refine", f"time at {list(REFINE_NORM_SHAPE)} bf16: kernel {ms:.3f} "
        f"ms ({nbytes(x, out) / (ms * 1e-3) / 1e12:.2f} TB/s), plain "
        f"{plain_ms:.3f} ms, F.instance_norm {lib_ms} ms, bound {b_ms:.3f} ms "
        f"({b_by}); on {card}")
    del x, out, ref
    torch.cuda.empty_cache()

    # 29. the refinement in f32 on the card (TF32 off) against the CPU
    cpu_rt = RuntimeConfig(random_weights=True, device="cpu")
    cpu_gm = store.load_gmflow(cpu_rt, gm.refine_config())
    with torch.no_grad():
        for p in cpu_gm.parameters():
            p.mul_(REFINE_WEIGHT_SCALE)
    gpu_gm = copy.deepcopy(cpu_gm).cuda()
    imgs = torch.from_numpy(rng.uniform(0, 255, size=(3, 128, 192, 3))
                            .astype(np.float32))
    with torch.inference_mode():
        f_cpu = torch.cat(gm.infer_pairs(cpu_gm, imgs[:-1], imgs[1:]))
        zero_counts()
        g = imgs.cuda()
        f_gpu = torch.cat(gm.infer_pairs(gpu_gm, g[:-1], g[1:])).cpu()
    got = read_counts()
    err = float((f_gpu - f_cpu).abs().max())
    tol = 1e-4 * float(f_cpu.abs().max())
    ok = (got == per_path(**REFINE_STEP) and bool(torch.isfinite(f_gpu).all())
          and err <= tol)
    say("gmflow-refine-f32", f"GMFlow refinement (128 channels, 6 layers, 2 "
        f"scales; weights x{REFINE_WEIGHT_SCALE}) 2 pairs at 128x192, f32: max "
        f"|flow_gpu - flow_cpu| {err:.3e} px, tol {tol:.3e} px (1e-4 of the "
        f"flow scale, max |flow| {float(f_cpu.abs().max()):.2f}); launches "
        f"{got} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the f32 GMFlow refinement on the card disagrees with the CPU")
    del cpu_gm, gpu_gm

    # 30. the refinement step at full width on the 8 frames
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lazy_model, infer = flow_gmflow_band.build_pairs(runtime, cfg=gm.refine_config())
    model = lazy_model().to(device=runtime.resolve_device(),
                            dtype=runtime.resolve_dtype())
    step = flow_base.make_flow_step(model, infer, FLOW_HW, need_masks=True,
                                    need_flow=True)
    step(frames)  # warm-up
    say("flow-refine", f"GMFlow refinement (128 channels, 6 layers; 1/8 in 2x2 "
        f"and 1/4 in 8x8 windows, local radius 4 and 1, convex x4), bf16, "
        f"random weights, {BATCH} frames = {P} bidirectional pairs at "
        f"{FLOW_HW[0]}x{FLOW_HW[1]} (padded to 832x1440): set-up and warm-up "
        f"{time.perf_counter() - t0:.2f} s")
    zero_counts()
    t0 = time.perf_counter()
    outs = [step(frames) for _ in range(TIMED_STEPS)]
    elapsed = time.perf_counter() - t0
    counts["flow_gmflow_refine"] = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_flow_outputs(outs)
    expect = per_path(**{key: n * TIMED_STEPS for key, n in REFINE_STEP.items()})
    if counts["flow_gmflow_refine"] != expect:
        fail(f"refinement launches in {TIMED_STEPS} steps: "
             f"{counts['flow_gmflow_refine']}, expected {REFINE_STEP} a step")
    say("flow-refine", f"{TIMED_STEPS} steps: fwd_rgb/bwd_rgb "
        f"{list(outs[0]['fwd_rgb'].shape)} uint8, masks "
        f"{list(outs[0]['fwd_mask'].shape)} bool (fwd valid "
        f"{float(outs[0]['fwd_mask'].mean()):.3f}), max-disp finite "
        f"({', '.join(f'{m:.2f}' for m in outs[0]['max_disp'])}); launches "
        f"{counts['flow_gmflow_refine']} ({REFINE_STEP} a step) ok")
    say("flow-refine", f"{P * TIMED_STEPS / elapsed:.2f} pairs/s "
        f"({elapsed / TIMED_STEPS * 1e3:.1f} ms per step of {P} pairs, host "
        f"clock, H2D and D2H included; K1 + K2 at the 1/4 windows "
        f"{6 * (rows['k1']['at_refine_windows']['ms'] + rows['k2']['at_refine_windows']['ms']):.1f}"
        f" ms of it at their own times); peak memory {peak:.2f} GiB; on {card}")
    del outs

    # one pair's real activations: every kernel call held to its plain
    # version; the flow against the plain path and the null path, with the
    # band's random weights (whose refinement amplifies any last-bit
    # difference into pixels on noise frames, so that the null check has
    # little power) and with the same weights at half scale (as phase 29)
    x = torch.from_numpy(frames[:2]).cuda()
    with torch.inference_mode():
        ds = resize2d(x.float(), FLOW_HW, method="cubic").to(torch.bfloat16)
    half = copy.deepcopy(model)
    with torch.no_grad():
        for p in half.parameters():
            p.mul_(REFINE_WEIGHT_SCALE)
    for scale, net in ((1.0, model), (REFINE_WEIGHT_SCALE, half)):
        gmflow_pair("flow-refine", infer, net, ds, REFINE_STEP,
                    f" (weights x{scale})")
    del model, half, step, ds
    torch.cuda.empty_cache()

    # 31. RAFT's fused lookup: in f32 against the volume path, then the
    # full-width step
    cpu_raft = store.load_raft(cpu_rt)
    gpu_raft = copy.deepcopy(cpu_raft).cuda()
    g = imgs.cuda()
    flow = {}
    with torch.inference_mode():
        for impl, expect in (("fused", per_path(K4=15)),
                             ("volume", per_path(K4=15, K5=4))):
            zero_counts()
            flow[impl] = torch.cat(raft.infer_pairs(gpu_raft, g[:-1], g[1:],
                                                    iters=4, corr_impl=impl))
            if read_counts() != expect:
                fail(f"raft-fused: {impl} launches {read_counts()}, expected "
                     f"{expect}")
    err = float((flow["fused"] - flow["volume"]).abs().max())
    tol = 1e-4 * float(flow["volume"].abs().max())
    ok = bool(torch.isfinite(flow["fused"]).all()) and err <= tol
    say("raft-fused", f"RAFT (full widths) 2 pairs at 128x192, 4 iterations, "
        f"f32 on the card: max |fused - volume| {err:.3e} px, tol {tol:.3e} px "
        f"(1e-4 of the flow scale, max |flow| "
        f"{float(flow['volume'].abs().max()):.2f}: the same sums in another "
        f"order); launches: fused 15 K4 and no K5, volume 15 K4 + 4 K5 "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the fused RAFT lookup disagrees with the volume path")
    del cpu_raft, gpu_raft, flow
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lazy_model, infer = flow_raft_band.build_pairs(runtime, iterations=RAFT_ITERS,
                                                   corr_impl="fused")
    model = lazy_model().to(device=runtime.resolve_device(),
                            dtype=runtime.resolve_dtype())
    step = flow_base.make_flow_step(model, infer, FLOW_HW, need_masks=True,
                                    need_flow=True)
    step(frames)  # warm-up
    setup = time.perf_counter() - t0
    zero_counts()
    out, elapsed = synced(lambda: step(frames))
    counts["flow_raft_fused"] = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_flow_outputs([out])
    if counts["flow_raft_fused"] != per_path(K4=15):
        fail(f"fused RAFT launches in one step: {counts['flow_raft_fused']}, "
             f"expected 15 K4 and no K5")
    say("raft-fused", f"RAFT --corr_impl fused, bf16 (lookup f32), random "
        f"weights, {P} pairs at {FLOW_HW[0]}x{FLOW_HW[1]}, {RAFT_ITERS} "
        f"iterations (set-up and warm-up {setup:.2f} s): one step "
        f"{elapsed * 1e3:.1f} ms, {P / elapsed:.2f} pairs/s, peak memory "
        f"{peak:.2f} GiB; the volume path (phase 13) {raft_volume['pairs_s']:.2f}"
        f" pairs/s, peak memory {raft_volume['peak_gib']:.2f} GiB; launches "
        f"{counts['flow_raft_fused']} (15 K4, no K5) ok; max-disp "
        f"{', '.join(f'{m:.2f}' for m in out['max_disp'])}; on {card}")
    del model, step, out
    torch.cuda.empty_cache()
    return counts


def trace_phase(runtime, frames, card, zero_counts, read_counts, per_path):
    """Phase 32: the depth loop's device trace around the ViT-L step.
    -> {path: launch counts}."""
    import tempfile

    from prisma_tpu_torch.bands import depth_anything_band, depth_base
    from prisma_tpu_torch.runtime.profiling import StageProfiler

    def equal(a, b):
        return set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)

    # 32. the ViT-L step between start_device_trace and stop_device_trace
    # (PRISMA_TPU_TRACE), against the same step untraced
    model, infer, flip = depth_anything_band.build_infer(runtime, encoder="vitl")
    step = depth_base.make_step(model, infer, flip, need_depth=True)
    step(frames)  # warm-up
    untraced, untraced_s = synced(lambda: [step(frames)
                                           for _ in range(TRACE_STEPS)])
    trace_dir = tempfile.mkdtemp(prefix="prisma_tpu_trace_")
    os.environ["PRISMA_TPU_TRACE"] = trace_dir
    try:
        prof = StageProfiler()
    finally:
        del os.environ["PRISMA_TPU_TRACE"]
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.start_device_trace()
    traced = [step(frames) for _ in range(TRACE_STEPS)]
    torch.cuda.synchronize()
    traced_s = time.perf_counter() - t0
    path = prof.stop_device_trace()
    export_s = time.perf_counter() - t0 - traced_s
    counts = {"depth_anything_traced": read_counts()}
    if path is None:
        fail("trace: stop_device_trace wrote no trace under PRISMA_TPU_TRACE")
    trace_mb = os.path.getsize(path) / 2 ** 20
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    shutil.rmtree(trace_dir)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1 = [e for e in kernels if K1_SYMBOL.search(e.get("name", ""))]
    expect = 24 * TRACE_STEPS
    same = all(equal(a, b) for a, b in zip(traced, untraced))
    ok = (len(k1) == expect and counts["depth_anything_traced"]
          == per_path(K1=expect) and same)
    say("trace", f"ViT-L step, {TRACE_STEPS} steps of {BATCH} uint8 "
        f"{FRAME_HW[0]}x{FRAME_HW[1]} frames between start_device_trace and "
        f"stop_device_trace (PRISMA_TPU_TRACE, torch.profiler CPU + CUDA): "
        f"a Chrome trace of {trace_mb:.1f} MiB, {len(events)} events, "
        f"{len(kernels)} kernels ({sum(e['dur'] for e in kernels) / 1e3:.2f} "
        f"ms of device time), {len(k1)} named flash_fwd_* (K1: "
        f"{sum(e['dur'] for e in k1) / 1e3:.2f} ms; {expect} expected); "
        f"launches {counts['depth_anything_traced']}; heat, min, max and "
        f"depth {'equal' if same else 'NOT equal'} bit for bit to the "
        f"untraced steps' {'ok' if ok else 'FAIL'}")
    say("trace", f"host clock: {untraced_s / TRACE_STEPS * 1e3:.1f} ms a step "
        f"untraced, {traced_s / TRACE_STEPS * 1e3:.1f} ms traced (the "
        f"profiler's start included), then {export_s:.2f} s to stop and "
        f"write the trace; on {card}")
    if not ok:
        fail("the traced depth loop did not record its K1 launches or "
             "changed the step's outputs")
    return counts


def default_devices():
    """Phase 33's devices: every visible card (as many as divide the batch),
    or two replicas on the one card -> (devices, how to name them)."""
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        n = max(d for d in (8, 4, 2) if d <= n_cards and BATCH % d == 0)
        return ([torch.device("cuda", i) for i in range(n)],
                f"{n} cards, one replica each")
    return ([torch.device("cuda", 0)] * 2,
            "two replicas on the one card: only one card is visible, so no "
            "split over cards ran")


def data_parallel_paths(runtime, frames, card, zero_counts, read_counts,
                        per_path, devices, where, tag=""):
    """Phase 33: the data-parallel depth and flow steps (parallel/mesh.py)
    over `devices` against one replica on the first card.
    -> {path + tag: launch counts}."""
    from prisma_tpu_torch.bands import depth_anything_band, depth_base
    from prisma_tpu_torch.bands import flow_base, flow_gmflow_band
    from prisma_tpu_torch.models import gmflow as gm
    from prisma_tpu_torch.ops import nn as pnn
    from prisma_tpu_torch.ops.cuda import flash_attention as fa
    from prisma_tpu_torch.parallel import mesh
    from prisma_tpu_torch.runtime.config import RuntimeConfig

    plain_p_bf16 = functools.partial(fa.flash_attention_ref, round_p=True)
    counts = {}
    n = len(devices)
    say("data-parallel", f"devices {[str(d) for d in devices]}: {where}")

    def timed(step):
        step(frames)  # warm-up: the replicas are made
        _, s = synced(lambda: [step(frames) for _ in range(TIMED_STEPS)])
        return s / TIMED_STEPS * 1e3

    def timed_one(step, x):
        step(x)  # warm-up
        _, s = synced(lambda: [step(x) for _ in range(TIMED_STEPS)])
        return s / TIMED_STEPS * 1e3

    # the depth step, bf16: split against whole; the null distance is the
    # whole step's with the plain attention (P rounded to bf16) for K1
    model, infer, flip = depth_anything_band.build_infer(runtime, encoder="vitl")
    step = depth_base.make_step(model, infer, flip, need_depth=True)
    split = depth_base.make_step(model, infer, flip, need_depth=True,
                                 devices=devices)
    whole_ms, split_ms = timed(step), timed(split)
    whole = step(frames)
    zero_counts()
    out = split(frames)
    counts["depth_data_parallel" + tag] = c = read_counts()
    if c != per_path(K1=24 * n):
        fail(f"data-parallel depth launches {c}, expected 24 K1 for each of "
             f"{n} replicas")
    pnn.flash_attention = plain_p_bf16
    try:
        null = step(frames)
    finally:
        pnn.flash_attention = fa.flash_attention
    ref = torch.from_numpy(whole["depth"]).cuda()
    null_check("data-parallel", "depth (bf16)",
               torch.from_numpy(out["depth"]).cuda(), ref,
               torch.from_numpy(null["depth"]).cuda(),
               float(ref.max() - ref.min()),
               null_label="one replica with the plain attention for K1",
               plain_label="on one replica", got_label="split")
    say("data-parallel", f"depth step over {n} replicas: launches {c} (24 K1 "
        f"a replica) ok; {split_ms:.1f} ms a batch-8 step split against "
        f"{whole_ms:.1f} ms on one replica (host clock, mean of "
        f"{TIMED_STEPS}); on {card}")
    # where the split's time goes: each replica's share of the batch run
    # alone on its device, one after the other, and the host time the infer
    # takes to queue a share's work
    alone = [timed_one(depth_base.make_step(m, infer, flip, need_depth=True),
                       ch) for m, ch in zip(mesh.replicate(model, devices),
                                            np.split(frames, n))]
    say("data-parallel", f"depth step's replicas alone on their devices "
        f"(host clock, mean of {TIMED_STEPS}): "
        f"{', '.join(f'{t:.1f}' for t in alone)} ms (sum {sum(alone):.1f})")

    def host_ms(x):
        """Host ms for infer to return, the card's work left queued."""
        with torch.inference_mode():
            infer(model, x)
            sync_all()
            t0 = time.perf_counter()
            infer(model, x)
            t = time.perf_counter() - t0
            sync_all()
        return t * 1e3

    x = torch.from_numpy(frames).cuda()
    say("data-parallel", f"the ViT-L infer's host time with no sync: "
        f"{host_ms(x):.1f} ms at batch {BATCH}, {host_ms(x[:BATCH // n]):.1f}"
        f" ms at batch {BATCH // n} (each replica's share)")
    del x
    del model, step, split, null, out, whole, ref
    torch.cuda.empty_cache()

    # the depth step in f32 (K1's f32 kernel): split within 1e-4 of the scale
    rt32 = RuntimeConfig(random_weights=True, compute_dtype="float32",
                         device="cuda")
    model, infer, flip = depth_anything_band.build_infer(rt32, encoder="vitl")
    whole = depth_base.make_step(model, infer, flip, need_depth=True)(frames)
    zero_counts()
    out = depth_base.make_step(model, infer, flip, need_depth=True,
                               devices=devices)(frames)
    f32_counts = read_counts()
    err = float(np.abs(out["depth"] - whole["depth"]).max())
    tol = 1e-4 * float(np.abs(whole["depth"]).max())
    ok = (f32_counts == per_path(K1=24 * n) and err <= tol
          and np.isfinite(out["depth"]).all())
    say("data-parallel", f"depth step in f32 over {n} replicas: max |split - "
        f"whole| {err:.3e}, tol {tol:.3e} (1e-4 of the depth scale); launches "
        f"{f32_counts} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the f32 data-parallel depth step disagrees with one replica")
    del model, out, whole
    torch.cuda.empty_cache()

    # the GMFlow step: the window's frames in runs a replica, each run with
    # its neighbour's first frame
    k = BATCH // n
    runs = [frames[i * k:(i + 1) * k + 1] for i in range(n)]
    runs = [r for r in runs if len(r) > 1]
    per_step = {"K1": 6, "K2": 6, "K3": 3, "K4": 15}
    lazy_model, infer = flow_gmflow_band.build_pairs(runtime)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        model = lazy_model().to(device="cuda", dtype=dtype)
        whole_step = flow_base.make_flow_step(model, infer, FLOW_HW,
                                              need_masks=True, need_flow=True)
        split = flow_base.make_flow_step(model, infer, FLOW_HW,
                                         need_masks=True, need_flow=True,
                                         devices=devices)
        if dtype == torch.bfloat16:
            whole_ms, split_ms = timed(whole_step), timed(split)
        whole = whole_step(frames)
        zero_counts()
        out = split(frames)
        c = read_counts()
        counts[f"flow_data_parallel_{name}{tag}"] = c
        check_flow_outputs([out])
        if c != per_path(**{key: v * len(runs) for key, v in per_step.items()}):
            fail(f"data-parallel flow launches {c}, expected {per_step} for "
                 f"each of {len(runs)} replicas with pairs")
        if dtype == torch.bfloat16:
            gm.flash_attention = plain_p_bf16
            try:
                null = whole_step(frames)
            finally:
                gm.flash_attention = fa.flash_attention
            # forward and backward apart: torch.quantile takes at most 2^24
            # values
            for key in ("fwd", "bwd"):
                null_check("data-parallel", f"{key} flow (bf16)",
                           torch.from_numpy(out[key]).cuda(),
                           torch.from_numpy(whole[key]).cuda(),
                           torch.from_numpy(null[key]).cuda(), 1.0, unit="px",
                           null_label="one replica with the plain attention "
                           "for K1 and K2", plain_label="on one replica",
                           got_label="split")
            say("data-parallel", f"GMFlow step (bf16) over {n} replicas, "
                f"{len(runs)} with pairs: launches {c} ({per_step} a replica) "
                f"ok; {split_ms:.1f} ms a step of {BATCH - 1} pairs split "
                f"against {whole_ms:.1f} ms on one replica (host clock, mean "
                f"of {TIMED_STEPS}); on {card}")
            del null
        else:
            # f32 at the band's full-scale weights, with TF32 off: the split
            # within 1e-4 of the flow's scale of the whole step; the witness
            # runs each replica's frames through the whole step on the first
            # card, one after the other, and holds the split to it (the same
            # work in the same batches), and that to the whole step (the same
            # work in one batch of 7 pairs)
            seq = [whole_step(r) for r in runs]
            flows = {label: np.concatenate([o["fwd"] for o in outs]
                                           + [o["bwd"] for o in outs])
                     for label, outs in (("split", [out]), ("whole", [whole]),
                                         ("one card", seq))}
            scale = float(np.abs(flows["whole"]).max())
            tol = 1e-4 * scale

            def dist(a, b):
                return float(np.abs(flows[a] - flows[b]).max())

            err, same_batches, batching = (dist("split", "whole"),
                                           dist("split", "one card"),
                                           dist("one card", "whole"))
            ok = err <= tol and same_batches <= tol
            say("data-parallel", f"GMFlow step (f32, TF32 off, the band's "
                f"weights) over {n} replicas, {len(runs)} with pairs: launches "
                f"{c} ({per_step} a replica); max |split - whole| {err:.3e} px, "
                f"tol {tol:.3e} px (1e-4 of the flow's {scale:.1f} px scale) "
                f"{'ok' if err <= tol else 'FAIL'}; witness: max |split - the "
                f"replicas' frames run one after the other on the first card "
                f"(batches of {[len(r) - 1 for r in runs]} pairs)| "
                f"{same_batches:.3e} px ({'bit-equal' if same_batches == 0 else 'not bit-equal'}; "
                f"tol {tol:.3e}) {'ok' if same_batches <= tol else 'FAIL'}, "
                f"and max |those batches - one batch of {BATCH - 1} pairs| "
                f"{batching:.3e} px")
            if not ok:
                fail("the f32 data-parallel flow step disagrees with one "
                     "replica")
            del seq, flows
        del model, whole_step, split, whole, out
        torch.cuda.empty_cache()
    return counts


def port_tools_paths(runtime, frames, card, zero_counts, read_counts,
                     per_path):
    """Phases 32-33: the depth loop's device trace around the ViT-L step,
    and the data-parallel depth and flow steps against one replica.
    -> {path: launch counts}."""
    counts = trace_phase(runtime, frames, card, zero_counts, read_counts,
                         per_path)
    devices, where = default_devices()
    counts.update(data_parallel_paths(runtime, frames, card, zero_counts,
                                      read_counts, per_path, devices, where))
    return counts


def host_tools_phase():
    """Phase 34: the host tools on a short synthetic folder. concat_image,
    to_float_rgb, create_folder/copy_folder and the viewer's helpers always;
    concat_video and a make_video / extract_frames_from_video round trip
    where the native codec loads. A machine without the codec's libraries
    says so, with the loader's error."""
    import tempfile

    import cv2

    from prisma_tpu_torch.cli import concat, view
    from prisma_tpu_torch.io import image, video
    from prisma_tpu_torch.ops import encode as enc

    root = tempfile.mkdtemp(prefix="prisma_tpu_tools_")
    try:
        yy, xx = np.mgrid[0:TOOLS_HW[0], 0:TOOLS_HW[1]]
        # smooth ramps, which x264 keeps within a level or two
        ramps = [(xx + 2 * yy + 3 * i) / (TOOLS_HW[1] + 2 * TOOLS_HW[0])
                 for i in range(TOOLS_FRAMES)]
        rgb = [np.stack([xx * 2 + i * 4, yy * 3, xx + yy], -1).astype(np.uint8)
               for i in range(TOOLS_FRAMES)]
        heat = [(enc.heat_to_rgb(torch.from_numpy(r.astype(np.float32)))
                 .numpy() * 255).astype(np.uint8) for r in ramps]
        folder = os.path.join(root, "seq")
        image.create_folder(folder)
        cv2.imwrite(os.path.join(folder, "rgba.png"), rgb[0])
        cv2.imwrite(os.path.join(folder, "depth.png"), heat[0])
        data = {"bands": {"rgba": {"url": "rgba.png"},
                          "depth": {"url": "depth.png"}}}
        out = os.path.join(root, "sheet.png")
        concat.concat_image(folder, out, data, ["depth"], ["rgba"])
        sheet = cv2.imread(out)
        if not np.array_equal(sheet, np.concatenate([heat[0], rgb[0]])):
            fail("tools: concat_image's sheet is not the bands stacked")
        image.copy_folder(folder, os.path.join(root, "copy"))
        if sorted(os.listdir(os.path.join(root, "copy"))) != \
                sorted(os.listdir(folder)):
            fail("tools: copy_folder lost files")
        if not np.array_equal(image.to_float_rgb(rgb[0]), rgb[0] / 255.0):
            fail("tools: to_float_rgb")
        depth = view.decode_depth_band(heat[0], 1.0, 5.0)
        ramp = 1.0 + 4.0 * ramps[0]
        if not np.abs(depth - ramp).max() <= 0.1:
            fail(f"tools: decode_depth_band off by {np.abs(depth - ramp).max()}")
        say("tools", f"concat_image ({list(sheet.shape)}), copy_folder, "
            f"to_float_rgb and decode_depth_band (within "
            f"{np.abs(depth - ramp).max():.3f} of the ramp, tol 0.1) ok")

        try:
            video._load_lib()
        except OSError as e:
            # only the codec's own libav libraries missing from the machine
            # is the environment's limit; any other load error (a broken or
            # absent libprisma_codec.so) fails the phase
            if not LIBAV_MISSING.search(str(e)):
                fail(f"tools: the native codec does not load: {e}")
            say("tools", f"NOT RUN here: concat_video and the make_video / "
                f"extract_frames_from_video round trip. The native codec "
                f"({os.path.relpath(video._LIB_PATH, HERE)}) does not load on "
                f"this machine: {e}. Its libavformat, libavcodec, libavutil "
                f"and libswscale are not installed here (the environment's "
                f"limit); tests/test_torch_tools.py drives both on the CPU")
            return "not run: libav missing"
        for name, frames in (("rgba.mp4", rgb), ("depth.mp4", heat)):
            w = video.VideoWriter(TOOLS_HW[1], TOOLS_HW[0], 24.0,
                                  filename=os.path.join(folder, name))
            for f in frames:
                w.write(f)
            w.close()
        data = {"fps": 24.0, "frames": TOOLS_FRAMES,
                "bands": {"rgba": {"url": "rgba.mp4"},
                          "depth": {"url": "depth.mp4"}}}
        out = os.path.join(root, "sheet.mp4")
        concat.concat_video(folder, out, data, ["depth"], ["rgba"])

        def decoded(path):
            r = video.VideoReader(path)
            try:
                return list(r)
            finally:
                r.close()

        srcs = [decoded(os.path.join(folder, n)) for n in ("depth.mp4", "rgba.mp4")]
        worst = 0.0
        for got, top, bottom in zip(decoded(out), *srcs):
            d = np.abs(got.astype(int) - np.concatenate([top, bottom]).astype(int))
            worst = max(worst, float(d.mean()))
        if len(decoded(out)) != TOOLS_FRAMES or worst >= X264_LEVELS:
            fail(f"tools: concat_video's frames differ from the bands stacked "
                 f"(mean {worst:.2f} levels)")
        pngs = os.path.join(root, "pngs")
        n = video.extract_frames_from_video(out, pngs, extension="png")
        made = os.path.join(root, "made.mp4")
        video.make_video(made, pngs, fps=24)
        back = decoded(made)
        worst = max(float(np.abs(a.astype(int) - b.astype(int)).mean())
                    for a, b in zip(back, decoded(out)))
        if n != TOOLS_FRAMES or len(back) != n or worst >= X264_LEVELS:
            fail(f"tools: make_video / extract_frames_from_video round trip: "
                 f"{n} frames out, {len(back)} back, mean {worst:.2f} levels")
        say("tools", f"concat_video ({TOOLS_FRAMES} frames), "
            f"extract_frames_from_video ({n} PNGs) and make_video back: "
            f"within {worst:.2f} levels in mean (x264, tol {X264_LEVELS}) ok")
        return "ok"
    finally:
        shutil.rmtree(root, ignore_errors=True)


def match_slabs(ours, theirs):
    """Match each valid instance of `theirs` to one of `ours` with its label,
    mask probabilities within 1e-4 and a decayed score within 5e-3 (the
    whole network's outputs part by a few ulp on two devices, which flips
    a mask pixel at the threshold now and then, moves an IoU in matrix NMS
    and can swap two instances of near scores). -> the worst (probability,
    score) distances, or None if an instance has no match."""
    if int(ours["valid"].sum()) != int(theirs["valid"].sum()):
        return None
    free = set(torch.nonzero(ours["valid"]).flatten().tolist())
    worst = (0.0, 0.0)
    for i in torch.nonzero(theirs["valid"]).flatten().tolist():
        best = None
        for j in free:
            if ours["labels"][j] != theirs["labels"][i]:
                continue
            err = float((ours["probs"][j] - theirs["probs"][i]).abs().max())
            if best is None or err < best[0]:
                best = (err, j)
        if best is None or best[0] > 1e-4:
            return None
        ds = abs(float(ours["scores"][best[1]] - theirs["scores"][i]))
        if ds > 5e-3:
            return None
        free.remove(best[1])
        worst = (max(worst[0], best[0]), max(worst[1], ds))
    return f"probabilities within {worst[0]:.2e}, scores within {worst[1]:.2e}"


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


def held(calls):
    """-> ratios(key, out, ref, tols): records (max/tol, mean/tol, ok) of
    out against ref in calls[key] and returns out."""
    def ratios(key, out, ref, tols):
        max_err, mean_err, ok = within(out, ref, tols)
        calls[key].append((max_err / tols[0], mean_err / tols[1], ok))
        return out
    return ratios


def norm_held(ratios):
    """K4, each call held to its plain version under its bounds."""
    from prisma_tpu_torch.ops.cuda import instance_norm as inorm

    def norm_checked(x, eps=inorm.EPS, relu=False):
        ref = inorm.instance_norm_relu_ref(x, eps, relu)
        return ratios("K4", inorm.instance_norm_relu(x, eps, relu), ref,
                      inorm.bounds(ref))
    return norm_checked


def gmflow_pair(phase, infer, net, ds, expect, label=""):
    """One pair's real activations (ds[:1] -> ds[1:]) through GMFlow: every
    kernel call held to its plain version under its bounds, `expect` calls
    of each kernel; then the pair's flow with the plain versions in place of
    the kernels, and with a plain path that rounds P to bf16 as K1/K2 do
    (the null distance): the kernels' flow within 2x of it."""
    from prisma_tpu_torch.models import gmflow as gm
    from prisma_tpu_torch.ops.cuda import flash_attention as fa
    from prisma_tpu_torch.ops.cuda import instance_norm as inorm

    calls = {key: [] for key in expect}
    ratios = held(calls)
    plain_p_bf16 = functools.partial(fa.flash_attention_ref, round_p=True)

    def fa_checked(q, k, v, region_bands=None, win_w=0):
        out = fa.flash_attention(q, k, v, region_bands=region_bands, win_w=win_w)
        ref = plain_p_bf16(q, k, v, region_bands=region_bands, win_w=win_w)
        return ratios("K1" if region_bands is None else "K2", out, ref,
                      attn_tols(ref))

    def streamed_checked(q, k, v, scale):
        return ratios("K3", fa.flash_attention_streamed(q, k, v, scale),
                      fa.flash_attention_streamed_ref(q, k, v, scale),
                      fa.streamed_bounds(v))

    paths = {
        "kernels": (fa_checked, streamed_checked, norm_held(ratios)),
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
                flows[name] = torch.cat(infer(net, ds[:1], ds[1:])).float()
            finally:
                gm.flash_attention, gm.flash_attention_streamed, \
                    gm.instance_norm_relu = (fa.flash_attention,
                                             fa.flash_attention_streamed,
                                             inorm.instance_norm_relu)
    n_calls = {key: len(v) for key, v in calls.items()}
    ok = n_calls == expect and all(r[2] for v in calls.values() for r in v)
    say(phase, f"pair 0{label} (max |flow| {float(flows['plain'].abs().max()):.1f}"
        f" px), every kernel call against its plain version on the real "
        f"activations, worst |err| / tol (max, mean): " + "; ".join(
            f"{key} x{len(v)} {max(r[0] for r in v):.3f}, "
            f"{max(r[1] for r in v):.3f}" for key, v in calls.items())
        + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{phase}: a kernel disagrees with its plain version on the "
             f"flow path's activations ({n_calls} calls)")
    null_check(phase, "flow" + label, flows["kernels"], flows["plain"],
               flows["plain_p_bf16"], 1.0, unit="px")


def null_check(phase, what, kernels, plain, null_path, span,
               unit="of the range", null_label="plain with P rounded to bf16",
               plain_label="with the plain versions", got_label="kernels"):
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
    say(phase, f"|{what} - {what} {plain_label}| ({unit}; mean, "
        f"99.9th pct, max): {got_label} " + ", ".join(f"{g:.3e}" for g in got)
        + f"; {null_label} " + ", ".join(f"{n:.3e}" for n in null)
        + f"; tol 2x the latter {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"the {what} through the {got_label} disagrees with the "
             f"reference path")


if __name__ == "__main__":
    if sys.argv[1:] == ["--data-parallel"]:
        data_parallel_main()
    elif sys.argv[1:]:
        fail(f"unknown arguments {sys.argv[1:]}: run with none, or with "
             f"--data-parallel")
    else:
        main()
