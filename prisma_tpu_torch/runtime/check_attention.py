"""The attention kernels alone on one CUDA card: a quick loop for work on
csrc/flash_attention.cu (the bf16 K1 and K2) and csrc/flash_attention_streamed.cu
(K3).

    python -m prisma_tpu_torch.runtime.check_attention [--kernels k1 k3]

Builds the named sources alone and checks, then times, each kernel; exits
non-zero on a failed case, before any timing. chip_smoke.py remains the full
check; this one takes about a minute.

K1/K2: the bf16 kernels against their plain version with P rounded to bf16
(`bf16_bounds`) at 33 cases: for d in 32, 64, 128 and N in 128, 256, 100,
2443, 1, uniform attention (q = k = 0, which isolates P·V from S) and random
q, k, v; GMFlow's 1080p windows [8, 4590, 128] with bands and with ids;
random ids at [6, 300, 64]. Then K1 at the ViT-L and GMFlow window shapes and
K2 at the window shape, each beside scaled_dot_product_attention.

K3: the bf16 kernel against its plain version (`streamed_bounds`) for d in
32, 64, 128: uniform (q = k = 0, v alone), random, peaked (keys a permutation
of the queries times 4, so each softmax is nearly one-hot and a misplaced v
row shows) and ragged M and N at the tile edges (M = 18360 + 37 keys, N =
1, 255, 257 queries), at dv = 1, 2, 4; then the matching [7, 18360, 128] and
propagation [14, 18360, 128] shapes at dv = 2, each beside
scaled_dot_product_attention with v cast to bf16 and padded to 128 (not the
same numerics), and against the same v zero-padded to dv = 4 (the DV = 4
body), in turn.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from prisma_tpu_torch.models import gmflow as gm
from prisma_tpu_torch.ops.cuda import build
from prisma_tpu_torch.ops.cuda import flash_attention as fa
from prisma_tpu_torch.runtime.profile_step import cuda_ms

FEAT_HW = (102, 180)  # GMFlow's 1/8 features of a 0.75x 1080p frame


def _bf16(shape, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


def case(label, out, ref, tol) -> bool:
    """Prints one case held to its (max, mean) bounds; True if it passed."""
    err = (out.float() - ref.float()).abs()
    ok = (bool(out.isfinite().all()) and float(err.max()) <= tol[0]
          and float(err.mean()) <= tol[1])
    print(f"{label}: |err| max {float(err.max()):.3e} (tol {tol[0]:.3e}), "
          f"mean {float(err.mean()):.3e} (tol {tol[1]:.3e}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return ok


def check(gen) -> int:
    """K1/K2: prints each case; returns the number that failed."""
    failed = 0

    def k1_case(label, out, ref):
        nonlocal failed
        failed += not case(label, out, ref, fa.bf16_bounds(ref))

    for d in (64, 128, 32):
        for n in (128, 256, 100, 2443, 1):
            v = _bf16((3, n, d), gen)
            z = torch.zeros_like(v)
            k1_case(f"uniform [3, {n}, {d}]", fa.flash_attention(z, z, v),
                 fa.flash_attention_ref(z, z, v, round_p=True))
            q, k = _bf16((3, n, d), gen), _bf16((3, n, d), gen)
            k1_case(f"random [3, {n}, {d}]", fa.flash_attention(q, k, v),
                 fa.flash_attention_ref(q, k, v, round_p=True))
    bands = torch.from_numpy(gm.shift_window_region_bands(*FEAT_HW, 2)).cuda()
    win_w = FEAT_HW[1] // 2
    q, k, v = (_bf16((8, 4590, 128), gen) for _ in range(3))
    k1_case("bands [8, 4590, 128]",
         fa.flash_attention(q, k, v, region_bands=bands, win_w=win_w),
         fa.flash_attention_ref(q, k, v, region_bands=bands, win_w=win_w,
                                round_p=True))
    ids = torch.from_numpy(np.tile(gm.shift_window_region_ids(*FEAT_HW, 2),
                                   (2, 1))).cuda()
    k1_case("ids [8, 4590, 128]", fa.flash_attention(q, k, v, ids=ids),
         fa.flash_attention_ref(q, k, v, ids=ids, round_p=True))
    ids = torch.randint(0, 4, (6, 300), generator=gen, device="cuda",
                        dtype=torch.int32)
    q, k, v = (_bf16((6, 300, 64), gen) for _ in range(3))
    k1_case("random ids [6, 300, 64]", fa.flash_attention(q, k, v, ids=ids),
         fa.flash_attention_ref(q, k, v, ids=ids, round_p=True))
    return failed


def timing(gen) -> None:
    """K1 at the ViT-L and GMFlow window shapes, K2 at the window shape."""
    for (B, N, d), heads in (((128, 2443, 64), 16), ((56, 4590, 128), 4)):
        q, k, v = (_bf16((B, N, d), gen) for _ in range(3))
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v), 20)
        q4, k4, v4 = (t.view(B // heads, heads, N, d) for t in (q, k, v))
        sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4), 20)
        flops = 4 * B * N * N * d
        print(f"K1 [{B}, {N}, {d}]: {ms:.3f} ms ({flops / ms / 1e9:.0f} "
              f"TFLOP/s); scaled_dot_product_attention {sdpa:.3f} ms", flush=True)
    bands = torch.from_numpy(gm.shift_window_region_bands(*FEAT_HW, 2)).cuda()
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, region_bands=bands,
                                            win_w=FEAT_HW[1] // 2), 20)
    print(f"K2 [56, 4590, 128], bands: {ms:.3f} ms "
          f"({flops / ms / 1e9:.0f} TFLOP/s)", flush=True)


def check_streamed(gen) -> int:
    """K3: prints each case; returns the number that failed."""
    failed = 0

    def k3_case(label, q, k, v):
        nonlocal failed
        scale = q.shape[-1] ** -0.5
        failed += not case(label, fa.flash_attention_streamed(q, k, v, scale),
                           fa.flash_attention_streamed_ref(q, k, v, scale),
                           fa.streamed_bounds(v))

    def pixels(B, M, dv):
        return torch.rand((B, M, dv), generator=gen, device="cuda") * 1440

    for d in (128, 64, 32):
        for dv in (1, 2, 4):
            z = torch.zeros((2, 300, d), device="cuda", dtype=torch.bfloat16)
            k3_case(f"uniform [2, 300, {d}], M 300, dv {dv}", z, z,
                    pixels(2, 300, dv))
            q, k = _bf16((2, 257, d), gen), _bf16((2, 1000, d), gen)
            k3_case(f"random [2, 257, {d}], M 1000, dv {dv}", q, k,
                    pixels(2, 1000, dv))
            q = _bf16((2, 1000, d), gen)
            perm = torch.randperm(1000, generator=gen, device="cuda")
            k3_case(f"peaked [2, 1000, {d}], dv {dv}", q,
                    (q[:, perm].float() * 4).to(torch.bfloat16), pixels(2, 1000, dv))
            k = _bf16((2, 18360 + 37, d), gen)
            for n in (1, 255, 257):
                k3_case(f"ragged [2, {n}, {d}], M {18360 + 37}, dv {dv}",
                        _bf16((2, n, d), gen), k, pixels(2, 18360 + 37, dv))
    return failed


def timing_streamed(gen) -> None:
    """K3 at the matching and propagation shapes, beside SDPA with v padded;
    then dv = 2 against the same v zero-padded to dv = 4, in turn, three
    rounds each: what the two v columns more cost."""
    for B in (7, 14):
        N, d = 18360, 128
        q, k = _bf16((B, N, d), gen), _bf16((B, N, d), gen)
        v = torch.rand((B, N, 2), generator=gen, device="cuda") * 1440
        ms = cuda_ms(lambda: fa.flash_attention_streamed(q, k, v, d ** -0.5), 10)
        vpad = F.pad(v.to(torch.bfloat16), (0, d - 2))[:, None]
        sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(
            q[:, None], k[:, None], vpad), 10)
        flops = 2 * B * N * N * (d + 2)
        print(f"K3 [{B}, {N}, {d}], dv 2: {ms:.3f} ms ({flops / ms / 1e9:.0f} "
              f"TFLOP/s); scaled_dot_product_attention with v padded to {d} "
              f"{sdpa:.3f} ms", flush=True)
        v4 = F.pad(v, (0, 2))
        rounds = [(cuda_ms(lambda: fa.flash_attention_streamed(q, k, v, d ** -0.5), 10),
                   cuda_ms(lambda: fa.flash_attention_streamed(q, k, v4, d ** -0.5), 10))
                  for _ in range(3)]
        print(f"K3 [{B}, {N}, {d}], dv 2 | v zero-padded to dv 4, ms by round: "
              + "; ".join(f"{a:.4f} | {b:.4f}" for a, b in rounds), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", nargs="+", choices=("k1", "k3"),
                    default=["k1", "k3"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("check_attention: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    sources = {"k1": "flash_attention", "k3": "flash_attention_streamed"}
    t0 = time.perf_counter()
    build.build_all([sources[k] for k in args.kernels])
    print(f"built {', '.join(sources[k] + '.cu' for k in args.kernels)} in "
          f"{time.perf_counter() - t0:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    failed = (check(gen) if "k1" in args.kernels else 0) + \
        (check_streamed(gen) if "k3" in args.kernels else 0)
    torch.cuda.synchronize()
    if failed:
        sys.exit(f"check_attention: {failed} case(s) FAILED")
    if "k1" in args.kernels:
        timing(gen)
    if "k3" in args.kernels:
        timing_streamed(gen)


if __name__ == "__main__":
    main()
