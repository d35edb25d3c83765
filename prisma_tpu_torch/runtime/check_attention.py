"""The bf16 flash-attention kernels K1 and K2 alone, on one CUDA card: a quick
loop for work on csrc/flash_attention.cu.

    python -m prisma_tpu_torch.runtime.check_attention

Builds flash_attention.cu alone and holds the bf16 kernels to their plain
version with P rounded to bf16 (`bf16_bounds`) at 33 cases: for d in 32, 64,
128 and N in 128, 256, 100, 2443, 1, uniform attention (q = k = 0, which
isolates P·V from S) and random q, k, v; GMFlow's 1080p windows [8, 4590,
128] with bands and with ids; random ids at [6, 300, 64]. Then it times K1 at
the ViT-L and GMFlow window shapes and K2 at the window shape, each beside
scaled_dot_product_attention in the same run. Exits non-zero on a failed
case. chip_smoke.py remains the full check; this one takes about a minute.
"""

from __future__ import annotations

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


def check(gen) -> int:
    """Prints each case; returns the number that failed."""
    failed = 0

    def case(label, out, ref):
        nonlocal failed
        err = (out.float() - ref.float()).abs()
        tol = fa.bf16_bounds(ref)
        ok = (bool(out.isfinite().all()) and float(err.max()) <= tol[0]
              and float(err.mean()) <= tol[1])
        failed += not ok
        print(f"{label}: |err| max {float(err.max()):.3e} (tol {tol[0]:.3e}), "
              f"mean {float(err.mean()):.3e} (tol {tol[1]:.3e}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)

    for d in (64, 128, 32):
        for n in (128, 256, 100, 2443, 1):
            v = _bf16((3, n, d), gen)
            z = torch.zeros_like(v)
            case(f"uniform [3, {n}, {d}]", fa.flash_attention(z, z, v),
                 fa.flash_attention_ref(z, z, v, round_p=True))
            q, k = _bf16((3, n, d), gen), _bf16((3, n, d), gen)
            case(f"random [3, {n}, {d}]", fa.flash_attention(q, k, v),
                 fa.flash_attention_ref(q, k, v, round_p=True))
    bands = torch.from_numpy(gm.shift_window_region_bands(*FEAT_HW, 2)).cuda()
    win_w = FEAT_HW[1] // 2
    q, k, v = (_bf16((8, 4590, 128), gen) for _ in range(3))
    case("bands [8, 4590, 128]",
         fa.flash_attention(q, k, v, region_bands=bands, win_w=win_w),
         fa.flash_attention_ref(q, k, v, region_bands=bands, win_w=win_w,
                                round_p=True))
    ids = torch.from_numpy(np.tile(gm.shift_window_region_ids(*FEAT_HW, 2),
                                   (2, 1))).cuda()
    case("ids [8, 4590, 128]", fa.flash_attention(q, k, v, ids=ids),
         fa.flash_attention_ref(q, k, v, ids=ids, round_p=True))
    ids = torch.randint(0, 4, (6, 300), generator=gen, device="cuda",
                        dtype=torch.int32)
    q, k, v = (_bf16((6, 300, 64), gen) for _ in range(3))
    case("random ids [6, 300, 64]", fa.flash_attention(q, k, v, ids=ids),
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("check_attention: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    build.build_all(["flash_attention"])
    print(f"built flash_attention.cu in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(0)
    failed = check(gen)
    torch.cuda.synchronize()
    if failed:
        sys.exit(f"check_attention: {failed} case(s) FAILED")
    timing(gen)


if __name__ == "__main__":
    main()
