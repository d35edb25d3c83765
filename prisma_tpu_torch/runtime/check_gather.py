"""K6a (lane gather) and K6b (minor transpose), the probe kernels, alone on
one CUDA card: a quick loop for work on csrc/probe_gather.cu.

    PYTHONPATH=<tree> python <tree or another>/prisma_tpu_torch/runtime/check_gather.py

Builds probe_gather.cu alone and holds both kernels to their plain versions,
bit for bit, in f32 and bf16: at the probe's shapes, at ragged ones (taps of
1 and past the row, offsets past both ends of the row, rows longer than a
span, slabs that do not fill 16 bytes or a buffer) and at the size of one
RAFT level-0 iteration: the probe's [32·180, 102] block and its [8, 180, 16]
slabs, each 2295 times (`L0_BLOCKS`), and a batch of slabs past the 65535 of
the previous design's grid. Exits non-zero on a failed case, before that
case is timed. Each at-scale case is then timed: the kernel and the design it
replaced in turns (new, previous, previous, new; the previous design cannot
take B > 65535), the one PyTorch call that computes the same function, the
plain version and the bound. chip_smoke.py's phase 14 makes its cases and its
numbers with the helpers here.
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
import sys
import time

import torch

from prisma_tpu_torch.ops.cuda import build, launch
from prisma_tpu_torch.ops.cuda import probe_gather as pg
from prisma_tpu_torch.runtime.profile_step import cuda_ms

HBM_BYTES_S = 3.35e12  # H100 SXM
TAPS = 10
L0_BLOCKS = 2295  # probe blocks in one RAFT level-0 iteration (probe_gather_kernel.py:127)
DTYPES = (torch.float32, torch.bfloat16)
# the probe's shapes, with the probe's offset ranges
PROBE_A = (((16, 128), -4, 124), ((16, 256), 0, 246), ((5760, 102), 0, 92))
PROBE_B = ((8, 180, 16),)
# ragged: (shape, taps), offsets from -2H to 2H; [5, 4099] rows are longer than a span
RAGGED_A = (((7, 33), 1), ((7, 33), 10), ((7, 33), 40),
            ((33, 102), 1), ((33, 102), 10), ((33, 102), 120), ((5, 4099), 10))
# odd W and T (slabs short of 16 bytes: the tail path) and slabs larger than a buffer
RAGGED_B = ((3, 45, 70), (8, 181, 17), (2, 300, 70))
SCALE_A = (L0_BLOCKS * 5760, 102)  # [13219200, 102]
SCALE_B = ((L0_BLOCKS * 8, 180, 16), (70000, 180, 16))
PREVIOUS_MAX_B = 65535


def dname(dtype: torch.dtype) -> str:
    return str(dtype)[6:]


def gather_input(gen: torch.Generator, shape, dtype, lo: int, hi: int):
    """(x [S, H] uniform in [0, 1) of dtype, off [S] int32 in [lo, hi)) on
    the card."""
    x = torch.rand(shape, generator=gen, device="cuda").to(dtype)
    off = torch.randint(lo, hi, shape[:1], generator=gen, device="cuda",
                        dtype=torch.int32)
    return x, off


def slab_input(gen: torch.Generator, shape, dtype):
    return torch.rand(shape, generator=gen, device="cuda").to(dtype)


def small_cases(gen: torch.Generator, probe_offsets=None):
    """([(label, x, off, taps)], [(label, x)]): the probe's shapes, then the
    ragged ones, each in f32 and bf16. probe_offsets: the offsets of the
    probe's shapes (int32, one per shape of PROBE_A, for both types) where
    the caller draws them; else each case draws its own."""
    a, b = [], []
    for i, (shape, lo, hi) in enumerate(PROBE_A):
        for dtype in DTYPES:
            x, off = gather_input(gen, shape, dtype, lo, hi)
            if probe_offsets is not None:
                off = probe_offsets[i]
            a.append((f"{list(shape)} {dname(dtype)}", x, off, TAPS))
    for shape, taps in RAGGED_A:
        for dtype in DTYPES:
            H = shape[1]
            a.append((f"{list(shape)} {dname(dtype)} taps {taps}",
                      *gather_input(gen, shape, dtype, -2 * H, 2 * H), taps))
    for shape in PROBE_B + RAGGED_B:
        for dtype in DTYPES:
            b.append((f"{list(shape)} {dname(dtype)}", slab_input(gen, shape, dtype)))
    return a, b


def scale_cases(gen: torch.Generator):
    """[(kernel, label, make)] at the at-scale shapes; make() -> the inputs
    ((x, off) for K6a, (x,) for K6b, 0.4-5.4 GB each), made on call so that
    one case's tensors can go before the next one's are made."""
    cases = [("K6a", f"lane_gather {list(SCALE_A)} {dname(dtype)} taps {TAPS}",
              functools.partial(gather_input, gen, SCALE_A, dtype, 0, 92))
             for dtype in DTYPES]
    for shape in SCALE_B:
        cases += [("K6b", f"minor_transpose {list(shape)} {dname(dtype)}",
                   functools.partial(lambda s, d: (slab_input(gen, s, d),), shape, dtype))
                  for dtype in DTYPES]
    return cases


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def gather_equal(x, off, taps, out, rows: int = 1 << 20) -> bool:
    """out equal to lane_gather_ref bit for bit, compared in row chunks (the
    plain version's int64 index of the at-scale input is 10.8 GB)."""
    return all(torch.equal(bits(out[i:i + rows]),
                           bits(pg.lane_gather_ref(x[i:i + rows], off[i:i + rows], taps)))
               for i in range(0, x.shape[0], rows))


def transpose_equal(x, out) -> bool:
    return torch.equal(bits(out), bits(pg.minor_transpose_ref(x)))


def gather_bytes(x: torch.Tensor, taps: int) -> dict:
    """K6a's bytes, both counts: `windows` what the outputs need (each row's
    taps window, the output, the offsets), `whole_x` with every value of x
    read."""
    S, H = x.shape
    es = x.element_size()
    return {"windows": S * min(taps, H) * es + S * H * es + 4 * S,
            "whole_x": 2 * S * H * es + 4 * S}


def transpose_bytes(x: torch.Tensor) -> int:
    return 2 * x.numel() * x.element_size()


@functools.cache
def _previous():
    """The C entries of the previous design (csrc/probe_gather.cu,
    `*_previous`): timed beside the kernels, called by no wrapper."""
    p, i = ctypes.c_void_p, ctypes.c_int
    return (launch.entry("probe_gather", "prisma_lane_gather_previous",
                         [p, p, p, ctypes.c_longlong, i, i, i]),
            launch.entry("probe_gather", "prisma_minor_transpose_previous",
                         [p, p, i, i, i, i]))


def gather_previous(x, off, taps, out) -> None:
    launch.launch("lane_gather_previous", _previous()[0], x.get_device(), x.data_ptr(),
                  off.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], taps,
                  pg._DTYPE_CODES[x.dtype])


def transpose_previous(x, out) -> None:
    B, W, T = x.shape
    launch.launch("minor_transpose_previous", _previous()[1], x.get_device(),
                  x.data_ptr(), out.data_ptr(), B, W, T, pg._DTYPE_CODES[x.dtype])


def in_turns(new, previous, iters: int):
    """(new ms by round, previous ms by round) from CUDA events, timed new,
    previous, previous, new; previous None -> []."""
    rounds = {"new": [], "previous": []}
    calls = {"new": new, "previous": previous}
    for key in ("new", "previous", "previous", "new"):
        if calls[key] is not None:
            rounds[key].append(cuda_ms(calls[key], iters))
    return rounds["new"], rounds["previous"]


def mean(v):
    return sum(v) / len(v) if v else None


def time_gather(x, off, taps: int, iters: int = 10) -> dict:
    """K6a's numbers at one input: the kernel and the previous design in
    turns (the previous one's output held to the kernel's), torch.gather with
    its index made beforehand, the plain version, both bounds."""
    out = pg.lane_gather(x, off, taps)
    prev_out = torch.empty_like(x)
    new, prev = in_turns(lambda: pg.lane_gather(x, off, taps),
                         lambda: gather_previous(x, off, taps, prev_out), iters)
    if not torch.equal(bits(prev_out), bits(out)):
        raise RuntimeError("the previous lane_gather design disagrees with the kernel")
    del out, prev_out
    H = x.shape[1]
    idx = (off.long()[:, None] + torch.arange(H, device=x.device).clamp_max(taps - 1)) \
        .clamp_(0, H - 1)
    library = cuda_ms(lambda: torch.gather(x, 1, idx), iters)
    del idx
    torch.cuda.empty_cache()
    plain = cuda_ms(lambda: pg.lane_gather_ref(x, off, taps), 2)
    nb = gather_bytes(x, taps)
    return dict(ms=mean(new), rounds=new, previous_ms=mean(prev), previous_rounds=prev,
                library_ms=library, plain_ms=plain,
                bound_ms=1e3 * nb["windows"] / HBM_BYTES_S, bound_by="bytes",
                bound_whole_x_ms=1e3 * nb["whole_x"] / HBM_BYTES_S,
                bytes=nb["windows"], bytes_whole_x=nb["whole_x"])


def time_transpose(x, iters: int = 20) -> dict:
    """K6b's numbers at one input: the kernel and the previous design in
    turns (where B <= 65535), `.transpose(1, 2).contiguous()`, the plain
    version (the same call, through the module), the bound."""
    prev = None
    if x.shape[0] <= PREVIOUS_MAX_B:
        prev_out = x.new_empty((x.shape[0], x.shape[2], x.shape[1]))
        prev = functools.partial(transpose_previous, x, prev_out)
    new, prev_rounds = in_turns(lambda: pg.minor_transpose(x), prev, iters)
    if prev is not None and not torch.equal(bits(prev_out), bits(pg.minor_transpose(x))):
        raise RuntimeError("the previous minor_transpose design disagrees with the kernel")
    library = cuda_ms(lambda: x.transpose(1, 2).contiguous(), iters)
    plain = cuda_ms(lambda: pg.minor_transpose_ref(x), iters)
    nb = transpose_bytes(x)
    return dict(ms=mean(new), rounds=new, previous_ms=mean(prev_rounds),
                previous_rounds=prev_rounds, library_ms=library, plain_ms=plain,
                bound_ms=1e3 * nb / HBM_BYTES_S, bound_by="bytes", bytes=nb)


def describe(label: str, t: dict) -> str:
    """One line of an at-scale case's numbers."""
    share = t["bound_ms"] / t["ms"]
    line = (f"{label}: kernel {t['ms']:.4f} ms (rounds "
            + ", ".join(f"{v:.4f}" for v in t["rounds"])
            + f"), {t['bytes'] / (t['ms'] * 1e-3) / 1e12:.2f} TB/s, {share:.1%} of the "
            f"bound {t['bound_ms']:.4f} ms")
    if "bound_whole_x_ms" in t:
        line += (f" (bytes the outputs need: each row's taps window, the output, the "
                 f"offsets; with all of x read the bound is {t['bound_whole_x_ms']:.4f} "
                 f"ms, {t['bound_whole_x_ms'] / t['ms']:.1%})")
    line += "; previous design "
    line += (f"{t['previous_ms']:.4f} ms (rounds "
             + ", ".join(f"{v:.4f}" for v in t["previous_rounds"])
             + f", {t['bound_ms'] / t['previous_ms']:.1%} of the bound)"
             if t["previous_ms"] is not None else f"not run (B > {PREVIOUS_MAX_B})")
    lib = "torch.gather" if "bound_whole_x_ms" in t else ".transpose(1, 2).contiguous()"
    faster = "faster" if t["ms"] < t["library_ms"] else "SLOWER"
    line += (f"; {lib} {t['library_ms']:.4f} ms ({faster} than it); plain "
             f"{t['plain_ms']:.4f} ms")
    return line


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("check_gather: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"prisma_tpu_torch from {pg.__file__.rsplit('/ops/', 1)[0]}")
    t0 = time.perf_counter()
    path = build.build_all(["probe_gather"])["probe_gather"]
    print(f"built probe_gather.cu in {time.perf_counter() - t0:.1f} s; ptxas: "
          + " | ".join(line.strip() for line in open(path + ".log")
                       if "registers" in line or "spill" in line))
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases_a, cases_b = small_cases(gen)
    failed = [label for label, x, off, taps in cases_a
              if not gather_equal(x, off, taps, pg.lane_gather(x, off, taps))]
    failed += [label for label, x in cases_b if not transpose_equal(x, pg.minor_transpose(x))]
    torch.cuda.synchronize()
    print(f"{len(cases_a)} lane_gather and {len(cases_b)} minor_transpose cases at the "
          f"probe's and ragged shapes: " + (f"FAILED {failed}" if failed else "all equal"),
          flush=True)
    if failed:
        sys.exit("check_gather: a case FAILED")
    for kernel, label, make in scale_cases(gen):
        inputs = make()
        if kernel == "K6a":
            x, off = inputs
            ok = gather_equal(x, off, TAPS, pg.lane_gather(x, off, TAPS))
        else:
            (x,) = inputs
            ok = transpose_equal(x, pg.minor_transpose(x))
        if not ok:
            sys.exit(f"check_gather: {label} FAILED")
        t = time_gather(x, off, TAPS) if kernel == "K6a" else time_transpose(x)
        print(describe(label + ", equal", t) + f"; {card}", flush=True)
        del inputs, x
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
