"""K5, RAFT's correlation-window lookup, alone on one CUDA card: a quick loop
for work on csrc/raft_lookup.cu.

    PYTHONPATH=<tree> python <tree or another>/prisma_tpu_torch/runtime/check_lookup.py

Builds raft_lookup.cu alone and holds the kernel to its plain version
`window_lookup_ref`, bit for bit, at the RAFT main shape (N = 257040 pixels,
four bf16 levels 102x180 to 12x22, centres the pixel grid +- 40 px, eight of
them at +-1e6, +-inf or NaN) and on the ragged cases; exits non-zero on a
failed case, before any timing. Then times the kernel (three rounds), its
plain version and `F.grid_sample` at the main shape beside the bound. It
imports whichever prisma_tpu_torch comes first on the path, so one run can
time a parent tree and a change in turn. chip_smoke.py's phase 11 makes its
cases and its bound with the helpers here, and the tests make theirs with
`edge_centres`.
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from prisma_tpu_torch.models import raft
from prisma_tpu_torch.ops.cuda import build
from prisma_tpu_torch.ops.cuda import raft_lookup as rl
from prisma_tpu_torch.runtime.profile_step import cuda_ms

FEAT_HW = (102, 180)   # RAFT's 1/8 features of a 0.75x 1080p frame (816x1440)
IMAGES = 14            # 7 bidirectional pairs
OFFSET = 40.0          # main-shape centres: the pixel grid plus up to this many px
HBM_BYTES_S = 3.35e12  # H100 SXM
SPECIALS = ((1e6, 5.0), (-1e6, 5.0), (5.0, 1e6), (5.0, -1e6), (float("inf"), 5.0),
            (float("-inf"), 5.0), (5.0, float("nan")), (float("nan"), float("nan")))


def edge_centres(n: int, hw, seed: int = 0, r: int = rl.RADIUS) -> torch.Tensor:
    """[n, 2] f32 centres (x, y) at the scale of an [n, H, W] level: integer
    corners from -(r+2) to W+r and H+r (every corner the kernel's clamp
    keeps), so the windows cover both edges of the plane and, across pixels,
    every start offset of a patch row within a 16-byte chunk; random
    fractions. Pixel 0 sits at the top-left corner of its plane (the
    tensor's first values) and the last pixel at the bottom-right corner of
    its plane (the tensor's last values), on every level."""
    rng = np.random.default_rng(seed)
    H, W = hw
    c = np.stack([rng.integers(-(r + 2), W + r + 1, n) + rng.uniform(0, 1, n),
                  rng.integers(-(r + 2), H + r + 1, n) + rng.uniform(0, 1, n)], -1)
    c[0] = (0.25, 0.25)
    c[-1] = (W - 0.25, H - 0.25)
    return torch.from_numpy(c.astype(np.float32))


def main_case(gen: torch.Generator):
    """(pyramid, coords) at the RAFT main shape on the card: the pyramid of
    seeded bf16 fmaps [14, 256, 102, 180] (12.5 GB), centres the pixel grid
    +- OFFSET px with SPECIALS in the first rows."""
    f1, f2 = (torch.randn((IMAGES, 256, *FEAT_HW), generator=gen, device="cuda")
              .to(torch.bfloat16) for _ in range(2))
    pyr = raft.build_corr_pyramid(f1, f2, 4)
    del f1, f2
    n = IMAGES * FEAT_HW[0] * FEAT_HW[1]
    grid = raft.coords_grid(IMAGES, *FEAT_HW, "cuda").reshape(n, 2)
    coords = (grid + (torch.rand((n, 2), generator=gen, device="cuda") * 2 - 1)
              * OFFSET).contiguous()
    coords[:len(SPECIALS)] = torch.tensor(SPECIALS, device="cuda")
    return pyr, coords


def ragged_cases(gen: torch.Generator):
    """[(label, pyramid, coords)] on the card: odd levels in f32 and bf16 with
    an empty level, 3001 pixels, centres up to 10 px off the plane with
    SPECIALS in the first rows; and odd widths down to 4 in bf16, 1001 pixels
    (not a multiple of the kernel's 16-pixel group), at `edge_centres`."""
    cases = []
    for hws, dtype in ((((41, 57), (20, 28), (10, 14), (5, 7)), torch.float32),
                       (((6, 9), (3, 4), (1, 2), (0, 1)), torch.bfloat16)):
        n = 3001
        h0, w0 = hws[0]
        c = torch.stack([torch.rand(n, generator=gen, device="cuda") * (w0 + 20) - 10,
                         torch.rand(n, generator=gen, device="cuda") * (h0 + 20) - 10],
                        dim=1)
        c[:len(SPECIALS)] = torch.tensor(SPECIALS, device="cuda")
        cases.append((n, hws, dtype, c))
    hws = ((23, 37), (11, 18), (5, 9), (2, 4))
    cases.append((1001, hws, torch.bfloat16, edge_centres(1001, hws[0]).cuda()))
    return [(f"[{n}] {str(dtype)[6:]}, levels " + " ".join(f"{h}x{w}" for h, w in hws),
             [(torch.randn((n, h, w), generator=gen, device="cuda")).to(dtype)
              for h, w in hws], c) for n, hws, dtype, c in cases]


def touched_bytes(pyr, coords) -> tuple[int, int]:
    """(32-byte sectors, bytes) that a lookup must move: the sectors of the
    in-plane patch rows its windows touch (each read once), its coords and
    its output."""
    n = coords.shape[0]
    sectors = 0
    for level, v in enumerate(pyr):
        h, w = v.shape[1:]
        x0, y0, _, _ = rl.clamped_centres(coords / 2 ** level, (h, w), rl.RADIUS)
        xs, xe = (x0 - 4).clamp(0, w), (x0 + 6).clamp(0, w)
        ys = y0[:, None] - 4 + torch.arange(10, device=coords.device)
        row = torch.arange(n, device=coords.device)[:, None] * (h * w) + ys * w
        es = v.element_size()
        first = (row + xs[:, None]) * es // 32
        last = ((row + xe[:, None]) * es - 1) // 32
        live = (ys >= 0) & (ys < h) & (xe > xs)[:, None]
        sectors += int(torch.where(live, last - first + 1, 0).sum())
    out_bytes = n * len(pyr) * 81 * pyr[0].element_size()
    return sectors, 32 * sectors + out_bytes + coords.numel() * 4


def grid_sample_lookup(pyr, coords):
    """A callable that computes the same windows with one F.grid_sample per
    level, in the reference's form (corr.py:30-43: align_corners=True, zero
    padding, x on the slow window axis); its grid takes the volume's dtype,
    so in bf16 it is not the same numerics. The yardstick of K5's time."""
    d = torch.arange(-4, 5, dtype=torch.float32, device=coords.device)
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
    return lambda: [F.grid_sample(v[:, None], g, align_corners=True)
                    for v, g in zip(pyr, grids)]


def equal_case(label, pyr, coords) -> bool:
    """Prints one case of the kernel against its plain version; True if the
    two are equal value for value and far or non-finite centres gave zeros."""
    out = rl.window_lookup(pyr, coords)
    ref = rl.window_lookup_ref(pyr, coords)
    far = ~torch.isfinite(coords).all(1) | (coords.abs() > 1e5).any(1)
    ok = torch.equal(out, ref) and bool((out[far] == 0).all())
    print(f"{label}: max |kernel - plain| "
          f"{float((out.float() - ref.float()).abs().max()):.3e} "
          f"{'equal' if ok else 'FAIL'}", flush=True)
    return ok


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("check_lookup: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"prisma_tpu_torch from {raft.__file__.rsplit('/models/', 1)[0]}")
    t0 = time.perf_counter()
    path = build.build_all(["raft_lookup"])["raft_lookup"]
    print(f"built raft_lookup.cu in {time.perf_counter() - t0:.1f} s; ptxas: "
          + " | ".join(line.strip() for line in open(path + ".log")
                       if "registers" in line or "spill" in line))
    gen = torch.Generator(device="cuda").manual_seed(0)
    pyr, coords = main_case(gen)
    n = coords.shape[0]
    failed = not equal_case(f"N = {n}, four bf16 levels", pyr, coords)
    for label, rag, c in ragged_cases(gen):
        failed |= not equal_case(label, rag, c)
    torch.cuda.synchronize()
    if failed:
        sys.exit("check_lookup: a case FAILED")
    rounds = [cuda_ms(lambda: rl.window_lookup(pyr, coords), 20) for _ in range(3)]
    plain = cuda_ms(lambda: rl.window_lookup_ref(pyr, coords), 3)
    library = cuda_ms(grid_sample_lookup(pyr, coords), 5)
    sectors, nbytes = touched_bytes(pyr, coords)
    bound = 1e3 * nbytes / HBM_BYTES_S
    print(f"K5 at N = {n}, four bf16 levels, ms by round: "
          + ", ".join(f"{ms:.4f}" for ms in rounds)
          + f" ({nbytes / (min(rounds) * 1e-3) / 1e12:.2f} TB/s of the bytes the "
          f"windows touch; {100 * bound / min(rounds):.1f}% of the bound); plain "
          f"{plain:.3f} ms; F.grid_sample x4 (bf16 grid) {library:.3f} ms; bound "
          f"{bound:.4f} ms (bytes: {sectors} 32-byte sectors, {nbytes / 1e9:.3f} GB "
          f"with the output and coords); {card}", flush=True)


if __name__ == "__main__":
    main()
