"""The mask band's epilogue kernels (csrc/mask_epilogue.cu) alone on one CUDA
card: a quick loop for work on them.

    PYTHONPATH=<tree> python <tree or another>/prisma_tpu_torch/runtime/check_mask_epilogue.py

Builds mask_epilogue.cu alone and holds both kernels to their plain versions
(`ops/sdf.kept_composite`, `ops/sdf.sdf_green_device`) on the card with
torch.equal: the SDF on the five cases of the CPU tests, a batch of 8 at
1080p of random discs and rectangles, all false, all true, one pixel in a
corner, H and W off the tile, H and W under CAP; the composite on 1080p
slabs of 100 instance slots (a few kept, none, all), 300 slots (past the
kernel's 255-instance packing), a frame size that is no multiple of 16 and
an unaligned slab (its value-by-value path). Exits non-zero on a failed case,
before anything is timed. Then, on a 1080p batch of 8 with 100 slots and a
few kept a frame, times the kernels, the plain versions and the bound, and
the device memory each path allocates. chip_smoke.py's phases 17-18 hold
and time the real slabs with the helpers here.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from prisma_tpu_torch.ops import sdf
from prisma_tpu_torch.ops.cuda import build
from prisma_tpu_torch.ops.cuda import mask_epilogue as me
from prisma_tpu_torch.runtime.profile_step import cuda_ms

HBM_BYTES_S = 3.35e12  # H100 SXM
FRAME_HW = (1080, 1920)
BATCH, SLOTS = 8, 100  # a mask step's frames; SOLOv2's max_per_img


def small_blobs(rng: np.random.Generator, shape, n: int = 3) -> np.ndarray:
    """A few rectangles (tests/test_torch_solov2.py's `_blobs`)."""
    mask = np.zeros(shape, bool)
    for _ in range(n):
        y, x = rng.integers(0, shape[0] - 8), rng.integers(0, shape[1] - 8)
        h, w = rng.integers(4, 40), rng.integers(4, 40)
        mask[y:y + h, x:x + w] = True
    return mask


def small_sdf_cases() -> list:
    """[(label, mask [H, W] bool on the CPU)]: the five cases of the CPU
    tests' test_sdf_green_device, drawn as they draw them."""
    rng = np.random.default_rng(7)
    make = {"blobs": lambda: small_blobs(rng, (96, 128)),
            "speckle": lambda: rng.random((64, 200)) > 0.95,
            "empty": lambda: np.zeros((48, 48), bool),
            "full": lambda: np.ones((48, 48), bool),
            "far": lambda: np.pad(np.ones((1, 1), bool), ((0, 299), (0, 299)))}
    return [(k, torch.from_numpy(f())) for k, f in make.items()]


def shapes_mask(gen: torch.Generator, n: int, H: int, W: int, device,
                size=(0.02, 0.3)) -> torch.Tensor:
    """[n, H, W] bool: each plane one disc or rectangle of a random size (a
    share `size` of the frame's short side) and place, some reaching past
    the edges."""
    def rand(k=1):
        return torch.rand(k, generator=gen, device=device)

    ys = torch.arange(H, device=device, dtype=torch.float32)[:, None]
    xs = torch.arange(W, device=device, dtype=torch.float32)[None]
    out = torch.empty((n, H, W), dtype=torch.bool, device=device)
    lo, hi = size
    for i in range(n):
        cy, cx = float(rand() * H), float(rand() * W)
        r = float(lo + (hi - lo) * rand()) * min(H, W)
        if float(rand()) < 0.5:
            out[i] = (ys - cy) ** 2 + (xs - cx) ** 2 < r * r
        else:
            out[i] = ((ys - cy).abs() < r) & ((xs - cx).abs() < 0.7 * r)
    return out


def sdf_cases(gen: torch.Generator, device) -> list:
    """[(label, mask [..., H, W] bool on device)]: every case of the SDF."""
    H, W = FRAME_HW
    cases = [(f"{k} {list(m.shape)}", m.to(device)) for k, m in small_sdf_cases()]
    blobs = torch.stack([shapes_mask(gen, 6, H, W, device).any(dim=0)
                         for _ in range(BATCH)])
    corner = torch.zeros((1, H, W), dtype=torch.bool, device=device)
    corner[0, 0, 0] = True
    far_corner = torch.zeros((1, H, W), dtype=torch.bool, device=device)
    far_corner[0, -1, -1] = True
    cases += [(f"random blobs {list(blobs.shape)}", blobs),
              (f"all false [2, {H}, {W}]", torch.zeros((2, H, W), dtype=torch.bool,
                                                      device=device)),
              (f"all true [2, {H}, {W}]", torch.ones((2, H, W), dtype=torch.bool,
                                                    device=device)),
              (f"one pixel in the top-left corner [1, {H}, {W}]", corner),
              (f"one pixel in the bottom-right corner [1, {H}, {W}]", far_corner),
              (f"complement of one corner pixel [1, {H}, {W}]", ~corner)]
    for shape in ((3, 1001, 1283), (2, 77, 203), (2, 40, 500), (2, 300, 50),
                  (3, 5, 7), (1, 1, 1)):
        m = shapes_mask(gen, 4, shape[1], shape[2], device, (0.05, 0.6))
        cases.append((f"off the tile {list(shape)}",
                      torch.stack([m[i % 4] ^ m[(i + 1) % 4] for i in range(shape[0])])))
    return cases


def frame_slabs(gen: torch.Generator, frames: int, slots: int, H: int, W: int,
                device, kept=(2, 6), size=(0.02, 0.3)) -> tuple[list, list]:
    """(masks [slots, H, W] bool a frame, keep [slots] bool a frame): random
    shapes (`shapes_mask`), between kept[0] and kept[1] of them kept (None:
    every slot)."""
    masks, keep = [], []
    for _ in range(frames):
        masks.append(shapes_mask(gen, slots, H, W, device, size))
        k = torch.zeros(slots, dtype=torch.bool, device=device)
        if kept is None:
            k[:] = True
        elif kept[1] > 0:
            n = int(torch.randint(kept[0], kept[1] + 1, (1,), generator=gen,
                                  device=device))
            k[torch.randperm(slots, generator=gen, device=device)[:n]] = True
        keep.append(k)
    return masks, keep


def slab_cases(gen: torch.Generator, device) -> list:
    """[(label, masks, keep)]: every case of the composite."""
    H, W = FRAME_HW
    cases = [(f"{BATCH} x [{SLOTS}, {H}, {W}], 2-6 kept a frame",
              *frame_slabs(gen, BATCH, SLOTS, H, W, device)),
             (f"2 x [{SLOTS}, {H}, {W}], none kept",
              *frame_slabs(gen, 2, SLOTS, H, W, device, kept=(0, 0))),
             (f"2 x [{SLOTS}, {H}, {W}], every slot kept",
              *frame_slabs(gen, 2, SLOTS, H, W, device, kept=None)),
             ("3 x [300, 64, 96], every slot kept, most pixels in over 255",
              *frame_slabs(gen, 3, 300, 64, 96, device, kept=None,
                           size=(0.8, 1.5))),
             ("2 x [10, 37, 51] (37·51 no multiple of 16), every slot kept",
              *frame_slabs(gen, 2, 10, 37, 51, device, kept=None)),
             ("33 x [7, 48, 64] (two launches), 2-6 kept",
              *frame_slabs(gen, 33, 7, 48, 64, device))]
    masks, keep = frame_slabs(gen, 2, 12, 64, 96, device, kept=(4, 8))
    unaligned = []
    for m in masks:  # one byte past an aligned start: the value-by-value path
        flat = torch.empty(m.numel() + 1, dtype=torch.bool, device=device)
        view = flat[1:].view(m.shape)
        view.copy_(m)
        unaligned.append(view)
    cases.append(("2 x [12, 64, 96] at an unaligned start, 4-8 kept", unaligned, keep))
    return cases


def plain(masks: list, keep: list, green: bool = True) -> tuple:
    """The plain versions on the slabs' device: (composite, green)."""
    composite = torch.stack([sdf.kept_composite(m, k) for m, k in zip(masks, keep)])
    return composite, sdf.sdf_green_device(composite != 0.0) if green else None


def held(masks: list, keep: list) -> dict:
    """The kernels against the plain versions on one batch of slabs: whether
    the composite, the marked pixels and the green are equal, launches
    counted."""
    before = (me.kept_composite.launches, me.sdf_green.launches)
    composite, marked = me.kept_composite(masks, keep)
    green = me.sdf_green(marked)
    torch.cuda.synchronize()
    ref_composite, ref_green = plain(masks, keep)
    return {"composite": torch.equal(composite, ref_composite),
            "marked": torch.equal(marked, ref_composite != 0.0),
            "green": torch.equal(green, ref_green),
            "launches": (me.kept_composite.launches - before[0],
                         me.sdf_green.launches - before[1]),
            "kept_share": float((ref_composite != 0).float().mean())}


def epilogue_bytes(masks: list, keep: list) -> dict:
    """Bytes each part must move: the kept instances' mask bytes read once,
    the f32 composite and green written once (and, for each kernel alone,
    the marked bytes it writes or reads)."""
    B, (H, W) = len(masks), masks[0].shape[1:]
    kept = sum(int(k.sum()) for k in keep) * H * W
    px = B * H * W
    return {"epilogue": kept + 8 * px, "composite": kept + 5 * px, "sdf": 5 * px,
            "kept_instances": kept // (H * W)}


def peak_mib(fn) -> float:
    """MiB the device allocator's peak rises by while fn runs."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    del out
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def timed(masks: list, keep: list, iters: int = 20, plain_iters: int = 3) -> dict:
    """Device ms of the kernels (composite, SDF, both) and of the plain
    versions (both in turns: kernels, plain, plain, kernels), the bounds at
    3.35 TB/s and the memory each path allocates."""
    composite, marked = me.kept_composite(masks, keep)
    kernels = lambda: me.sdf_green(me.kept_composite(masks, keep)[1])  # noqa: E731
    plain_both = lambda: plain(masks, keep)  # noqa: E731
    rounds = {"kernels": [], "plain": []}
    for key in ("kernels", "plain", "plain", "kernels"):
        rounds[key].append(cuda_ms(kernels if key == "kernels" else plain_both,
                                   iters if key == "kernels" else plain_iters))
    nb = epilogue_bytes(masks, keep)
    return dict(
        kernels_ms=sum(rounds["kernels"]) / 2, kernels_rounds=rounds["kernels"],
        plain_ms=sum(rounds["plain"]) / 2, plain_rounds=rounds["plain"],
        composite_ms=cuda_ms(lambda: me.kept_composite(masks, keep), iters),
        sdf_ms=cuda_ms(lambda: me.sdf_green(marked), iters),
        plain_composite_ms=cuda_ms(lambda: plain(masks, keep, green=False),
                                   plain_iters),
        plain_sdf_ms=cuda_ms(lambda: sdf.sdf_green_device(composite != 0.0),
                             plain_iters),
        bound_ms=1e3 * nb["epilogue"] / HBM_BYTES_S,
        composite_bound_ms=1e3 * nb["composite"] / HBM_BYTES_S,
        sdf_bound_ms=1e3 * nb["sdf"] / HBM_BYTES_S, bound_by="bytes",
        bytes=nb["epilogue"], kept_instances=nb["kept_instances"],
        kernels_alloc_mib=peak_mib(kernels), plain_alloc_mib=peak_mib(plain_both))


def describe(label: str, t: dict) -> str:
    """One line of an at-scale case's numbers."""
    return (f"{label}: kernels {t['kernels_ms']:.4f} ms (rounds "
            + ", ".join(f"{v:.4f}" for v in t["kernels_rounds"])
            + f"; composite {t['composite_ms']:.4f}, SDF {t['sdf_ms']:.4f}), "
            f"{t['bound_ms'] / t['kernels_ms']:.1%} of the bound {t['bound_ms']:.4f} ms "
            f"({t['bytes'] / 1e6:.1f} MB: {t['kept_instances']} kept instances' masks, "
            f"the f32 composite and green; each kernel alone: composite "
            f"{t['composite_bound_ms']:.4f}, SDF {t['sdf_bound_ms']:.4f} ms with the "
            f"marked bytes); plain {t['plain_ms']:.3f} ms (rounds "
            + ", ".join(f"{v:.3f}" for v in t["plain_rounds"])
            + f"; composite {t['plain_composite_ms']:.3f}, SDF {t['plain_sdf_ms']:.3f}); "
            f"allocated {t['kernels_alloc_mib']:.1f} MiB (plain "
            f"{t['plain_alloc_mib']:.1f} MiB)")


def check_all(device) -> list:
    """Every case held; -> the labels of the failed ones (each printed)."""
    gen = torch.Generator(device=device).manual_seed(0)
    failed = []
    for label, mask in sdf_cases(gen, device):
        before = me.sdf_green.launches
        ok = torch.equal(me.sdf_green(mask), sdf.sdf_green_device(mask)) \
            and me.sdf_green.launches == before + 1
        print(f"sdf {label}: {'equal' if ok else 'FAILED'}", flush=True)
        if not ok:
            failed.append(label)
    for label, masks, keep in slab_cases(gen, device):
        h = held(masks, keep)
        ok = h["composite"] and h["marked"] and h["green"] \
            and h["launches"] == (-(-len(masks) // me.MAX_FRAMES), 1)
        print(f"composite {label}: {h} {'equal' if ok else 'FAILED'}", flush=True)
        if not ok:
            failed.append(label)
    return failed


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("check_mask_epilogue: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"prisma_tpu_torch from {me.__file__.rsplit('/ops/', 1)[0]}")
    t0 = time.perf_counter()
    path = build.build_all(["mask_epilogue"])["mask_epilogue"]
    print(f"built mask_epilogue.cu in {time.perf_counter() - t0:.1f} s; ptxas: "
          + " | ".join(line.strip() for line in open(path + ".log")
                       if "registers" in line or "spill" in line or "entry" in line))
    failed = check_all("cuda")
    if failed:
        sys.exit(f"check_mask_epilogue: FAILED {failed}")
    gen = torch.Generator(device="cuda").manual_seed(1)
    masks, keep = frame_slabs(gen, BATCH, SLOTS, *FRAME_HW, "cuda")
    t = timed(masks, keep)
    label = f"{BATCH} x [{SLOTS}, {FRAME_HW[0]}, {FRAME_HW[1]}], 2-6 kept a frame"
    print(describe(label, t) + f"; {card}", flush=True)
    print(json.dumps({"mask_epilogue": t, "card": card}))


if __name__ == "__main__":
    main()
