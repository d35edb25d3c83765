"""Host time per call of the port's kernel wrappers, on one CUDA card.

    PYTHONPATH=<tree> python <tree or another>/prisma_tpu_torch/runtime/launch_cost.py

`host_us` (host microseconds per call over 1000 calls with no sync between
them: what the host spends to enqueue one launch) and `empty_launch` (an
empty kernel through the shared launch path, `ops/cuda/launch.py`) are the
yardsticks that chip_smoke.py's phase 14 prints beside the probe kernels.

Run as a script, it times K6a (lane gather, [5760, 102] f32), K6b (minor
transpose, [8, 180, 16] f32), K4 (instance norm, [1, 8, 16, 16] f32) and K1
(flash attention, [1, 128, 64] bf16) that way and back to back under CUDA
events, beside torch.gather's and the transpose's host time; then, where the
tree has the shared launch path, where the host time of one lane_gather call
goes: each step of its wrapper timed alone. It imports whichever
prisma_tpu_torch comes first on the path, so the same script measures two
trees (before and after a change to the launch path) in one run.
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
import time

import torch


def host_us(fn, calls: int = 1000) -> float:
    """Host microseconds per call of fn over `calls` calls with no sync
    between them (the enqueue, not the device work), after a warm-up."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / calls / 1e3


@functools.cache
def _empty_entry():
    """The C entry of csrc/probe_gather.cu's empty kernel."""
    from prisma_tpu_torch.ops.cuda import launch
    return launch.entry("probe_gather", "prisma_empty", [])


def empty_launch(device: int) -> None:
    """An empty kernel through the shared launch path on CUDA device
    `device`: the floor that a small kernel's time stands on. Not a kernel of
    any path, and not counted."""
    from prisma_tpu_torch.ops.cuda import launch
    launch.launch("empty", _empty_entry(), device)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("launch_cost: needs a CUDA card")
    import importlib.util

    import prisma_tpu_torch
    from prisma_tpu_torch.ops.cuda import build
    from prisma_tpu_torch.ops.cuda import flash_attention as fa
    from prisma_tpu_torch.ops.cuda import instance_norm as inorm
    from prisma_tpu_torch.ops.cuda import probe_gather as pg
    from prisma_tpu_torch.runtime.profile_step import cuda_ms

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}; tree {prisma_tpu_torch.__file__}")
    shared_path = importlib.util.find_spec("prisma_tpu_torch.ops.cuda.launch") is not None
    build.build_all(["probe_gather", "instance_norm", "flash_attention"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((5760, 102), generator=gen, device="cuda")
    off = torch.randint(0, 92, (5760,), generator=gen, device="cuda",
                        dtype=torch.int32)
    xt = torch.rand((8, 180, 16), generator=gen, device="cuda")
    xn = torch.rand((1, 8, 16, 16), generator=gen, device="cuda")
    q = torch.randn((1, 128, 64), generator=gen, device="cuda").to(torch.bfloat16)
    calls = {"K6a lane_gather [5760, 102] f32": lambda: pg.lane_gather(x, off, 10),
             "K6b minor_transpose [8, 180, 16] f32": lambda: pg.minor_transpose(xt),
             "K4 instance_norm_relu [1, 8, 16, 16] f32": lambda: inorm.instance_norm_relu(xn),
             "K1 flash_attention [1, 128, 64] bf16": lambda: fa.flash_attention(q, q, q)}
    if shared_path:
        calls["empty kernel"] = lambda: empty_launch(x.get_device())
    li = torch.arange(102, device="cuda").clamp_max(9)
    idx = (off.long()[:, None] + li).clamp(0, 101)
    calls["torch.gather [5760, 102] f32"] = lambda: torch.gather(x, 1, idx)
    calls[".transpose(1, 2).contiguous() [8, 180, 16] f32"] = \
        lambda: xt.transpose(1, 2).contiguous()
    for label, fn in calls.items():
        print(f"{label}: host {host_us(fn):.2f} us a call (no sync), "
              f"{cuda_ms(fn, 50):.4f} ms a call back to back", flush=True)
    if shared_path:
        breakdown(x, off)


def breakdown(x: torch.Tensor, off: torch.Tensor) -> None:
    """Host microseconds of each step of one lane_gather call, alone."""
    from prisma_tpu_torch.ops.cuda import build, launch
    from prisma_tpu_torch.ops.cuda import probe_gather as pg

    current, stream = launch._cuda_state()
    gather = pg._entries()[0]
    empty = _empty_entry()
    # the same C entry with its pointers typed as 64-bit ints: ctypes' own cost
    # per converted argument
    gather_u64 = build.load("probe_gather")["prisma_lane_gather"]
    gather_u64.argtypes = [ctypes.c_uint64] * 3 + [ctypes.c_longlong] + \
        [ctypes.c_int] * 3 + [ctypes.c_uint64]
    gather_u64.restype = ctypes.c_int
    device = x.get_device()
    o = torch.empty_like(x)
    ptrs = (x.data_ptr(), off.data_ptr(), o.data_ptr())
    steps = {
        "x.is_cuda": lambda: x.is_cuda,
        "dtype code": lambda: pg._DTYPE_CODES.get(x.dtype),
        "x.shape": lambda: x.shape,
        "x.get_device()": lambda: x.get_device(),
        "x.is_contiguous()": lambda: x.is_contiguous(),
        "x.numel()": lambda: x.numel(),
        "off.shape != x.shape[:1]": lambda: off.shape != x.shape[:1],
        "torch.empty_like(x)": lambda: torch.empty_like(x),
        "x.new_empty(shape)": lambda: x.new_empty((5760, 102)),
        "x.data_ptr()": lambda: x.data_ptr(),
        "current device": current,
        "raw current stream": lambda: stream(device),
        "C entry, empty kernel": lambda: empty(stream(device)),
        "C entry, lane gather kernel": lambda: gather(*ptrs, 5760, 102, 10, 0, stream(device)),
        "the same, pointers as c_uint64": lambda: gather_u64(*ptrs, 5760, 102, 10, 0,
                                                             stream(device)),
        "launch.launch, lane gather": lambda: launch.launch("g", gather, device, *ptrs,
                                                            5760, 102, 10, 0),
        "the whole wrapper": lambda: pg.lane_gather(x, off, 10),
    }
    print("lane_gather's host time, step by step (us a call, 1000 calls):")
    for label, fn in steps.items():
        print(f"  {label:<30} {host_us(fn):7.2f}", flush=True)


if __name__ == "__main__":
    main()
