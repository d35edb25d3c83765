"""The band steps' host copies: a host batch to the step's device, and the
step's outputs back to host numpy.

The route follows the device. On a CUDA card both directions go through
pinned blocks of torch's caching host allocator, so each copy is one DMA at
the host link's rate (a pageable copy is staged by CUDA through a bounce
buffer of its own, at a fraction of it), and the step waits once, at its
end. Elsewhere they are `.to(device)` and `.cpu().numpy()`.

- `to_device` copies the batch into a pinned block and issues its DMA
  without waiting. The block is dropped at once: the allocator keeps it
  from reuse until the copy recorded on it is done.
- `to_host` gives each output a pinned block of its own, issues every DMA
  without waiting, and waits once on the outputs' device's current stream.
  Each returned array owns its block; dropping the array returns the block
  to the allocator's cache, with no unmap, and no page faults when it is
  used again. No ring of buffers is kept: callers hold outputs past the
  next step (the sinks' writer threads, a benchmark's sample), and a reused
  buffer would rewrite what they hold.

The allocator keeps its blocks, each a power of two in size, for the life
of the process: its pinned bytes rise to the most that the outputs held at
once ever needed, and stay there.

COPIES and BYTES count the tensors copied and their bytes by route and
direction ("pinned H2D", "pinned D2H", "pageable H2D", "pageable D2H");
`runtime.profiling.StageProfiler.report` prints them, with the allocator's
pinned bytes on a card.
"""

from __future__ import annotations

from collections import Counter

import torch

COPIES: Counter = Counter()
BYTES: Counter = Counter()


def _count(route: str, t: torch.Tensor) -> None:
    COPIES[route] += 1
    BYTES[route] += t.numel() * t.element_size()


def to_device(frames, device) -> torch.Tensor:
    """A host batch [N, ...] (an array or a tensor) -> the same values on
    device (without a wait on a card)."""
    x = torch.as_tensor(frames)
    device = torch.device(device)
    if device.type != "cuda":
        _count("pageable H2D", x)
        return x.to(device)
    _count("pinned H2D", x)
    return x.pin_memory().to(device, non_blocking=True)


def to_host(tensors: dict) -> dict:
    """{key: tensor}, all on one device -> {key: numpy array} of the same
    values, dtypes and shapes, every copy done."""
    host, device = {}, None
    for k, v in tensors.items():
        if v.device.type == "cuda":
            host[k] = torch.empty_like(v, device="cpu", pin_memory=True)
            host[k].copy_(v, non_blocking=True)
            device = v.device
            _count("pinned D2H", v)
        else:
            host[k] = v.cpu()
            _count("pageable D2H", v)
    if device is not None:
        torch.cuda.current_stream(device).synchronize()
    return {k: h.numpy() for k, h in host.items()}


def summary() -> str:
    """COPIES and BYTES on one line, with the pinned share of the copies
    and, on a card, the pinned bytes that the caching host allocator holds
    now and at most (both rounded up to its blocks' powers of two)."""
    n = sum(COPIES.values())
    pinned = COPIES["pinned H2D"] + COPIES["pinned D2H"]
    share = f"{pinned / n * 100:.1f}%" if n else "-"
    line = (", ".join(f"{k} x{c} ({BYTES[k] / 1e6:.1f} MB)"
                      for k, c in sorted(COPIES.items()) if c)
            + f"; pinned {share} of the copies")
    stats = torch.cuda.host_memory_stats() if torch.cuda.is_available() \
        else {}
    if "allocated_bytes.current" in stats:
        line += (f"; pinned host blocks "
                 f"{stats['allocated_bytes.current'] / 1e6:.1f} MB held, "
                 f"peak {stats['allocated_bytes.peak'] / 1e6:.1f} MB")
    return line
