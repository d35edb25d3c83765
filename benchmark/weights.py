"""Seeded random weights, made on the device in a few large calls.

A configuration's reference lists its checkpoint's parameters as (name,
shape, init), init ('normal', std) or ('const', value); one normal draw
fills all of them, a per-element scale and offset give each its init, and
one cast
gives the type they are served in. The state_dict's tensors are views into
that one buffer, so saving it writes the buffer once."""

from __future__ import annotations

import math

import torch


def make_state_dict(specs: list, seed: int, device,
                    dtype: torch.dtype = torch.bfloat16) -> dict:
    sizes = [math.prod(shape) for _, shape, _ in specs]
    scale = [v if kind == "normal" else 0.0 for _, _, (kind, v) in specs]
    offset = [v if kind == "const" else 0.0 for _, _, (kind, v) in specs]
    n = torch.tensor(sizes, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    flat.normal_(generator=gen)
    flat.mul_(torch.repeat_interleave(torch.tensor(scale, device=device), n))
    flat.add_(torch.repeat_interleave(torch.tensor(offset, device=device), n))
    flat = flat.to(dtype)
    sd, at = {}, 0
    for (name, shape, _), size in zip(specs, sizes):
        sd[name] = flat[at:at + size].view(shape)
        at += size
    return sd
