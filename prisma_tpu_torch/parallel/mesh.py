"""Data-parallel over the visible cards (counterpart of
prisma_tpu/parallel/mesh.py).

The JAX package shards the leading batch axis (frames, PatchFusion tiles,
Marigold members) over a 1-D `data` mesh and replicates the parameters. The
port does the same with explicit devices, no process group and no NCCL: a
replica of the module on each device, the batch split along its leading
axis (edge-padded where a ragged batch must split evenly), each replica's
chunk queued on its own device from the caller's thread, one device after
the other, and the results gathered back once all are queued. Every caller
takes an explicit `devices=` list, and `data_devices` lists the visible
cards as `data_mesh_or_none` does. The bands and the CLI pass none and run
on one card (PERF.md, "Several cards", has the split's times).
"""

from __future__ import annotations

import contextlib
import copy
import weakref
from typing import Callable, Sequence

import torch

# module -> {device: its replica there}; a replica lives as long as its module
_replicas: "weakref.WeakKeyDictionary[torch.nn.Module, dict]" = \
    weakref.WeakKeyDictionary()


def _canonical(device) -> torch.device:
    """The device with its index: `cuda` alone names the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def data_devices(device) -> list[torch.device] | None:
    """Every visible card when `device` is `cuda` with no index and more than
    one card is visible (`data_mesh_or_none`'s rule); otherwise None, and the
    work stays on one device. `cuda:N` pins one card."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return None
    n = torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(n)] if n > 1 else None


def replicate(module: torch.nn.Module,
              devices: Sequence) -> list[torch.nn.Module]:
    """The module on each device: the module itself on the device it lives
    on, elsewhere a copy made at the first call and kept while the module
    lives (the copies share no storage with it; inference only)."""
    home = _canonical(next(module.parameters()).device)
    cache = _replicas.setdefault(module, {})
    out = []
    for device in map(_canonical, devices):
        if device == home:
            out.append(module)
            continue
        if device not in cache:
            cache[device] = copy.deepcopy(module).to(device)
        out.append(cache[device])
    return out


def pad_to_devices(batch: torch.Tensor, n: int) -> torch.Tensor:
    """Pad the leading axis up to a multiple of n by repeating the last
    element (`pad_to_mesh`), so ragged tile and member batches (49 tiles, 10
    members) split evenly; the caller drops the padded tail of the outputs."""
    pad = (-batch.shape[0]) % n
    if not pad:
        return batch
    return torch.cat([batch, batch[-1:].expand(pad, *batch.shape[1:])])


def split_batch_padded(batch: torch.Tensor, devices: Sequence):
    """Edge-pad the leading axis to a multiple of len(devices) and split it
    into one equal chunk a device, each moved there (`shard_batch_padded`).
    -> (chunks, original length): outputs past the original length are
    duplicates of the last element and must be dropped."""
    orig = batch.shape[0]
    chunks = pad_to_devices(batch, len(devices)).chunk(len(devices))
    return [c.to(d) for c, d in zip(chunks, devices)], orig


def gather(outputs: Sequence[torch.Tensor], length: int | None = None,
           device=None) -> torch.Tensor:
    """The replicas' outputs concatenated on `device` (default: the first
    output's), cut to `length` along the leading axis."""
    device = outputs[0].device if device is None else device
    out = torch.cat([o.to(device) for o in outputs])
    return out if length is None else out[:length]


def run_replicas(fn: Callable, devices: Sequence, args: Sequence[tuple]) -> list:
    """fn(*args[i]) with device i current, one device after the other from
    the caller's thread -> their results in device order. fn should queue
    its work and return device tensors without waiting for them: each card
    then computes while the next is launched, and the caller waits only when
    it moves the results (a host thread a replica was slower still on the
    H100s: PERF.md, "Several cards")."""
    out = []
    for device, a in zip(devices, args):
        device = torch.device(device)
        with (torch.cuda.device(device) if device.type == "cuda"
              else contextlib.nullcontext()):
            out.append(fn(*a))
    return out
