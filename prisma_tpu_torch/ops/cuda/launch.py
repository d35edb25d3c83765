"""The host side of a launch, shared by every ctypes-bound kernel wrapper.

Each wrapper in `ops/cuda/` checks its tensors, allocates its outputs and
calls `launch(name, fn, device, *args)`, which calls the C entry point
`fn(*args, stream)` on the current stream of the tensors' device. At the
probe kernels' sizes the device work is a few microseconds, so this path sets
their pace; it costs little:

- the stream is the raw handle of the device's current stream (PyTorch's own
  `_cuda_getCurrentRawStream`, as its generated kernels use), not a
  `torch.cuda.Stream` object built per call; it follows `torch.cuda.stream`;
- the device is entered only when it is not the current one already;
- the C entry's argument types are set once, when its library is loaded
  (`entry`), so a call converts plain ints and floats.

A C entry returns the `cudaError_t` of its launch (0 on success); a refused
launch raises here.
"""

from __future__ import annotations

import ctypes

import torch

from prisma_tpu_torch.ops.cuda import build


def _cuda_state():
    """(current device index, raw handle of a device's current stream):
    PyTorch's direct calls, which its CUDA builds have (a CPU build never
    gets here: it has no CUDA tensor to launch on)."""
    return torch._C._cuda_getDevice, torch._C._cuda_getCurrentRawStream


def entry(library: str, symbol: str, argtypes: list):
    """The C entry `symbol` of csrc/<library>.cu, built and loaded at first
    use, with its argument types set (a pointer is ctypes.c_void_p, an int
    ctypes.c_int, a float ctypes.c_float; the stream, last, is added here)
    and its result, a cudaError_t, as an int."""
    fn = getattr(build.load(library), symbol)
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(name: str, fn, device: int, *args) -> None:
    """fn(*args, stream) on the current stream of CUDA device `device` (an
    index, as `tensor.get_device()` gives it); raises RuntimeError if the C
    entry reports a CUDA error."""
    current, stream = _cuda_state()
    if device == current():
        err = fn(*args, stream(device))
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream(device))
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
