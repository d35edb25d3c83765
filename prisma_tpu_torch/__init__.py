"""prisma_tpu_torch — the PyTorch and CUDA port of prisma_tpu.

A second package beside `prisma_tpu`, held against it module by module. It
imports `torch` and never `jax`; the kernels that `prisma_tpu/ops/pallas/`
wrote for the TPU are hand-written CUDA C++ for Hopper under `csrc/`, built
with nvcc at first use and bound with ctypes (`ops/cuda/`).

Layering mirrors prisma_tpu: bands/ (drivers), models/ (nn.Modules whose
parameter names are the reference checkpoints' keys), ops/ (functional ops,
resizing, encoders; ops/cuda/ kernel wrappers), weights/ (checkpoint loading),
io/ (native codec bindings, writers), runtime/, utils/.
"""

__version__ = "0.1.0"
