"""Kernel families of a device trace: a frozen copy of `kernel_family` in
prisma_tpu_torch/runtime/profile_step.py, so that a later change to the
program does not move the yardstick. It names each device kernel's family
by the symbol each kernel of the port carries, then GEMM, cuDNN and the
copies; everything else is elementwise work."""

from __future__ import annotations

ELEMENTWISE = "elementwise, reductions, device copies"


def kernel_family(name: str) -> str:
    """The family of a device kernel or copy, by its name in the trace."""
    low = name.lower()
    for symbol, family in (("flash_region", "K2 flash attention, region bias"),
                           ("flash_streamed", "K3 streamed global attention"),
                           ("flash_fwd", "K1 flash attention"),
                           ("instance_norm_relu", "K4 instance norm"),
                           ("raft_window_lookup", "K5 RAFT window lookup"),
                           ("lane_gather", "K6a lane gather"),
                           ("minor_transpose", "K6b minor transpose")):
        if symbol in low:
            return family
    if name.startswith("Memcpy"):
        return "host copies (" + name.split()[1] + ")"
    if any(s in low for s in ("fprop", "cudnn", "nhwc", "conv")):
        return "convolution (cuDNN)"
    if any(s in low for s in ("gemm", "nvjet", "cutlass", "magma", "cublas")):
        return "GEMM"
    return ELEMENTWISE
