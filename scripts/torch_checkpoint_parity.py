"""Read the port's parity with the JAX package on checkpoint files in the
real layouts, filled with random weights, on the CPU.

    JAX_PLATFORMS=cpu python scripts/torch_checkpoint_parity.py [--out DIR]

It writes raft-sintel.pth, both GMFlow files, depth_anything_vits14.pt,
the SOLOv2 file and midas_v21_384.pt (the port's seeded random models plus
N(0, 0.01) noise, ~1 GB together) into DIR (a temporary directory by
default), then runs those cases of tests/test_torch_checkpoint_fidelity.py
against them and prints, for every comparison, the max |port - JAX|, the
output's scale and their ratio beside the limit the test holds.
"""

import argparse
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")


def write_files(out: str) -> None:
    import torch

    from prisma_tpu_torch.models import gmflow as gm
    from prisma_tpu_torch.runtime.config import RuntimeConfig
    from prisma_tpu_torch.weights import store

    rt = RuntimeConfig(random_weights=True, device="cpu",
                       compute_dtype="float32")

    def noisy(sd):
        g = torch.Generator().manual_seed(7)
        return {k: v + 0.01 * torch.randn(v.shape, generator=g)
                if v.is_floating_point() else v for k, v in sd.items()}

    def save(obj, name):
        torch.save(obj, os.path.join(out, name))

    save({"module." + k: v for k, v in noisy(store.load_raft(rt).state_dict())
          .items()}, "raft-sintel.pth")
    save({"model": noisy(store.load_gmflow(rt).state_dict())},
         "gmflow_sintel-0c07dcb3.pth")
    save({"model": noisy(store.load_gmflow(rt, gm.refine_config())
                         .state_dict())},
         "gmflow_with_refine_sintel-3ed1cf48.pth")
    save(noisy(store.load_depth_anything(rt, encoder="vits")[1].state_dict()),
         "depth_anything_vits14.pt")
    save({"state_dict": noisy(store.load_solov2(rt).state_dict())},
         "solov2_r101_fpn_3x_coco_x.pth")
    save(noisy(store.load_midas(rt, "midas2")[1].state_dict()),
         "midas_v21_384.pt")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default="")
    out = parser.parse_args().out or tempfile.mkdtemp(prefix="prisma_parity_")
    os.makedirs(out, exist_ok=True)
    write_files(out)

    import jax
    jax.config.update("jax_platforms", "cpu")
    from tests import test_torch_checkpoint_fidelity as fid

    fid.MODELS_DIR = out
    held = fid._close
    case = [""]

    def measured(ours, theirs, rel=0.0, atol=0.0):
        o = ours.detach().float().numpy() if hasattr(ours, "detach") \
            else np.asarray(ours)
        t = np.asarray(theirs, np.float32)
        err, scale = float(np.abs(o - t).max()), float(np.abs(t).max())
        print(f"{case[0]}: max |port - JAX| {err:.3e}, scale {scale:.3e}, "
              f"ratio {err / scale:.3e}; limit {atol:g} + {rel:g} x scale",
              flush=True)
        held(ours, theirs, rel=rel, atol=atol)

    fid._close = measured
    cases = [
        ("depth_anything vits",
         lambda: fid.test_depth_anything_checkpoint("vits")),
        ("raft", fid.test_raft_checkpoint),
        ("gmflow", lambda: fid.test_gmflow_checkpoint(
            "gmflow_sintel-0c07dcb3.pth", 1)),
        ("gmflow_with_refine", lambda: fid.test_gmflow_checkpoint(
            "gmflow_with_refine_sintel-3ed1cf48.pth", 2)),
        ("solov2", fid.test_solov2_checkpoint),
        ("midas v2.1", lambda: fid.test_midas_checkpoint("midas_v21_384.pt",
                                                        "midas2"))]
    failed = 0
    for case[0], run in cases:
        try:
            run()
            print(f"{case[0]}: within the limits", flush=True)
        except AssertionError as e:
            failed += 1
            print(f"{case[0]}: FAILED {str(e)[:400]}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
