"""The flow_raft band (counterpart of prisma_tpu/bands/flow_raft_band.py;
reference `bands/flow_raft.py`): RAFT at 0.75 scale, padded to /8, 20 GRU
iterations, forward and backward flow in one doubled batch; see
bands/flow_base.py for the shared output contract.

`--corr_impl fused` takes the O(HW)-memory lookup, for inputs whose
correlation volume does not fit the card; the JAX band's other choices are
TPU formulations of one volume lookup, which the port runs as K5.
"""

from __future__ import annotations

import functools
import os

from prisma_tpu_torch.bands.base import BandIO
from prisma_tpu_torch.bands.flow_base import run_flow_band
from prisma_tpu_torch.models import raft
from prisma_tpu_torch.runtime.config import RuntimeConfig
from prisma_tpu_torch.weights.store import load_raft

BAND = "flow_raft"
ITERATIONS = 20


def build_pairs(runtime: RuntimeConfig, iterations: int = ITERATIONS,
                corr_impl: str = "volume_onehot"):
    """-> (lazy_model, infer_pairs). corr_impl: one of raft.CORR_IMPLS;
    "fused" is the O(HW)-memory lookup, every other name the volume and K5."""
    model = functools.partial(load_raft, runtime)  # loaded after resolve
    infer = functools.partial(raft.infer_pairs, iters=iterations,
                              corr_impl=corr_impl)
    return model, infer


def run(input_path: str, output: str = "", subpath: str = "",
        backwards: bool = False, mask: bool = False, subpath_mask: str = "",
        iterations: int = ITERATIONS, scale: float = 0.75,
        corr_impl: str = "volume_onehot",
        runtime: RuntimeConfig | None = None) -> BandIO:
    """corr_impl: see build_pairs."""
    runtime = runtime or RuntimeConfig()
    model, infer = build_pairs(runtime, iterations=iterations,
                               corr_impl=corr_impl)
    return run_flow_band(BAND, input_path, model, infer, output=output,
                         subpath=subpath, backwards=backwards, mask=mask,
                         subpath_mask=subpath_mask, scale=scale,
                         runtime=runtime)


def main(argv=None):
    """Standalone band CLI (reference bands/flow_raft.py flag surface)."""
    from prisma_tpu_torch.bands.cli import band_parser, run_guarded, \
        runtime_from_args

    parser = band_parser(BAND)
    parser.add_argument("--backwards", "-b", action="store_true")
    parser.add_argument("--mask", action="store_true",
                        help="compute consistency-mask videos as well")
    parser.add_argument("--subpath_mask", type=str, default="",
                        help="folder for 16-bit packed flow+validity PNGs")
    parser.add_argument("--iterations", type=int, default=ITERATIONS)
    parser.add_argument("--scale", type=float, default=0.75)
    parser.add_argument("--corr_impl", type=str,
                        default=os.environ.get("PRISMA_RAFT_CORR",
                                               "volume_onehot"),
                        choices=list(raft.CORR_IMPLS),
                        help="fused: the O(HW)-memory lookup; the others: "
                             "the correlation volume (see build_pairs)")
    args = parser.parse_args(argv)
    run_guarded(BAND, run, args.input, output=args.output,
                subpath=args.subpath, backwards=args.backwards,
                mask=args.mask, subpath_mask=args.subpath_mask,
                iterations=args.iterations, scale=args.scale,
                corr_impl=args.corr_impl, runtime=runtime_from_args(args))


if __name__ == "__main__":
    main()
