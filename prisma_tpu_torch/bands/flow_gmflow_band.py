"""flow_gmflow band driver (counterpart of prisma_tpu/bands/flow_gmflow_band.py;
reference `bands/flow_gmflow.py`): GMFlow at 0.75 scale, /16 padding, swin
transformer + global matching, bidirectional; see bands/flow_base.py for the
shared output contract. --num_scales 2 runs gmflow_with_refine (a 1/4-scale
refinement with local matching, /32 padding, a convex x4 upsample).

The reference only computes backward flow when masks or backwards are asked
for (flow_gmflow.py:88); here forward and backward always ride one doubled
batch, as in the JAX package, and the outputs are unchanged.
"""

from __future__ import annotations

import functools

from prisma_tpu_torch.bands.base import BandIO
from prisma_tpu_torch.bands.flow_base import run_flow_band
from prisma_tpu_torch.models import gmflow as gm
from prisma_tpu_torch.runtime.config import RuntimeConfig
from prisma_tpu_torch.weights.store import load_gmflow

BAND = "flow_gmflow"


def build_pairs(runtime: RuntimeConfig, inference_size=None,
                cfg: gm.GMFlowConfig | None = None):
    """-> (lazy_model, infer_pairs).

    inference_size: optional (h, w): resize the inputs to that size for
    inference instead of padding to /16, then resize and rescale the flow
    back (reference flow_gmflow.py --inference_size). cfg selects the model
    (gm.refine_config() for the 2-scale gmflow_with_refine)."""
    cfg = cfg or gm.GMFlowConfig()
    model = functools.partial(load_gmflow, runtime, cfg)  # after resolve
    infer = gm.infer_pairs
    if inference_size is not None:
        infer = functools.partial(infer, inference_size=tuple(inference_size))
    return model, infer


def run(input_path: str, output: str = "", subpath: str = "",
        backwards: bool = False, mask: bool = False, subpath_mask: str = "",
        scale: float = 0.75, inference_size=None,
        cfg: gm.GMFlowConfig | None = None,
        runtime: RuntimeConfig | None = None) -> BandIO:
    """inference_size / cfg: see build_pairs."""
    runtime = runtime or RuntimeConfig()
    model, infer = build_pairs(runtime, inference_size=inference_size, cfg=cfg)
    return run_flow_band(BAND, input_path, model, infer,
                         output=output, subpath=subpath, backwards=backwards,
                         mask=mask, subpath_mask=subpath_mask, scale=scale,
                         runtime=runtime)


def main(argv=None):
    """Standalone band CLI (reference bands/flow_gmflow.py flag surface)."""
    from prisma_tpu_torch.bands.cli import band_parser, run_guarded, \
        runtime_from_args

    parser = band_parser(BAND)
    parser.add_argument("--backwards", "-b", action="store_true")
    parser.add_argument("--mask", action="store_true",
                        help="compute consistency-mask videos as well")
    parser.add_argument("--subpath_mask", type=str, default="",
                        help="folder for 16-bit packed flow+validity PNGs")
    parser.add_argument("--scale", type=float, default=0.75)
    parser.add_argument("--inference_size", type=int, nargs="+", default=None,
                        help="(h, w) inference resize instead of /16 padding")
    parser.add_argument("--num_scales", type=int, default=1,
                        help="1 = basic gmflow (1/8 feature); 2 = refinement "
                             "with the additional 1/4 feature (reference "
                             "flow_gmflow.py:237)")
    parser.add_argument("--upsample_factor", type=int, default=None)
    parser.add_argument("--attn_splits_list", type=int, nargs="+",
                        default=None)
    parser.add_argument("--corr_radius_list", type=int, nargs="+",
                        default=None, help="-1 = global matching")
    parser.add_argument("--prop_radius_list", type=int, nargs="+",
                        default=None, help="-1 = global propagation")
    parser.add_argument("--padding_factor", type=int, default=None)
    args = parser.parse_args(argv)
    kw = {}
    if args.num_scales > 1:
        kw = dict(num_scales=2, upsample_factor=4, padding_factor=32)
    for name in ("upsample_factor", "padding_factor"):
        if getattr(args, name) is not None:
            kw[name] = getattr(args, name)
    for name in ("attn_splits_list", "corr_radius_list", "prop_radius_list"):
        if getattr(args, name) is not None:
            kw[name] = tuple(getattr(args, name))
    cfg = gm.GMFlowConfig(**kw) if kw else None
    run_guarded(BAND, run, args.input, output=args.output,
                subpath=args.subpath, backwards=args.backwards,
                mask=args.mask, subpath_mask=args.subpath_mask,
                scale=args.scale, inference_size=args.inference_size,
                cfg=cfg, runtime=runtime_from_args(args))


if __name__ == "__main__":
    main()
