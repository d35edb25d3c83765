"""Orchestrator: image/video -> PRISMA band folder, on one CUDA card
(counterpart of prisma_tpu/cli/process.py).

    python -m prisma_tpu_torch.cli.process -i clip.mp4 [--random_weights]
        [--device cpu]

Flag-compatible with the reference `process.py` (process.py:76-98) and the
JAX package's, plus --device; bands run in-process instead of one subprocess
per band (process.py:60-73), by default on the card. The folder layout and
metadata.json are the JAX package's. A band the port lacks
(bands/base.BAND_MODULES) raises before any work.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

# Band tables (reference process.py:17-43)
DEPTH_VIDEO_DEFAULT = "depth_anything"
DEPTH_IMAGE_DEFAULT = "depth_patchfusion"
DEPTH_BANDS = ["depth_midas", "depth_marigold", "depth_zoedepth",
               "depth_patchfusion", "depth_anything"]
FLOW_DEFAULT = "flow_gmflow"
FLOW_BANDS = ["flow_gmflow", "flow_raft"]
MASK_DEFAULT = "mask_mmdet"
MASK_BANDS = ["mask_mmdet"]

SUBFOLDERS = {
    "rgba": "images",
    "mask_mmdet": "mask",
    "flow_raft": "flow_raft",
    "flow_gmflow": "flow_gmflow",
    "depth_zoedepth": "depth_zoedepth",
    "depth_midas": "depth_midas",
    "depth_marigold": "depth_marigold",
    "depth_patchfusion": "depth_patchfusion",
    "depth_anything": "depth_anything",
    "camera_colmap": "sparse",
}


def check_ported(bands) -> None:
    """Raise, before any work, for a band the port lacks."""
    from prisma_tpu_torch.bands.base import not_ported
    msg = not_ported(bands)
    if msg:
        raise NotImplementedError(msg)


def run_band(band: str, folder: str, runtime, subpath: bool = False,
             **kwargs) -> bool:
    import importlib

    from prisma_tpu_torch.bands.base import BAND_MODULES
    print(f"\n#  {band.upper()}")
    check_ported([band])
    impl = importlib.import_module(
        f"prisma_tpu_torch.bands.{BAND_MODULES[band]}").run
    if band == "camera_colmap":
        kwargs["force"] = runtime.overwrite
    try:
        impl(folder, subpath=SUBFOLDERS[band] if subpath else "",
             runtime=runtime, **kwargs)
    except FileExistsError as e:
        # idempotent re-run (reference check_overwrite, common/io.py:35-51):
        # a band whose output exists is skipped before any device work
        print(f"#  {band}: skipping ({e}); pass --force to recompute")
        return False
    return True


def main(argv=None):
    from prisma_tpu_torch.bands import rgba as rgba_band
    from prisma_tpu_torch.bands.base import resolve as resolve_band
    from prisma_tpu_torch.io.image import get_image_size
    from prisma_tpu_torch.io.video import get_video_data
    from prisma_tpu_torch.runtime.config import RuntimeConfig
    from prisma_tpu_torch.utils import meta

    parser = argparse.ArgumentParser(prog="python -m prisma_tpu_torch.cli.process")
    parser.add_argument("--input", "-i", help="input file", type=str, required=True)
    parser.add_argument("--output", help="folder name", type=str, default="")
    parser.add_argument("--record3d", help="Record3D video", action="store_true")
    parser.add_argument("--fps", "-r", help="fix framerate", type=float, default=24)
    parser.add_argument("--extra", "-e",
                        help="Save extra data [>0 frames|PLYs; >1 FLOs; >2 NPY]",
                        type=int, default=0)
    parser.add_argument("--rgbd", help="Where the depth is", type=str, default=None)
    parser.add_argument("--depth", "-d", help="Depth bands", type=str, default=None,
                        choices=DEPTH_BANDS + ["all", "none"])
    parser.add_argument("--ply", "-p", help="Save ply for images", action="store_true")
    parser.add_argument("--npy", "-n", help="Save npy version of files",
                        action="store_true")
    parser.add_argument("--flow", "-f", help="Flow bands", type=str, default=None,
                        choices=FLOW_BANDS + ["all", "none"])
    parser.add_argument("--flo", help="Save flo files for raft", action="store_true")
    parser.add_argument("--flow_backwards", "-b", help="Save backwards video",
                        action="store_true")
    parser.add_argument("--flow_mask", "-m", help="Save mask of videos",
                        action="store_true")
    parser.add_argument("--mask", help="Mask band", type=str, default=MASK_DEFAULT,
                        choices=MASK_BANDS + ["none"])
    # the JAX package's extensions
    parser.add_argument("--batch", help="frames per device step", type=int, default=8)
    parser.add_argument("--dtype", help="device compute dtype", type=str,
                        default="bfloat16", choices=["float32", "bfloat16"])
    parser.add_argument("--random_weights", help="random-init models (smoke runs)",
                        action="store_true")
    parser.add_argument("--encoder", help="depth_anything encoder size", type=str,
                        default="vitl", choices=["vits", "vitb", "vitl"])
    parser.add_argument("--depth_size", type=int, nargs="+", default=None,
                        help="depth-band inference budget override: one int "
                             "(depth_anything relative target / midas "
                             "upper-bound) or H W (metric zoe / zoedepth "
                             "core size)")
    parser.add_argument("--segment_frames", type=int, default=64,
                        help="mp4 segment size for frame-index resume "
                             "(0 disables resume)")
    parser.add_argument("--force", "-F", action="store_true",
                        help="recompute bands whose output already exists "
                             "(without it a finished folder is a no-op)")
    parser.add_argument("--sequential_bands", action="store_true",
                        help="run bands one-by-one, re-decoding rgba.mp4 per "
                             "band (the reference's architecture), instead "
                             "of the fused single-decode pipeline")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="where the models run (default: the CUDA card; "
                             "cpu runs the kernels' plain versions)")
    args = parser.parse_args(argv)

    runtime = RuntimeConfig(batch_size=args.batch, compute_dtype=args.dtype,
                            random_weights=args.random_weights,
                            segment_frames=args.segment_frames,
                            overwrite=args.force, device=args.device)
    depth = args.depth or (DEPTH_VIDEO_DEFAULT if meta.is_video(args.input)
                           else DEPTH_IMAGE_DEFAULT)
    check_ported({"all": DEPTH_BANDS, "none": []}.get(depth, [depth]))
    runtime.resolve_device()  # no card where one is asked for: raise first

    input_path = args.input
    input_folder = os.path.dirname(input_path)
    input_basename = os.path.basename(input_path).rsplit(".", 1)[0]
    folder_name = args.output or os.path.join(input_folder, input_basename)

    data = meta.create_metadata(folder_name)
    video = meta.is_video(input_path)
    extension = "mp4" if video else "png"
    name_rgba = "rgba." + extension
    path_rgba = os.path.join(folder_name, name_rgba)

    # Record3D side-by-side depth videos (reference process.py:124-160)
    encoding_depth = "none"
    if args.record3d:
        args.rgbd = "right"
        encoding_depth = "hue"
        if video:
            _, height, _, _ = get_video_data(args.input)
        else:
            _, height = get_image_size(args.input)
        r3d = meta.get_record3d_data(args.input)
        cam = r3d["intrinsicMatrix"]
        depth_range = r3d["rangeOfEncodedDepth"]
        data["focal_length"] = max(cam[0], cam[4])
        data["principal_point"] = [cam[6], cam[7]]
        data["field_of_view"] = float(
            2 * np.arctan(0.5 * height / data["focal_length"]) * 180 / np.pi)
        meta.add_band(data, "depth", url="depth." + extension)
        data["bands"]["depth"]["values"] = {
            "min": {"type": "float", "value": depth_range[0]},
            "max": {"type": "float", "value": depth_range[1]},
        }

    # rgba always runs first, with the images/ subpath (reference process.py:172)
    meta.add_band(data, "rgba", url=name_rgba)
    meta.write_metadata(folder_name, data)
    try:
        rgba_io = resolve_band("rgba", input_path, output=path_rgba,
                               subpath=SUBFOLDERS["rgba"], runtime=runtime,
                               force_extension="png")
        rgba_io.data = data
        rgba_io.meta_root = folder_name
        rgba_band.run(rgba_io, fps=args.fps, rgbd=args.rgbd or "none",
                      encoding_depth=encoding_depth,
                      output_depth=os.path.join(folder_name,
                                                "depth." + extension)
                      if args.rgbd else "")
    except FileExistsError as e:
        print(f"#  rgba: skipping ({e}); pass --force to recompute")
    data = meta.load_metadata(folder_name)

    # global media metadata (process.py:175-189)
    if video:
        w, h, fps, frames = get_video_data(path_rgba)
        data["width"], data["height"], data["fps"], data["frames"] = w, h, fps, frames
        data["duration"] = float(frames) / float(fps)
    else:
        data["width"], data["height"] = get_image_size(path_rgba)
    if "principal_point" not in data:
        data["principal_point"] = [float(data["width"] / 2), float(data["height"] / 2)]
    if "focal_length" not in data:
        data["focal_length"] = float(data["height"] * data["width"]) ** 0.5
    if "field_of_view" not in data:
        data["field_of_view"] = (
            2 * np.arctan(0.5 * data["height"] / data["focal_length"]) * 180 / np.pi)
    meta.write_metadata(folder_name, data)

    if args.extra > 0:
        args.ply = True
    if args.extra > 1:
        args.flo = True
    if args.extra > 2:
        args.npy = True

    if args.depth is None:
        args.depth = DEPTH_VIDEO_DEFAULT if video else DEPTH_IMAGE_DEFAULT
    if args.flow is None:
        args.flow = FLOW_DEFAULT

    def depth_band_kwargs(band):
        kw = {"npy": args.npy, "ply": args.ply}
        if band == "depth_patchfusion" and video:
            kw["mode"] = "p49"
        if band == "depth_anything":
            kw["metric"] = "outdoor"  # reference default EXTRA_ARGS (process.py:53)
            kw["encoder"] = args.encoder
            if args.depth_size:
                kw["img_size"] = args.depth_size
        if band == "depth_zoedepth" and args.depth_size:
            kw["img_size"] = (args.depth_size * 2)[:2]
        if band == "depth_midas" and args.depth_size:
            kw["target"] = args.depth_size[0]
        return kw

    # fused single-decode pipeline: when a video asks for 2+ of
    # {mask, fusable depth, flow}, decode rgba.mp4 once and run the band
    # steps interleaved per batch (bands/multiband.py). The per-band
    # sequential path below skips whatever ran here; outputs are identical.
    fused: dict = {}
    if video and not args.sequential_bands:
        from prisma_tpu_torch.bands import multiband
        mask_on = args.mask != "none"
        depth_cand = None
        if args.depth != "none":
            cand = DEPTH_VIDEO_DEFAULT if args.depth == "all" else args.depth
            if cand in multiband.FUSED_DEPTH_BANDS:
                depth_cand = cand
        flow_cand = None
        if args.flow != "none":
            flow_cand = FLOW_DEFAULT if args.flow == "all" else args.flow
        if int(mask_on) + (depth_cand is not None) + \
                (flow_cand is not None) >= 2:
            depth_build = {k: v for k, v in
                           depth_band_kwargs(depth_cand or "").items()
                           if k in ("metric", "encoder", "img_size", "target")}
            fused = multiband.run_fused(
                folder_name, runtime,
                mask_on=mask_on, mask_sdf=True,
                mask_subpath=SUBFOLDERS["mask_mmdet"],
                depth_band=depth_cand, depth_build=depth_build,
                depth_subpath=SUBFOLDERS[depth_cand]
                if depth_cand and args.extra else "",
                depth_npy=args.npy,
                flow_band=flow_cand,
                flow_backwards=args.flow_backwards, flow_mask=args.flow_mask,
                flow_subpath=SUBFOLDERS[flow_cand]
                if flow_cand and args.flo else "")

    # mask (reference runs it with --sdf, process.py:46-48,207)
    if args.mask != "none" and "mask_mmdet" not in fused:
        run_band(args.mask, folder_name, runtime, subpath=True, sdf=True)

    # depth
    ran_depth = dict(fused)
    if args.depth != "none":
        bands = DEPTH_BANDS if args.depth == "all" else [args.depth]
        for band in bands:
            if band in fused:
                continue
            ran_depth[band] = run_band(band, folder_name, runtime,
                                       subpath=bool(args.extra),
                                       **depth_band_kwargs(band))
        if args.rgbd is None:
            default = (DEPTH_VIDEO_DEFAULT if video else DEPTH_IMAGE_DEFAULT) \
                if args.depth == "all" else args.depth
            if ran_depth.get(default):
                meta.set_default_band(folder_name, "depth", default)

    if video:
        # flow
        if args.flow != "none":
            flow_kwargs = {"backwards": args.flow_backwards, "mask": args.flow_mask}
            bands = FLOW_BANDS if args.flow == "all" else [args.flow]
            ran = {b: fused[b] if b in fused else
                   run_band(b, folder_name, runtime, subpath=args.flo,
                            **flow_kwargs) for b in bands}
            default = FLOW_DEFAULT if args.flow == "all" else args.flow
            if ran.get(default):
                meta.set_default_band(folder_name, "flow", default)
                meta.set_default_band(folder_name, "flow_bwd", default + "_bwd")
                meta.set_default_band(folder_name, "flow_mask", default + "_mask")
                meta.set_default_band(folder_name, "flow_mask_bwd",
                                      default + "_mask_bwd")
        # camera poses
        run_band("camera_colmap", folder_name, runtime, subpath=True)

    return folder_name


if __name__ == "__main__":
    main()
