"""camera_colmap band: COLMAP sparse reconstruction + camera_pose.csv export.

Reference contract (`bands/camera_colmap.py`): shell out to the COLMAP binary
(feature_extractor with optional mask path -> sequential matcher with guided
matching -> mapper with tuned BA tolerances; optional bundle_adjuster /
image_undistorter / TXT conversion), skip recomputation when sparse/ exists,
then convert the binary model to camera_pose.csv (f, ox, oy, R[9], t[3] per
frame, sorted by image name) and update the manifest intrinsics
(camera_colmap.py:132-189). Band key is "camera_pose".

The reconstruction itself is a host-side C++ binary (SURVEY.md §2.9 #3); this
driver keeps the subprocess contract and degrades gracefully when the binary
is absent. The CSV conversion uses the port's COLMAP model reader. This is
the port's copy of prisma_tpu/bands/camera_colmap_band.py (host-only).
"""

from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np

from prisma_tpu_torch.io.colmap_model import qvec2rotmat, read_model
from prisma_tpu_torch.runtime.config import RuntimeConfig
from prisma_tpu_torch.utils import meta

BAND = "camera_pose"


def colmap_available() -> bool:
    return shutil.which("colmap") is not None


def run_reconstruction(folder: str, camera_model: str = "SIMPLE_PINHOLE",
                       matcher: str = "sequential", refine: bool = False,
                       undistort: bool = False, subpath: str = "sparse") -> bool:
    """Run the COLMAP pipeline into <folder>/<subpath>. Returns success."""
    sparse = os.path.join(folder, subpath)
    images = os.path.join(folder, "images")
    mask_folder = os.path.join(folder, "mask")
    database = os.path.join(folder, "colmap.db")

    if not colmap_available():
        print("[camera_colmap] colmap binary not found on PATH; skipping "
              "reconstruction (csv conversion still runs if sparse/ exists)")
        return os.path.isdir(sparse)

    if not os.path.isdir(sparse):
        os.makedirs(sparse, exist_ok=True)
        extractor = ["colmap", "feature_extractor",
                     "--database_path", database,
                     "--image_path", images,
                     "--ImageReader.camera_model", camera_model,
                     "--ImageReader.single_camera", "1",
                     "--SiftExtraction.use_gpu", "1",
                     "--SiftExtraction.first_octave", "0"]
        if os.path.isdir(mask_folder):
            extractor += ["--ImageReader.mask_path", mask_folder]
        subprocess.run(extractor)
        subprocess.run(["colmap", f"{matcher}_matcher",
                        "--database_path", database,
                        "--SiftMatching.use_gpu", "1",
                        "--SiftMatching.guided_matching=true"])
        subprocess.run(["colmap", "mapper",
                        "--database_path", database,
                        "--image_path", images,
                        "--output_path", sparse,
                        "--Mapper.multiple_models", "0",
                        "--Mapper.num_threads", "16",
                        "--Mapper.init_min_tri_angle", "4",
                        "--Mapper.extract_colors", "1",
                        "--Mapper.ba_local_max_refinements", "1",
                        "--Mapper.ba_global_max_refinements", "1",
                        "--Mapper.ba_global_function_tolerance=0.000001"])

    model0 = os.path.join(sparse, "0")
    if refine and os.path.isdir(model0):
        subprocess.run(["colmap", "bundle_adjuster",
                        "--input_path", model0, "--output_path", model0,
                        "--BundleAdjustment.refine_principal_point", "1"])
    if undistort and os.path.isdir(model0):
        und = os.path.join(folder, "undistorted")
        subprocess.run(["colmap", "image_undistorter",
                        "--image_path", images, "--input_path", model0,
                        "--output_path", und, "--output_type", "COLMAP"])
        for f in os.listdir(und):
            if f != "0":
                shutil.move(os.path.join(und, f), os.path.join(model0, f))
        subprocess.run(["colmap", "model_converter",
                        "--input_path", model0, "--output_path", model0,
                        "--output_type", "TXT"])
    return os.path.isdir(sparse)


def convert_to_csv(folder: str, output: str, data: dict | None,
                   expected_frames: int | None = None,
                   subpath: str = "sparse") -> None:
    """sparse model -> camera_pose.csv (reference camera_colmap.py:132-189)."""
    sparsedir = os.path.join(folder, subpath)
    if os.path.exists(os.path.join(sparsedir, "0")):
        sparsedir = os.path.join(sparsedir, "0")

    cameras, images, _points = read_model(sparsedir)
    keys = sorted(images.keys(), key=lambda k: images[k].name)
    if expected_frames is not None:
        assert len(keys) == expected_frames, \
            f"{len(keys)} registered images != {expected_frames} frames"

    cam = cameras[images[keys[0]].camera_id]
    params = cam.params
    if data is not None:
        data["model"] = cam.model
        # reference semantics preserved: focal from params[0], principal point
        # from params[:2] for both SIMPLE_PINHOLE and PINHOLE
        # (camera_colmap.py:164-170)
        if cam.model in ("SIMPLE_PINHOLE", "PINHOLE"):
            data["focal_length"] = params[0]
            data["principal_point"] = params[:2].tolist()
        data["field_of_view"] = float(
            2 * np.arctan(0.5 * params[1] / params[0]) * 180 / np.pi)

    Rs = np.stack([qvec2rotmat(images[k].qvec) for k in keys]).reshape(-1, 9)
    ts = np.stack([images[k].tvec for k in keys])
    N = Rs.shape[0]
    head = params[:3][None].repeat(N, axis=0)
    lines = np.concatenate((head, Rs, ts), axis=1)
    np.savetxt(output, lines, delimiter=",", newline="\n",
               header=",".join(["f", "ox", "oy"]
                               + [f"R[{i // 3},{i % 3}]" for i in range(9)]
                               + [f"t[{i}]" for i in range(3)]))


def run(input_path: str, output: str = "", subpath: str = "sparse",
        refine: bool = False, undistort: bool = False,
        runtime: RuntimeConfig | None = None, force: bool = True) -> str:
    data = meta.load_metadata(input_path)
    folder = input_path if os.path.isdir(input_path) \
        else os.path.dirname(input_path)
    resolved = None
    if data is not None:
        resolved = meta.get_url(input_path, data, "rgba")
        folder = os.path.dirname(resolved)
    csv_out = os.path.join(folder, BAND + ".csv")
    if not force and os.path.exists(csv_out):
        # idempotent re-run (reference camera_colmap.py:23 skip /
        # check_overwrite): a finished reconstruction is left untouched
        print(f"[{BAND}] skipping: {csv_out} exists; pass --force to redo")
        return csv_out

    ok = run_reconstruction(folder, refine=refine, undistort=undistort,
                            subpath=subpath)
    if ok and resolved is not None:
        # register the band only once a sparse model exists, so a missing
        # colmap binary leaves no dangling metadata entry
        meta.get_target(resolved, data, band=BAND, target=output,
                        force_extension="csv")
    if ok and os.path.isdir(os.path.join(folder, subpath)):
        images_dir = os.path.join(folder, "images")
        expected = len(os.listdir(images_dir)) if os.path.isdir(images_dir) \
            else None
        try:
            convert_to_csv(folder, csv_out, data, expected, subpath)
        except FileNotFoundError:
            print("[camera_colmap] no sparse model found; skipping csv export")
    meta.write_metadata(input_path, data)
    return csv_out


def main(argv=None):
    """Standalone band CLI (reference bands/camera_colmap.py:190-236)."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m prisma_tpu_torch.bands.camera_colmap_band")
    parser.add_argument("--input", "-i", type=str, required=True,
                        help="video path or PRISMA folder")
    parser.add_argument("--output", "-o", type=str, default="")
    parser.add_argument("--subpath", "-d", type=str, default="sparse")
    parser.add_argument("--colmap_refine", "-r", action="store_true",
                        help="adjust bundle by refining cameras")
    parser.add_argument("--colmap_undistort", "-u", action="store_true",
                        help="undistort images")
    parser.add_argument("--force", "-F", action="store_true",
                        help="recompute even if the csv already exists")
    args = parser.parse_args(argv)
    run(args.input, output=args.output, subpath=args.subpath,
        refine=args.colmap_refine, undistort=args.colmap_undistort,
        force=args.force)


if __name__ == "__main__":
    main()
