"""metadata.json manifest — the cross-band state of a PRISMA folder (a host-only
copy of prisma_tpu/utils/meta.py: importing prisma_tpu imports JAX).

File format is byte-compatible with the reference (`bands/common/meta.py`):
a JSON object with a top-level ``bands`` mapping, written with ``indent=4``.
Unlike the reference (one subprocess per band, each re-reading the manifest from
disk), the bands run in-process; this module still round-trips through the
file so that outputs remain interchangeable and resumable.
"""

from __future__ import annotations

import json
import os
from typing import Optional

META_FILE = "metadata.json"

VIDEO_EXTENSIONS = (".mp4",)


def is_video(path: str) -> bool:
    return path.endswith(VIDEO_EXTENSIONS)


def get_metadata_path(path: str) -> Optional[str]:
    """Resolve the metadata.json path for a file-in-folder or folder path."""
    if os.path.isfile(path):
        if path.endswith(".json"):
            return path
        return get_metadata_path(os.path.dirname(path))
    if os.path.isdir(path):
        return os.path.join(path, META_FILE)
    return None


def load_metadata(path: str) -> Optional[dict]:
    meta_path = get_metadata_path(path)
    if meta_path is not None and os.path.exists(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return None


def create_metadata(path: str) -> dict:
    """Create (or load, if present) the manifest for an output folder."""
    folder = os.path.dirname(path) if os.path.isfile(path) else path
    os.makedirs(folder, exist_ok=True)
    meta_path = os.path.join(folder, META_FILE)
    if not os.path.exists(meta_path):
        with open(meta_path, "w") as f:
            f.write(json.dumps({"bands": {}}, indent=4))
    return load_metadata(meta_path)


def write_metadata(path: str, metadata: Optional[dict]) -> None:
    if metadata is None:
        return
    meta_path = get_metadata_path(path)
    if meta_path is not None and os.path.exists(meta_path):
        with open(meta_path, "w") as f:
            f.write(json.dumps(metadata, indent=4))


def add_band(metadata: dict, band: str, url: str = "", folder: str = "") -> None:
    bands = metadata.setdefault("bands", {})
    entry = bands.setdefault(band, {})
    if url:
        entry["url"] = url
    if folder:
        entry["folder"] = folder


def get_target(
    path: str,
    metadata: Optional[dict],
    band: str = "rgba",
    target: str = "",
    force_extension: Optional[str] = None,
) -> str:
    """Resolve the output path for a band and register its url in the manifest.

    Mirrors the reference resolution rules (`bands/common/meta.py:70-94`): the band
    file lives next to the input (or inside ``target`` if it is a directory), named
    ``<band>.<ext>`` where ext follows the input except when forced.
    """
    if os.path.isdir(target):
        input_folder = target
    else:
        input_folder = os.path.dirname(path)

    input_extension = os.path.basename(path).rsplit(".", 1)[1]
    if force_extension and (not is_video(path) or force_extension == "csv"):
        input_extension = force_extension

    target_filename = band + "." + input_extension
    if target == "" or os.path.isdir(target):
        target = os.path.join(input_folder, target_filename)

    if metadata is not None:
        add_band(metadata, band, url=target_filename)
    return target


def get_url(path: str, metadata: Optional[dict], band: str) -> str:
    """Map a PRISMA folder + band name to the band's file path."""
    if os.path.isdir(path) and metadata:
        url = metadata.get("bands", {}).get(band, {}).get("url")
        if url is not None:
            return os.path.join(path, url)
    return path


def set_default_band(path: str, band: str, band_default: str) -> None:
    """Alias e.g. 'depth' -> the chosen depth band's entry. No-op if absent."""
    data = load_metadata(path)
    if data and band_default in data.get("bands", {}):
        data["bands"][band] = data["bands"][band_default]
        write_metadata(path, data)


def get_media_info(path: str) -> dict:
    """Container metadata via pymediainfo (optional dependency)."""
    try:
        from pymediainfo import MediaInfo
    except ImportError as e:
        raise ImportError(
            "Record3D support requires the pymediainfo package") from e
    import json as _json
    return _json.loads(MediaInfo.parse(path).to_json())


def get_record3d_data(path: str) -> dict:
    """Record3D's embedded camera metadata (reference meta.py:148-156)."""
    import json as _json
    info = get_media_info(path)
    return _json.loads(info["tracks"][0]["movie_more"])
