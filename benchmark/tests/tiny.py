"""A cell of BENCHMARK.json cut to a size the CPU runs in seconds: the same
files and code paths, narrow models (vits at a 42-pixel budget; a 32-channel
2-layer GMFlow) in float32, 96x64 frames, a pool of two inputs."""

from __future__ import annotations

import os

from benchmark import run

TINY_DEPTH = dict(encoder="vits", embed_dim=384, depth=12, num_heads=6,
                  features=64, out_channels=[48, 96, 192, 384], target=42,
                  dtype="float32", checkpoint="depth_anything_vits14.pt")
TINY_FLOW = dict(feature_channels=32, num_transformer_layers=2,
                 dtype="float32")
TINY_FRAMES = dict(width=96, height=64, pool=2,
                   texture=dict(cell_px=16, octaves=2, grain=4.0))


def manifest() -> dict:
    return run.load_json(run.ROOT, "BENCHMARK.json")


def tiny_cell(name: str) -> run.Cell:
    cell = run.Cell(manifest(), name)
    cell.cfg.update(TINY_DEPTH if cell.spec["config"].startswith("depth")
                    else TINY_FLOW)
    cell.traffic.update(TINY_FRAMES)
    return cell


def names() -> list:
    return [w["name"] for w in manifest()["workloads"]]


def bench_path(*parts) -> str:
    return os.path.join(run.BENCH_DIR, *parts)
