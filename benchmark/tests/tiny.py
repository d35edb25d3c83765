"""A cell of BENCHMARK.json cut to a size the CPU runs in seconds: the same
files and code paths, the configuration at its builder's TINY (narrow
models in float32), 96x64 frames, a pool of two inputs."""

from __future__ import annotations

import os

from benchmark import run

TINY_FRAMES = dict(width=96, height=64, pool=2,
                   texture=dict(cell_px=16, octaves=2, grain=4.0))


def manifest() -> dict:
    return run.load_json(run.ROOT, "BENCHMARK.json")


def tiny(cell: run.Cell) -> run.Cell:
    cell.cfg.update(cell.builder.TINY)
    cell.traffic.update(TINY_FRAMES)
    return cell


def tiny_cell(name: str) -> run.Cell:
    return tiny(run.Cell(manifest(), name))


def names() -> list:
    return [w["name"] for w in manifest()["workloads"]]


def bench_path(*parts) -> str:
    return os.path.join(run.BENCH_DIR, *parts)
