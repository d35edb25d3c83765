"""The faults planted under a run of any cell, named by what they break, and
a run of a tiny cell on the CPU with one of them planted. They read only the
builder's PRIMARY and the cell's frames a step, so a configuration added as
new files gets them as it is."""

from __future__ import annotations

import os
import tempfile

import numpy as np

from benchmark import run


def complement(a: np.ndarray) -> np.ndarray:
    """a reflected within its type's range (uint8: 255 - a; bool: not a),
    or within its own range where it is a float."""
    if a.dtype == bool:
        return ~a
    if np.issubdtype(a.dtype, np.integer):
        info = np.iinfo(a.dtype)
        return (int(info.max) + int(info.min) - a.astype(np.int64)) \
            .astype(a.dtype)
    return a.max() + a.min() - a


def alter_one_answer(step, cell):
    """The first frame of the builder's PRIMARY output complemented."""
    def broken(frames):
        out = step(frames)
        key = cell.builder.PRIMARY
        out[key][0] = complement(out[key][0])
        return out
    return broken


def half_the_batch(step, cell):
    """Only the first half of the frames computed; the left-out outputs are
    copies of the computed ones, as many rows as a step counts."""
    def broken(frames):
        out = step(frames[:len(frames) // 2 + 1])
        n = cell.frames_per_step
        return {k: np.concatenate([v] * -(-n // len(v)))[:n]
                for k, v in out.items()}
    return broken


FAULTS = {None: None, "one answer altered": alter_one_answer,
          "half the batch left out": half_the_batch}


def run_with(cell, fault, monkeypatch, tmp_dir, seconds: float = 1.0):
    """run.run of the cell on the CPU with TMPDIR at tmp_dir, and with
    `fault(step, cell)` wrapping the step that the builder builds."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_dir))
    build = cell.builder.build_step
    if fault is not None:
        monkeypatch.setattr(cell.builder, "build_step",
                            lambda *a: fault(build(*a), cell))
    return run.run(cell, 2 ** 31 + 99, seconds, trace=False, device="cpu")


def files_left(tmp_dir) -> list:
    """The files a run left in its models directory under tmp_dir."""
    models = os.path.join(str(tmp_dir), "prisma_benchmark_models")
    return sorted(os.listdir(models)) if os.path.isdir(models) else []
