"""BENCHMARK.json against its contract, and the harness finding every cell,
configuration, traffic mix, limit and metric by name."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from benchmark import run
from benchmark.tests.tiny import bench_path, manifest, names

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BUILDER_NAMES = ("OVERLAP", "param_specs", "save_checkpoint",
                 "load_reference_weights", "build_step", "reference",
                 "compare", "step_flops", "attention_calls")


def test_manifest_keys_and_names():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= m["run_seconds"] <= 51
    assert m["paths"] == ["benchmark"]
    for c in m["configs"]:
        assert NAME.match(c["name"]) and os.path.exists(
            os.path.join(run.ROOT, c["file"]))
    metrics = m["end_to_end"] + m["per_layer"]
    assert len({x["name"] for x in metrics}) == len(metrics)
    for x in metrics:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"])
        assert x["better"] in ("lower", "higher")
    for x in m["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25
        assert x["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {x["name"] for x in m["end_to_end"]}
    for x in m["per_layer"]:
        assert x["moves"] in {e["name"] for e in m["end_to_end"]}
    pairs = {(w["config"], w["traffic"]) for w in m["workloads"]}
    assert len(pairs) == len(m["workloads"])
    assert all(w["chips"] == 1 and len(w["why"]) <= 200
               and NAME.match(w["name"]) for w in m["workloads"])


@pytest.mark.parametrize("name", names())
def test_every_cell_resolves(name):
    cell = run.Cell(manifest(), name)
    for attr in BUILDER_NAMES:
        assert hasattr(cell.builder, attr), attr
    assert cell.traffic["frames_per_input"] > cell.builder.OVERLAP
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    assert {"setup_s"} < {m["name"] for m in cell.end_to_end}
    assert cell.per_layer
    assert all(callable(r.read) for r in cell.readers.values())


def test_a_cell_added_as_new_files_is_found(tmp_path):
    """A new traffic mix, its limits and a new per-layer metric, added as
    files and manifest entries only: the harness finds them with no file
    of the benchmark edited."""
    bench = tmp_path / "benchmark"
    shutil.copytree(bench_path(), bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    traffic = json.loads((bench / "traffic" / "1080p.json").read_text())
    traffic.update(width=1280, height=720)
    (bench / "traffic" / "720p.json").write_text(json.dumps(traffic))
    (bench / "limits" / "gmflow_sintel.720p.json").write_text(
        json.dumps({"limits": {"fwd_rgb_gap": 1.0}}))
    (bench / "metrics" / "steps_counted.py").write_text(
        "def read(ctx):\n    return len(ctx.step_s)\n")
    m = manifest()
    m["workloads"].append({"name": "gmflow_sintel.720p",
                           "config": "gmflow_sintel", "traffic": "720p",
                           "chips": 1, "why": "a test cell"})
    m["per_layer"].append({"name": "steps_counted", "unit": "steps",
                           "better": "higher", "source": "program_counter",
                           "layer": "the test", "moves": "frames_per_s",
                           "workloads": ["gmflow_sintel.720p"]})
    cell = run.Cell(m, "gmflow_sintel.720p", bench_dir=str(bench))
    assert cell.traffic["width"] == 1280
    assert "steps_counted" in cell.readers
    assert cell.readers["steps_counted"].read(
        type("Ctx", (), {"step_s": [0.1, 0.2]})()) == 2
    other = run.Cell(m, "gmflow_sintel.1080p", bench_dir=str(bench))
    assert "steps_counted" not in other.readers
    for p, data in before.items():
        assert p.read_bytes() == data, p
