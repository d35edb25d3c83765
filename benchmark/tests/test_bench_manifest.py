"""BENCHMARK.json against its contract, and the harness finding every cell,
configuration, traffic mix, limit and metric by name."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from benchmark import run
from benchmark.tests.faults import FAULTS, files_left, run_with
from benchmark.tests.tiny import bench_path, manifest, names, tiny, tiny_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BUILDER_NAMES = ("OVERLAP", "PRIMARY", "TINY", "NULL_FLOOR", "param_specs",
                 "save_checkpoint", "load_reference_weights", "build_step",
                 "reference", "compare", "step_flops", "attention_calls")


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
        assert hasattr(cell.builder, attr), \
            f"the builder of {cell.spec['config']} defines no {attr}"
    assert isinstance(cell.builder.PRIMARY, str) and cell.builder.PRIMARY
    assert isinstance(cell.builder.TINY, dict)
    assert set(cell.builder.TINY) <= set(cell.cfg), "TINY overrides only"
    assert os.path.isfile(os.path.join(run.ROOT, cell.cfg["reference"]))
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


# the tiny sizes that the four cells' CPU tests have always run at, written
# out: the builders' TINY and tests/tiny.py must keep them
TINY_BY_NAME = {
    "depth_anything_vitl": dict(
        encoder="vits", embed_dim=384, depth=12, num_heads=6, features=64,
        out_channels=[48, 96, 192, 384], target=42, dtype="float32",
        checkpoint="depth_anything_vits14.pt"),
    "gmflow_sintel": dict(feature_channels=32, num_transformer_layers=2,
                          dtype="float32")}
FRAMES_BEFORE = dict(width=96, height=64, pool=2,
                     texture=dict(cell_px=16, octaves=2, grain=4.0))


@pytest.mark.parametrize("name", ["depth_anything_vitl.1080p",
                                  "depth_anything_vitl.2160p",
                                  "gmflow_sintel.1080p",
                                  "gmflow_sintel.1080p_bidir_mask"])
def test_the_tiny_cells_are_as_before(name):
    spec = next(w for w in manifest()["workloads"] if w["name"] == name)
    cfg = run.load_json(bench_path("configs", spec["config"] + ".json"))
    cfg.update(TINY_BY_NAME[spec["config"]])
    traffic = run.load_json(bench_path("traffic", spec["traffic"] + ".json"))
    traffic.update(FRAMES_BEFORE)
    cell = tiny_cell(name)
    assert cell.cfg == cfg and cell.traffic == traffic


THIRD = "toy_tone.1080p"


def third_band(tmp_path):
    """A copy of the benchmark with the toy band of tests/third_band added
    as new files (configs/toy_tone.{json,py}, reference/toy_tone.py,
    limits/toy_tone.1080p.json) and manifest entries: -> (the manifest, the
    copy's directory, its files' bytes before the band was added)."""
    bench = tmp_path / "benchmark"
    shutil.copytree(bench_path(), bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    added = bench / "tests" / "third_band"
    for p in added.rglob("*.*"):
        dest = bench / p.relative_to(added)
        assert not dest.exists(), dest
        shutil.copy(p, dest)
    m = manifest()
    m["configs"].append({"name": "toy_tone", "source": "a test's toy",
                         "file": "benchmark/configs/toy_tone.json",
                         "reduced": [], "why": "a band of a new family"})
    m["workloads"].append({"name": THIRD, "config": "toy_tone",
                           "traffic": "1080p", "chips": 1,
                           "why": "a test cell"})
    return m, bench, before


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_third_band_added_as_new_files_runs(fault, tmp_path, monkeypatch):
    """A configuration of a family the harness has not seen (no shared
    frame, outputs named neither heat nor fwd_rgb, two checkpoint files, its
    own TINY) is found, run and judged, both generic faults come out not
    correct with no failed step, its checkpoints are removed, and no file
    of the benchmark was edited."""
    m, bench, before = third_band(tmp_path)
    cell = tiny(run.Cell(m, THIRD, bench_dir=str(bench)))
    assert cell.builder.OVERLAP == 0 and cell.frames_per_step == 8
    assert cell.cfg["hidden"] == 8 and cell.traffic["width"] == 96
    res = run_with(cell, FAULTS[fault], monkeypatch, tmp_path / "tmp")
    assert res["correct"] is (fault is None), res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["checks"]) == {"tone_gap"}
    assert files_left(tmp_path / "tmp") == []
    for p, data in before.items():
        assert p.read_bytes() == data, p


def _raises(*_):
    raise RuntimeError("a planted failure")


def _raises_after(calls: int):
    """A fault: the step runs `calls` times (the warm-up's), then raises."""
    def fault(step, _cell):
        done = []

        def broken(frames):
            done.append(1)
            return step(frames) if len(done) <= calls else _raises()
        return broken
    return fault


@pytest.mark.parametrize("where", ["build", "warm-up", "window"])
def test_checkpoints_are_removed_when_the_run_fails(where, tmp_path,
                                                    monkeypatch):
    """Both checkpoint files go when the step's build or a warm-up step
    raises (the run raises) and when every step of the window raises (the
    run is not correct)."""
    m, bench, _ = third_band(tmp_path)
    cell = tiny(run.Cell(m, THIRD, bench_dir=str(bench)))
    saved = []
    save = cell.builder.save_checkpoint
    monkeypatch.setattr(cell.builder, "save_checkpoint",
                        lambda *a: saved.extend(save(*a)) or list(saved))
    if where == "build":
        monkeypatch.setattr(cell.builder, "build_step", _raises)
    if where == "window":
        res = run_with(cell, _raises_after(2), monkeypatch, tmp_path / "tmp",
                       seconds=0.2)
        assert res["correct"] is False and res["failed"] == res["attempted"]
    else:
        with pytest.raises(RuntimeError, match="planted"):
            run_with(cell, _raises_after(0), monkeypatch, tmp_path / "tmp")
    assert len(saved) == 2 and all(p.startswith(str(tmp_path / "tmp"))
                                   for p in saved)
    assert files_left(tmp_path / "tmp") == []
