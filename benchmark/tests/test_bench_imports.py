"""What a run loads: no module whose top-level name is JAX's or the JAX
package's (compared whole: the port's name begins with the JAX package's),
and a reference that loads nothing of the program. Each in a fresh
interpreter, so that nothing a test process imported counts."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.tests.tiny import manifest

RUN_A_TINY_CELL = """
import json, sys
from benchmark import run
from benchmark.tests.tiny import tiny_cell
res = run.run(tiny_cell("gmflow_sintel.1080p"), 3, 0.3, trace=False,
              device="cpu")
print(json.dumps({"forbidden": run.forbidden_modules(),
                  "port": "prisma_tpu_torch" in sys.modules,
                  "correct": res["correct"]}))
"""

# a configuration's reference, loaded from its `reference` key, run through
# its builder at the builder's TINY size on frames of the cell's traffic
REFERENCE_ALONE = """
import json, os, sys, torch
from benchmark import run, weights
from benchmark.tests.tiny import manifest, tiny
m = manifest()
config = {config!r}
c = next(c for c in m["configs"] if c["name"] == config)
path = run.load_json(run.ROOT, c["file"])["reference"]
run.load_module(os.path.join(run.ROOT, path), "reference_of_" + config)
cell = tiny(run.Cell(m, next(w["name"] for w in m["workloads"]
                             if w["config"] == config)))
sd = weights.make_state_dict(cell.builder.param_specs(cell.cfg), 1, "cpu",
                             torch.float32)
x = torch.randint(0, 255, (3, cell.traffic["height"], cell.traffic["width"],
                           3), dtype=torch.uint8)
cell.builder.reference(sd, x, cell.cfg, cell.traffic)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _python(code: str, tmp_dir) -> str:
    env = dict(os.environ, PYTHONPATH=run.ROOT, TMPDIR=str(tmp_dir))
    r = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax_and_not_the_jax_package(tmp_path):
    out = json.loads(_python(RUN_A_TINY_CELL, tmp_path))
    assert out["port"] and out["correct"] in (True, False)
    assert out["forbidden"] == []


@pytest.mark.parametrize("config", [c["name"] for c in manifest()["configs"]])
def test_the_reference_loads_nothing_of_the_program(config, tmp_path):
    tops = set(json.loads(_python(REFERENCE_ALONE.format(config=config),
                                  tmp_path)))
    assert not tops & {"prisma_tpu_torch", "prisma_tpu", "jax", "jaxlib",
                       "flax"}
