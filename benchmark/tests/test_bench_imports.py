"""What a run loads: no module whose top-level name is JAX's or the JAX
package's (compared whole: the port's name begins with the JAX package's),
and a reference that loads nothing of the program. Each in a fresh
interpreter, so that nothing a test process imported counts."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from benchmark import run

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

REFERENCE_ALONE = """
import json, sys, torch
from benchmark.reference import common, depth_anything, gmflow
from benchmark.tests.tiny import TINY_DEPTH, TINY_FLOW, tiny_cell
from benchmark import weights
for name in ("depth_anything_vitl.1080p", "gmflow_sintel.1080p_bidir_mask"):
    cell = tiny_cell(name)
    sd = weights.make_state_dict(cell.builder.param_specs(cell.cfg), 1, "cpu",
                                 torch.float32)
    x = torch.randint(0, 255, (3, 64, 96, 3), dtype=torch.uint8)
    cell.builder.reference(sd, x, cell.cfg, cell.traffic)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _python(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=run.ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax_and_not_the_jax_package():
    out = json.loads(_python(RUN_A_TINY_CELL))
    assert out["port"] and out["correct"] in (True, False)
    assert out["forbidden"] == []


def test_the_reference_loads_nothing_of_the_program():
    tops = set(json.loads(_python(REFERENCE_ALONE)))
    assert not tops & {"prisma_tpu_torch", "prisma_tpu", "jax", "jaxlib",
                       "flax"}
