"""The readings that the limits of `correct` are set from, outside any timed
window: for each seed, the numbers that the run compares, of the program
(the port's step, set up as a run sets it up, on every input of the pool
that a run's sample draws from) and of the control (the plain reference
with every product's operands rounded to fp8 e4m3, put in the program's
place), each against the float32 reference.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3

Prints one JSON line a seed. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(BENCH_DIR) not in sys.path:
    sys.path.insert(0, os.path.dirname(BENCH_DIR))

import torch  # noqa: E402

from benchmark import run  # noqa: E402
from benchmark.reference.common import Ops, fp8_round  # noqa: E402


def readings(cell: "run.Cell", seed: int, device: str, program: bool = True,
             control: bool = True, faults: dict | None = None) -> dict:
    """{'program': numbers, 'control': numbers} of one seed over every input
    of the pool, judged as a run judges its sample (`run.judge`); with
    `faults` ({name: f(output) -> output}), 'faults': {name: numbers} of
    the program's outputs with each fault planted where they are produced."""
    b = cell.builder
    with run.checkpoint(cell, seed, device) as (models_dir, saved):
        pool = run.make_pool(cell, seed, device)
        outs = None
        if program:
            step = b.build_step(cell.cfg, cell.traffic, models_dir, device)
            outs = [step(x) for x in pool]
            del step
        run.free_program(device)
        ref_sd = b.load_reference_weights(saved, device)
    samples = {}
    for k, x in enumerate(pool):
        inp = torch.from_numpy(x).to(device)
        want, null = run.references(cell, ref_sd, inp)
        if outs is not None:
            samples.setdefault("program", []).append((outs[k], want, null))
            for name, fault in (faults or {}).items():
                samples.setdefault(name, []).append(
                    (fault(dict(outs[k])), want, null))
        if control:
            low = run.host(b.reference(ref_sd, inp, cell.cfg, cell.traffic,
                                       Ops(fp8_round)))
            samples.setdefault("control", []).append((low, want, null))
    res = {"seed": seed}
    for name, sample in samples.items():
        if name in ("program", "control"):
            res[name] = run.judge(b, sample)
        else:
            res.setdefault("faults", {})[name] = run.judge(b, sample)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = run.Cell(run.load_json(run.ROOT, "BENCHMARK.json"), args.workload)
    for s in args.seeds:
        r = readings(cell, s, "cuda")
        print(json.dumps({"workload": args.workload, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
