"""The readings that the limits of `correct` are set from.

    python3 -m portbench.readings --workload <cell> --seeds 1,2,3 [--modes program,control,half_batch]

For each seed: the cell's set-up as a run makes it (train state, weights
from the seed, the checked first iteration), the program's state freed,
then the check's numbers for each mode (`families/<family>.judge`):
"program" (what a run compares), "control" (the reference in the program's
place with TF32 products, the next precision down) and "half_batch" (the
reference in the program's place with the loss over half of each batch's
rows, or for the actor-critic family over half of the rollout's envs: a
planted fault). No measured window: the numbers come from the first
iteration alone (the after-window checks are exact and not read here). One
JSON line a seed and mode, then one with each number's largest program
reading and smallest control and fault readings. The benchmark's runs do
not run this.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--modes", default="program,control,half_batch")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from portbench import run, spec

    workload = spec.workload(args.workload)
    config = spec.config(workload["config"])
    modes = args.modes.split(",")
    readings = {m: [] for m in modes}
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = run.Cell(workload, config, seed, args.device)
        cell.free()
        for mode in modes:
            numbers = cell.judge(mode)
            readings[mode].append(numbers)
            print(json.dumps({"workload": args.workload, "seed": seed, "mode": mode, "numbers": numbers}), flush=True)
    summary = {}
    for mode, rows in readings.items():
        pick = max if mode == "program" else min
        summary[mode] = {k: pick(r[k] for r in rows) for k in rows[0]} if rows else {}
    print(json.dumps({"workload": args.workload, "summary": summary, "seeds": args.seeds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
