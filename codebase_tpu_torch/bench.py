"""Headline benchmark of the port + its full suite. Prints exactly ONE JSON line.

    python -m codebase_tpu_torch.bench [--windows 5] [--only idqn_lbf] [--device cuda]

The counterpart of the repo's root `bench.py` (which stays the JAX
package's). Headline metric: IDQN train throughput on Level-Based Foraging
(`bench_suite.CONFIGS["idqn_lbf"]`: 65536 Foraging-8x8-2p-3f envs, replay on
the device, double-Q updates, target maintenance) on one GPU, in env-steps/s,
beside the card's name and power limit (`nvidia-smi`).

The `suite` field carries every lane of `bench_suite.CONFIGS` with
env-steps/s, MFU and HBM use (see `bench_suite.py`). Each lane is the best of
`--windows` windows of 16 iterations, each window ending in a device sync,
the counters read outside it. A lane that raises is recorded as
`{"error": ...}`, the line is still printed, and the process exits 1, so a
failed lane never hides behind exit code 0.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback

from codebase_tpu_torch import bench_suite
from codebase_tpu_torch.profile import card
from codebase_tpu_torch.utils.device import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=5)
    ap.add_argument("--only", choices=sorted(bench_suite.CONFIGS), default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    info = card(resolve_device(args.device))

    suite = {}
    for key in bench_suite.CONFIGS:
        if args.only and key != args.only:
            continue
        try:
            suite[key] = bench_suite.run_config(key, windows=args.windows, device=args.device)
        except Exception:  # record the lane's failure and go on to the next lane
            suite[key] = {"error": traceback.format_exc(limit=3).splitlines()[-1]}
            print(f"bench_suite lane {key} failed:", file=sys.stderr)
            traceback.print_exc()

    headline = suite.get("idqn_lbf", {})
    value = float(headline.get("env_steps_per_s", 0.0) or 0.0)
    # Field order is load-bearing: a reader may keep only the LAST 2000
    # characters of this line. The bulky per-lane suite goes FIRST; a compact
    # per-lane summary plus the headline fields go LAST, so the headline
    # always survives the cut.
    summary = {
        k: {"steps_per_s": round(v["env_steps_per_s"], 0),
            "mfu": round(v["mfu"], 4) if v["mfu"] is not None else None}
        if "error" not in v else {"error": True}
        for k, v in suite.items()
    }
    print(json.dumps({
        "suite": suite,
        "summary": summary,
        "metric": "idqn_train_env_steps_per_s",
        "value": round(value, 1),
        "unit": "env-steps/s/gpu",
        "card": info["nvidia_smi"] or info["name"],
    }), flush=True)
    return 1 if any("error" in v for v in suite.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
