"""The readings that the limits of ``correct`` are set from, on the card.

    python perfbench/limits.py --workload fleet18.suite --seeds 12 --control-seeds 3 --seconds 5

In one process: the cell's timed path on ``--seeds`` seeds (a short window
at the cell's own load, compared as a run compares), then the control (the
plain reference in bfloat16 in the program's place) on ``--control-seeds``
more. Prints one JSON line a run, then each number's lower reading (the
largest of the program's runs) and upper reading (the smallest of the
control's). The benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
FIRST_SEED = 3_000_000_019  # seeds past 31 bits, as the driver's are
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)

    import torch

    from harness import bench

    if not torch.cuda.is_available():
        print("perfbench limits: needs a CUDA card", file=sys.stderr)
        return 2
    runs = {"program": [], "control": []}
    seeds = [FIRST_SEED + 7_919 * i for i in range(args.seeds + args.control_seeds)]
    for i, seed in enumerate(seeds):
        control = i >= args.seeds
        t0 = time.perf_counter()
        out = bench.run_cell(args.workload, seed, args.seconds, False, t0, control=control)
        checks = {k: v["value"] for k, v in out["checks"].items()}
        runs["control" if control else "program"].append(checks)
        print(json.dumps(dict(workload=args.workload, seed=seed, control=control, correct=out["correct"],
                              attempted=out["attempted"], seconds=time.perf_counter() - t0,
                              checks=checks)), flush=True)
    names = list(runs["program"][0]) if runs["program"] else []
    summary = {k: dict(lower=max(r[k] for r in runs["program"]),
                       upper=min(r[k] for r in runs["control"]) if runs["control"] else None)
               for k in names}
    print(json.dumps(dict(workload=args.workload, readings=summary)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
