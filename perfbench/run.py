"""Run one cell of the benchmark once, on the card it is started on.

    python perfbench/run.py --workload fleet18.suite --seed 7 --seconds 51 --trace 0

From the root of a checkout: loads the program (``src/repro_torch``),
generates the cell's inputs from ``--seed``, warms up, measures for
``--seconds`` (and, with ``--trace 1``, then profiles a bounded stretch), holds
what the timed path produced against the plain reference, and prints one
JSON line last: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (``breakdown`` when traced) and ``checks``, each number
compared beside its limit, which also close standard error. Exits 2
without a result when there is no CUDA card or too few, and 3 when a
module of JAX or of the JAX package got loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(ROOT / "src"))
# Every build and kernel cache at a fixed path inside the checkout.
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
# One host thread for the CPU-side math: the load is one process, and a
# pool of threads on a host shared with others waits for its slowest.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import repro_torch  # noqa: F401  the program under test: without it, no run
    import torch

    from harness import bench

    torch.set_num_threads(1)

    cell = bench.cell_of(bench.spec(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: cell {cell['name']} needs {cell['chips']} CUDA card(s), found {found}",
              file=sys.stderr)
        return 2
    out = bench.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    found = bench.loaded_forbidden()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    for name, row in out["checks"].items():
        print(f"check {name} = {row['value']!r} (limit {row['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
