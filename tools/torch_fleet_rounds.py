#!/usr/bin/env python3
"""Times the fleet rounds of ``chip_smoke.py``'s phase 4 on the card, from
the checkout at ``--root`` (default: this one), so that two commits can be
compared on one card in one call: 16 sensors of the scale density (seed
11 + s), 20 warm-up rounds, then 500 rounds of 20 ms chunks and a flush,
closed by a synchronize a round, as phase 4 times them.

    python tools/torch_fleet_rounds.py --root build/parent
    python tools/torch_fleet_rounds.py

Run it without ``PYTHONPATH``: the root's ``chip_smoke.py`` puts the
root's own ``src`` on the path, so each root runs its own harness
(``tools/torch_call_overhead.py`` instead imports another tree's ``src``
under this checkout's harness, and adds the stage wrappers and the
default route). Prints the card's name and power limit,
then one JSON line: the root, the per-round p50, p99 and largest ms over
the 500 rounds (the flush left out) and the garbage collector's ms.
``--profile N`` then runs the rounds once more under ``cProfile`` and
prints the N functions with the most time of their own, one JSON line
each (the profiler slows the host's Python; compare two roots only
under it).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--profile", type=int, default=0)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import chip_smoke as C  # the root's, which puts the root's src/ on the path
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.pipeline import PipelineConfig
    from repro_torch.data.synthetic import make_recording

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    cfg = PipelineConfig(use_kernels=True, metrics_impl="kernel")
    recs = [make_recording(seed=11 + s, **C.FLEET) for s in range(C.FLEET_SENSORS)]
    rounds = C.fleet_rounds(recs)
    C.run_fleet(cfg, rounds[:20], len(recs), dev)  # warm-up
    _, ms, gc_ms, _ = C.run_fleet(cfg, rounds, len(recs), dev, sync_each=True)
    stats = C.round_stats(ms[:-1])
    print(json.dumps(dict(root=str(root), rounds=len(ms) - 1, **stats, gc_ms=sum(gc_ms[:-1]),
                          src=str(Path(sys.modules["repro_torch"].__file__).parent))), flush=True)
    if args.profile:
        import cProfile
        import pstats

        prof = cProfile.Profile()
        prof.runcall(C.run_fleet, cfg, rounds, len(recs), dev, sync_each=True)
        st = pstats.Stats(prof)
        top = sorted(st.stats.items(), key=lambda kv: kv[1][2], reverse=True)[:args.profile]
        for (file, line, name), (_, calls, own, cum, _) in top:
            print(json.dumps(dict(fn=f"{Path(file).name}:{line}:{name}", calls=calls,
                                  own_ms=own * 1e3, cum_ms=cum * 1e3)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
