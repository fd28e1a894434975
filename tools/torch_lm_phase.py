#!/usr/bin/env python3
"""Runs LM phases of ``chip_smoke.py`` alone on the card, with every reading
kept: phase 9c (Llama-3.2-1B at full width, depth 2, float32, card against
CPU) or phase 10c (each family, one block-pattern cycle) repeated, phase
10a (each family served at full width, without the teacher-forcing check),
the whole of phase 10, the whole of phase 11 (LM training at full width
and the paged decode), the whole of phase 12 (the launch tooling; run
alone, it has no phase 9 or 11 medians to set its bounds beside), or the
whole of phase 13 (the multi-device slice; run alone, it first runs
phase 4's unsharded fleet, which 13a is held against, and after it the
int8 collectives in a 4-rank gloo group on this machine's CPU, which the
script leaves to the tests).

    PYTHONPATH=src python tools/torch_lm_phase.py 9c --repeat 10
    PYTHONPATH=src python tools/torch_lm_phase.py 10c --repeat 3 [--arch A ...]
    PYTHONPATH=src python tools/torch_lm_phase.py 10a [--arch A ...]
    PYTHONPATH=src python tools/torch_lm_phase.py 10
    PYTHONPATH=src python tools/torch_lm_phase.py 11
    PYTHONPATH=src python tools/torch_lm_phase.py 12
    PYTHONPATH=src python tools/torch_lm_phase.py 13

A repeated run past its bound is recorded (with the message that names
its reading) and the others still run; the script exits non-zero if any
failed. Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402  (puts src/ on the path)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("phase", choices=("9c", "10a", "10c", "10", "11", "12", "13"))
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--arch", nargs="*", default=list(C.LM10_FAMILIES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.phase == "11":
        C.phase11(dev, smi)
        return 0
    if args.phase == "12":
        C.phase12(dev, smi)
        return 0
    if args.phase == "13":
        from repro_torch.core.pipeline import PipelineConfig
        from repro_torch.data.synthetic import make_recording

        cfg = PipelineConfig(use_kernels=True, metrics_impl="kernel")
        recs = [make_recording(seed=11 + s, **C.FLEET) for s in range(C.FLEET_SENSORS)]
        rounds = C.fleet_rounds(recs)
        C.run_fleet(cfg, rounds[:20], len(recs), dev)  # warm-up
        sync, ms, _, _ = C.run_fleet(cfg, rounds, len(recs), dev, sync_each=True)
        C.phase13(cfg, recs, sync, C.round_stats(ms[:-1]), dev, smi)
        C.mesh13_gloo()
        return 0
    if args.phase == "10":
        C.LM10_FAMILIES = {a: C.LM10_FAMILIES[a] for a in args.arch}
        C.phase10(dev, smi)
        return 0
    if args.phase == "10a":
        for arch in args.arch:
            served = C.family_serve(arch, dev, smi)
            print(json.dumps({"arch": arch, **{k: v for k, v in served.items() if isinstance(v, (int, float))}}))
            del served
            torch.cuda.empty_cache()
        return 0
    readings, failed = [], 0
    for i in range(args.repeat):
        for arch in (["llama3.2-1b"] if args.phase == "9c" else args.arch):
            try:
                r = (C.lm_card_against_cpu(dev, smi) if args.phase == "9c"
                     else C.family_card_against_cpu(arch, dev, smi))
                readings.append(dict(run=i, arch=arch, max_abs_err=r["max_abs_err"]))
            except AssertionError as e:
                failed += 1
                readings.append(dict(run=i, arch=arch, failed=str(e)))
    print(json.dumps({"phase": args.phase, "readings": readings, "failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
