#!/usr/bin/env python3
"""Host cost of the float stage wrappers, and the fleet round, on one GPU.

Measures, for the port's package under ``--src`` (default: this
checkout's ``src``):

* ``cluster_accum_topk`` (the clustering stage kernel's wrapper) and
  ``patch_metrics`` on the scan's block of the scale recording at
  capacity 256 (``call_ms``: CUDA events over 20 calls; ``ms``: the kernel
  alone under the profiler), and on one and two of its windows, as the
  live stream hands them over (``call_ms`` there, and ``host_us``: host
  clock per call over 2,000 calls with one synchronize at the end);
* the full-width fleet (``chip_smoke.py``'s 16 sensors x 10 s, 20 ms
  rounds) on the kernel route and under ``PipelineConfig()`` (the
  default event route): per-round host ms with a synchronize per round,
  p50 and p99, after 20 rounds of warm-up.

Host time on a shared machine only ever gains from other work, so each
wrapper number is taken ``--repeats`` times and reported as its least
and its median, and the fleet is run that many times, each run's p50
kept. Prints one JSON line. To compare two trees on the same card, run
each in turn in one call, e.g. parent, change, change, parent:

    python3 tools/torch_call_overhead.py --src /path/to/parent/src --label parent
    python3 tools/torch_call_overhead.py --label change

Each tree builds its kernels into its own ``build/`` at first use. With
``--out``, the runs' lines gather in one file; ``--summarize FILE`` then
reads it (consecutive lines labelled ``parent`` and ``change`` are one
pair) and prints, for each fleet route, each side's median and quartiles
of the runs' mean p50, the pairs the change won and lost, and a verdict:
"regression" when the change's median exceeds the parent's by more than
the parent's quartile spread, "gain" when it is lower by more than that
and the change won nine tenths of the pairs, else "unresolved". It needs
no card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="directory holding repro_torch")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--out", default=None, help="also append the JSON line to this file")
    ap.add_argument("--summarize", default=None, help="summarize the pairs in this file and exit")
    args = ap.parse_args()
    if args.summarize:
        return summarize(args.summarize)

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # its constants and timing helpers; imports no repro_torch

    sys.path.insert(0, str(Path(args.src).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_call_overhead: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.core.events import EventBatch, pad_windows
    from repro_torch.core.grid_clustering import GridConfig
    from repro_torch.core.pipeline import PipelineConfig, config as C
    from repro_torch.core.pipeline.window_core import _cluster, _condition
    from repro_torch.data.synthetic import make_recording
    from repro_torch.kernels import _build
    from repro_torch.kernels import cluster_accum as _ca
    from repro_torch.kernels import patch_metrics as _pm

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    _build.build_all()
    cfg = PipelineConfig(use_kernels=True, metrics_impl="kernel")
    g = GridConfig()
    scale = make_recording(**cs.SCALE)
    win = pad_windows(scale.x, scale.y, scale.t, scale.p, cfg.batcher, dev)
    b = _condition(cfg, win.batch)
    cl = _cluster(cfg, C._histogram_fn(cfg), b)

    def host_us(fn, n: int = 2000) -> float:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e6

    def least_median(fn) -> dict:
        v = sorted(fn() for _ in range(args.repeats))
        return dict(least=v[0], median=v[len(v) // 2])

    out = dict(label=args.label, src=str(Path(repro_torch.__file__).resolve().parents[1]), card=smi)
    for n_win, key in ((b.x.shape[0], "scan"), (1, "one_window"), (2, "two_windows")):
        bb = EventBatch(*(a[:n_win].contiguous() for a in b))
        cc = type(cl)(*(a[:n_win].contiguous() for a in cl))
        ca = lambda: _ca.cluster_accum_topk(bb.x, bb.y, bb.t, bb.valid, g)  # noqa: E731
        pm = lambda: _pm.patch_metrics(bb, cc, width=640, height=480)  # noqa: E731
        for name, fn, kname in (("cluster_accum", ca, "cluster_accum_kernel"),
                                ("patch_metrics", pm, "patch_metrics_kernel")):
            row = dict(shape=list(bb.x.shape), call_ms=least_median(lambda: cs.cuda_ms(fn)))
            if key == "scan":
                row["ms"] = cs.kernel_device_ms(fn, (kname,))
            else:
                row["host_us"] = least_median(lambda: host_us(fn))
            out[f"{name}_{key}"] = row

    recs = [make_recording(seed=11 + s, **cs.FLEET) for s in range(cs.FLEET_SENSORS)]
    rounds = cs.fleet_rounds(recs)
    for route, fleet_cfg in (("kernel", cfg), ("default", PipelineConfig())):
        cs.run_fleet(fleet_cfg, rounds[:20], len(recs), dev)  # warm-up
        p50, p99 = [], []
        for _ in range(args.repeats):
            _, ms, _, _ = cs.run_fleet(fleet_cfg, rounds, len(recs), dev, sync_each=True)
            lat = np.asarray(ms[:-1])  # the feeds; the flush is the last entry
            p50.append(float(np.percentile(lat, 50)))
            p99.append(float(np.percentile(lat, 99)))
        out[f"fleet_{route}"] = dict(sensors=len(recs), rounds=len(lat), p50_ms=p50, p99_ms=p99)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


def summarize(path: str) -> int:
    """Pair verdicts of the parent/change runs in ``path`` (see the module
    docstring); prints one JSON line."""
    import numpy as np

    runs = [json.loads(line) for line in Path(path).read_text().splitlines() if line.strip()]
    pairs = [{r["label"]: r for r in runs[i:i + 2]} for i in range(0, len(runs) - 1, 2)]
    pairs = [p for p in pairs if set(p) == {"parent", "change"}]
    out = dict(pairs=len(pairs))
    for key in sorted(k for k in runs[0] if k.startswith("fleet")):
        read = lambda r: float(np.mean(r[key]["p50_ms"]))  # noqa: E731
        par = np.array([read(p["parent"]) for p in pairs])
        chg = np.array([read(p["change"]) for p in pairs])
        q = lambda a: [float(v) for v in np.percentile(a, [25, 50, 75])]  # noqa: E731
        (p1, pm, p3), (c1, cm, c3) = q(par), q(chg)
        wins, losses = int((chg < par).sum()), int((chg > par).sum())
        if cm - pm > p3 - p1:
            verdict = "regression"
        elif pm - cm > p3 - p1 and wins >= 0.9 * len(pairs):
            verdict = "gain"
        else:
            verdict = "unresolved"
        out[key] = dict(parent_q1_median_q3=[p1, pm, p3], change_q1_median_q3=[c1, cm, c3],
                        change_won=wins, change_lost=losses, verdict=verdict)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
