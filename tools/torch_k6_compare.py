#!/usr/bin/env python3
"""``window_entropy`` (K6) of one source tree at ``chip_smoke.py``'s three
shapes, on one GPU.

The inputs are made by this checkout's package; then the package under
``--src`` (default: this checkout's ``src``) is imported in its place and
its kernel is timed on them:

* (a) ``entropy_frame()``'s 32 centres (phase 2's row);
* (b) the first 64 reconstructed frames of the scale recording that hold
  a valid cluster, their valid centres rounded, one launch a frame (phase
  8d's);
* (c) the K = 8,192 probe, ``entropy_probe_centres`` over the same frame;
* (d) the probe's centres sorted row-major (neighbouring centres on
  neighbouring warps), and (e) one centre 8,192 times (every slice after
  the first served from the cache): what the data's locality, and then
  the memory system, cost at (c).

For each, ``chip_smoke.time_window_entropy``'s numbers (the kernel alone
under the profiler per launch, the wrapper's call under CUDA events, the
plain version, the bound and the floor, a one-element ``fill_`` alone) and
the largest difference of the outputs from the tree's plain version on
the card. Prints one JSON line. With ``--paths`` (a tree whose kernel
has the wide and the warp path), a second line: each path forced, the
kernel alone a launch, at (a), (b), (c) and at ``K`` of ``SWEEP_K`` probe
centres, twice each in the order wide, warp, warp, wide, beside the path
the launch chooses and the SM clock.
To compare two trees on the same card, run each in turn in one call, e.g.
parent, change, change, parent:

    python3 tools/torch_k6_compare.py --src /path/to/parent/src --label parent
    python3 tools/torch_k6_compare.py --label change

Each tree builds its kernels into its own ``build/`` at first use.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SWEEP_K = (132, 264, 265, 396, 528, 1000, 2048, 4096)


def path_sweep(cs, we, dev, calls_by_shape: dict) -> dict:
    """``--paths``' line: per shape, each path's alone ms a launch."""
    out = {}
    for key, calls in calls_by_shape.items():
        n = len(calls)
        kw = [(c, {}) for c in calls]
        row = dict(plan=we.plan(max(c[1].shape[0] for c in calls), dev), wide=[], warp=[])
        for path in ("wide", "warp", "warp", "wide"):
            launch = lambda *a, p=path: we._launch(*a, p)  # noqa: E731
            row[path].append(cs.kernel_device_ms(lambda: cs.replay(launch, kw), ("window_entropy_kernel",),
                                                 iters=max(2, 20 // n)) / n)
        row["sm_clock"] = cs.sm_clock_mhz()
        out[key] = row
    return out


def real_frames(cs, dev) -> list:
    """Phase 8d's inputs as numpy ``(frame, cx, cy)``: the clusters of the
    frame route's configuration (equal on every float route, phase 8a)."""
    import torch

    from repro_torch.core import metrics as M
    from repro_torch.core.events import EventBatch, pad_windows
    from repro_torch.core.pipeline import config as PC
    from repro_torch.core.pipeline.window_core import _cluster, _condition
    from repro_torch.data.synthetic import make_recording

    cfg = cs.route_config("frame")
    scale = make_recording(**cs.SCALE)
    win = pad_windows(scale.x, scale.y, scale.t, scale.p, cfg.batcher, dev)
    raw = win.batch
    cl = _cluster(cfg, PC._histogram_fn(cfg), _condition(cfg, raw))
    pick = torch.nonzero(cl.valid.any(-1)).flatten()[:cs.K6_WINDOWS]
    frames = M.reconstruct_frame(_condition(cfg, EventBatch(*(a[pick] for a in raw))),
                                 cfg.grid.width, cfg.grid.height)
    out = []
    for i, w in enumerate(pick.tolist()):
        sel = cl.valid[w]
        out.append((frames[i].cpu().numpy(),
                    *(torch.round(c[w][sel]).to(torch.int32).cpu().numpy()
                      for c in (cl.centroid_x, cl.centroid_y))))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="directory holding repro_torch")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--paths", action="store_true", help="also time each path forced")
    args = ap.parse_args()

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # puts this checkout's src on the path

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_k6_compare: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.data.adversarial import entropy_frame, entropy_probe_centres

    dev = torch.device("cuda")
    frame, cx, cy = entropy_frame()
    px, py = entropy_probe_centres(cs.K6_PROBE)
    order = np.lexsort((px, py))
    shapes = {"a": [(frame, cx, cy)], "b": real_frames(cs, dev), "c": [(frame, px, py)],
              "d": [(frame, px[order], py[order])],
              "e": [(frame, np.full_like(px, 320), np.full_like(py, 240))]}
    torch.cuda.synchronize()

    for name in [m for m in sys.modules if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, str(Path(args.src).resolve()))
    import repro_torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import window_entropy as _we

    floor = cs.fill_floor_ms(dev)
    out = dict(label=args.label, package=str(Path(repro_torch.__file__).parent),
               device=torch.cuda.get_device_name(0),
               smi=subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                  capture_output=True, text=True).stdout.strip())
    for key, calls in shapes.items():
        calls = [tuple(torch.from_numpy(a).to(dev) for a in c) for c in calls]
        err = max(float((_we.window_entropy(*c) - ref.window_entropy_ref(*c)).abs().max())
                  for c in calls)
        out[key] = dict(cs.time_window_entropy(calls, floor), launches=len(calls),
                        centres=sum(c[1].shape[0] for c in calls), max_abs_err=err)
    print(json.dumps(out), flush=True)
    if args.paths:
        sweep = {key: [tuple(torch.from_numpy(a).to(dev) for a in c) for c in shapes[key]]
                 for key in ("a", "b", "c")}
        for k in SWEEP_K:
            sweep[f"K = {k}"] = [(torch.from_numpy(frame).to(dev),
                                  *(torch.from_numpy(a[:k]).to(dev) for a in (px, py)))]
        print(json.dumps(dict(label=args.label, paths=path_sweep(cs, _we, dev, sweep))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
