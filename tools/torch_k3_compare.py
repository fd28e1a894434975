#!/usr/bin/env python3
"""``patch_metrics`` (K3) of one source tree on its large path, on one GPU.

The inputs are made by this checkout's package; then the package under
``--src`` (default: this checkout's ``src``) is imported in its place and
its kernel is timed on them:

* ``stride``: the scale recording in ``chip_smoke.STRIDE_US`` stride
  windows at capacity ``chip_smoke.STRIDE_CAPACITY``, conditioned and
  clustered as the scan's window core does (``chip_smoke.stride_blocks``),
  one launch a block: the large path on real sky;
* ``stride, first n windows`` for n in ``STRIDE_SLICES``: the first block's
  first n windows, grids that take 8 and 16 slots a CTA by default;
* ``E = e, K = k`` for e in ``chip_smoke.LARGE_E`` and
  ``chip_smoke.K3_SCRATCH_E``, k in 32 and ``chip_smoke.LARGE_K``:
  ``large_windows(e)`` with every slot valid (``full_slot_clusters``).

For each: the kernel alone under the profiler and the wrapper's call under
CUDA events, a launch (``chip_smoke.kernel_device_ms``, ``cuda_ms``); the
bound and its counts from ``chip_smoke.patch_metrics_cost`` (of this
checkout); the largest difference of the outputs from the tree's plain
version on the card (event_count and edge_density required identical,
the rest within ``chip_smoke.RTOL``/``ATOL``); and the SM clock just after
the timing. Prints one JSON line. With ``--groups`` (a tree whose wrapper
has ``_launch``), a second line: the alone ms at each of ``GROUPS`` slots
a CTA, in the order of ``GROUPS`` then reversed.
To compare two trees on the same card, run each in turn in one call, e.g.
parent, change, change, parent:

    python3 tools/torch_k3_compare.py --src /path/to/parent/src --label parent
    python3 tools/torch_k3_compare.py --label change

Each tree builds its kernels into its own ``build/`` at first use.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GROUPS = (4, 8, 16, 32)
STRIDE_SLICES = (132, 300)


def inputs(cs, dev) -> dict:
    """name -> list of ``(batch, clusters)``, one launch each."""
    from repro_torch.core.pipeline import PipelineConfig
    from repro_torch.data.adversarial import full_slot_clusters, large_windows, stacked_batch
    from repro_torch.data.synthetic import make_recording

    cfg = PipelineConfig(use_kernels=True, metrics_impl="kernel")
    stride, _, _ = cs.stride_blocks(make_recording(**cs.SCALE), cfg, dev)
    out = {"stride": stride}
    b, cl = stride[0]
    for n in STRIDE_SLICES:
        out[f"stride, first {n} windows"] = [(type(b)(*(a[:n] for a in b)), type(cl)(*(a[:n] for a in cl)))]
    for e in (*cs.LARGE_E, cs.K3_SCRATCH_E):
        b = stacked_batch(large_windows(e, n_windows=2 if e > 4096 else 3), dev)
        for k in (32, cs.LARGE_K):
            out[f"E = {e}, K = {k}"] = [(b, full_slot_clusters(b, k))]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="directory holding repro_torch")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--groups", action="store_true", help="also time each slots-a-CTA setting")
    args = ap.parse_args()

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # puts this checkout's src on the path

    import torch

    if not torch.cuda.is_available():
        print("torch_k3_compare: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    shapes = inputs(cs, dev)
    costs = {key: [cs.patch_metrics_cost(b, cl, width=640, height=480) for b, cl in calls]
             for key, calls in shapes.items()}
    torch.cuda.synchronize()

    for name in [m for m in sys.modules if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, str(Path(args.src).resolve()))
    import repro_torch
    from repro_torch.kernels import patch_metrics as _pm
    from repro_torch.kernels import ref

    out = dict(label=args.label, package=str(Path(repro_torch.__file__).parent),
               device=torch.cuda.get_device_name(0),
               smi=subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                  capture_output=True, text=True).stdout.strip())
    for key, calls in shapes.items():
        rows = []
        for (b, cl), cost in zip(calls, costs[key]):
            pm = lambda: _pm.patch_metrics(b, cl, width=640, height=480)  # noqa: E731
            err = cs.compare_metrics(pm(), ref.patch_metrics_stage_ref(b, cl, width=640, height=480),
                                     f"{args.label} {key}")
            rows.append(dict(ms=cs.kernel_device_ms(pm, ("patch_metrics_kernel",)), call_ms=cs.cuda_ms(pm),
                             max_abs_err=err, **cost, shape=tuple(b.x.shape)))
        r = cs.per_launch(rows)
        r["max_abs_err"] = max(row["max_abs_err"] for row in rows)
        cs.bound(r)
        r["sm_clock"] = cs.sm_clock_mhz()
        out[key] = r
    print(json.dumps(out), flush=True)
    if args.groups:
        sweep = {}
        for key, calls in shapes.items():
            row = {g: [] for g in GROUPS}
            for g in GROUPS + GROUPS[::-1]:
                fn = lambda g=g: [_pm._launch(b, cl, 640, 480, g) for b, cl in calls]  # noqa: E731
                row[g].append(cs.kernel_device_ms(fn, ("patch_metrics_kernel",)) / len(calls))
            row["sm_clock"] = cs.sm_clock_mhz()
            sweep[key] = row
        print(json.dumps(dict(label=args.label, groups=sweep)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
