"""Quickstart on the PyTorch/CUDA port: detect orbiting objects in a
synthetic night-sky recording on the GPU.

The same run as ``examples/quickstart.py``, through ``repro_torch``:
dual-threshold windowing on the host, then conditioning, grid clustering
(the ``cluster_accum`` CUDA kernel), the six quality metrics (the
``patch_metrics`` CUDA kernel) and tracking on the device, then scoring
against the simulator's ground truth. With ``--numerics fixed`` the
integer datapath runs instead, its whole per-window chain in the
``window_pipeline`` CUDA kernel.

  PYTHONPATH=src python examples/torch_quickstart.py            # on the GPU
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
  PYTHONPATH=src python examples/torch_quickstart.py --numerics fixed
"""
import argparse

import numpy as np

from repro_torch.core.pipeline import PipelineConfig, evaluate_detection, run_recording_scan
from repro_torch.core.tracking import confirmed
from repro_torch.data.synthetic import make_recording


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--duration", type=float, default=2.0, help="recording length, s")
    ap.add_argument("--numerics", choices=("float", "fixed"), default="float",
                    help="float32 datapath or the fixed-point one")
    args = ap.parse_args()

    print(f"Generating a {args.duration:g} s synthetic EVAS-like recording (2 RSOs)...")
    rec = make_recording(seed=7, duration_s=args.duration, n_rsos=2, lens="standard")
    print(f"  {len(rec):,} events "
          f"({np.sum(rec.kind == 2):,} RSO / {np.sum(rec.kind == 1):,} star "
          f"/ {np.sum(rec.kind == 0):,} noise)")

    # Paper defaults (16 px cells, min_events=5) on the kernel routes.
    if args.numerics == "fixed":
        cfg = PipelineConfig(numerics="fixed", metrics_impl="megakernel")
    else:
        cfg = PipelineConfig(use_kernels=True, metrics_impl="kernel")
    result = run_recording_scan(rec, cfg, with_tracking=True, device=args.device)
    print(f"Processed {result.num_windows} windows on {args.device}.")
    print(f"Clusters passing min_events=5: {int(result.clusters.valid.sum())}")

    final = result.final_tracks
    conf = confirmed(final, cfg.tracker).cpu().numpy()
    print(f"Confirmed tracks: {int(conf.sum())}")
    for i in np.flatnonzero(conf):
        print(
            f"  track {i}: pos=({float(final.x[i]):6.1f},{float(final.y[i]):6.1f}) "
            f"vel=({float(final.vx[i]):+5.2f},{float(final.vy[i]):+5.2f}) px/win "
            f"hits={int(final.hits[i])} entropy={float(final.entropy[i]):.2f}"
        )

    score = evaluate_detection(rec, cfg, device=args.device)
    print(
        f"Detection accuracy vs ground truth: {100 * score.accuracy:.1f}% "
        f"(tp={score.tp} fp={score.fp} fn={score.fn} tn={score.tn})"
    )


if __name__ == "__main__":
    main()
