"""Streaming quickstart on the PyTorch/CUDA port: detect orbiting objects
from a live-style feed on the GPU.

The port's counterpart of ``examples/stream_quickstart.py``. It replays
the same synthetic EVAS-like recording through ``StreamingPipeline`` in
20 ms chunks, the cadence of a live event camera. Each ``feed`` call
windows the incoming events with the paper's dual-threshold policy, runs
one step over the windows that closed (clustering in the
``cluster_accum`` kernel, the six metrics in ``patch_metrics``, then the
tracker) and returns their clusters, quality metrics and tracker state.
The dual-threshold remainder and the tracker carry ride along in
``StreamingPipeline.state`` between calls, so the results equal
``run_recording_scan`` over the same events however the stream is
chunked. With ``--numerics fixed`` the fixed-point datapath runs instead
(the ``window_pipeline`` kernel).

  PYTHONPATH=src python examples/torch_stream_quickstart.py            # on the GPU
  PYTHONPATH=src python examples/torch_stream_quickstart.py --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core.events import stride_bounds
from repro_torch.core.pipeline import PipelineConfig, StreamingPipeline
from repro_torch.core.tracking import confirmed
from repro_torch.data.synthetic import make_recording

CHUNK_US = 20_000  # feed 20 ms of events at a time


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--numerics", choices=("float", "fixed"), default="float",
                    help="float32 datapath or the fixed-point one")
    args = ap.parse_args()

    print("Generating a 2 s synthetic EVAS-like recording (2 RSOs)...")
    rec = make_recording(seed=7, duration_s=2.0, n_rsos=2, lens="standard")
    print(f"  {len(rec):,} events")

    if args.numerics == "fixed":
        cfg = PipelineConfig(numerics="fixed", metrics_impl="megakernel")
    else:  # paper defaults (16 px cells, min_events=5) on the kernel routes
        cfg = PipelineConfig(use_kernels=True, metrics_impl="kernel")
    sp = StreamingPipeline(cfg, with_tracking=True, device=args.device)
    sync = torch.cuda.synchronize if sp.device.type == "cuda" else (lambda: None)

    n_windows = 0
    n_detections = 0
    latencies = []
    for lo, hi, _ in stride_bounds(rec.t, CHUNK_US):
        t0 = time.perf_counter()
        res = sp.feed(rec.x[lo:hi], rec.y[lo:hi], rec.t[lo:hi], rec.p[lo:hi])
        n_det = int(res.clusters.valid.sum())  # reads the step's result
        sync()
        latencies.append((time.perf_counter() - t0) * 1e3)
        n_windows += res.num_windows
        n_detections += n_det
    tail = sp.flush()  # close the trailing partial window
    n_windows += tail.num_windows
    n_detections += int(tail.clusters.valid.sum())

    print(f"Processed {n_windows} windows from {len(latencies)} chunked feeds on {sp.device}.")
    print(f"Clusters passing min_events=5: {n_detections}")
    lat = np.asarray(latencies[3:])  # skip the warm-up feeds
    print(
        f"Steady-state per-chunk latency: p50={np.percentile(lat, 50):.1f} ms "
        f"p99={np.percentile(lat, 99):.1f} ms (paper budget: 62 ms)"
    )

    final = sp.state.tracks
    conf = confirmed(final, cfg.tracker).cpu().numpy()
    print(f"Confirmed tracks: {int(conf.sum())}")
    for i in np.flatnonzero(conf):
        print(
            f"  track {i}: pos=({float(final.x[i]):6.1f},{float(final.y[i]):6.1f}) "
            f"vel=({float(final.vx[i]):+5.2f},{float(final.vy[i]):+5.2f}) px/win "
            f"hits={int(final.hits[i])} entropy={float(final.entropy[i]):.2f}"
        )


if __name__ == "__main__":
    main()
