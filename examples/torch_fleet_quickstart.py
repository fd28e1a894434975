"""Fleet quickstart on the PyTorch/CUDA port: four live sensors through
one ``FleetPipeline`` on the GPU.

The port's counterpart of ``examples/fleet_quickstart.py``, on the same
scenario-diverse sky: a crossing pair, a GEO slow-mover, a tumbling RSO
and a ballistic arc, each sensor with its own pointing jitter
(``make_fleet_recordings`` over the scenario families). Every round
takes one 20 ms chunk per sensor over the ragged ingest wire, decodes it on the device (the ``event_unpack`` CUDA kernel), and
drives all four sensors through one step: conditioning, clustering (the
``cluster_accum`` kernel), the six metrics (the ``patch_metrics``
kernel) and the tracker, with per-sensor carries riding along between
rounds. Per-sensor results equal four independent
``StreamingPipeline`` runs. With ``--numerics fixed`` the fixed-point
datapath runs instead (the ``window_pipeline`` kernel; its wire decodes
on the plain route, as the reference's does without ``use_kernels``).

  PYTHONPATH=src python examples/torch_fleet_quickstart.py            # on the GPU
  PYTHONPATH=src python examples/torch_fleet_quickstart.py --device cpu
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.pipeline import FleetPipeline, PipelineConfig
from repro_torch.core.tracking import TrackState, confirmed
from repro_torch.data.evas import iter_chunks
from repro_torch.data.synthetic import SCENARIO_FAMILIES, make_fleet_recordings

CHUNK_US = 20_000  # feed 20 ms per sensor per round
FAMILIES = ("crossing", "geo_slow", "tumbling", "ballistic")
N_SENSORS = len(FAMILIES)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--duration", type=float, default=2.0, help="recording length, s")
    ap.add_argument("--numerics", choices=("float", "fixed"), default="float",
                    help="float32 datapath or the fixed-point one")
    args = ap.parse_args()

    print(f"Generating a {N_SENSORS}-sensor scenario-diverse sky ({args.duration:g} s each)...")
    recs = [
        dataclasses.replace(
            make_fleet_recordings(1, scenario=SCENARIO_FAMILIES[fam], seed0=31 * s,
                                  duration_s=args.duration)[0],
            name=f"sensor{s}-{fam}",
        )
        for s, fam in enumerate(FAMILIES)
    ]
    for rec in recs:
        print(f"  {rec.name:<22} {len(rec):>7,} events")

    per_sensor = [list(iter_chunks(r, CHUNK_US)) for r in recs]
    n_rounds = max(len(c) for c in per_sensor)
    if args.numerics == "fixed":
        cfg = PipelineConfig(numerics="fixed", metrics_impl="megakernel")
    else:
        cfg = PipelineConfig(use_kernels=True, metrics_impl="kernel")
    fleet = FleetPipeline(cfg, n_sensors=N_SENSORS, device=args.device)
    sync = torch.cuda.synchronize if fleet.device.type == "cuda" else (lambda: None)

    windows = detections = 0
    latencies = []
    for i in range(n_rounds):
        chunks = [c[i] if i < len(c) else None for c in per_sensor]
        t0 = time.perf_counter()
        out = fleet.feed(chunks)  # one step for the whole fleet
        sync()
        latencies.append((time.perf_counter() - t0) * 1e3)
        windows += out.total_windows
        if out.clusters is not None:
            detections += int(out.clusters.valid.sum())
    tail = fleet.flush()
    windows += tail.total_windows

    print(f"Processed {windows} windows across {N_SENSORS} sensors in {n_rounds} fleet rounds "
          f"on {fleet.device}.")
    print(f"Clusters passing min_events=5: {detections}")
    lat = np.asarray(latencies[3:] or latencies)  # skip the warm-up rounds
    print(f"Per-round latency: p50={np.percentile(lat, 50):.1f} ms "
          f"p99={np.percentile(lat, 99):.1f} ms (paper budget: 62 ms)")
    print(f"Ingest wire: {fleet.wire_stats.compression:.2f}x smaller than dense planes, "
          f"{fleet.wire_stats.spilled} spilled events")

    final = fleet.state.tracks  # leaves (S, T): stacked per-sensor carries
    for s in range(N_SENSORS):
        state = TrackState(*(a[s] for a in final))
        ids = np.flatnonzero(confirmed(state, cfg.tracker).cpu().numpy())
        line = ", ".join(
            f"({float(state.x[i]):5.0f},{float(state.y[i]):5.0f}) hits={int(state.hits[i])}"
            for i in ids
        ) or "none"
        print(f"  sensor {s} ({recs[s].name}): {len(ids)} confirmed tracks: {line}")


if __name__ == "__main__":
    main()
