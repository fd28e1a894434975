#!/usr/bin/env python3
"""Measures the reference's hot-row host view against the fleet's whole
copy on the card, on the serving workloads of ``chip_smoke.py``'s phases 6
and 7: the detection service (float and fixed), the chaos harness (float
and fixed) and the 4-shard constellation, each at the script's widths.

The fleet's ``FleetResult`` copies every row of every stacked leaf to
the host once a round. The reference (``src/repro/core/pipeline/fleet.py``,
``_host_view``) gathers only the hot rows, the slots that closed a window,
when they are fewer than half the slots. This script keeps a copy of that
gather (:func:`gather_view`, one index launch and one device-to-host copy
a leaf, the slot mapped to its gathered row in ``sensor``) and swaps it in
for one arm. Each workload runs with the gather and with the whole copy,
in the order gather, copy, copy, gather. For every run it prints one JSON
line: the share of the fleet rounds whose host view found fewer than half
the slots hot (the rounds the gather serves), the host views' ms summed
over the run, and the rounds' p50, p99 and largest ms (host clock, as the
script times them).

    PYTHONPATH=src python tools/torch_host_view.py

Prints the card's name and power limit first.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402  (puts src/ on the path)


def gather_view(res) -> tuple:
    """The reference's host view: the whole copy when at least half the
    slots closed a window, else only the hot rows, one gather a leaf
    (``res._rows`` maps a slot to its gathered row; a cold slot trims
    ``[:0]`` from row 0). ``final_tracks`` is always copied whole."""
    import numpy as np
    import torch

    from repro_torch.distributed.sharding import assemble

    if res._host is None:
        hot = np.flatnonzero(np.asarray(res.n_windows) > 0)
        if 2 * len(hot) >= len(res.windows):
            take, res._rows = (lambda a: a.cpu()), None
        else:
            index = {}

            def take(a):
                t = assemble(a)
                if t.device not in index:
                    index[t.device] = torch.as_tensor(hot, device=t.device)
                return t[index[t.device]].cpu()

            res._rows = {int(s): i for i, s in enumerate(hot)}
        leaves = lambda tree, fn: None if tree is None else type(tree)(*(fn(a) for a in tree))  # noqa: E731
        res._host = (leaves(res.clusters, take), {k: take(v) for k, v in res.metrics.items()},
                     leaves(res.tracks, take), leaves(res.final_tracks, lambda a: a.cpu()))
    return res._host


def gather_sensor(res, s: int):
    """``FleetResult.sensor`` over :func:`gather_view` (reached through
    ``_host_view``, which :func:`view_arm` times)."""
    from repro_torch.core.pipeline.scan import ScanResult
    from repro_torch.core.pipeline.stream import empty_scan_result
    from repro_torch.core.tracking import TrackState

    n, w = int(res.n_windows[s]), res.windows[s]
    if res.clusters is None:
        carry_s = TrackState(*(a[s].cpu() for a in res._carry_tracks))
        return empty_scan_result(res._config, res._with_tracking, carry_s, w)
    clusters_h, mets_h, tracks_h, final_h = res._host_view()
    row = s if res._rows is None else res._rows.get(s, 0)
    trim = lambda a: a[row, :n]  # noqa: E731
    return ScanResult(
        t_start_us=w.t_start_us,
        clusters=type(clusters_h)(*(trim(a) for a in clusters_h)),
        metrics={k: trim(v) for k, v in mets_h.items()},
        tracks=TrackState(*(trim(a) for a in tracks_h)) if res._with_tracking else None,
        final_tracks=TrackState(*(a[s] for a in final_h)) if res._with_tracking else None,
        windows=w,
    )


@contextlib.contextmanager
def view_arm(gather: bool):
    """The gather swapped in for the whole copy (``gather``), and a clock
    over the host view's first call a round."""
    import numpy as np

    from repro_torch.core.pipeline.fleet import FleetResult

    saved = FleetResult._host_view, FleetResult.sensor
    view = gather_view if gather else saved[0]
    clock = dict(views=0, sparse=0, ms=0.0)

    def timed(res):
        if res._host is not None:
            return res._host
        hot = int((np.asarray(res.n_windows) > 0).sum())
        clock["views"] += 1
        clock["sparse"] += 2 * hot < len(res.windows)
        t0 = time.perf_counter()
        out = view(res)
        clock["ms"] += (time.perf_counter() - t0) * 1e3
        return out

    FleetResult._host_view = timed
    if gather:
        FleetResult.sensor = gather_sensor
    try:
        yield clock
    finally:
        FleetResult._host_view, FleetResult.sensor = saved


def service(cfg, dev):
    sched = C.service_schedule(**C.SERVICE_FULL)
    recs = C.service_recordings(1 + max(k for evs in sched.values() for _, k in evs))
    C.run_service(cfg, recs[:4], C.service_schedule(**C.SERVICE_CUT), 8, dev)  # warm-up
    return lambda: C.round_stats(C.run_service(cfg, recs, sched, C.SERVICE_FULL["rounds"], dev)["ms"])


def chaos(cfg, dev):
    from repro_torch.serve import ChaosConfig, ChaosHarness

    return lambda: C.round_stats(ChaosHarness(ChaosConfig(**C.CHAOS_FULL), cfg, device=dev).run().round_times_ms)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.pipeline import PipelineConfig

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    float_cfg = PipelineConfig(use_kernels=True, metrics_impl="kernel")
    fixed_cfg = PipelineConfig(numerics="fixed", metrics_impl="megakernel")
    workloads = [("service float", service(float_cfg, dev)), ("service fixed", service(fixed_cfg, dev)),
                 ("chaos float", chaos(float_cfg, dev)), ("chaos fixed", chaos(fixed_cfg, dev)),
                 ("constellation", lambda: C.check_constellation(float_cfg, dev)["rounds"])]
    for name, run in workloads:
        for gather in (True, False, False, True):
            with view_arm(gather) as clock:
                stats = run()
            print(json.dumps(dict(workload=name, view="gather" if gather else "whole copy",
                                  views=clock["views"], sparse_share=clock["sparse"] / max(clock["views"], 1),
                                  view_ms=clock["ms"], **stats)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
