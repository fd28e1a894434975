#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Three paths are driven: the float main path (``use_kernels=True,
metrics_impl="kernel"``: the clustering stage is one launch of the
``cluster_accum`` kernel, the metrics stage one of ``patch_metrics``), the
fixed-point path (``numerics="fixed",
metrics_impl="megakernel"``: the ``window_pipeline`` kernel) and the live
ingest path (``FleetPipeline`` over the ragged wire, decoded by the
``event_unpack`` kernel, then the float kernels).

Phases (any failure exits non-zero; no error is caught):

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc``, one
   ``nvcc`` per source, all at once;
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and on adversarial inputs, and time kernel, plain
   version and, where one exists, a one-call library yardstick; this
   includes ``grid_quantize_packed`` and ``window_entropy``, which no
   pipeline route reaches (in the reference neither). Beside the two
   stage kernels, the torch ops each took off its stage are timed on the
   same inputs;
3. each path on the quickstart recording through the entry points
   (``run_recording_scan`` + ``evaluate_detection``), on the card and on
   the CPU: integer outputs equal, the reference counts, and each path's
   launch counters read just after it ran; then a four-sensor fleet of
   quickstart recordings on both devices, float and fixed: integer
   outputs equal across devices and each sensor equal to its scan;
4. each path at real scale (60 s, 20 kHz noise, 5,154 windows): the float
   path's integer outputs equal to the CPU run, the fixed path's equal to
   its staged route on the card; steady-state times of the entry points'
   own functions, and the window core's stages from a profile, which
   requires exactly one device kernel per block in ``"clustering"`` and
   in ``"metrics"`` (so too the fleet profile below). The same
   recording through ``StreamingPipeline(wire="ragged")`` in 20 ms
   chunks, every field equal to its scan on the card, and the
   ``event_unpack`` kernel held against its plain version and timed on
   the wires that stream decoded, one kernel per decode;
   ``cluster_accum`` and ``patch_metrics`` timed per launch on that
   stream's own inputs (1-2 windows a feed), each beside the torch ops it
   took off its stage. Then the fleet at full width: 16
   sensors of 10 s at the scale recording's density, fed in 20 ms chunks
   over the ragged wire; every sensor's outputs equal to its
   ``run_recording_scan`` on the card, field for field, ``feed_async`` at
   depth 2 equal to ``feed``; per-round latency, windows per second, the
   wire's compression and the decode's share of a round under the
   profiler;
5. every kernel of each path was launched on it;
6. the detection service (``DetectionService``) on the float kernel and
   the fixed megakernel config: sessions of the five balanced scenario
   families, 2.5 s each, 4 growing to 16 (promotions 4 -> 8 -> 16), then
   the oldest out and a new one in every 12 rounds, 120 rounds of 20 ms
   under ``AdmissionConfig(0.02, 250 * 16)``: every session, detach tail
   included, equal to a dedicated ``StreamingPipeline`` on the card;
   depth 2 equal to depth 1; a 4-session 40-round cut equal between the
   card and the CPU; no step retry and no degraded round; the path's
   kernels launched; per-round latency and windows per second. Then a
   session exported on the card and adopted by a CPU service (and the
   other way), equal to a never-migrated stream; Table I
   (``grid_cluster``, ``kmeans``, ``dbscan``) timed on the card with
   DBSCAN's labels equal to the CPU's, and ``quantize_packed`` on the
   scale recording's words equal to ``grid_quantize_packed``;
7. fault injection and scale-out serving: (a) on both datapaths the
   chaos harness (``ChaosHarness``) at 16 sensors, 4 faulty, 120 rounds
   of 400 events: every fault kind fired, none escaped, the healthy
   sessions bit-identical to the fault-free twin, shed accounting exact,
   quarantines, evictions and a retry or degraded round; a
   step_exception-only run with retries and degraded rounds, bit for bit;
   a 5-sensor 32-round cut with equal reports and outputs on the card and
   the CPU; (b) ``ConstellationService``, float path, 4 shards on the
   card, 32 sessions with churn, a migration, a forced rebalance and
   shard 3 stalled, rescued and revived: every session equal to a
   dedicated ``StreamingPipeline`` on the card, none lost, the int8
   exchange within its per-round bound and telescoping identity; (c) the
   shard chaos harness (``ShardChaosHarness``), 4 shards, 16 sensors, 96
   rounds: bit-identical, a rescue, no lost session, nothing escaped.
   Each run's launch counters are set to 0 just before it; the slowest
   faulted rounds are printed with the fault kinds scheduled in them.

Since the loop driver and the accuracy sweep were ported, phase 2 also
holds both stage kernels past their small path (E = 1025, 4096 and
20,000; K = 160; a cell table outside shared memory; cell t sums past
2^24, centroid_t within its stated bound) and times them on the scale
recording's 100 ms stride windows at capacity 4096; phase 3 also runs the
loop driver (``run_recording``) on the quickstart recording, equal window
for window to the scan with one launch per window of each path kernel,
and ``threshold_sweep(make_validation_suite())`` with the scan and the
fleet driver on both datapaths, equal to the JAX reference's scores; phase
4 also runs the scale recording in those stride windows, equal to the CPU
run.

Then one JSON line of per-kernel numbers (with each path kernel's
launches in phase 6's depth-1 service run as ``service_launches``, in
phase 7a's chaos run as ``chaos_launches``, in 7b as
``constellation_launches`` and in 7c as ``shard_chaos_launches``), the
card's name and power limit, and last ``{"ok": true, "device": {...}}``. In that line a path
kernel's ``launches`` count one pass of the scale recording through its
path's driver (``LAUNCH_BASIS``), and its times are per launch of that
pass: ``ms`` the kernels alone under the profiler, ``call_ms`` the
wrapper's call under CUDA events; ``score_ms`` is launches x (ms -
bound_ms), the ranking of the next redesign. The rows of
``cluster_accum`` and ``patch_metrics`` carry the same numbers for the
ragged stream under ``stream``, and ``removed_ops_ms``, the torch ops the
kernel took off its stage, per launch on the same inputs; the row of
``cluster_accum`` (its stage entry, which the path launches) also carries
its rows entry against ``index_add_`` under ``rows_entry``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and the
# float32 rate outside the tensor cores (an FMA counted as two), which the
# float kernels' arithmetic uses. The data sheet gives no 32-bit integer
# rate: an SM has 64 INT32 lanes against 128 FP32 lanes, so a quarter of
# the float32 figure, one operation a lane a clock. The window_pipeline
# kernel's work is integer.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
PEAK_INT32_S = PEAK_OPS_S / 4
RTOL = ATOL = 1e-5  # order-dependent float32 reductions and log2 (see tests)
TRACK_RTOL, TRACK_ATOL = 1e-6, 1e-4
QUICKSTART = dict(seed=7, duration_s=2.0, n_rsos=2)
QUICKSTART_EXPECT = dict(windows=100, valid=203, confirmed=2, tp=199, fp=4, fn=5, tn=562)
FLOAT_KERNELS = ("cluster_accum", "patch_metrics")
FIXED_KERNELS = ("window_pipeline",)
FLEET_KERNELS = ("event_unpack", "cluster_accum", "patch_metrics")
NO_PATH = ("grid_quantize_packed", "window_entropy")  # tests only, as in the reference
REPLACES = {
    "cluster_accum": "src/repro/kernels/cluster_accum.py:69",
    "patch_metrics": "src/repro/kernels/patch_metrics.py:80",
    "window_pipeline": "src/repro/kernels/window_pipeline.py:230",
    "event_unpack": "src/repro/kernels/event_unpack.py:32",
    "grid_quantize_packed": "src/repro/kernels/grid_quantize.py:41",
    "window_entropy": "src/repro/kernels/window_entropy.py:49",
}
# What a path kernel's launches count: one pass of the scale recording
# through the driver of the kernel's path. Its times are per launch of
# that pass (mean over the launches timed).
LAUNCH_BASIS = {
    "cluster_accum": "run_recording_scan of the scale recording (float); timed on its blocks",
    "patch_metrics": "run_recording_scan of the scale recording (float); timed on its blocks",
    "window_pipeline": "run_recording_scan of the scale recording (fixed); timed on its blocks",
    "event_unpack": "StreamingPipeline(wire='ragged') of the scale recording in 20 ms chunks; "
                    "timed on its wires",
}
SOURCE = {name: f"src/repro_torch/kernels/csrc/{name}.cu" for name in REPLACES}
SOURCE["grid_quantize_packed"] = "src/repro_torch/kernels/csrc/grid_quantize.cu"
SCALE = dict(seed=11, duration_s=60, n_rsos=4, noise_rate_hz=20_000)
# The fleet at full width: the scale recording's density, cut from 60 s
# to 10 s for the time limit; sensor s has seed 11 + s.
FLEET = dict(duration_s=10, n_rsos=4, noise_rate_hz=20_000)
FLEET_SENSORS = 16  # DEFAULT_TIERS' third tier
FLEET_QUICK = dict(duration_s=2.0, n_rsos=2)  # sensor s has seed 20 + s
CHUNK_US = 20_000
BUDGET_MS = 62.0  # the paper's per-window deterministic budget
# Past the stage kernels' small path (E <= 1024, K <= 128): E one over it,
# the stride windows' capacity, and past the 227 KB of shared memory that
# patch_metrics' events and keys fit in; K = 160.
LARGE_E = (1025, 4096, 20_000)
LARGE_K = 160
# The scale recording in 100 ms stride windows at capacity 4096 (about
# 2,150 events a window): the stage kernels' large path on real sky.
STRIDE_US = 100_000
STRIDE_CAPACITY = 4096
# threshold_sweep(make_validation_suite()) of the JAX reference on the CPU
# (default config): tp, fp, fn, tn per min_events threshold.
SWEEP_THRESHOLDS = (2, 3, 4, 5, 6, 8, 10)
SWEEP_EXPECT = {2: (4246, 12974, 78, 0), 3: (3912, 2804, 87, 10170), 4: (3640, 647, 140, 12327),
                5: (3386, 129, 253, 12845), 6: (3120, 20, 435, 12954), 8: (2536, 0, 933, 12974),
                10: (1843, 0, 1608, 12974)}
ENTROPY_RTOL, ENTROPY_ATOL = 1e-5, 1e-7  # order-dependent float32 sums, log2f
# Phase 6, the detection service: sessions of make_fleet_recordings over
# the five balanced families, 2.5 s each at the paper's widths; start with
# 4 sessions, attach one every 4 rounds up to 16 (4 -> 8 -> 16), then
# detach the oldest and attach a new one every 12 rounds; 120 rounds of
# 20 ms. The cut runs 4 sessions for 40 rounds on both devices.
SERVICE_FAMILIES = ("crossing", "geo_slow", "tumbling", "ballistic", "jitter")
SERVICE_DURATION_S = 2.5
SERVICE_TIERS = (4, 8, 16, 32)
SERVICE_FULL = dict(max_sessions=16, rounds=120)
SERVICE_CUT = dict(max_sessions=4, rounds=40)
SERVICE_START, SERVICE_GROW_EVERY, SERVICE_CHURN_EVERY = 4, 4, 12
SERVICE_KERNELS = {"float": FLEET_KERNELS, "fixed": FIXED_KERNELS}
# Table I at the sizes of benchmarks/table1_algorithms.py, plus n = 4096.
TABLE1_GRID_N = (64, 128, 256, 512, 1024, 4096)
TABLE1_BASELINE_N = (64, 128, 256, 512, 4096)
# Phase 7, fault injection and scale-out serving. 7a: the chaos harness
# at 16 sensors (4 faulty), 400 events per 20 ms round (the scale
# recording's 20 kHz), 6,000-event bursts over a 3,200-event queue
# budget; its cut runs on the card and on the CPU. 7b: 32 sessions over
# 4 constellation shards on the one card, 120 rounds: every 12 rounds the
# oldest session leaves and a new one joins; a migrate at round 30, a
# forced rebalance at 60, shard 3 stalled over rounds 80-85 (rescued),
# revived at 100. 7c: the shard chaos harness at the same widths.
CHAOS_FULL = dict(n_sensors=16, n_faulty=4, n_rounds=120, seed=7, chunk_events=400,
                  burst_events=6000, queue_budget_events=3200, tiers=(4, 8, 16, 32))
CHAOS_CUT = dict(n_sensors=5, n_rounds=32, tiers=(4, 8))
CONST_SHARDS, CONST_TIERS, CONST_SESSIONS, CONST_ROUNDS = 4, (4, 8, 16), 32, 120
CONST_CHURN_EVERY, CONST_MIGRATE_AT, CONST_REBALANCE_AT = 12, 30, 60
CONST_STALL_SHARD, CONST_STALL, CONST_REVIVE_AT = 3, (80, 85), 100
SHARD_CHAOS = dict(n_shards=4, n_sensors=16, n_faulty=4, n_rounds=96, seed=7, chunk_events=400,
                   burst_events=6000, queue_budget_events=3200)


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def kernel_device_ms(fn, names, iters: int = 20) -> float:
    """Device time per call of the kernels whose names contain one of
    ``names``, from ``torch.profiler`` over ``iters`` calls of ``fn()``:
    the kernels alone, without the host time between launches that
    :func:`cuda_ms` includes when the wrapper's host work is the longer."""
    return kernel_device_profile(fn, names, iters)[0]


def kernel_device_profile(fn, names, iters: int = 20, expect: int = 1) -> tuple[float, float]:
    """:func:`kernel_device_ms`, and the number of those kernels the
    device ran per call of ``fn()``. Now and then a session loses device
    records (it never adds any): a session that holds fewer than
    ``expect`` of those kernels per call is profiled again, up to twice,
    and the fullest session counts."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ran = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and any(n in e.name for n in names)]
        if len(ran) > len(best):
            best = ran
        if len(best) >= expect * iters:
            break
    return sum(e.device_time_total for e in best) / 1e3 / iters, len(best) / iters


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def equal(a, b, what: str) -> float:
    """Require ``a == b`` elementwise; returns the max abs difference."""
    import torch

    a, b = a.cpu(), b.cpu()
    require(a.shape == b.shape, f"{what}: shapes {tuple(a.shape)} vs {tuple(b.shape)}")
    diff = torch.nonzero(a != b)
    require(
        len(diff) == 0,
        f"{what}: {len(diff)} of {a.numel()} differ, first at {diff[:3].tolist()}: "
        f"{a[tuple(diff[0])].item()} vs {b[tuple(diff[0])].item()}, largest difference "
        f"{float((a.double() - b.double()).abs().max())}" if len(diff) else "",
    )
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def close(a, b, what: str, rtol: float = RTOL, atol: float = ATOL) -> float:
    import torch

    a, b = a.cpu().double(), b.cpu().double()
    require(a.shape == b.shape, f"{what}: shapes {tuple(a.shape)} vs {tuple(b.shape)}")
    err = float((a - b).abs().max()) if a.numel() else 0.0
    require(torch.allclose(a, b, rtol=rtol, atol=atol), f"{what}: max abs err {err}")
    return err


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions.
# ---------------------------------------------------------------------------

def stage_cases(dev) -> list:
    """(name, batch) adversarial cases for the two stage kernels and the
    megakernel: the adversarial windows, the six named windows, runs and
    ties, E = 1024."""
    from repro_torch.data.adversarial import (
        adversarial_batch, clustered_window, named_windows, run_and_tie_windows, stacked_batch,
    )

    return [
        ("adversarial", adversarial_batch(dev)),
        ("six named windows", stacked_batch(list(named_windows().values()), dev)),
        ("runs and ties", stacked_batch(run_and_tie_windows(), dev)),
        ("E = 1024", stacked_batch([clustered_window(s, n=1000, capacity=1024) for s in range(4)], dev)),
    ]


def topk_grids() -> list:
    """The grids the clustering stage entry is held to: cell sizes 16 and
    12 at min_events 5, 1 and 0; K = 128; grids smaller than the sensor."""
    from repro_torch.core.grid_clustering import GridConfig
    from repro_torch.data.adversarial import ClippedGrid

    return [GridConfig(cell_size=cs, min_events=me) for cs in (16, 12) for me in (5, 1, 0)] + [
        GridConfig(min_events=0, max_clusters=128), GridConfig(cell_size=12, max_clusters=128),
        ClippedGrid(), ClippedGrid(cell_size=12, cols=40, rows=30, min_events=1)]


def compare_metrics(got: dict, want: dict, what: str) -> float:
    """event_count and edge_density identical, the other four within
    RTOL/ATOL; returns the largest absolute difference."""
    from repro_torch.core import metrics as M

    err = 0.0
    for m in M.METRIC_NAMES:
        check = equal if m in ("event_count", "edge_density") else close
        err = max(err, check(got[m], want[m], f"{what}: {m}"))
    return err


def check_kernels(dev, blocks) -> dict:
    """Hold both stage kernels against their plain versions, on
    adversarial windows and on every ``(batch, clusters)`` block of the
    main path; time them on each block, per launch (the mean over the
    blocks), beside the torch ops each took off its stage."""
    import torch

    from repro_torch.core import metrics as M
    from repro_torch.core.grid_clustering import GridConfig, clusters_from_histogram
    from repro_torch.data.adversarial import edge_slot_clusters
    from repro_torch.kernels import cluster_accum as _ca
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import patch_metrics as _pm

    cases = stage_cases(dev)
    main = [(f"main path block {i}", b) for i, (b, _) in enumerate(blocks)]
    results = {}

    # cluster_accum, rows entry: exact, at cell sizes 16 and 12.
    err_ca = 0.0
    for cs in (16, 12):
        g = GridConfig(cell_size=cs)
        kw = dict(cell_size=cs, grid_w=g.grid_w, grid_h=g.grid_h, width=640, height=480)
        for name, b in cases[:1] + main:
            got = ops.cluster_accum(b.x, b.y, b.t, b.valid, **kw)
            exp = ref.cluster_accum_ref(b.x, b.y, b.t, b.valid, **kw)
            for field, a, e in zip(("count", "sum_x", "sum_y", "sum_t"), got, exp):
                err_ca = max(err_ca, equal(a, e, f"cluster_accum {field} ({name}, cell_size={cs})"))
    log("  cluster_accum, rows entry: identical to the plain version (adversarial + main path, "
        "cell 16 and 12)")
    # cluster_accum, stage entry: every field, every grid, every case.
    for g in topk_grids():
        for name, b in cases + main:
            before = ops.LAUNCHES["cluster_accum"]
            got = ops.cluster_accum_topk(b.x, b.y, b.t, b.valid, g)
            require(ops.LAUNCHES["cluster_accum"] == before + 1, f"cluster_accum_topk ({name}): not one launch")
            want = ref.cluster_accum_topk_ref(b.x, b.y, b.t, b.valid, g)
            for f in got._fields:
                err_ca = max(err_ca, equal(getattr(got, f), getattr(want, f),
                                           f"cluster_accum_topk {f} ({name}, {g})"))
    log(f"  cluster_accum, stage entry: every field identical to clusters_from_histogram of the "
        f"plain rows ({', '.join(n for n, _ in cases)}, main path; cell 16 and 12, min_events 5, 1 "
        f"and 0, K 32 and 128, grids smaller than the sensor)")

    # patch_metrics: the adversarial cases with clusters at min_events=1
    # plus corner and invalid slots, and the main path's blocks.
    err_pm = 0.0
    for name, b, cl in [(n, b, edge_slot_clusters(b)) for n, b in cases] + [
            (f"main path block {i}", b, cl) for i, (b, cl) in enumerate(blocks)]:
        before = ops.LAUNCHES["patch_metrics"]
        got = ops.patch_metrics(b, cl)
        require(ops.LAUNCHES["patch_metrics"] == before + 1, f"patch_metrics ({name}): not one launch")
        err_pm = max(err_pm, compare_metrics(
            got, ref.patch_metrics_stage_ref(b, cl, width=640, height=480), f"patch_metrics ({name})"))
    log(f"  patch_metrics: event_count/edge_density identical, others max abs err {err_pm:.3e} "
        f"({', '.join(n for n, _ in cases)}, main path)")

    # Timing on each of the main path's blocks: one launch per block.
    ca_rows, pm_rows, rows_rows = [], [], []
    g = GridConfig()
    kw = dict(cell_size=16, grid_w=g.grid_w, grid_h=g.grid_h, width=640, height=480)
    n_cells = g.n_cells
    for b, cl in blocks:
        n_win, e = b.x.shape
        args = (b.x, b.y, b.t, b.valid, g)
        ca = lambda: _ca.cluster_accum_topk(*args)  # noqa: E731
        rows = ref.cluster_accum_ref(b.x, b.y, b.t, b.valid, **kw)
        ca_rows.append(dict(
            ms=kernel_device_ms(ca, ("cluster_accum_kernel",)), call_ms=cuda_ms(ca),
            plain_ms=cuda_ms(lambda: ref.cluster_accum_topk_ref(*args)), library_ms=None,
            removed_ms=cuda_ms(lambda: clusters_from_histogram(*rows, g)),
            **cluster_accum_topk_cost(*args), shape=(n_win, e),
        ))
        # The rows entry against its one-call yardstick: one index_add_ of
        # the (E, 4) stats into (W * n_cells, 4).
        ra = lambda: _ca.cluster_accum(b.x, b.y, b.t, b.valid, **kw)  # noqa: E731
        wf = ((b.x >= 0) & (b.x < 640) & (b.y >= 0) & (b.y < 480) & b.valid).float()
        flat = ((b.y // 16) * g.grid_w + (b.x // 16)).clamp(0, n_cells - 1).long()
        flat = (flat + n_cells * torch.arange(n_win, device=dev)[:, None]).reshape(-1)
        stats = torch.stack([wf, wf * b.x, wf * b.y, wf * b.t], -1).reshape(-1, 4)
        acc = torch.zeros((n_win * n_cells, 4), device=dev)
        rows_rows.append(dict(
            ms=kernel_device_ms(ra, ("cluster_accum_kernel",)), call_ms=cuda_ms(ra),
            plain_ms=cuda_ms(lambda: ref.cluster_accum_ref(b.x, b.y, b.t, b.valid, **kw)),
            library_ms=cuda_ms(lambda: acc.zero_().index_add_(0, flat, stats)),
            **cluster_accum_cost(b.x, b.y, b.valid, **kw), shape=(n_win, e),
        ))

        pm = lambda: _pm.patch_metrics(b, cl, width=640, height=480)  # noqa: E731
        pm_rows.append(dict(
            ms=kernel_device_ms(pm, ("patch_metrics_kernel",)), call_ms=cuda_ms(pm),
            plain_ms=cuda_ms(lambda: ref.patch_metrics_stage_ref(b, cl, width=640, height=480),
                             iters=3, warmup=1),
            library_ms=None,
            removed_ms=cuda_ms(lambda: (M.event_normalizer(b, 640, 480), M.window_origin(
                cl.centroid_x, cl.centroid_y, 640, 480))),
            **patch_metrics_cost(b, cl, width=640, height=480), shape=(n_win, e),
        ))
    results["cluster_accum"] = dict(per_launch(ca_rows), max_abs_err=err_ca)
    results["patch_metrics"] = dict(per_launch(pm_rows), max_abs_err=err_pm)
    rows_entry = per_launch(rows_rows)
    for name, r in list(results.items()) + [("cluster_accum, rows entry", rows_entry)]:
        bound(r)
        log_kernel(name, r)
    results["cluster_accum"]["rows_entry"] = {k: rows_entry[k] for k in (
        "ms", "call_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
    log("  torch ops the stage kernels took off their stages, per launch on the same blocks "
        "(CUDA events): clustering (sort, gathers, wheres of clusters_from_histogram) "
        f"{results['cluster_accum']['removed_ms']:.4f} ms, metrics (event_normalizer + "
        f"window_origin) {results['patch_metrics']['removed_ms']:.4f} ms")
    return results


def within_centroid_t_bound(got, want, abs_t, grid, what: str) -> float:
    """Every cluster field of ``got`` identical to ``want``'s but
    centroid_t, which is held to ``ref.centroid_t_bound`` of each valid
    slot's cell (identical where the cell's t sum is below 2^24).
    ``abs_t`` is the cells' exact sum of |t|. Returns the largest
    centroid_t difference."""
    import torch

    from repro_torch.kernels import ref

    for f in got._fields:
        if f != "centroid_t":
            equal(getattr(got, f), getattr(want, f), f"{what}: {f}")
    cell = (want.cell_y * grid.grid_w + want.cell_x).clamp_min(0).long()
    lim = torch.where(want.valid, ref.centroid_t_bound(want.count, abs_t.gather(-1, cell)), 0.0)
    diff = (got.centroid_t.to(want.centroid_t.device).double() - want.centroid_t.double()).abs()
    require(bool((diff <= lim).all()), f"{what}: centroid_t beyond its bound by "
            f"{float((diff - lim).max())}")
    return float(diff.max()) if diff.numel() else 0.0


def check_large_sizes(dev) -> dict:
    """Both stage kernels past their small path (E <= 1024, K <= 128),
    against their plain versions on the card: E in ``LARGE_E`` at K = 32
    and 160 (cell 16; cell 12 at min_events 0), K2's cell table outside
    shared memory (cell 4) and the hand-built window whose cell t sums
    pass 2^24. Every integer field identical, centroid_t and sum_t within
    their stated bounds, K3's metrics at the stated tolerances. Returns
    the largest difference of each kernel and of centroid_t."""
    from repro_torch.core.grid_clustering import GridConfig
    from repro_torch.data.adversarial import (
        edge_slot_clusters, large_windows, stacked_batch, sum_t_window,
    )
    from repro_torch.kernels import ops, ref

    err = {"cluster_accum": 0.0, "patch_metrics": 0.0, "centroid_t": 0.0}
    grids = [GridConfig(), GridConfig(min_events=1, max_clusters=LARGE_K),
             GridConfig(cell_size=12, min_events=0, max_clusters=LARGE_K)]
    cases = [(f"E = {e}", stacked_batch(large_windows(e, n_windows=2 if e > 4096 else 3), dev),
              list(grids)) for e in LARGE_E]
    cases[1][2].append(GridConfig(cell_size=4, min_events=1, max_clusters=LARGE_K))
    cases.append(("sum_t window", stacked_batch([sum_t_window()], dev), grids[:2]))
    for name, b, gs in cases:
        for g in gs:
            kw = dict(cell_size=g.cell_size, grid_w=g.grid_w, grid_h=g.grid_h, width=640, height=480)
            abs_t = ref.abs_t_rows(b.x, b.y, b.t, b.valid, **kw)
            before = ops.LAUNCHES["cluster_accum"]
            got = ops.cluster_accum_topk(b.x, b.y, b.t, b.valid, g)
            require(ops.LAUNCHES["cluster_accum"] == before + 1, f"cluster_accum_topk ({name}): not one launch")
            want = ref.cluster_accum_topk_ref(b.x, b.y, b.t, b.valid, g)
            err["centroid_t"] = max(err["centroid_t"], within_centroid_t_bound(
                got, want, abs_t, g, f"cluster_accum_topk ({name}, {g})"))
            rows = ops.cluster_accum(b.x, b.y, b.t, b.valid, **kw)
            plain = ref.cluster_accum_ref(b.x, b.y, b.t, b.valid, **kw)
            for field, a, e in zip(("count", "sum_x", "sum_y"), rows, plain):
                err["cluster_accum"] = max(err["cluster_accum"], equal(a, e, f"cluster_accum {field} ({name}, {g})"))
            lim = ref.sum_t_bound(plain[0], abs_t)
            diff = (rows[3].double() - plain[3].double()).abs()
            require(bool((diff <= lim).all()), f"cluster_accum sum_t ({name}, {g}): beyond its bound")
        for k in (32, LARGE_K):
            cl = edge_slot_clusters(b, k)
            before = ops.LAUNCHES["patch_metrics"]
            got = ops.patch_metrics(b, cl)
            require(ops.LAUNCHES["patch_metrics"] == before + 1, f"patch_metrics ({name}): not one launch")
            err["patch_metrics"] = max(err["patch_metrics"], compare_metrics(
                got, ref.patch_metrics_stage_ref(b, cl, width=640, height=480), f"patch_metrics ({name}, K = {k})"))
    log(f"  large sizes (E {', '.join(map(str, LARGE_E))}; K 32 and {LARGE_K}; K2's table outside shared "
        f"memory at cell 4; the sum_t window): cluster_accum's integer fields and both entries' sums "
        f"identical but t (centroid_t within its bound, largest difference {err['centroid_t']:.3g} us); "
        f"patch_metrics event_count/edge_density identical, others max abs err {err['patch_metrics']:.3e}")
    return err


def stride_blocks(rec, cfg, dev):
    """``rec`` in ``STRIDE_US`` stride windows at ``STRIDE_CAPACITY``,
    conditioned and clustered as the scan's window core does it: the
    ``(batch, clusters)`` blocks the stage kernels see there, and the
    windows."""
    import dataclasses

    from repro_torch.core.events import BatcherConfig, EventBatch, pad_windows
    from repro_torch.core.pipeline import config as C
    from repro_torch.core.pipeline.scan import WINDOW_BLOCK
    from repro_torch.core.pipeline.window_core import _cluster, _condition

    cfg = dataclasses.replace(cfg, batcher=BatcherConfig(capacity=STRIDE_CAPACITY))
    win = pad_windows(rec.x, rec.y, rec.t, rec.p, cfg.batcher, dev, policy="stride", window_us=STRIDE_US)
    n = win.batch.x.shape[0]
    raws = [EventBatch(*(a[lo:lo + WINDOW_BLOCK] for a in win.batch)) for lo in range(0, n, WINDOW_BLOCK)]
    conditioned = [_condition(cfg, r) for r in raws]
    return [(b, _cluster(cfg, C._histogram_fn(cfg), b)) for b in conditioned], win, cfg


def time_large(blocks) -> dict:
    """Both stage kernels per launch on the stride windows' blocks (E =
    4,096, the large path), beside their bounds and plain versions."""
    from repro_torch.core.grid_clustering import GridConfig
    from repro_torch.kernels import cluster_accum as _ca
    from repro_torch.kernels import patch_metrics as _pm
    from repro_torch.kernels import ref

    g = GridConfig()
    ca_rows, pm_rows = [], []
    for b, cl in blocks:
        args = (b.x, b.y, b.t, b.valid, g)
        ca = lambda: _ca.cluster_accum_topk(*args)  # noqa: E731
        ca_rows.append(dict(
            ms=kernel_device_ms(ca, ("cluster_accum_kernel",)), call_ms=cuda_ms(ca),
            plain_ms=cuda_ms(lambda: ref.cluster_accum_topk_ref(*args)), library_ms=None,
            **cluster_accum_topk_cost(*args), shape=tuple(b.x.shape)))
        pm = lambda: _pm.patch_metrics(b, cl, width=640, height=480)  # noqa: E731
        pm_rows.append(dict(
            ms=kernel_device_ms(pm, ("patch_metrics_kernel",)), call_ms=cuda_ms(pm),
            plain_ms=cuda_ms(lambda: ref.patch_metrics_stage_ref(b, cl, width=640, height=480),
                             iters=3, warmup=1),
            library_ms=None, **patch_metrics_cost(b, cl, width=640, height=480), shape=tuple(b.x.shape)))
    out = {}
    for name, rows in (("cluster_accum", ca_rows), ("patch_metrics", pm_rows)):
        r = per_launch(rows)
        bound(r)
        log_kernel(f"{name}, large path (the scale recording's {STRIDE_US // 1000} ms stride windows)", r)
        out[name] = r
    return out


def cluster_accum_cost(x, y, valid, *, cell_size, grid_w, grid_h, width, height) -> dict:
    """Bytes and operations the rows entry must move and do on these
    ``(W, E)`` events: x, y and valid of every event and t of each
    in-sensor valid event read, four ``(n_cells,)`` rows written."""
    n_win, e = x.shape
    n_cells = grid_w * grid_h
    inb = int(((x >= 0) & (x < width) & (y >= 0) & (y < height) & valid).sum())
    return dict(bytes=n_win * e * (4 + 4 + 1) + inb * 4 + n_win * n_cells * 16,
                ops=n_win * e * 12 + n_win * n_cells * 4)


def cluster_accum_topk_cost(x, y, t, valid, grid) -> dict:
    """Bytes and operations the stage entry must move and do on these
    ``(W, E)`` events: x, y and valid of every event and t of each
    in-sensor valid event read, the seven ``(W, K)`` fields written (25
    bytes a slot). Operations: 12 per event (mask, quantize, four sums),
    a pass over the cells (2 each) and a sort of each window's counted
    cells (2 log2 n per cell), about 10 per slot for its fields."""
    from repro_torch.kernels import ref

    n_win, e = x.shape
    k = grid.max_clusters
    inb = int(((x >= 0) & (x < grid.width) & (y >= 0) & (y < grid.height) & valid).sum())
    count = ref.cluster_accum_ref(x, y, t, valid, cell_size=grid.cell_size, grid_w=grid.grid_w,
                                  grid_h=grid.grid_h, width=grid.width, height=grid.height)[0]
    n_cand = (count >= max(grid.min_events, 1)).sum(-1).double()  # (W,)
    sort_ops = int((2 * n_cand * n_cand.clamp_min(2).log2().ceil()).sum())
    return dict(bytes=n_win * e * 9 + inb * 4 + n_win * k * 25,
                ops=n_win * e * 12 + n_win * grid.grid_w * grid.grid_h * 2 + sort_ops + n_win * k * 10)


def patch_metrics_cost(batch, clusters, *, width, height) -> dict:
    """Bytes and operations the metrics stage must move and do on these
    arguments. Bytes: x, y and valid of the events of each window that
    holds a valid slot, the valid flag of every slot, centroids and count
    of each valid slot, six floats out per slot. Operations: per window
    that holds a valid slot, a sort of its w in-sensor valid events (2
    log2 w each) and about 8 per such event for the runs, c, leaders and
    bins; per valid slot, a binary search of the sorted events for each of
    its 48 patch rows (2 log2 w each), ~8 per event inside its patch
    (offsets, compares, atomics: only the events the patch holds, not the
    window's), ~25 per pixel for the Sobel, e2, sqrt and three
    reductions, 2 per pixel for the edge pass, ~320 for the epilogue."""
    from repro_torch.core import metrics as M

    n_win, e = batch.x.shape
    k = clusters.valid.shape[-1]
    busy = clusters.valid.any(-1)
    n_valid = int(clusters.valid.sum())
    n_busy = int(busy.sum())
    inb = batch.valid & (batch.x >= 0) & (batch.x < width) & (batch.y >= 0) & (batch.y < height)
    w = inb[busy].sum(-1).double()  # (busy,)
    sort_ops = int((w * (2 * w.clamp_min(2).log2().ceil() + 8)).sum())
    x0, y0 = M.window_origin(clusters.centroid_x, clusters.centroid_y, width, height)
    wi, ki = clusters.valid.nonzero(as_tuple=True)  # the valid slots
    dx = batch.x[wi] - x0[wi, ki][:, None]
    dy = batch.y[wi] - y0[wi, ki][:, None]
    in_patch = int((inb[wi] & (dx >= 0) & (dx < M.WINDOW) & (dy >= 0) & (dy < M.WINDOW)).sum())
    w_slot = inb[wi].sum(-1).double()
    search_ops = int((M.WINDOW * 2 * w_slot.clamp_min(2).log2().ceil()).sum())
    return dict(bytes=n_busy * e * 9 + n_win * k * (1 + 24) + n_valid * 12,
                ops=sort_ops + search_ops + 8 * in_patch + n_valid * (27 * M.WINDOW * M.WINDOW + 320),
                valid_slots=n_valid, busy_windows=n_busy)


def per_launch(rows: list[dict]) -> dict:
    """The mean over one launch each of ``rows`` (times, bytes,
    operations; counts summed), so a row's numbers are per launch of the
    run they stand for."""
    out = {}
    for key, v in rows[0].items():
        vals = [r[key] for r in rows]
        if key == "shape":
            out[key] = " + ".join(str(tuple(a)) for a in vals)
        elif key in ("valid_slots", "busy_windows"):
            out[key] = sum(vals)
        elif v is None:
            out[key] = None
        else:
            out[key] = sum(vals) / len(vals)
    out["n_launches_timed"] = len(rows)
    return out


def compare_fixed(got, want, what: str) -> float:
    """``(FixedClusters, metrics, surfaces)`` of the kernel and of the plain
    version: every field, the six metrics to the bit, the normalizer, and
    the surfaces of valid slots (the kernel writes zeros for the rest).
    Returns the largest absolute difference over all of them, the metrics
    compared as floats after their bits."""
    import torch

    (fc, mets, surf), (rfc, rmets, rsurf) = got, want
    err = 0.0
    for f in fc._fields:
        err = max(err, equal(getattr(fc, f), getattr(rfc, f), f"{what}: {f}"))
    for m in mets:
        equal(mets[m].view(torch.int32), rmets[m].view(torch.int32), f"{what}: {m}")
        err = max(err, equal(mets[m], rmets[m], f"{what}: {m}"))
    err = max(err, equal(surf["norm_i"], rsurf["norm_i"], f"{what}: norm_i"))
    for k in surf:
        if k != "norm_i":
            err = max(err, equal(surf[k][fc.valid], rsurf[k][fc.valid], f"{what}: {k} of valid slots"))
    return err


def check_window_pipeline(dev, raw_blocks, cfg) -> dict:
    """Hold the fixed-point megakernel against its plain version (the
    staged path) to the bit, on the main path's raw blocks and on
    adversarial windows; time it on each block, per launch."""
    import dataclasses

    from repro_torch.core.grid_clustering import GridConfig
    from repro_torch.data.adversarial import ClippedGrid
    from repro_torch.kernels import ops, ref

    c12 = dataclasses.replace(cfg, grid=GridConfig(cell_size=12))
    cases = []
    for name, b in [(f"main path block {i}", b) for i, b in enumerate(raw_blocks)] + stage_cases(dev):
        cases += [(name, b, cfg), (f"{name}, cell 12", b, c12)]
    ties = dict(stage_cases(dev))["runs and ties"]
    cases += [
        ("runs and ties, cell 12, min_events 1", ties, dataclasses.replace(
            cfg, grid=GridConfig(cell_size=12, min_events=1))),
        ("runs and ties, min_events 0", ties, dataclasses.replace(cfg, grid=GridConfig(min_events=0))),
        ("runs and ties, clipped grid", ties, dataclasses.replace(cfg, grid=ClippedGrid())),
    ]
    err = 0.0
    for name, b, c in cases:
        err = max(err, compare_fixed(
            ops.window_pipeline(b, c), ref.window_pipeline_ref(b, c), f"window_pipeline ({name})"))
    log("  window_pipeline: fields, metrics and valid-slot surfaces identical to the plain version "
        "(main path, six named windows, adversarial, capacity 1024, runs and ties; cell 16 and 12; "
        "min_events 5, 1 and 0; a grid smaller than the sensor)")

    g = cfg.grid
    k = g.max_clusters
    kw = dict(roi=tuple(cfg.roi), hot_pixel_max=cfg.hot_pixel_max, cell_size=g.cell_size,
              grid_w=g.grid_w, grid_h=g.grid_h, min_events=g.min_events, k=k,
              width=g.width, height=g.height)
    r = dict(per_launch([time_window_pipeline(b, cfg, kw) for b in raw_blocks]), max_abs_err=err)
    bound(r)
    log_kernel("window_pipeline", r)
    return r


def time_window_pipeline(raw_block, cfg, kw) -> dict:
    """One launch of the megakernel on ``raw_block``: kernel, call and
    plain times, and the bytes and operations the block's data needs."""
    import torch

    from repro_torch.core import fixed_point as FX
    from repro_torch.core.events import roi_filter
    from repro_torch.core.pipeline.window_core import _condition
    from repro_torch.kernels import ref
    from repro_torch.kernels import window_pipeline as _wp

    g = cfg.grid
    k = g.max_clusters
    n_win, e = raw_block.x.shape
    xi, yi, ti, vi = (a.contiguous() for a in (raw_block.x, raw_block.y, raw_block.t, raw_block.valid))
    wp = lambda: _wp.window_pipeline(xi, yi, ti, vi, **kw)  # noqa: E731
    # The plain version of what the kernel computes: the integer stages
    # of the staged path (the float epilogue runs after either).
    wp_plain = cuda_ms(lambda: FX.fixed_stage_surfaces(cfg, raw_block), iters=3, warmup=1)
    # The work this block's data needs, from the plain version's masks
    # and surfaces, counted by what the function needs and not by the
    # kernel's own loops.
    cond = _condition(cfg, raw_block)
    inb = (cond.x >= 0) & (cond.x < g.width) & (cond.y >= 0) & (cond.y < g.height)
    n_roi = roi_filter(raw_block, cfg.roi).valid.sum(-1)  # (W,)
    n_w = (cond.valid & inb).sum(-1)  # (W,) kept events
    fc, _, surf = ref.window_pipeline_ref(raw_block, cfg)
    n_valid = int(fc.valid.sum())
    n_in_patch = int(surf["s1"][fc.valid].sum())  # kept events inside valid slots' patches
    # Bytes: x, y and valid of every event and t of each kept event read
    # once; the nine fields of every slot, norm of every window and the 37
    # surface ints of each valid slot written once.
    wp_bytes = (n_win * e * 9 + int(n_w.sum()) * 4
                + n_win * (9 * k + 1) * 4 + n_valid * (_wp.BINS + 5) * 4)
    # Integer operations: 6 per event for the ROI and sensor masks; per
    # window a sort of its ROI-valid events by pixel (2 log2 n per event)
    # and 6 per event for the hot-pixel counts, coincidence counts and
    # leaders from the sorted runs; 7 per kept event for the cell stats;
    # one selection pass over the cells (2 per cell) and the ordering of
    # the K slots (K log2 K); about 40 per valid slot for its fields; per
    # valid slot 4 per kept event of its window (the patch test) and 4 per
    # event inside the patch (scatter, histogram bin, sums); 18 per patch
    # pixel (separable Sobel 6, g2 2, max 1, edge test 3, isqrt 4, two
    # sums 2).
    log2n = torch.log2(n_roi.clamp_min(2).double()).ceil()
    valid_per_win = fc.valid.sum(-1)
    wp_ops = (6 * n_win * e + int((n_roi * (2 * log2n + 6)).sum()) + 7 * int(n_w.sum())
              + n_win * (2 * g.n_cells + k * math.ceil(math.log2(k)))
              + 40 * n_valid + 4 * int((valid_per_win * n_w).sum()) + 4 * n_in_patch
              + n_valid * 18 * _wp.WINDOW * _wp.WINDOW)
    return dict(ms=kernel_device_ms(wp, ("window_pipeline_kernel",)), call_ms=cuda_ms(wp),
                plain_ms=wp_plain, library_ms=None,
                bytes=wp_bytes, ops=wp_ops, ops_peak=PEAK_INT32_S, valid_slots=n_valid,
                busy_windows=int(fc.valid.any(-1).sum()), shape=(n_win, e))



def check_wire_kernels(dev, scale, fleet_recs) -> dict:
    """Hold ``event_unpack``, ``grid_quantize_packed`` and
    ``window_entropy`` against their plain versions; time them. The first
    is timed here at a 16-sensor fleet round and on the scale recording's
    whole wire (its row in the kernels line comes from the stream's own
    decodes, :func:`check_stream`); the other two lie on no path and are
    timed on the scale recording's words and at K = 32 centres."""
    import numpy as np
    import torch

    from repro_torch.core.events import pack_wire, wire_tensors
    from repro_torch.data.adversarial import (
        adversarial_wires, dual_bounds3, entropy_frame, fleet_wire, overlay_wires,
    )
    from repro_torch.kernels import grid_quantize as _gq
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import window_entropy as _we

    results = {}
    # event_unpack: exact on every wire.
    cases = {"scale recording, whole wire": (pack_wire(
        scale.x, scale.y, scale.t, scale.p, dual_bounds3(scale.t), 256)[0], 256)}
    cases.update(adversarial_wires())
    # Spill overlays beyond what the packer writes, against the plain
    # version on the CPU (on a card an index_put keeps either of two
    # entries on one slot).
    on_cpu = overlay_wires()
    cases.update(on_cpu)
    cases["16-sensor round"] = (fleet_wire(
        [(r.x, r.y, r.t, r.p, dual_bounds3(r.t[:2000])[:2]) for r in fleet_recs], 256), 256)
    err = 0.0
    timed = {}
    for name, (wire, cap) in cases.items():
        args = wire_tensors(wire, dev)
        before = ops.LAUNCHES["event_unpack"]
        got = ops.event_unpack(*args, cap)
        require(ops.LAUNCHES["event_unpack"] == before + 1, f"event_unpack ({name}): not one launch")
        # On the device too: every kernel the decode ran, whatever its name.
        _, ran = kernel_device_profile(lambda: ops.event_unpack(*args, cap), ("",), iters=3)
        require(ran == 1, f"event_unpack ({name}): {ran} kernels per decode on the device")
        exp = ref.unpack_wire_ref(*(wire_tensors(wire, "cpu") if name in on_cpu else args), cap)
        err = max(err, equal(got[0], exp[0], f"event_unpack packed ({name})"),
                  equal(got[1], exp[1], f"event_unpack valid ({name})"))
        if name in ("scale recording, whole wire", "16-sensor round"):
            timed[name] = time_event_unpack([(*args, cap)])
    log(f"  event_unpack: identical to the plain version, one launch per decode, on "
        f"{', '.join(cases)}")
    for name, r in timed.items():
        bound(r)
        log_kernel(f"event_unpack ({name})", r)
    results["event_unpack"] = dict(max_abs_err=err)

    # grid_quantize_packed: exact, at cell sizes 16 and 12.
    w = ((scale.y.astype(np.uint32) & 0xFFFF) << 16) | (scale.x.astype(np.uint32) & 0xFFFF)
    edge = w.copy()
    edge[0] = 0xFFFFFFFF
    words = torch.from_numpy(w.view(np.int32)).to(dev)
    err = 0.0
    for cs in (16, 12):
        for name, a in [("scale words", words)] + [
                (f"{n} words from 0xFFFFFFFF", torch.from_numpy(edge[:n].view(np.int32)).to(dev))
                for n in (1, 1023, 1024, 1025)]:
            err = max(err, equal(ops.grid_quantize_packed(a, cs), ref.grid_quantize_packed_ref(a, cs),
                                 f"grid_quantize_packed ({name}, cell_size={cs})"))
    log("  grid_quantize_packed: identical to the plain version (scale words, 0xFFFFFFFF, "
        "lengths 1/1023/1024/1025; cell 16 and 12)")
    n = words.shape[0]
    gq = lambda: _gq.grid_quantize_packed(words, 16)  # noqa: E731
    r = dict(ms=kernel_device_ms(gq, ("grid_quantize_kernel",)), call_ms=cuda_ms(gq),
             plain_ms=cuda_ms(lambda: ref.grid_quantize_packed_ref(words, 16)),
             library_ms=None, max_abs_err=err, bytes=8 * n, ops=6 * n, ops_peak=PEAK_INT32_S,
             shape=(n,))
    bound(r)
    log_kernel("grid_quantize_packed (scale words, cell 16)", r)
    results["grid_quantize_packed"] = r

    # window_entropy: rtol 1e-5 (float32 sums in another order, log2f).
    frame, cx, cy = entropy_frame()
    err = 0.0
    for name, f in (("frame", frame), ("empty frame", np.zeros_like(frame))):
        args = [torch.from_numpy(a).to(dev) for a in (f, cx, cy)]
        err = max(err, close(ops.window_entropy(*args), ref.window_entropy_ref(*args),
                             f"window_entropy ({name})", ENTROPY_RTOL, ENTROPY_ATOL))
    log(f"  window_entropy: within rtol {ENTROPY_RTOL} of the plain version (corner-clipped, "
        f"single hot pixel and random centres; empty frame), max abs err {err:.3e}")
    args = [torch.from_numpy(a).to(dev) for a in (frame, cx, cy)]
    k = cx.shape[0]
    we = lambda: _we.window_entropy(*args)  # noqa: E731
    r = dict(ms=kernel_device_ms(we, ("window_entropy_kernel",)), call_ms=cuda_ms(we),
             plain_ms=cuda_ms(lambda: ref.window_entropy_ref(*args)),
             library_ms=None, max_abs_err=err,
             bytes=k * (48 * 48 * 4 + 8 + 12), ops=k * 48 * 48 * 10, shape=(k,))
    bound(r)
    log_kernel(f"window_entropy (K = {k})", r)
    results["window_entropy"] = r
    return results


def time_calls(calls, kernel, plain, names, n_plain: int | None = None) -> dict:
    """Per launch over ``calls``, each ``(args, kwargs)`` of one call of
    the kernel's wrapper ``kernel``: the kernels alone (``names``, under
    the profiler), the call (CUDA events), the plain version ``plain`` on
    the first ``n_plain`` calls (all by default), and the kernels the
    device ran per call."""
    n = len(calls)
    iters = max(2, 20 // n)
    ms, per_call = kernel_device_profile(lambda: replay(kernel, calls), names, iters=iters, expect=n)
    head = calls[:n_plain] if n_plain else calls
    return dict(
        ms=ms / n, kernels_per_call=per_call / n, call_ms=replay_ms(kernel, calls, iters),
        plain_ms=replay_ms(plain, head, max(1, 5 // len(head))), library_ms=None,
    )


def replay(fn, calls) -> None:
    for a, kw in calls:
        fn(*a, **kw)


def replay_ms(fn, calls, iters: int = 1) -> float:
    """Mean ms per call of ``fn`` over ``calls``, each ``(args, kwargs)``,
    under CUDA events, after one warm-up replay."""
    return cuda_ms(lambda: replay(fn, calls), iters=iters, warmup=1) / len(calls)


def time_event_unpack(calls) -> dict:
    """Per call of the ``event_unpack`` kernel over ``calls``, each the
    wire tensors and the capacity as a decoder takes them: the kernel
    alone, the call, the plain version, and the bytes and operations the
    wires need. Requires at most one kernel on the device per decode
    (phase 2 requires exactly one on every wire case)."""
    from repro_torch.core.events import SPILL_SENTINEL
    from repro_torch.kernels import event_unpack as _eu
    from repro_torch.kernels import ref

    n = len(calls)
    nbytes = nops = 0
    windows = []
    for _, _, _, offsets, spill, cap in calls:
        off = offsets.cpu().long()
        s_, w_ = off.shape[0], off.shape[1] - 1
        n_events = int((off[:, -1] - off[:, 0]).sum())
        m = int((spill[0].cpu() != SPILL_SENTINEL).sum())
        # Each wire event's word, delta and bit read once, the offsets and
        # the real spill entries, 17 bytes out per slot.
        nbytes += int(n_events * 6.125) + 4 * s_ * (w_ + 1) + 20 * m + 17 * s_ * w_ * cap
        nops += 10 * s_ * w_ * cap
        windows.append(w_)
    shape = ((s_, w_, cap) if n == 1 else
             f"{n} decodes of (1, W, {cap}), W {min(windows)}-{max(windows)}, {sum(windows)} windows")
    r = time_calls([(a, {}) for a in calls], _eu.event_unpack, ref.unpack_wire_ref,
                   ("event_unpack_kernel",))
    # The profiler may drop records over thousands of launches, never add.
    require(r["kernels_per_call"] <= 1, f"event_unpack: {r['kernels_per_call']} kernels per decode")
    return dict(r, bytes=nbytes / n, ops=nops / n, ops_peak=PEAK_INT32_S, shape=shape)


def bound(r: dict) -> None:
    """Add ``bound_ms`` and ``bound_by`` to a kernel's result."""
    t_bytes = r["bytes"] / PEAK_BYTES_S * 1e3
    t_ops = r["ops"] / r.get("ops_peak", PEAK_OPS_S) * 1e3
    r["bound_ms"] = max(t_bytes, t_ops)
    r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"


def log_kernel(name: str, r: dict) -> None:
    lib = r["library_ms"]
    per = f", per launch of {r['n_launches_timed']}" if r.get("n_launches_timed", 1) > 1 else ""
    log(f"  {name} at {r['shape']}{per}: kernels alone {r['ms']:.4f} ms (call {r['call_ms']:.4f} ms), "
        f"plain {r['plain_ms']:.4f} ms, library {lib if lib is None else round(lib, 4)} ms, "
        f"bound {r['bound_ms']:.4g} ms by {r['bound_by']} ({r['bytes']:.0f} B, {r['ops']:.0f} ops"
        + (f", {r['valid_slots']} valid slots in {r['busy_windows']} windows)"
           if "valid_slots" in r else ")"))


# ---------------------------------------------------------------------------
# Phases 3 and 4: the main path.
# ---------------------------------------------------------------------------

def run_main_path(rec, cfg, device):
    from repro_torch.core.pipeline import evaluate_detection, run_recording_scan

    result = run_recording_scan(rec, cfg, device=device)
    score = evaluate_detection(rec, cfg, device=device)
    return result, score


def compare_runs(gpu, cpu, what: str) -> None:
    """Integer outputs identical, floats within the stated tolerances."""
    (rg, sg), (rc, sc) = gpu, cpu
    require(rg.num_windows == rc.num_windows, f"{what}: window counts differ")
    for f in ("count", "cell_x", "cell_y", "valid", "centroid_x", "centroid_y", "centroid_t"):
        equal(getattr(rg.clusters, f), getattr(rc.clusters, f), f"{what}: clusters.{f}")
    for f in ("event_count", "edge_density"):
        equal(rg.metrics[f], rc.metrics[f], f"{what}: {f}")
    for f in ("shannon_entropy", "renyi_entropy", "differential_entropy", "local_contrast"):
        close(rg.metrics[f], rc.metrics[f], f"{what}: {f}")
    for f in ("hits", "misses", "age", "active"):
        equal(getattr(rg.tracks, f), getattr(rc.tracks, f), f"{what}: tracks.{f}")
    for f in ("x", "y", "vx", "vy", "entropy"):
        close(getattr(rg.tracks, f), getattr(rc.tracks, f), f"{what}: tracks.{f}",
              TRACK_RTOL, TRACK_ATOL)
    require(sg == sc, f"{what}: scores differ: {sg} vs {sc}")


def check_loop_driver(rec, cfg, name: str, own, dev) -> dict:
    """The loop driver (``run_recording``: one window core call per
    window) on the card: every window's clusters, metrics and tracks equal
    to ``run_recording_scan``'s on the card, and each of the path's
    kernels launched exactly once per window. Returns its launches."""
    import torch

    from repro_torch.core.pipeline import run_recording, run_recording_scan
    from repro_torch.kernels import ops

    ops.reset_launches()
    t0 = time.perf_counter()
    loop = run_recording(rec, cfg, device=dev)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    counts = dict(ops.LAUNCHES)
    scan = run_recording_scan(rec, cfg, device=dev)
    n = len(loop)
    require(n == scan.num_windows > 0, f"loop driver ({name}): {n} windows, scan {scan.num_windows}")
    for w, (a, b) in enumerate(zip(loop, scan.window_results())):
        require(a.t_start_us == b.t_start_us, f"loop driver ({name}) window {w}: t_start_us")
        for f in a.clusters._fields:
            equal(getattr(a.clusters, f), getattr(b.clusters, f), f"loop driver ({name}) window {w}: {f}")
        for k in a.metrics:
            equal(torch.as_tensor(a.metrics[k]), torch.as_tensor(b.metrics[k]),
                  f"loop driver ({name}) window {w}: {k}")
        for f in a.tracks._fields:
            equal(getattr(a.tracks, f), getattr(b.tracks, f), f"loop driver ({name}) window {w}: tracks.{f}")
    require(all(counts[k] == (n if k in own else 0) for k in counts),
            f"loop driver ({name}): launches {counts} over {n} windows, expected one of each of {own} a window")
    log(f"[3] quickstart, loop driver (run_recording), {name} path: {n} windows in {wall:.1f} ms, every "
        f"window's clusters, metrics and tracks equal to run_recording_scan's on the card; launches "
        f"{counts}, one per window of each of {own}")
    return counts


def check_sweep(cfg, fixed, dev) -> dict:
    """``threshold_sweep(make_validation_suite())`` on the card, float
    kernel and fixed megakernel configs, with the scan and the fleet
    driver: every threshold's score printed; the float scores equal to the
    JAX reference's (``SWEEP_EXPECT``), both drivers equal and equal to the
    port's CPU run; the fixed scores equal to their CPU run. Returns the
    float scan sweep's launches and wall times."""
    import torch

    from repro_torch.core.pipeline import threshold_sweep
    from repro_torch.data.synthetic import make_validation_suite
    from repro_torch.kernels import ops

    suite = make_validation_suite()
    log(f"[3] validation suite: {len(suite)} recordings of 2 s, {sum(len(r) for r in suite)} events")
    out, scores = {}, {}
    # The fleet driver decodes its ragged wire with event_unpack under
    # use_kernels (the float kernel config).
    paths = (("float kernel", cfg, {"scan": FLOAT_KERNELS, "fleet": FLEET_KERNELS}),
             ("fixed megakernel", fixed, {"scan": FIXED_KERNELS, "fleet": FIXED_KERNELS}))
    for name, c, own_of in paths:
        for driver, own in own_of.items():
            walls = []
            for _ in range(2):  # the first call pays the allocator's and the fleet's set-up
                ops.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sw = threshold_sweep(suite, SWEEP_THRESHOLDS, c, driver=driver, device=dev)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            counts = dict(ops.LAUNCHES)
            got = {t: (s.tp, s.fp, s.fn, s.tn) for t, s in sw.items()}
            scores[name, driver] = got
            require(all((counts[k] > 0) == (k in own) for k in counts),
                    f"sweep ({name}, {driver}): launches {counts}, expected {own}")
            log(f"    sweep, {name}, {driver} driver, cuda: wall {walls[0]:.1f} ms first, {walls[1]:.1f} ms "
                f"second; launches {counts}; min_events -> tp/fp/fn/tn (accuracy): " + ", ".join(
                    f"{t}: {'/'.join(map(str, v))} ({sw[t].accuracy:.4f})" for t, v in got.items()))
            if name == "float kernel" and driver == "scan":
                out = dict(launches=counts, wall_ms=walls)
        cpu = threshold_sweep(suite, SWEEP_THRESHOLDS, c, device="cpu")
        cpu = {t: (s.tp, s.fp, s.fn, s.tn) for t, s in cpu.items()}
        require(scores[name, "scan"] == scores[name, "fleet"] == cpu,
                f"sweep ({name}): scan {scores[name, 'scan']}, fleet {scores[name, 'fleet']}, cpu {cpu}")
    require(scores["float kernel", "scan"] == SWEEP_EXPECT,
            f"sweep (float kernel): {scores['float kernel', 'scan']}, the reference's {SWEEP_EXPECT}")
    same = scores["fixed megakernel", "scan"] == scores["float kernel", "scan"]
    log(f"    sweep scores equal to the JAX reference's at every threshold (threshold 5: "
        f"{'/'.join(map(str, SWEEP_EXPECT[5]))}), scan = fleet = the CPU run on both datapaths; the "
        f"fixed path's scores {'equal' if same else 'differ from'} the float path's"
        + ("" if same else f": fixed {scores['fixed megakernel', 'scan']}"))
    return out


def check_stride_scale(rec, cfg, win, dev) -> dict:
    """The scale recording in 100 ms stride windows at capacity 4096
    through ``run_recording_scan`` untracked, float kernel config, on the
    card (the stage kernels' large path) and on the CPU: every integer
    equal, centroid_t within ``ref.centroid_t_bound`` of each valid slot's
    cell (sized by the cell's exact sum of |t| over the conditioned
    windows, so identical where that is below 2^24), metrics at the
    stated tolerances; the window core's time. Returns the card run's
    launches."""
    import torch

    from repro_torch.core.events import pad_windows
    from repro_torch.core.pipeline import run_recording_scan
    from repro_torch.core.pipeline.window_core import _condition
    from repro_torch.kernels import ops, ref

    ops.reset_launches()
    gpu = run_recording_scan(rec, cfg, with_tracking=False, windows=win, device=dev)
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    cpu_win = pad_windows(rec.x, rec.y, rec.t, rec.p, cfg.batcher, "cpu", policy="stride",
                          window_us=STRIDE_US)
    t0 = time.perf_counter()
    cpu = run_recording_scan(rec, cfg, with_tracking=False, windows=cpu_win, device="cpu")
    cpu_s = time.perf_counter() - t0
    n = gpu.num_windows
    require(n == cpu.num_windows > 0, "stride scale: window counts differ")
    require(not cfg.merge_neighbors, "stride scale: merged clusters span cells; the bound is per cell")
    g = cfg.grid
    b = _condition(cfg, cpu_win.batch)  # what the clustering stage sees
    abs_t = ref.abs_t_rows(b.x, b.y, b.t, b.valid, cell_size=g.cell_size, grid_w=g.grid_w,
                           grid_h=g.grid_h, width=g.width, height=g.height)
    t_diff = within_centroid_t_bound(gpu.clusters, cpu.clusters, abs_t, g, "stride scale")
    err = compare_metrics(gpu.metrics, cpu.metrics, "stride scale")
    events = win.batch.valid.sum(-1).double()
    core_ms, _ = best_ms(lambda: run_recording_scan(rec, cfg, with_tracking=False, windows=win, device=dev))
    require(counts["cluster_accum"] == counts["patch_metrics"] > 0, f"stride scale launches {counts}")
    log(f"[4] scale recording in {STRIDE_US // 1000} ms stride windows at capacity {STRIDE_CAPACITY} "
        f"(float kernel config, untracked): {n} windows of {events.mean():.0f} events on average (at most "
        f"{int(events.max())}), {int(gpu.clusters.valid.sum())} valid clusters; integer outputs equal to "
        f"the CPU run ({cpu_s:.1f} s), centroid_t within its bound (largest difference "
        f"{t_diff:.3g} us), metrics max abs err {err:.3e}; window core {core_ms:.2f} ms "
        f"(best of 3); launches cluster_accum {counts['cluster_accum']}, patch_metrics "
        f"{counts['patch_metrics']}")
    return dict(counts, window_core_ms=core_ms, windows=n)


def summary(result, score, cfg) -> dict:
    from repro_torch.core.tracking import confirmed

    return dict(
        windows=result.num_windows,
        valid=int(result.clusters.valid.sum()),
        confirmed=int(confirmed(result.final_tracks, cfg.tracker).sum()),
        tp=score.tp, fp=score.fp, fn=score.fn, tn=score.tn,
    )


def best_ms(fn, repeats: int = 3) -> tuple[float, object]:
    """Least host-clock ms of ``fn()`` over ``repeats`` runs, each closed
    by a synchronize; returns it with the last run's result."""
    import torch

    best, out = float("inf"), None
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best, out


def stage_times(rec, cfg, dev) -> tuple[dict, object]:
    """Steady-state ms of the functions the entry points call, on their
    real inputs: ``pad_windows``; ``run_recording_scan`` without the
    tracker (conditioning, clustering and metrics over the blocks);
    ``track_recording`` on that run's clusters; ``evaluate_detection``
    (its own windowing and untracked scan at the candidate floor, then
    truth matching and scoring); and the whole tracked scan."""
    from repro_torch.core.events import pad_windows
    from repro_torch.core.pipeline import evaluate_detection, run_recording_scan
    from repro_torch.core.tracking import init_tracks, track_recording

    out = {}
    out["windowing"], win = best_ms(
        lambda: pad_windows(rec.x, rec.y, rec.t, rec.p, cfg.batcher, dev))
    out["window core"], core = best_ms(lambda: run_recording_scan(
        rec, cfg, with_tracking=False, windows=win, device=dev))
    out["tracker"], _ = best_ms(lambda: track_recording(
        core.clusters, core.metrics["shannon_entropy"], cfg.tracker,
        init_tracks(cfg.tracker, dev)))
    out["evaluate_detection"], _ = best_ms(lambda: evaluate_detection(rec, cfg, device=dev))
    out["run_recording_scan"], _ = best_ms(lambda: run_recording_scan(rec, cfg, device=dev))
    return out, win


# Runtime calls that put work on the device: a launch, a copy or a fill.
DEVICE_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset", "cudaGraphLaunch")


def device_calls(e) -> list:
    """The runtime calls that put work on the device (kernels, copies,
    fills) made inside host event ``e`` of a profile, its children's
    included. The profiler links a kernel to the aten op that launched
    it, so a kernel that a ctypes library launches is linked to no host
    range; its runtime call is a child of the range all the same, and
    carries the kernel's correlation id."""
    own = [e] if e.name.startswith(DEVICE_CALLS) else []
    return own + [c for ch in e.cpu_children for c in device_calls(ch)]


def profile_ranges(run, stages) -> dict:
    """``run()`` under ``torch.profiler``. For each ``record_function``
    range in ``stages``: its host ms, the device ms of the work launched
    in it (by the correlation ids of its runtime calls) and the device
    span from its first kernel's start to its last's end; and the number
    of device launches (kernels, copies, fills) in each occurrence of it.
    Also the device's busy ms (the same work) and the host ms of the
    run."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ranges = {k: [0.0, 0.0, 0.0] for k in stages}
    kernels = {k: [] for k in stages}
    busy = 0.0
    device_ms = {}  # correlation id -> device ms of the work it launched
    hosts = []
    # A range shows up twice: as a host event and as a device-side
    # annotation span.
    for e in prof.events():
        on_device = e.device_type == DeviceType.CUDA
        if e.name in ranges:
            if on_device:
                ranges[e.name][2] += e.device_time_total / 1e3
            else:
                hosts.append(e)
        elif on_device:
            ms = (e.time_range.end - e.time_range.start) / 1e3
            busy += ms
            device_ms[e.id] = device_ms.get(e.id, 0.0) + ms
    for e in hosts:
        calls = device_calls(e)
        r = ranges[e.name]
        r[0] += e.cpu_time_total / 1e3
        r[1] += sum(device_ms.get(c.id, 0.0) for c in calls)
        kernels[e.name].append(len(calls))
    return dict(ranges=ranges, kernels=kernels, device_busy_ms=busy, host_ms=wall)


def require_one_launch_per_block(prof: dict, n_blocks: int, what: str) -> None:
    """Exactly one device kernel in each ``"clustering"`` and ``"metrics"``
    range, one range each per block (the float kernel route)."""
    for stage in ("clustering", "metrics"):
        got = prof["kernels"][stage]
        require(got == [1] * n_blocks,
                f"{what}: device kernels per block in {stage!r}: {got}, expected 1 in each of {n_blocks}")


def window_core_profile(rec, cfg, dev, win, stages=("conditioning", "clustering", "metrics")) -> dict:
    """One ``run_recording_scan`` without the tracker under the profiler
    (see :func:`profile_ranges`)."""
    from repro_torch.core.pipeline import run_recording_scan

    return profile_ranges(
        lambda: run_recording_scan(rec, cfg, with_tracking=False, windows=win, device=dev), stages)


def check_fixed_scale(rec, fixed, staged, dev, float_core_ms: float) -> dict:
    """The fixed path at scale, untracked, plus ``evaluate_detection``:
    the megakernel route's outputs identical to the staged route's on the
    card; then steady-state times beside the float window core's. Returns
    the launches of the scan alone."""
    import torch

    from repro_torch.core.events import pad_windows
    from repro_torch.core.pipeline import evaluate_detection, run_recording_scan
    from repro_torch.kernels import ops

    ops.reset_launches()
    mega = run_recording_scan(rec, fixed, with_tracking=False, device=dev)
    torch.cuda.synchronize()
    scan_counts = dict(ops.LAUNCHES)
    score = evaluate_detection(rec, fixed, device=dev)
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    ref = run_recording_scan(rec, staged, with_tracking=False, device=dev)
    ref_score = evaluate_detection(rec, staged, device=dev)
    require(mega.num_windows == ref.num_windows, "fixed scale: window counts differ")
    for f in mega.clusters._fields:
        equal(getattr(mega.clusters, f), getattr(ref.clusters, f), f"fixed scale: clusters.{f}")
    for m in mega.metrics:
        equal(mega.metrics[m].view(torch.int32), ref.metrics[m].view(torch.int32), f"fixed scale: {m}")
    require(score == ref_score, f"fixed scale: scores differ: {score} vs {ref_score}")
    require(counts["window_pipeline"] > 0 and counts["cluster_accum"] == counts["patch_metrics"] == 0,
            f"fixed scale launches {counts}")
    n = mega.num_windows
    log(f"[4] scale recording, fixed path (untracked): {n} windows, "
        f"{int(mega.clusters.valid.sum())} valid clusters, {score}, launches {counts}; "
        "megakernel route identical to the staged route on the card")
    times = {}
    times["windowing"], win = best_ms(
        lambda: pad_windows(rec.x, rec.y, rec.t, rec.p, fixed.batcher, dev))
    for name, c in (("megakernel", fixed), ("staged", staged)):
        times[f"fixed window core, {name}"], _ = best_ms(lambda: run_recording_scan(
            rec, c, with_tracking=False, windows=win, device=dev))
    times["evaluate_detection, megakernel"], _ = best_ms(
        lambda: evaluate_detection(rec, fixed, device=dev))
    times["float window core"] = float_core_ms
    log("    steady state (best of 3, ms per recording / per window): " + ", ".join(
        f"{k} {v:.1f} / {v / n:.4f}" for k, v in times.items()))
    prof = window_core_profile(rec, fixed, dev, win, stages=("fixed window core",))
    log(f"    fixed window core under the profiler: host {prof['host_ms']:.1f} ms, device busy "
        f"{prof['device_busy_ms']:.2f} ms; range (host ms, kernel ms, device span ms): "
        + ", ".join(f"{k} ({h:.2f}, {d:.2f}, {sp:.2f})" for k, (h, d, sp) in prof["ranges"].items()))
    return scan_counts


# ---------------------------------------------------------------------------
# The live ingest path: the fleet over the ragged wire.
# ---------------------------------------------------------------------------

def fleet_rounds(recs) -> list:
    """One 20 ms chunk per sensor per round (``None`` once a sensor's
    recording is exhausted)."""
    from repro_torch.data.evas import iter_chunks

    per = [list(iter_chunks(r, CHUNK_US)) for r in recs]
    return [[c[i] if i < len(c) else None for c in per] for i in range(max(map(len, per)))]


class GcClock:
    """Milliseconds the interpreter's garbage collector ran, by generation
    (``gc.callbacks``), while installed as a context manager."""

    def __init__(self):
        self.ms = [0.0, 0.0, 0.0]
        self._t0 = 0.0

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.ms[info["generation"]] += (time.perf_counter() - self._t0) * 1e3

    def __enter__(self):
        import gc

        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._cb)


def run_fleet(cfg, rounds, n, dev, sync_each: bool = False):
    """Feed every round and flush; returns the round results, the host ms
    of each round (closed by a synchronize when ``sync_each``), the ms of
    garbage collection inside each round and the pipeline."""
    import torch

    from repro_torch.core.pipeline import FleetPipeline

    fp = FleetPipeline(cfg, n_sensors=n, device=dev)
    out, ms, gc_ms = [], [], []
    with GcClock() as clock:
        for chunks in rounds + [None]:
            g0 = sum(clock.ms)
            t0 = time.perf_counter()
            out.append(fp.flush() if chunks is None else fp.feed(chunks))
            if sync_each:
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            gc_ms.append(sum(clock.ms) - g0)
    return out, ms, gc_ms, fp


def sensor_parts(results, s) -> dict:
    """Sensor ``s``'s outputs over every fleet round, concatenated."""
    return concat_parts([r.sensor(s) for r in results])


def concat_parts(parts) -> dict:
    """The outputs of consecutive feeds of one sensor, concatenated."""
    import torch

    cat = lambda get: torch.cat([get(p) for p in parts])  # noqa: E731
    return dict(
        windows=sum(p.num_windows for p in parts),
        clusters={f: cat(lambda p: getattr(p.clusters, f)) for f in parts[0].clusters._fields},
        metrics={k: cat(lambda p: p.metrics[k]) for k in parts[0].metrics},
        tracks={f: cat(lambda p: getattr(p.tracks, f)) for f in parts[0].tracks._fields},
        final={f: getattr(parts[-1].final_tracks, f) for f in parts[-1].final_tracks._fields},
    )


def scan_parts(scan) -> dict:
    return dict(
        windows=scan.num_windows,
        clusters=scan.clusters._asdict(), metrics=scan.metrics,
        tracks=scan.tracks._asdict(), final=scan.final_tracks._asdict(),
    )


def compare_parts(got: dict, want: dict, what: str, exact: bool = True) -> None:
    """Every field equal; with ``exact=False`` (two devices) integers and
    centroids equal, metric and tracker floats within the stated
    tolerances."""
    require(got["windows"] == want["windows"], f"{what}: {got['windows']} vs {want['windows']} windows")
    for group in ("clusters", "metrics", "tracks", "final"):
        for k, a in got[group].items():
            b = want[group][k]
            label = f"{what}: {group}.{k}"
            if exact or not a.is_floating_point() or group == "clusters" \
                    or k in ("event_count", "edge_density"):
                equal(a, b, label)
            elif group == "metrics":
                close(a, b, label)
            else:
                close(a, b, label, TRACK_RTOL, TRACK_ATOL)


def check_quick_fleet(cfg, name, own, dev) -> dict:
    """Four quickstart-size sensors through the fleet on the card and on
    the CPU: each sensor equal to its scan on the same device, and the
    two devices' integer outputs equal. Returns the card run's launches."""
    import torch

    from repro_torch.core.pipeline import run_recording_scan
    from repro_torch.data.synthetic import make_recording
    from repro_torch.kernels import ops

    recs = [make_recording(seed=20 + s, **FLEET_QUICK) for s in range(4)]
    rounds = fleet_rounds(recs)
    ops.reset_launches()
    gpu, _, _, _ = run_fleet(cfg, rounds, 4, dev)
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    cpu, _, _, _ = run_fleet(cfg, rounds, 4, "cpu")
    for s, rec in enumerate(recs):
        g, c = sensor_parts(gpu, s), sensor_parts(cpu, s)
        compare_parts(g, scan_parts(run_recording_scan(rec, cfg, device=dev)), f"quick fleet ({name}) {s} vs scan, cuda")
        compare_parts(c, scan_parts(run_recording_scan(rec, cfg, device="cpu")), f"quick fleet ({name}) {s} vs scan, cpu")
        compare_parts(g, c, f"quick fleet ({name}) sensor {s}, cuda vs cpu", exact=False)
    windows = sum(r.total_windows for r in gpu)
    require(all((counts[k] > 0) == (k in own) for k in counts),
            f"quick fleet ({name}): launches {counts}, expected only {own}")
    log(f"[3] quickstart fleet, {name} path: 4 sensors, {len(rounds)} rounds, {windows} windows; "
        f"each sensor equal to its scan on cuda and on cpu, integer outputs equal across devices; "
        f"launches {counts}")
    return counts


def check_full_fleet(cfg, recs, dev) -> dict:
    """The fleet at full width on the card: outputs against each sensor's
    scan, field for field; ``feed_async`` against ``feed``; per-round
    latency, throughput, wire stats and the decode's share of a round."""
    import numpy as np

    from repro_torch.core.pipeline import FleetPipeline, run_recording_scan
    from repro_torch.kernels import ops

    n = len(recs)
    rounds = fleet_rounds(recs)
    run_fleet(cfg, rounds[:20], n, dev)  # warm-up
    ops.reset_launches()
    t0 = time.perf_counter()
    sync, ms, gc_ms, fp = run_fleet(cfg, rounds, n, dev, sync_each=True)
    wall = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    windows = sum(r.total_windows for r in sync)
    require(all(counts[k] > 0 for k in FLEET_KERNELS), f"full fleet launches {counts}")
    stats = fp.wire_stats
    lat = np.asarray(ms[:-1])  # the feeds; the flush is the last entry
    log(f"[4] fleet at full width: {n} sensors x {FLEET['duration_s']} s, "
        f"{sum(len(r) for r in recs)} events, {len(rounds)} rounds + flush, {windows} windows; "
        f"launches {counts}")
    log(f"    per-round latency (host clock, synchronize per round): p50 "
        f"{np.percentile(lat, 50):.3f} ms, p99 {np.percentile(lat, 99):.3f} ms, max {lat.max():.3f} ms "
        f"(budget {BUDGET_MS} ms); {windows / sum(ms) * 1e3:.0f} windows/s over the rounds, "
        f"{windows / wall:.0f} windows/s wall; wire compression {stats.compression:.3f}x, "
        f"{stats.wire_bytes_per_round:.0f} B/round, spilled {stats.spilled}")
    w_max = [int(r.n_windows.max()) for r in sync[:-1]]
    first = {w: w_max.index(w) for w in set(w_max)}
    log("    slowest rounds (index, ms, of which garbage collection ms, most windows a sensor "
        "closed, first round of that staging shape): " + ", ".join(
            f"({i}, {lat[i]:.3f}, {gc_ms[i]:.3f}, {w_max[i]}, {first[w_max[i]] == i})"
            for i in np.argsort(lat)[::-1][:4])
        + f"; garbage collection {sum(gc_ms):.1f} ms over the run"
        + "; rounds by most windows a sensor closed: "
        + ", ".join(f"{w}: {w_max.count(w)}" for w in sorted(first)))
    for s, rec in enumerate(recs):
        compare_parts(sensor_parts(sync, s), scan_parts(run_recording_scan(rec, cfg, device=dev)),
                      f"full fleet sensor {s} vs its scan")
    log(f"    every sensor's clusters, metrics, per-window tracks and final carry equal to its "
        f"run_recording_scan on the card")

    fa = FleetPipeline(cfg, n_sensors=n, staging_depth=2, device=dev)
    pend = [fa.feed_async(c) for c in rounds] + [fa.feed_async([None] * n, final=True)]
    for i, (p, want) in enumerate(zip(pend, sync)):
        got = p.wait()
        require(np.array_equal(got.n_windows, want.n_windows), f"async round {i}: windows differ")
        if want.clusters is None:
            require(got.clusters is None, f"async round {i}: clusters")
            continue
        for group in ("clusters", "tracks", "final_tracks"):
            for f, a, b in zip(getattr(want, group)._fields, getattr(got, group), getattr(want, group)):
                equal(a, b, f"async round {i}: {group}.{f}")
        for k in want.metrics:
            equal(got.metrics[k], want.metrics[k], f"async round {i}: {k}")
    log(f"    feed_async at depth 2 (all {len(pend)} rounds dispatched before the first explicit "
        f"wait, at most 2 in flight by the staging ring) equal to feed, every round")

    prof_fp = FleetPipeline(cfg, n_sensors=n, device=dev)
    for c in rounds[:40]:
        prof_fp.feed(c)

    def forty():
        for c in rounds[40:80]:
            prof_fp.feed(c)

    ops.reset_launches()
    prof = profile_ranges(forty, ("wire decode", "conditioning", "clustering", "metrics", "tracker"))
    dec = prof["ranges"]["wire decode"]
    log(f"    40 rounds under the profiler: host {prof['host_ms']:.1f} ms, device busy "
        f"{prof['device_busy_ms']:.2f} ms; wire decode host {dec[0]:.2f} ms "
        f"({100 * dec[0] / prof['host_ms']:.1f}% of the rounds' host time), kernels {dec[1]:.3f} ms "
        f"({100 * dec[1] / max(prof['device_busy_ms'], 1e-9):.1f}% of device busy); ranges "
        "(host ms, kernel ms, device span ms): "
        + ", ".join(f"{k} ({h:.2f}, {d:.3f}, {sp:.3f})" for k, (h, d, sp) in prof["ranges"].items()))
    per_round = {k: sorted(set(v)) for k, v in prof["kernels"].items()}
    log(f"    device kernels per fleet step (distinct counts over the {len(prof['kernels']['metrics'])} "
        f"steps of the 40 rounds): {per_round}")
    steps = len(prof["kernels"]["metrics"])
    require_one_launch_per_block(prof, steps, "fleet profile")
    require(steps > 0 and ops.LAUNCHES["cluster_accum"] == ops.LAUNCHES["patch_metrics"] == steps,
            f"fleet profile: {steps} steps, launches {ops.LAUNCHES}")
    return counts


def check_stream(cfg, rec, scan, dev) -> tuple[dict, dict]:
    """The live stream on the card: ``rec`` fed to
    ``StreamingPipeline(wire="ragged")`` in 20 ms chunks, then flushed;
    every field equal to ``scan``, its ``run_recording_scan`` on the
    card. The decoder's inputs in this run are kept, and after it the
    ``event_unpack`` kernel is held against its plain version and timed
    on them. Returns the run's launches and that kernel's row."""
    import numpy as np
    import torch

    from repro_torch.core import metrics as M
    from repro_torch.core.grid_clustering import clusters_from_histogram
    from repro_torch.core.pipeline import StreamingPipeline
    from repro_torch.data.evas import iter_chunks
    from repro_torch.kernels import cluster_accum as _ca
    from repro_torch.kernels import event_unpack as _eu
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import patch_metrics as _pm

    chunks = list(iter_chunks(rec, CHUNK_US))
    sp = StreamingPipeline(cfg, wire="ragged", device=dev)
    calls = []
    decode = sp._wire

    def keep(*args):  # the stream's decoder, its inputs kept
        calls.append(args)
        return decode(*args)

    sp._wire = keep
    # The window-core kernels' inputs in this run are kept too: the stage
    # entries the clustering and metrics stages call.
    captured = {_ca: [], _pm: []}
    kernel_fns = {mod: mod.__dict__[name] for mod, name in
                  ((_ca, "cluster_accum_topk"), (_pm, "patch_metrics"))}

    def capture(mod):
        def call(*a, **kw):
            captured[mod].append((a, kw))
            return kernel_fns[mod](*a, **kw)
        return call

    _ca.cluster_accum_topk, _pm.patch_metrics = capture(_ca), capture(_pm)
    ops.reset_launches()
    parts, ms = [], []
    try:
        for c in chunks + [None]:
            t0 = time.perf_counter()
            parts.append(sp.flush() if c is None else sp.feed(*c))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        _ca.cluster_accum_topk, _pm.patch_metrics = kernel_fns[_ca], kernel_fns[_pm]
    counts = dict(ops.LAUNCHES)
    require(all(counts[k] > 0 for k in FLEET_KERNELS), f"stream launches {counts}")
    require(counts["event_unpack"] == len(calls), f"stream: {len(calls)} decodes, launches {counts}")
    compare_parts(concat_parts(parts), scan_parts(scan), "stream vs its scan")
    lat = np.asarray(ms[:-1])
    stats = sp.wire_stats
    log(f"[4] stream of the scale recording over the ragged wire: {len(chunks)} feeds of "
        f"{CHUNK_US // 1000} ms + flush, {scan.num_windows} windows, launches {counts}; every "
        f"field equal to its run_recording_scan on the card; per-feed latency (host clock, "
        f"synchronize per feed) p50 {np.percentile(lat, 50):.3f} ms, p99 "
        f"{np.percentile(lat, 99):.3f} ms, max {lat.max():.3f} ms (budget {BUDGET_MS} ms); "
        f"wire compression {stats.compression:.3f}x, spilled {stats.spilled}")
    err = 0.0
    for args in calls:
        got, exp = _eu.event_unpack(*args), ref.unpack_wire_ref(*args)
        err = max(err, equal(got[0], exp[0], "event_unpack packed (stream)"),
                  equal(got[1], exp[1], "event_unpack valid (stream)"))
    row = dict(time_event_unpack(calls), max_abs_err=err)
    bound(row)
    log(f"  event_unpack: identical to the plain version on each of the stream's {len(calls)} wires")
    log_kernel("event_unpack (the stream's wires)", row)
    # The window-core kernels per launch on the stream's own inputs (1-2
    # windows a feed), the plain versions on the first 300 launches; beside
    # them the torch ops each kernel took off its stage, on the same inputs.
    stream_rows = {}
    rows_of = lambda x, y, t, v, g: ref.cluster_accum_ref(  # noqa: E731
        x, y, t, v, cell_size=g.cell_size, grid_w=g.grid_w, grid_h=g.grid_h,
        width=g.width, height=g.height)
    removed = {
        "cluster_accum": [((*rows_of(*a), a[4]), {}) for a, _ in captured[_ca]],
        "patch_metrics": [((a[0], a[1]), kw) for a, kw in captured[_pm]],
    }
    removed_fn = {
        "cluster_accum": clusters_from_histogram,
        "patch_metrics": lambda b, cl, width, height: (
            M.event_normalizer(b, width, height),
            M.window_origin(cl.centroid_x, cl.centroid_y, width, height)),
    }
    for name, mod, plain, kernel_name, cost in (
            ("cluster_accum", _ca, ref.cluster_accum_topk_ref, "cluster_accum_kernel",
             lambda a, kw: cluster_accum_topk_cost(*a)),
            ("patch_metrics", _pm, ref.patch_metrics_stage_ref, "patch_metrics_kernel",
             lambda a, kw: patch_metrics_cost(*a, **kw))):
        calls_k = captured[mod]
        require(len(calls_k) == counts[name], f"stream: {len(calls_k)} {name} calls, launches {counts}")
        costs = [cost(a, kw) for a, kw in calls_k]
        r = time_calls(calls_k, kernel_fns[mod], plain, (kernel_name,), n_plain=300)
        r["removed_ms"] = replay_ms(removed_fn[name], removed[name][:300])
        r.update({k: sum(c[k] for c in costs) / len(costs) for k in ("bytes", "ops")})
        events = [(a[0].x if name == "patch_metrics" else a[0]).shape for a, _ in calls_k]
        windows = [w for w, _ in events]
        r["shape"] = f"{len(calls_k)} launches of (W, {events[0][1]}), W {min(windows)}-{max(windows)}"
        bound(r)
        r["launches"] = len(calls_k)
        log_kernel(f"{name} (the stream's launches)", r)
        log(f"    torch ops it took off its stage, per launch on the same inputs: {r['removed_ms']:.4f} ms")
        stream_rows[name] = r
    return counts, row, stream_rows


# ---------------------------------------------------------------------------
# Phase 6: the detection service, a session across devices, Table I.
# ---------------------------------------------------------------------------

def service_recordings(n: int) -> list:
    """Session k's recording: family k mod 5, seed 17 k, 2.5 s."""
    import dataclasses

    from repro_torch.data.synthetic import SCENARIO_FAMILIES, make_fleet_recordings

    recs = []
    for k in range(n):
        fam = SERVICE_FAMILIES[k % len(SERVICE_FAMILIES)]
        rec = make_fleet_recordings(1, scenario=SCENARIO_FAMILIES[fam], seed0=17 * k,
                                    duration_s=SERVICE_DURATION_S)[0]
        recs.append(dataclasses.replace(rec, name=f"station{k}-{fam}"))
    return recs


def service_schedule(max_sessions: int, rounds: int) -> dict:
    """Round -> [("detach" | "attach", session key)]: SERVICE_START
    sessions at round 0, one more every SERVICE_GROW_EVERY rounds up to
    ``max_sessions``, then every SERVICE_CHURN_EVERY rounds the oldest
    leaves and a new one joins."""
    sched = {0: [("attach", k) for k in range(SERVICE_START)]}
    live, nxt = list(range(SERVICE_START)), SERVICE_START
    full = SERVICE_GROW_EVERY * (max_sessions - SERVICE_START)
    for r in range(1, rounds):
        if r <= full and r % SERVICE_GROW_EVERY == 0:
            sched[r] = [("attach", nxt)]
            live.append(nxt)
            nxt += 1
        elif r > full and (r - full) % SERVICE_CHURN_EVERY == 0:
            sched[r] = [("detach", live.pop(0)), ("attach", nxt)]
            live.append(nxt)
            nxt += 1
    return sched


def run_service(cfg, recs, sched, rounds: int, dev, depth: int = 1) -> dict:
    """Drive a ``DetectionService`` through ``sched``: each round its
    attaches and detaches, one 20 ms chunk per live session, and a forced
    pump; at depth 1 each round's results are read inside it, at depth 2
    only after every round was dispatched. Then every session detaches.
    Returns parts and chunks per key, the rounds' host ms (closed by a
    synchronize), the service and the wall time."""
    import torch

    from repro_torch.data.evas import iter_chunks
    from repro_torch.serve import AdmissionConfig, DetectionService

    svc = DetectionService(cfg, tiers=SERVICE_TIERS, device=dev, max_inflight_rounds=depth,
                           admission=AdmissionConfig(max_delay_s=0.02, max_items=250 * 16))
    sync = torch.cuda.synchronize if svc.device.type == "cuda" else (lambda: None)
    chunks = {k: list(iter_chunks(rec, CHUNK_US)) for k, rec in enumerate(recs)}
    sid, key, start, fed, served, tails, ms = {}, {}, {}, {}, [], {}, []
    t_wall = time.perf_counter()
    for r in range(rounds):
        t0 = time.perf_counter()
        got = []
        for op, k in sched.get(r, ()):
            if op == "detach":
                tails[k] = svc.detach(sid.pop(k))
            else:
                sid[k], start[k], fed[k] = svc.attach(recs[k].name), r, []
                key[sid[k]] = k
        for k, s in sid.items():
            i = r - start[k]
            if i < len(chunks[k]):
                fed[k].append(chunks[k][i])
                got += svc.feed(s, *chunks[k][i])
        got += svc.pump(force=True)
        if depth == 1:
            for fd in got:
                fd.result  # noqa: B018 - a client reads its results
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        served += got
    for k in list(sid):
        tails[k] = svc.detach(sid.pop(k))
    svc.drain()
    sync()
    wall = time.perf_counter() - t_wall
    parts = {k: [] for k in fed}
    for fd in served:
        parts[key[fd.sid]].append(fd.result)
    for k in parts:
        parts[k].append(tails[k])
    return dict(parts=parts, fed=fed, ms=ms, svc=svc, wall=wall)


def require_clean(svc, what: str) -> None:
    """No device failure hidden by a retry or a degraded round."""
    require(svc.step_retries == 0 and svc.degraded_rounds == 0,
            f"{what}: {svc.step_retries} step retries, {svc.degraded_rounds} degraded rounds")


def path_launches(name: str, counts: dict, what: str) -> None:
    """Each kernel of the path ran, and no kernel of the other path."""
    own = SERVICE_KERNELS[name]
    require(all(counts[k] > 0 for k in own) and all(
        counts[k] == 0 for k in ("cluster_accum", "patch_metrics", "window_pipeline") if k not in own),
        f"{what} ({name}): launches {counts}, expected {own}")


def round_stats(ms) -> dict:
    import numpy as np

    lat = np.asarray(ms)
    return dict(p50=float(np.percentile(lat, 50)), p99=float(np.percentile(lat, 99)), max=float(lat.max()))


def check_service(name: str, cfg, dev) -> dict:
    """The service at full width on the card (SERVICE_FULL) at depth 1 and
    2 and the cut (SERVICE_CUT) on the card and the CPU. Returns the
    launches of the depth-1 run and its per-round numbers."""
    import numpy as np
    import torch

    from repro_torch.core.pipeline import StreamingPipeline
    from repro_torch.kernels import ops

    sched = service_schedule(**SERVICE_FULL)
    n_keys = 1 + max(k for evs in sched.values() for _, k in evs)
    recs = service_recordings(n_keys)
    run_service(cfg, recs[:4], service_schedule(**SERVICE_CUT), 8, dev)  # warm-up
    ops.reset_launches()
    one = run_service(cfg, recs, sched, SERVICE_FULL["rounds"], dev)
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    svc = one["svc"]
    require_clean(svc, f"service ({name})")
    path_launches(name, counts, "service")
    detaches = sum(op == "detach" for evs in sched.values() for op, _ in evs)
    require(svc.promotions == 2 and svc.capacity == 16 and svc.demotions == 0,
            f"service ({name}): promotions {svc.promotions}, capacity {svc.capacity}")
    require(len(svc.detached_sessions) == n_keys and n_keys == 16 + detaches,
            f"service ({name}): {len(svc.detached_sessions)} detached of {n_keys}")
    windows = sum(p.num_windows for parts in one["parts"].values() for p in parts)
    for k, chunks in one["fed"].items():
        sp = StreamingPipeline(cfg, wire="ragged", device=dev)
        want = [sp.feed(*c) for c in chunks] + [sp.flush()]
        compare_parts(concat_parts(one["parts"][k]), concat_parts(want),
                      f"service ({name}) session {k} vs its dedicated stream")
    two = run_service(cfg, recs, sched, SERVICE_FULL["rounds"], dev, depth=2)
    require_clean(two["svc"], f"service ({name}, depth 2)")
    for k in one["parts"]:
        compare_parts(concat_parts(two["parts"][k]), concat_parts(one["parts"][k]),
                      f"service ({name}) session {k}, depth 2 vs depth 1")
    cut_sched = service_schedule(**SERVICE_CUT)
    cut = {d: run_service(cfg, recs, cut_sched, SERVICE_CUT["rounds"], d) for d in (dev, "cpu")}
    for run in cut.values():
        require_clean(run["svc"], f"service cut ({name})")
    for k in cut[dev]["parts"]:
        compare_parts(concat_parts(cut[dev]["parts"][k]), concat_parts(cut["cpu"]["parts"][k]),
                      f"service cut ({name}) session {k}, cuda vs cpu", exact=False)
    lat = np.asarray(one["ms"])
    row = dict(**round_stats(lat), windows=windows, wall_s=one["wall"],
               windows_per_s=windows / one["wall"], launches=counts)
    log(f"[6] service, {name} path: {n_keys} sessions ({SERVICE_START} -> 16, promotions "
        f"{svc.promotions}, {detaches} churn detaches), {SERVICE_FULL['rounds']} rounds of "
        f"{CHUNK_US // 1000} ms, {windows} windows, launches {counts}; every session, detach "
        f"tail included, equal to its dedicated StreamingPipeline on the card; depth 2 equal to "
        f"depth 1; the {SERVICE_CUT['max_sessions']}-session {SERVICE_CUT['rounds']}-round cut "
        f"equal cuda vs cpu; step retries 0, degraded rounds 0")
    log(f"    per-round latency (host clock, attaches + feeds + forced pump + results read, "
        f"synchronize per round): p50 {row['p50']:.3f} ms, p99 {row['p99']:.3f} ms, max "
        f"{row['max']:.3f} ms (budget {BUDGET_MS} ms); {row['windows_per_s']:.0f} windows/s wall "
        f"({one['wall']:.2f} s with the final detaches); depth 2 wall {two['wall']:.2f} s; "
        "slowest rounds (index, ms, the round's attaches and detaches): " + ", ".join(
            f"({i}, {lat[i]:.3f}, {sched.get(int(i), [])})" for i in np.argsort(lat)[::-1][:3]))
    return row


def check_migration(cfg, dev) -> None:
    """A session exported on one device and adopted by a service on the
    other (through the numpy form), both ways, with chunks still queued
    at the export and a neighbour streaming on each side: equal to a
    never-migrated stream on the card."""
    from repro_torch.core.pipeline import StreamingPipeline
    from repro_torch.data.evas import iter_chunks
    from repro_torch.serve import (
        AdmissionConfig, DetectionService, session_export_from_numpy, session_export_to_numpy,
    )

    recs = service_recordings(3)
    mover, other = (list(iter_chunks(r, CHUNK_US)) for r in recs[1:3])
    cut = len(mover) // 2
    lazy = AdmissionConfig(max_delay_s=1e9, max_items=1 << 30)
    sp = StreamingPipeline(cfg, wire="ragged", device=dev)
    never = concat_parts([sp.feed(*c) for c in mover] + [sp.flush()])
    for src_dev, dst_dev in ((dev, "cpu"), ("cpu", dev)):
        src, dst = (DetectionService(cfg, tiers=(4,), admission=lazy, device=d)
                    for d in (src_dev, dst_dev))
        parts = []
        s, n = src.attach("mover"), src.attach("neighbour")
        for i in range(cut):
            src.feed(n, *other[i])
            src.feed(s, *mover[i])
            if i < cut - 2:  # the last two chunks stay queued for the export
                parts += [fd.result for fd in src.pump(force=True) if fd.sid == s]
        require(src.session(s).queued_events > 0, "migration: nothing queued at the export")
        exp = session_export_from_numpy(session_export_to_numpy(src.export_session(s)))
        dn = dst.attach("neighbour")
        dst.feed(dn, *other[0])
        new = dst.adopt_session(exp)
        for i in range(cut, len(mover)):
            dst.feed(new, *mover[i])
            parts += [fd.result for fd in dst.pump(force=True) if fd.sid == new]
        parts.append(dst.detach(new))
        require_clean(src, "migration source")
        require_clean(dst, "migration destination")
        compare_parts(concat_parts(parts), never, f"session migrated {src_dev} -> {dst_dev}",
                      exact=False)
    log(f"[6] a session exported on the card and adopted on the cpu, and the other way, "
        f"{cut} chunks in, two still queued: equal to a never-migrated stream on the card")


def check_table1(dev, scale) -> dict:
    """Table I on the card: ``grid_cluster``, ``kmeans(k=8, iters=16)`` and
    ``dbscan(eps=8, min_pts=5)`` per call under CUDA events on uniform
    batches; DBSCAN's labels equal to the CPU's exactly. And
    ``quantize_packed`` on the scale recording's words equal to K1."""
    import numpy as np
    import torch

    from repro_torch.core.baselines import dbscan, kmeans
    from repro_torch.core.events import batch_from_arrays, pack_words
    from repro_torch.core.grid_clustering import GridConfig, grid_cluster, quantize_packed
    from repro_torch.kernels import ops

    def batch(n, device):
        rng = np.random.default_rng(0)
        return batch_from_arrays(rng.integers(0, 640, n), rng.integers(0, 480, n), np.arange(n),
                                 rng.integers(0, 2, n), n, device)

    times = {"grid": {}, "kmeans": {}, "dbscan": {}}
    for n in TABLE1_GRID_N:
        b = batch(n, dev)
        times["grid"][n] = cuda_ms(lambda: grid_cluster(b, GridConfig()))
    for n in TABLE1_BASELINE_N:
        b, c = batch(n, dev), batch(n, "cpu")
        times["kmeans"][n] = cuda_ms(lambda: kmeans(b, k=8, iters=16), iters=5, warmup=1)
        times["dbscan"][n] = cuda_ms(lambda: dbscan(b, eps=8.0, min_pts=5), iters=5, warmup=1)
        g, h = dbscan(b, eps=8.0, min_pts=5), dbscan(c, eps=8.0, min_pts=5)
        equal(g.labels, h.labels, f"dbscan n={n} labels, cuda vs cpu")
        equal(g.core_mask, h.core_mask, f"dbscan n={n} core mask, cuda vs cpu")
        require(int(g.n_clusters) == int(h.n_clusters), f"dbscan n={n} clusters")
        km, kc = kmeans(b, k=8, iters=16), kmeans(c, k=8, iters=16)
        close(km.centroids, kc.centroids, f"kmeans n={n} centroids, cuda vs cpu", rtol=1e-5, atol=0.0)
    slope = {k: float(np.log(v[512] / v[128]) / np.log(4)) for k, v in times.items()}
    log("[6] Table I on the card (ms a call, CUDA events): " + "; ".join(
        f"{k} " + ", ".join(f"n={n} {t:.4f}" for n, t in v.items()) + f", slope n=128..512 "
        f"{slope[k]:.2f}" for k, v in times.items())
        + "; DBSCAN labels equal to the cpu run's at every n")
    words = pack_words(torch.as_tensor(scale.x, device=dev), torch.as_tensor(scale.y, device=dev))
    for cell in (16, 12):
        k1 = ops.grid_quantize_packed(words.to(torch.int32), cell)
        equal(k1.to(torch.int64) & 0xFFFFFFFF, quantize_packed(words, cell),
              f"quantize_packed vs grid_quantize_packed, cell {cell}")
    log(f"    quantize_packed on cuda equal to the grid_quantize_packed kernel on {words.numel()} "
        f"words (cells 16 and 12)")
    return dict(times=times, slope=slope)


# ---------------------------------------------------------------------------
# Phase 7: fault injection and scale-out serving.
# ---------------------------------------------------------------------------

def slowest_rounds(ms, schedule, n: int = 3) -> str:
    """The ``n`` slowest rounds as (index, ms, the fault kinds the schedule
    put in that round)."""
    import numpy as np

    kinds = {}
    for r, _, kind in schedule:
        kinds.setdefault(r, []).append(kind)
    lat = np.asarray(ms)
    return ", ".join(f"({i}, {lat[i]:.3f}, {kinds.get(int(i), [])})" for i in np.argsort(lat)[::-1][:n])


class KeepFaulted:
    """A harness wrapper that keeps the faulted run's record (the healthy
    sessions' parts) for a comparison across devices."""

    def __init__(self, harness):
        self.harness = harness
        self.faulted = None
        run = harness._run_faulted

        def keep():
            self.faulted = run()
            return self.faulted

        harness._run_faulted = keep


def check_chaos(name: str, cfg, dev) -> dict:
    """7a on one datapath: the full-width chaos harness on the card, its
    step_exception-only run, and its cut on the card and the CPU."""
    import dataclasses

    import torch

    from repro_torch.kernels import ops
    from repro_torch.serve import FAULT_TAXONOMY, ChaosConfig, ChaosHarness

    full = ChaosConfig(**CHAOS_FULL)
    harness = ChaosHarness(full, cfg, device=dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    rep = harness.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    what = f"[7a] chaos ({name})"
    path_launches(name, counts, what)
    require(set(rep.fired) == set(FAULT_TAXONOMY) and min(rep.fired.values()) >= 1,
            f"{what}: fired {rep.fired}")
    require(rep.escaped_errors == [], f"{what}: escaped {rep.escaped_errors}")
    require(rep.bit_identical and rep.healthy_windows > 0, f"{what}: {rep.mismatches[:5]}")
    require(rep.shed["exact"] and rep.shed["shed"] > 0, f"{what}: shed {rep.shed}")
    require(rep.quarantines >= 1 and rep.evictions >= 1,
            f"{what}: quarantines {rep.quarantines}, evictions {rep.evictions}")
    require(rep.step_retries + rep.degraded_rounds >= 1,
            f"{what}: step retries {rep.step_retries}, degraded rounds {rep.degraded_rounds}")
    lat = round_stats(rep.round_times_ms)
    log(f"{what}: {full.n_sensors} sensors ({full.n_faulty} faulty), {full.n_rounds} rounds of "
        f"{full.chunk_events} events, fired {rep.fired}; quarantines {rep.quarantines}, evictions "
        f"{rep.evictions}, step retries {rep.step_retries}, degraded rounds {rep.degraded_rounds}, "
        f"demotions {rep.demotions}, shed {rep.shed}; escaped errors none; {rep.healthy_windows} "
        f"healthy windows bit-identical to the fault-free twin; launches {counts}; wall {wall:.2f} s "
        "(faulted run and its fault-free twin)")
    log(f"    faulted rounds (host clock, injections + feeds + forced pump, depth 1): p50 "
        f"{lat['p50']:.3f} ms, p99 {lat['p99']:.3f} ms, max {lat['max']:.3f} ms; slowest rounds "
        f"(index, ms, faults scheduled): {slowest_rounds(rep.round_times_ms, harness.schedule())}")
    step = ChaosHarness(dataclasses.replace(full, faults=("step_exception",)), cfg, device=dev).run()
    require(step.step_retries >= 1 and step.degraded_rounds >= 1 and step.bit_identical
            and step.escaped_errors == [],
            f"{what}, step_exception only: retries {step.step_retries}, degraded "
            f"{step.degraded_rounds}, escaped {step.escaped_errors}, {step.mismatches[:3]}")
    log(f"    step_exception only: fired {step.fired['step_exception']}, step retries "
        f"{step.step_retries}, degraded rounds {step.degraded_rounds}; healthy outputs "
        f"bit-identical after the restored chunks were re-fed")
    cut = dataclasses.replace(full, **CHAOS_CUT)
    runs = {d: KeepFaulted(ChaosHarness(cut, cfg, device=d)) for d in (dev, "cpu")}
    reps = {d: k.harness.run() for d, k in runs.items()}

    def fields(r):
        return (r.fired, r.quarantines, r.evictions, r.degraded_rounds, r.step_retries,
                r.demotions, r.healthy_windows, r.shed, r.escaped_errors, r.bit_identical,
                [(e.kind, e.sid, e.time_s) for e in r.errors])

    require(fields(reps[dev]) == fields(reps["cpu"]),
            f"{what} cut: cuda {fields(reps[dev])} vs cpu {fields(reps['cpu'])}")
    require(reps[dev].bit_identical and reps[dev].escaped_errors == [], f"{what} cut: {reps[dev]}")
    gpu_parts, cpu_parts = (runs[d].faulted["healthy_parts"] for d in (dev, "cpu"))
    for sid, parts in gpu_parts.items():
        compare_parts(concat_parts(parts), concat_parts(cpu_parts[sid]),
                      f"{what} cut, healthy session {sid}, cuda vs cpu", exact=False)
    log(f"    cut ({cut.n_sensors} sensors, {cut.n_rounds} rounds, tiers {cut.tiers}): report and "
        f"healthy outputs equal on the card and the cpu")
    return dict(launches=counts, wall_s=wall, rounds=lat)


def constellation_schedule() -> dict:
    """Round -> [(op, arg)] of 7b: 32 sessions at round 0, then every
    CONST_CHURN_EVERY rounds the oldest leaves and a new one joins."""
    sched = {0: [("attach", k) for k in range(CONST_SESSIONS)]}
    live, nxt = list(range(CONST_SESSIONS)), CONST_SESSIONS
    for r in range(CONST_CHURN_EVERY, CONST_ROUNDS, CONST_CHURN_EVERY):
        sched[r] = [("detach", live.pop(0)), ("attach", nxt)]
        live.append(nxt)
        nxt += 1
    return sched


class ExchangeCheck:
    """The exchange's per-round bound and telescoping identity on every
    push. The bound is the reference test's, |deq - (plane + ef_prev)| <=
    scale / 2 + 1e-5, in float32, plus two float32 ulps of the plane's
    largest corrected value (the roundings of the quotient and of q *
    scale). The identity: over a run of pushes at one plane shape, the
    published sum equals the exact sum plus the residual before the run
    minus the residual after it (rtol 1e-5, atol 1e-3, as the reference's
    test). Each push is logged by reference to its device tensors, with
    no synchronization, and checked after its round, outside the timing."""

    def __init__(self, ex):
        self.ex = ex
        self.log = []
        self.runs = {}  # shard -> [exact sum, published sum, residual at the start, residual now]
        self.rounds = 0
        self.worst = 0.0  # largest |deq - (plane + ef_prev)| / scale
        push = ex.push_round

        def logged(shard, round_):
            ef_prev, n = ex._ef[shard], ex.rounds
            push(shard, round_)
            if ex.rounds != n:
                self.log.append((shard, round_, ef_prev, ex._latest[shard], ex._scale[shard], ex._ef[shard]))

        ex.push_round = logged

    def _close(self, shard) -> None:
        import numpy as np

        exact, pub, ef0, ef = self.runs.pop(shard)
        want = exact + ef0 - ef
        require(np.allclose(pub, want, rtol=1e-5, atol=1e-3),
                f"[7b] exchange telescoping, shard {shard}: max err {float(np.abs(pub - want).max())}")

    def check(self) -> None:
        import numpy as np

        from repro_torch.serve import CrossShardExchange

        for shard, rnd, ef_prev, deq, scale, ef in self.log:
            exact = CrossShardExchange.summary_plane(rnd).cpu().numpy()
            prev = np.zeros_like(exact)
            if ef_prev is not None:
                e = ef_prev.cpu().numpy()
                keep = min(e.shape[0], exact.shape[0])
                prev[:keep] = e[:keep]  # the push's resize: kept rows carry, new rows start clean
            corrected = exact + prev
            deq, scale = deq.cpu().numpy(), float(scale)
            err = float(np.abs(deq - corrected).max())
            tol = scale / 2 + 1e-5 + 2 * float(np.spacing(np.abs(corrected).max()))
            require(err <= tol, f"[7b] exchange bound, shard {shard}: {err} > {tol}")
            self.worst = max(self.worst, err / scale)
            run = self.runs.get(shard)
            if run is not None and run[0].shape != exact.shape:
                self._close(shard)
                run = None
            if run is None:
                run = self.runs[shard] = [np.zeros(exact.shape), np.zeros(exact.shape), prev.astype(np.float64), None]
            run[0] += exact
            run[1] += deq
            run[3] = ef.cpu().numpy().astype(np.float64)
            self.rounds += 1
        self.log.clear()

    def finish(self) -> None:
        self.check()
        for shard in list(self.runs):
            self._close(shard)


def check_constellation(cfg, dev) -> dict:
    """7b: the constellation's schedule on the card, every session against
    a dedicated StreamingPipeline on the card, the exchange's bounds."""
    import numpy as np
    import torch

    from repro_torch.core.pipeline import StreamingPipeline
    from repro_torch.data.evas import iter_chunks
    from repro_torch.kernels import ops
    from repro_torch.serve import AdmissionConfig, ConstellationService, FaultConfig
    from repro_torch.serve.chaos import _FakeClock, _FlakyFleet
    from repro_torch.serve.sessions import LIVE

    sched = constellation_schedule()
    n_keys = 1 + max(k for evs in sched.values() for _, k in evs)
    recs = service_recordings(n_keys)
    chunks = {k: list(iter_chunks(rec, CHUNK_US)) for k, rec in enumerate(recs)}
    clock = _FakeClock()
    cs = ConstellationService(
        cfg, n_shards=CONST_SHARDS, tiers=CONST_TIERS,
        admission=AdmissionConfig(max_delay_s=0.02, max_items=250 * 16),
        faults=FaultConfig(degrade_on_step_failure=True, max_step_retries=0),
        rescue_after_degraded_rounds=2, exchange="int8_ef", devices=[dev],
        clock=clock, sleep=lambda s: None,
    )
    check = ExchangeCheck(cs.exchange)
    gid, key, start, fed, parts, ms = {}, {}, {}, {}, {}, []
    stalled = None
    ops.reset_launches()
    t_wall = time.perf_counter()
    for r in range(CONST_ROUNDS):
        t0 = time.perf_counter()
        clock.now += CHUNK_US / 1e6
        got = []
        for op, k in sched.get(r, ()):
            if op == "detach":
                parts[k].append(cs.detach(gid.pop(k)))
            else:
                gid[k], start[k], fed[k], parts[k] = cs.attach(recs[k].name), r, [], []
                key[gid[k]] = k
        if r == CONST_MIGRATE_AT:
            g = gid[min(gid)]
            cs.migrate(g, (cs.shard_of(g) + 1) % CONST_SHARDS)
        if r == CONST_REBALANCE_AT:  # unbalance shard 0 -> 1, then a forced sweep
            for g in sorted(cs.shard(0).local_to_global.values())[-4:]:
                cs.migrate(g, 1)
            moves = cs.rebalance()
            require(moves >= 1 and max(cs.loads) - min(cs.loads) <= cs.rebalance_margin,
                    f"[7b] rebalance: {moves} moves, loads {cs.loads}")
        if r == CONST_STALL[0]:
            stalled = _FlakyFleet(cs.shard(CONST_STALL_SHARD).service._fleet)
            stalled.fail_next = 10**9
            cs.shard(CONST_STALL_SHARD).service._fleet = stalled
        if r == CONST_STALL[1] + 1:
            stalled.fail_next = 0
        if r == CONST_REVIVE_AT:
            require(cs.down_shards == [CONST_STALL_SHARD], f"[7b] down shards {cs.down_shards}")
            cs.revive_shard(CONST_STALL_SHARD)
        for k, g in gid.items():
            i = r - start[k]
            if i < len(chunks[k]):
                fed[k].append(chunks[k][i])
                got += cs.feed(g, *chunks[k][i])
        got += cs.pump(force=True)
        for f in got:
            f.result  # noqa: B018 - a client reads its results
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        for f in got:
            parts[key[f.gid]].append(f.result)
        check.check()
    require(all(cs.session(g).state == LIVE for g in gid.values()) and cs.n_sessions == len(gid),
            f"[7b] sessions lost: {cs.n_sessions} live of {len(gid)}")
    loads = cs.loads
    for k in list(gid):
        parts[k].append(cs.detach(gid.pop(k)))
    cs.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_wall
    counts = dict(ops.LAUNCHES)
    check.finish()
    path_launches("float", counts, "[7b] constellation")
    require(cs.rescues == 1 and cs.down_shards == [], f"[7b] rescues {cs.rescues}, down {cs.down_shards}")
    degraded = [sh.service.degraded_rounds for sh in cs._shards]
    require(degraded[CONST_STALL_SHARD] >= 2 and sum(degraded) == degraded[CONST_STALL_SHARD],
            f"[7b] degraded rounds per shard {degraded}")
    windows = 0
    for k, chunk_list in fed.items():
        sp = StreamingPipeline(cfg, wire="ragged", device=dev)
        want = [sp.feed(*c) for c in chunk_list] + [sp.flush()]
        compare_parts(concat_parts(parts[k]), concat_parts(want),
                      f"[7b] constellation session {k} vs its dedicated stream")
        windows += sum(p.num_windows for p in parts[k])
    st = cs.exchange.stats
    require(st["rounds"] == check.rounds and st["rounds"] > 0, f"[7b] exchange rounds {st}")
    lat = round_stats(ms)
    log(f"[7b] constellation, float path: {CONST_SHARDS} shards on {dev} (tiers {CONST_TIERS}), "
        f"{n_keys} sessions ({CONST_SESSIONS} live, one out and one in every {CONST_CHURN_EVERY} "
        f"rounds), {CONST_ROUNDS} rounds; migrations {cs.migrations}, rebalances {cs.rebalances}, "
        f"rescues {cs.rescues} (shard {CONST_STALL_SHARD} stalled rounds {CONST_STALL[0]}-"
        f"{CONST_STALL[1]}, degraded rounds {degraded}, revived at {CONST_REVIVE_AT}); loads at the "
        f"end {loads}; {windows} windows; every session, detach tail included, equal to its "
        f"dedicated StreamingPipeline on the card; no session lost; launches {counts}")
    log(f"    exchange: {st['rounds']} published planes, compression_ratio "
        f"{st['compression_ratio']:.3f} ({st['wire_bytes']} vs {st['exact_bytes']} bytes); every "
        f"round within scale / 2 (worst {check.worst:.4f} scale) and the telescoping identity held")
    log(f"    per-round latency (host clock, churn + feeds + forced pump on every up shard + "
        f"results read, synchronize per round): p50 {lat['p50']:.3f} ms, p99 {lat['p99']:.3f} ms, "
        f"max {lat['max']:.3f} ms (budget {BUDGET_MS} ms); {windows / wall:.0f} windows/s wall "
        f"({wall:.2f} s with the final detaches); slowest rounds (index, ms): " + ", ".join(
            f"({i}, {ms[i]:.3f})" for i in np.argsort(ms)[::-1][:3]))
    return dict(launches=counts, wall_s=wall, rounds=lat, windows=windows,
                compression_ratio=st["compression_ratio"])


def check_shard_chaos(cfg, dev) -> dict:
    """7c: the shard chaos harness at full width on the card."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serve import ShardChaosConfig, ShardChaosHarness

    harness = ShardChaosHarness(ShardChaosConfig(**SHARD_CHAOS), cfg, device=dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    rep = harness.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    path_launches("float", counts, "[7c] shard chaos")
    require(rep.bit_identical and rep.healthy_windows > 0, f"[7c] shard chaos: {rep.mismatches[:5]}")
    require(rep.rescues >= 1 and rep.lost_sessions == 0 and rep.escaped_errors == [],
            f"[7c] shard chaos: rescues {rep.rescues}, lost {rep.lost_sessions}, escaped "
            f"{rep.escaped_errors}")
    lat = round_stats(rep.round_times_ms)
    log(f"[7c] shard chaos, float path: {SHARD_CHAOS['n_shards']} shards, "
        f"{SHARD_CHAOS['n_sensors']} sensors ({SHARD_CHAOS['n_faulty']} faulty), "
        f"{SHARD_CHAOS['n_rounds']} rounds; fired {rep.fired}; migrations {rep.migrations}, "
        f"rebalances {rep.rebalances}, rescues {rep.rescues}, lost sessions 0, quarantines "
        f"{rep.quarantines}, evictions {rep.evictions}, degraded rounds {rep.degraded_rounds}; "
        f"escaped errors none; {rep.healthy_windows} healthy windows bit-identical to dedicated "
        f"streams; exchange {rep.exchange}; launches {counts}; wall {wall:.2f} s")
    log(f"    faulted rounds (host clock, depth 2 per shard, no synchronize): p50 {lat['p50']:.3f} "
        f"ms, p99 {lat['p99']:.3f} ms, max {lat['max']:.3f} ms; slowest rounds (index, ms, faults "
        f"scheduled): {slowest_rounds(rep.round_times_ms, harness.schedule())}")
    return dict(launches=counts, wall_s=wall, rounds=lat)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    # Fails outside a checkout of the repo, before any result is printed.
    from repro_torch.core.events import EventBatch, pad_windows
    from repro_torch.core.pipeline import PipelineConfig, config as C
    from repro_torch.core.pipeline import evaluate_detection, run_recording_scan
    from repro_torch.core.pipeline.scan import WINDOW_BLOCK
    from repro_torch.core.pipeline.window_core import _cluster, _condition
    from repro_torch.data.synthetic import make_recording
    from repro_torch.kernels import _build, ops

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = PipelineConfig(use_kernels=True, metrics_impl="kernel")

    # Phase 1: build.
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"[1] built {sorted(libs)} in {time.perf_counter() - t0:.1f} s "
        f"into {_build.build_dir().relative_to(ROOT)}")
    for name in libs:
        logf = _build.build_dir() / f"{name}.log"
        if logf.exists():
            for line in logf.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"    {name}: {line.strip()}")

    # Phase 2: kernels against their plain versions.
    fixed = PipelineConfig(numerics="fixed", metrics_impl="megakernel")
    staged = PipelineConfig(numerics="fixed", metrics_impl="staged")
    scale = make_recording(**SCALE)
    win = pad_windows(scale.x, scale.y, scale.t, scale.p, cfg.batcher, dev)
    # The blocks the scan's window core runs on, one kernel launch each.
    n_win = win.batch.x.shape[0]
    raws = [EventBatch(*(a[lo:lo + WINDOW_BLOCK] for a in win.batch))
            for lo in range(0, n_win, WINDOW_BLOCK)]
    blocks = [(b, _cluster(cfg, C._histogram_fn(cfg), b)) for b in (_condition(cfg, r) for r in raws)]
    log(f"[2] kernels vs plain versions on the card, main-path blocks "
        f"{[tuple(b.x.shape) for b, _ in blocks]}")
    kernels = check_kernels(dev, blocks)
    large_err = check_large_sizes(dev)
    for name in FLOAT_KERNELS:
        kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], large_err[name])
    kernels["cluster_accum"]["max_abs_err"] = max(kernels["cluster_accum"]["max_abs_err"],
                                                  large_err["centroid_t"])
    stride, stride_win, stride_cfg = stride_blocks(scale, cfg, dev)
    large_rows = time_large(stride)
    kernels["window_pipeline"] = check_window_pipeline(dev, raws, fixed)
    fleet_recs = [make_recording(seed=11 + s, **FLEET) for s in range(FLEET_SENSORS)]
    ops.reset_launches()
    kernels.update(check_wire_kernels(dev, scale, fleet_recs))
    torch.cuda.synchronize()
    phase2 = dict(ops.LAUNCHES)  # the no-path kernels' only launches
    phase2_err = kernels["event_unpack"]["max_abs_err"]

    # Phase 3: each path on the quickstart recording, its launch counters
    # set to 0 just before it and read just after.
    rec = make_recording(**QUICKSTART)
    quick = {}
    for name, c, own in (("float", cfg, FLOAT_KERNELS), ("fixed", fixed, FIXED_KERNELS)):
        ops.reset_launches()
        gpu = run_main_path(rec, c, dev)
        torch.cuda.synchronize()
        counts = dict(ops.LAUNCHES)
        cpu = run_main_path(rec, c, "cpu")
        s_gpu, s_cpu = summary(*gpu, c), summary(*cpu, c)
        log(f"[3] quickstart, {name} path: cuda {s_gpu}, cpu {s_cpu}, launches {counts}")
        compare_runs(gpu, cpu, f"quickstart ({name})")
        require(s_gpu == QUICKSTART_EXPECT, f"quickstart ({name}): expected {QUICKSTART_EXPECT}")
        require(all(v == 0 for k, v in counts.items() if k not in own),
                f"quickstart ({name}): another path's kernel ran: {counts}")
        quick.update({k: counts[k] for k in own})
    quick["event_unpack"] = check_quick_fleet(cfg, "float", FLEET_KERNELS, dev)["event_unpack"]
    check_quick_fleet(fixed, "fixed", FIXED_KERNELS, dev)
    for name, c, own in (("float", cfg, FLOAT_KERNELS), ("fixed", fixed, FIXED_KERNELS)):
        check_loop_driver(rec, c, name, own, dev)
    sweep = check_sweep(cfg, fixed, dev)

    # Phase 4: each path at real scale. The kernels line's launches are
    # this phase's: one pass of the scale recording through each path's
    # driver (the scan for the float and fixed kernels, the stream for
    # the decode), each path's counters set to 0 just before it.
    launches = {}
    ops.reset_launches()
    t0 = time.perf_counter()
    scan = run_recording_scan(scale, cfg, device=dev)
    torch.cuda.synchronize()
    scale_launches = dict(ops.LAUNCHES)
    gpu = (scan, evaluate_detection(scale, cfg, device=dev))
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    launches.update({k: scale_launches[k] for k in FLOAT_KERNELS})
    t0 = time.perf_counter()
    cpu = run_main_path(scale, cfg, "cpu")
    cpu_s = time.perf_counter() - t0
    compare_runs(gpu, cpu, "scale")
    s_gpu = summary(*gpu, cfg)
    log(f"[4] scale recording ({len(scale)} events), float path: cuda {s_gpu}, launches "
        f"{scale_launches}; first cuda run {first:.2f} s, cpu run {cpu_s:.2f} s; integer outputs identical")
    require(all(scale_launches[k] > 0 for k in FLOAT_KERNELS), f"scale launches {scale_launches}")
    n = s_gpu["windows"]
    times, win = stage_times(scale, cfg, dev)
    log("    steady state (best of 3, ms per recording / per window): " + ", ".join(
        f"{k} {v:.1f} / {v / n:.4f}" for k, v in times.items()))
    prof = window_core_profile(scale, cfg, dev, win)
    log(f"    window core under the profiler: host {prof['host_ms']:.1f} ms, device busy "
        f"{prof['device_busy_ms']:.2f} ms; by stage (host ms, kernel ms, device span ms): "
        + ", ".join(f"{k} ({h:.2f}, {d:.2f}, {sp:.2f})" for k, (h, d, sp) in prof["ranges"].items())
        + "; device kernels per block: " + ", ".join(f"{k} {v}" for k, v in prof["kernels"].items()))
    require_one_launch_per_block(prof, len(raws), "scan window core")
    stride_run = check_stride_scale(scale, stride_cfg, stride_win, dev)

    fixed_counts = check_fixed_scale(scale, fixed, staged, dev, times["window core"])
    launches.update({k: fixed_counts[k] for k in FIXED_KERNELS})
    stream_counts, kernels["event_unpack"], stream_rows = check_stream(cfg, scale, scan, dev)
    kernels["event_unpack"]["max_abs_err"] = max(
        kernels["event_unpack"]["max_abs_err"], phase2_err)
    launches["event_unpack"] = stream_counts["event_unpack"]
    fleet_counts = check_full_fleet(cfg, fleet_recs, dev)

    # Phase 5: the kernels ran on their paths.
    path_kernels = [k for k in REPLACES if k not in NO_PATH]
    require(all(launches[k] > 0 and quick[k] > 0 for k in path_kernels),
            f"[5] a kernel was not launched on its path: scale {launches}, quickstart {quick}")
    require(all(fleet_counts[k] > 0 for k in FLEET_KERNELS), f"[5] full fleet {fleet_counts}")
    log(f"[5] launch counters, one pass of the scale recording through each path's driver "
        f"(run_recording_scan, float and fixed; the ragged stream for event_unpack): {launches}; "
        f"quickstart runs (scan; 4-sensor fleet for event_unpack): {quick}; full-width fleet: "
        f"{ {k: fleet_counts[k] for k in FLEET_KERNELS} }; "
        f"{ {k: phase2[k] for k in NO_PATH} } in phase 2 for the kernels no path reaches")
    launches.update({k: phase2[k] for k in NO_PATH})

    # Phase 6: the detection service on both datapaths, each run's
    # counters set to 0 just before it; a session across devices; Table I.
    t6 = time.perf_counter()
    service = {name: check_service(name, c, dev) for name, c in (("float", cfg), ("fixed", fixed))}
    check_migration(cfg, dev)
    check_table1(dev, scale)
    log(f"[6] phase wall time {time.perf_counter() - t6:.1f} s")

    # Phase 7: fault injection and scale-out serving, each run's counters
    # set to 0 just before it.
    t7 = time.perf_counter()
    chaos = {name: check_chaos(name, c, dev) for name, c in (("float", cfg), ("fixed", fixed))}
    constellation = check_constellation(cfg, dev)
    shard_chaos = check_shard_chaos(cfg, dev)
    log(f"[7] phase wall time {time.perf_counter() - t7:.1f} s")

    rows = []
    for name, r in kernels.items():
        row = dict(
            name=name, route="cuda", source=SOURCE[name], replaces=REPLACES[name],
            launches=launches[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            # ms: the kernels alone (profiler), per launch; call_ms: the
            # wrapper's call under CUDA events, host work included.
            call_ms=r["call_ms"], timed_on=str(r["shape"]),
        )
        if "removed_ms" in r:  # the torch ops the stage kernel took off its stage
            row["removed_ops_ms"] = r["removed_ms"]
        if "rows_entry" in r:
            row["rows_entry"] = r["rows_entry"]
        for path, r6 in service.items():  # the service run that drives this kernel
            if name in SERVICE_KERNELS[path]:
                row["service_launches"] = r6["launches"][name]
                row["service_launches_on"] = (
                    f"DetectionService, {path} path, {SERVICE_FULL['rounds']} rounds of the "
                    f"phase-6 schedule at depth 1")
                row["chaos_launches"] = chaos[path]["launches"][name]
                row["chaos_launches_on"] = (
                    f"ChaosHarness.run, {path} path, {CHAOS_FULL['n_sensors']} sensors, "
                    f"{CHAOS_FULL['n_rounds']} rounds (faulted run and fault-free twin)")
        if name in SERVICE_KERNELS["float"]:
            row["constellation_launches"] = constellation["launches"][name]
            row["shard_chaos_launches"] = shard_chaos["launches"][name]
            row["constellation_launches_on"] = (
                f"ConstellationService, float path, {CONST_SHARDS} shards, {CONST_ROUNDS} rounds; "
                f"shard_chaos_launches: ShardChaosHarness.run, {SHARD_CHAOS['n_rounds']} rounds")
        if name in NO_PATH:
            row["path"] = "no path (tests only, as in the reference); launches are phase 2's"
        else:
            row["launches_on"] = LAUNCH_BASIS[name]
            # Rule 2's ranking: launches x (alone - bound), in ms.
            row["score_ms"] = launches[name] * (r["ms"] - r["bound_ms"])
        if name in large_rows:  # the large path, per launch on the stride windows
            lg = large_rows[name]
            row["large_path"] = dict(
                launches=stride_run[name], ms=lg["ms"], call_ms=lg["call_ms"], plain_ms=lg["plain_ms"],
                bound_ms=lg["bound_ms"], bound_by=lg["bound_by"], library_ms=None, timed_on=str(lg["shape"]),
                launches_on=f"run_recording_scan of the scale recording in {STRIDE_US // 1000} ms stride "
                            f"windows at capacity {STRIDE_CAPACITY} (float, untracked)",
            )
        if name in stream_rows:  # the same kernel per launch on the ragged stream
            st = stream_rows[name]
            row["stream"] = dict(
                launches=st["launches"], ms=st["ms"], call_ms=st["call_ms"],
                plain_ms=st["plain_ms"], bound_ms=st["bound_ms"], bound_by=st["bound_by"],
                score_ms=st["launches"] * (st["ms"] - st["bound_ms"]), timed_on=st["shape"],
                launches_on=LAUNCH_BASIS["event_unpack"], removed_ops_ms=st["removed_ms"],
            )
        rows.append(row)
    log(f"[5] threshold_sweep on the card (float kernel, scan driver): launches {sweep['launches']}, "
        f"wall {sweep['wall_ms'][1]:.1f} ms; stride-window scale run: window core "
        f"{stride_run['window_core_ms']:.2f} ms over {stride_run['windows']} windows")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
