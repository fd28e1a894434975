#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Two paths are driven: the float main path (``use_kernels=True,
metrics_impl="kernel"``: the ``cluster_accum`` and ``patch_metrics``
kernels) and the fixed-point path (``numerics="fixed",
metrics_impl="megakernel"``: the ``window_pipeline`` kernel).

Phases (any failure exits non-zero; no error is caught):

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and on adversarial windows, and time kernel, plain
   version and, where one exists, a one-call library yardstick;
3. each path on the quickstart recording through the entry points
   (``run_recording_scan`` + ``evaluate_detection``), on the card and on
   the CPU: integer outputs equal, the reference counts, and each path's
   launch counters read just after it ran;
4. each path at real scale (60 s, 20 kHz noise, 5,154 windows): the float
   path's integer outputs equal to the CPU run, the fixed path's equal to
   its staged route on the card; steady-state times of the entry points'
   own functions, and the window core's stages from a profile;
5. every kernel of each path was launched on it.

Then one JSON line of per-kernel numbers, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.
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
REPLACES = {
    "cluster_accum": "src/repro/kernels/cluster_accum.py:69",
    "patch_metrics": "src/repro/kernels/patch_metrics.py:80",
    "window_pipeline": "src/repro/kernels/window_pipeline.py:230",
}
SCALE = dict(seed=11, duration_s=60, n_rsos=4, noise_rate_hz=20_000)


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
        f"{a[tuple(diff[0])].item()} vs {b[tuple(diff[0])].item()}" if len(diff) else "",
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

def check_kernels(dev, main_batch, main_clusters) -> dict:
    """Hold both kernels against their plain versions; time them."""
    import torch

    from repro_torch.core import metrics as M
    from repro_torch.core.grid_clustering import GridConfig
    from repro_torch.data.adversarial import adversarial_batch, edge_slot_clusters
    from repro_torch.kernels import cluster_accum as _ca
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import patch_metrics as _pm

    adv = adversarial_batch(dev)
    results = {}

    # cluster_accum: exact, at cell sizes 16 and 12, adversarial + main path.
    err_ca = 0.0
    for cs in (16, 12):
        g = GridConfig(cell_size=cs)
        kw = dict(cell_size=cs, grid_w=g.grid_w, grid_h=g.grid_h, width=640, height=480)
        for name, b in (("adversarial", adv), ("main path", main_batch)):
            got = ops.cluster_accum(b.x, b.y, b.t, b.valid, **kw)
            exp = ref.cluster_accum_ref(b.x, b.y, b.t, b.valid, **kw)
            for field, a, e in zip(("count", "sum_x", "sum_y", "sum_t"), got, exp):
                err_ca = max(err_ca, equal(a, e, f"cluster_accum {field} ({name}, cell_size={cs})"))
    log("  cluster_accum: identical to the plain version (adversarial + main path, cell 16 and 12)")

    # patch_metrics: adversarial windows with clusters at min_events=1 plus
    # edge / invalid slots, and the main path block.
    adv_cl = edge_slot_clusters(adv)
    err_pm = 0.0
    exact = {"event_count", "edge_density"}
    for name, b, cl in (("adversarial", adv, adv_cl), ("main path", main_batch, main_clusters)):
        got = ops.patch_metrics(b, cl)
        c, leader, w, norm = M.event_normalizer(b, 640, 480)
        x0, y0 = M.window_origin(cl.centroid_x, cl.centroid_y, 640, 480)
        exp = ref.patch_metrics_ref(b.x, b.y, w, c, leader, x0, y0, cl.count, cl.valid, norm)
        for i, m in enumerate(M.METRIC_NAMES):
            check = equal if m in exact else close
            err_pm = max(err_pm, check(got[m], exp[..., i], f"patch_metrics {m} ({name})"))
    log(f"  patch_metrics: event_count/edge_density identical, others max abs err {err_pm:.3e}")

    # Timing at the main path's block shape.
    b = main_batch
    g = GridConfig()
    kw = dict(cell_size=16, grid_w=g.grid_w, grid_h=g.grid_h, width=640, height=480)
    n_win, e = b.x.shape
    n_cells = g.n_cells
    xi, yi, ti, vi = (a.contiguous() for a in (b.x, b.y, b.t, b.valid))
    ca_ms = cuda_ms(lambda: _ca.cluster_accum(xi, yi, ti, vi, **kw))
    ca_plain = cuda_ms(lambda: ref.cluster_accum_ref(xi, yi, ti, vi, **kw))
    # Yardstick: one index_add_ of the (E, 4) stats into (W * n_cells, 4).
    inb = (xi >= 0) & (xi < 640) & (yi >= 0) & (yi < 480) & vi
    wf = inb.float()
    flat = ((yi // 16) * g.grid_w + (xi // 16)).clamp(0, n_cells - 1).long()
    flat = (flat + n_cells * torch.arange(n_win, device=dev)[:, None]).reshape(-1)
    stats = torch.stack([wf, wf * xi, wf * yi, wf * ti], -1).reshape(-1, 4)
    acc = torch.zeros((n_win * n_cells, 4), device=dev)
    ca_lib = cuda_ms(lambda: acc.zero_().index_add_(0, flat, stats))
    # Bytes the kernel must move for this block: x, y and valid of every
    # event, t of each in-sensor valid event, four (n_cells,) rows out.
    ca_bytes = n_win * e * (4 + 4 + 1) + int(inb.sum()) * 4 + n_win * n_cells * 16
    ca_ops = n_win * e * 12 + n_win * n_cells * 4
    results["cluster_accum"] = dict(
        ms=ca_ms, plain_ms=ca_plain, library_ms=ca_lib, max_abs_err=err_ca,
        bytes=ca_bytes, ops=ca_ops,
    )

    cl = main_clusters
    c, leader, w, norm = M.event_normalizer(b, 640, 480)
    x0, y0 = M.window_origin(cl.centroid_x, cl.centroid_y, 640, 480)
    args = [a.contiguous() for a in (
        b.x, b.y, w, c.int(), leader, x0, y0, cl.count.int(), cl.valid, norm
    )]
    pm_ms = cuda_ms(lambda: _pm.patch_metrics(*args))
    pm_plain = cuda_ms(lambda: ref.patch_metrics_ref(*args), iters=3, warmup=1)
    k = cl.count.shape[-1]
    n_valid = int(cl.valid.sum())
    n_busy = int(cl.valid.any(-1).sum())
    # Bytes the kernel must move: the events (x, y, c int32; w, leader
    # bool) and norm of each window that holds a valid slot, cvalid of
    # every slot, x0/y0/count of each valid slot, six floats out per slot.
    pm_bytes = n_busy * (e * 14 + 4) + n_win * k * (1 + 24) + n_valid * 12
    # Per valid slot: ~8 ops per event of the window (offsets, compares,
    # atomics), ~25 per pixel for the Sobel, e2, sqrt and three
    # reductions, 2 per pixel for the edge pass, ~320 for the epilogue.
    pm_ops = n_valid * (8 * e + 27 * M.WINDOW * M.WINDOW + 320)
    results["patch_metrics"] = dict(
        ms=pm_ms, plain_ms=pm_plain, library_ms=None, max_abs_err=err_pm,
        bytes=pm_bytes, ops=pm_ops, valid_slots=n_valid, busy_windows=n_busy,
    )
    for name, r in results.items():
        bound(r)
        log_kernel(name, r, (n_win, e))
    return results


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


def check_window_pipeline(dev, raw_block, cfg) -> dict:
    """Hold the fixed-point megakernel against its plain version (the
    staged path) to the bit, on the main path's raw block and on
    adversarial windows; time it."""
    import dataclasses

    import torch

    from repro_torch.core import fixed_point as FX
    from repro_torch.core.events import roi_filter
    from repro_torch.core.grid_clustering import GridConfig
    from repro_torch.core.pipeline.window_core import _condition
    from repro_torch.data.adversarial import (
        adversarial_batch, clustered_window, named_windows, stacked_batch,
    )
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import window_pipeline as _wp

    c12 = dataclasses.replace(cfg, grid=GridConfig(cell_size=12))
    named = stacked_batch(list(named_windows().values()), dev)
    cases = (
        ("main path", raw_block, cfg),
        ("main path, cell 12", raw_block, c12),
        ("six named windows", named, cfg),
        ("six named windows, cell 12", named, c12),
        ("adversarial", adversarial_batch(dev), cfg),
        ("adversarial, cell 12", adversarial_batch(dev), c12),
        ("capacity 1024", stacked_batch([clustered_window(s, n=1000, capacity=1024) for s in range(4)], dev), cfg),
    )
    err = 0.0
    for name, b, c in cases:
        err = max(err, compare_fixed(
            ops.window_pipeline(b, c), ref.window_pipeline_ref(b, c), f"window_pipeline ({name})"))
    log("  window_pipeline: fields, metrics and valid-slot surfaces identical to the plain version "
        "(main path, six named windows, adversarial, cell 16 and 12, capacity 1024)")

    g = cfg.grid
    n_win, e = raw_block.x.shape
    k = g.max_clusters
    xi, yi, ti, vi = (a.contiguous() for a in (raw_block.x, raw_block.y, raw_block.t, raw_block.valid))
    kw = dict(roi=tuple(cfg.roi), hot_pixel_max=cfg.hot_pixel_max, cell_size=g.cell_size,
              grid_w=g.grid_w, grid_h=g.grid_h, min_events=g.min_events, k=k,
              width=g.width, height=g.height)
    wp_ms = cuda_ms(lambda: _wp.window_pipeline(xi, yi, ti, vi, **kw))
    # The plain version of what the kernel computes: the integer stages
    # of the staged path (the float epilogue runs after either).
    wp_plain = cuda_ms(lambda: FX.fixed_stage_surfaces(cfg, raw_block), iters=3, warmup=1)
    # The work this block's data needs, from the plain version's masks
    # and surfaces, counted by what the function needs and not by the
    # kernel's own loops (its pairwise and K arg-max passes do far more).
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
    r = dict(ms=wp_ms, plain_ms=wp_plain, library_ms=None, max_abs_err=err,
             bytes=wp_bytes, ops=wp_ops, ops_peak=PEAK_INT32_S, valid_slots=n_valid,
             busy_windows=int(fc.valid.any(-1).sum()))
    bound(r)
    log_kernel("window_pipeline", r, (n_win, e))
    return r


def bound(r: dict) -> None:
    """Add ``bound_ms`` and ``bound_by`` to a kernel's result."""
    t_bytes = r["bytes"] / PEAK_BYTES_S * 1e3
    t_ops = r["ops"] / r.get("ops_peak", PEAK_OPS_S) * 1e3
    r["bound_ms"] = max(t_bytes, t_ops)
    r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"


def log_kernel(name: str, r: dict, shape) -> None:
    log(f"  {name} at {tuple(shape)}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
        f"library {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} ms, "
        f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
        f"({r['bytes']} B, {r['ops']} ops"
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


def window_core_profile(rec, cfg, dev, win, stages=("conditioning", "clustering", "metrics")) -> dict:
    """One ``run_recording_scan`` without the tracker under
    ``torch.profiler``. For each ``record_function`` range in ``stages``:
    its host ms, the ms of the kernels launched in it, and the device span
    from its first kernel's start to its last's end. Also the device's busy
    ms (kernels, copies and fills) and the run's host ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.pipeline import run_recording_scan

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_recording_scan(rec, cfg, with_tracking=False, windows=win, device=dev)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ranges = {k: [0.0, 0.0, 0.0] for k in stages}
    busy = 0.0
    # A range shows up twice: as a host event, whose device time sums the
    # kernels launched inside it, and as a device-side annotation span.
    for e in prof.events():
        on_device = e.device_type == DeviceType.CUDA
        if e.name in ranges:
            r = ranges[e.name]
            if on_device:
                r[2] += e.device_time_total / 1e3
            else:
                r[0] += e.cpu_time_total / 1e3
                r[1] += e.device_time_total / 1e3
        elif on_device:
            busy += e.device_time_total / 1e3
    return dict(ranges=ranges, device_busy_ms=busy, host_ms=wall)


def check_fixed_scale(rec, fixed, staged, dev, float_core_ms: float) -> None:
    """The fixed path at scale, untracked, plus ``evaluate_detection``:
    the megakernel route's outputs identical to the staged route's on the
    card; then steady-state times beside the float window core's."""
    import torch

    from repro_torch.core.events import pad_windows
    from repro_torch.core.pipeline import evaluate_detection, run_recording_scan
    from repro_torch.kernels import ops

    ops.reset_launches()
    mega = run_recording_scan(rec, fixed, with_tracking=False, device=dev)
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    # Fails outside a checkout of the repo, before any result is printed.
    from repro_torch.core.events import EventBatch, pad_windows
    from repro_torch.core.pipeline import PipelineConfig, config as C
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
    raw = EventBatch(*(a[:4096] for a in win.batch))
    block = _condition(cfg, raw)
    clusters = _cluster(cfg, C._histogram_fn(cfg), block)
    log(f"[2] kernels vs plain versions on the card, main-path block {tuple(block.x.shape)}")
    kernels = check_kernels(dev, block, clusters)
    kernels["window_pipeline"] = check_window_pipeline(dev, raw, fixed)

    # Phase 3: each path on the quickstart recording, its launch counters
    # set to 0 just before it and read just after.
    rec = make_recording(**QUICKSTART)
    launches = {}
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
        launches.update({k: counts[k] for k in own})

    # Phase 4: each path at real scale.
    ops.reset_launches()
    t0 = time.perf_counter()
    gpu = run_main_path(scale, cfg, dev)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    scale_launches = dict(ops.LAUNCHES)
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
        + ", ".join(f"{k} ({h:.2f}, {d:.2f}, {sp:.2f})" for k, (h, d, sp) in prof["ranges"].items()))

    check_fixed_scale(scale, fixed, staged, dev, times["window core"])

    # Phase 5: the kernels ran on their paths.
    require(all(launches[k] > 0 for k in REPLACES),
            f"[5] a kernel was not launched on its path: {launches}")
    log(f"[5] launch counters on the quickstart paths: {launches}")

    rows = []
    for name, r in kernels.items():
        rows.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces=REPLACES[name],
            launches=launches[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
        ))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
