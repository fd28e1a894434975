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
``event_unpack`` kernel, then the float kernels). Phase 8 also drives
the reference's other two float routes, the frame oracle and the atlas
event core (``cluster_accum`` on both, ``event_unpack`` on the live
ingest path).

Phases (a failure prints its phase's number and traceback to standard
output and exits 1; nothing is caught that lets the run go on):

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc``, one
   ``nvcc`` per source, all at once;
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and on adversarial inputs, and time kernel, plain
   version and, where one exists, a one-call library yardstick; this
   includes ``grid_quantize_packed`` and ``window_entropy``, which no
   pipeline route reaches (in the reference neither; ``window_entropy``
   at K = 0, 1, 32 and the K6_PROBE probe, each of its two paths forced
   at K >= 32). Beside the two
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
   faulted rounds are printed with the fault kinds scheduled in them;
8. the reference's other float metric routes, the frame oracle
   (``metrics_impl="frame"``) and the atlas event core (the default
   ``metrics_impl="event"``): (a) the scale recording under the event,
   frame and kernel routes with ``use_kernels=True`` and under
   ``PipelineConfig()``: cluster fields, tracker integers and
   tp/fp/fn/tn equal across the four, the event and frame metrics equal
   bit for bit, the kernel route's within the stated bound,
   ``cluster_accum`` launched on each kernel run, and the frame route
   equal to its CPU run; (b) the event route's atlas over the ragged
   stream of the scale recording's first 10 s (and a 2 s cut with a
   forced tag rollover) equal to the CPU stream's, ``event_unpack``
   launched, no host synchronization in the event core
   (``torch.cuda.set_sync_debug_mode``); (c) a 16-sensor event-route
   fleet, every sensor's exported atlas equal to its dedicated stream's,
   and phase 6's session migration on the event route, atlas included;
   (d) ``window_entropy`` on 64 real reconstructed frames (timed beside
   its bound and floor) against its
   plain version and the frame oracle; (e) Fig. 7 (``metric_matrix``,
   ``correlation_matrix``) on the card against the CPU run, the 6x6
   matrix printed; (f) each route's untracked window core at scale (best
   of 3), its profile and the atlas update's device ms;
9. the LM serving path at Llama-3.2-1B's full width (``examples/torch_serve_lm.py``
   -> ``launch/serve.py`` -> ``serve/lm.py:ServingEngine`` ->
   ``models/transformer.py:prefill`` / ``decode_step``; no TPU kernel lies
   on it, so the path is plain PyTorch): (a) random weights from
   ``torch.Generator`` seed 0 on the card, served as a bf16 copy, 24
   requests of 16-64 prompt tokens and 16 new ones in batches of 8: every
   answer 16 tokens, each batch's prefill and decode steps under CUDA
   events beside their bounds, tokens/s, mean batch latency, peak memory,
   and the host synchronizations of a decode step and of a whole batch
   under ``torch.cuda.set_sync_debug_mode``; (b) teacher forcing:
   ``forward_train`` over the first batch's prompts and answers against
   the logits that served them; (c) the same float32 weights at depth 2 on
   the card and on the CPU (a prefill of a padded batch of 8, four decode
   steps, ``flash_attention`` at the prefill's shapes); (d) the port's
   ``flash_attention`` against ``F.scaled_dot_product_attention`` (timed
   only; nothing on the path calls it) and one decode step with cuBLAS's
   reduced-precision bf16 reduction off and on. Its summary is the line
   starting ``[9] {``;
10. the MLA, MoE, RG-LRU and xLSTM families at full width, one after the
   other (``recurrentgemma-9b``, ``minicpm3-4b``, ``xlstm-350m``, and
   ``moonshot-v1-16b-a3b`` cut to 16 of its 48 layers; plain PyTorch, no
   TPU kernel on the path): (a) random weights from ``torch.Generator``
   seed 0 on the card, served as a bf16 copy (the float32 masters
   dropped), 8 requests of 16-64 prompt tokens and 16 new ones in one
   batch: every answer 16 tokens, the prefill and each decode step under
   CUDA events beside their bounds, tokens/s, batch latency, peak memory,
   and no host synchronization in any decode step; (b) teacher forcing
   within each family's bound measured on the CPU (the MoE family served
   again without drops, since a router's capacity depends on the call's
   token count); (c) the same float32 weights one block-pattern cycle deep
   on the card and on the CPU: a prefill of the padded batch and four
   decode steps within 1e-4, and for the MoE family the first layer's
   expert choices and keep mask. Its summary is the line starting
   ``[10] {``.
11. LM training at Llama-3.2-1B's full width and the paged decode (plain
   PyTorch; no TPU kernel lies on the path): (a) phase 9's first batch
   through ``decode_step`` on caches with a hot page of 4 slots
   (``transformer.PAGED_DECODE``), every layer flushed
   (``attention.flush_page``) each 4 steps: teacher forcing within 0.125,
   no host synchronization in a paged step or a flush, the paged and the
   dense decode step timed on the same tokens, and depth 2 in float32 on
   the card and the CPU within 1e-4; (b) ``launch/train.py:train`` at full
   width (float32 masters, bf16 compute, batch 8 x seq 128, 20 steps):
   losses finite and falling, every parameter moved; the step under CUDA
   events and the profiler beside its bound, peak memory, and a step with
   ``remat=True`` (its loss equal to the step's without); (c) one train
   step at depth 2 in float32 on the card and the CPU: loss, gradient norm
   and every updated parameter within 1e-4; (d) ``ElasticRunner`` over the
   tiny preset's train step: a node lost and a NaN injected, the final
   parameters against an uninterrupted run's, a card checkpoint restored
   on the CPU leaf for leaf; (e) ``examples/torch_train_lm.py``'s default
   run (small100m, 300 steps), a loss drop over 0.05. Its summary is the
   line starting ``[11] {``.
12. the launch tooling at Llama-3.2-1B's full width (plain PyTorch; no TPU
   kernel lies on the path): (a) ``launch/op_analysis.py`` counts phase 9's
   decode step, a prefill of phase 9's first batch and phase 11's train
   step on the card (FLOPs, bytes, aten operators), with the roofline of
   those counts on one H100 (``launch/roofline.py``), ``model_flops`` and
   the useful ratio beside phases 9 and 11's hand bounds and medians; (b)
   the same three steps counted on the meta device equal the card's; (c)
   phase 9's first batch decoded with ``attention.CACHE_DTYPE_DOTS``
   (the decode products in the cache's bf16): teacher forcing within 0.125,
   no host synchronization, its step timed against the default's in turns;
   (d) ``launch/dryrun.py`` over Llama-3.2-1B's three cells on both
   production meshes, every cell ok. Its summary is the line starting
   ``[12] {``.
13. the multi-device slice on the one card (no TPU kernel changes; the
   fleet path's kernels launch once a mesh block): (a) phase 4's fleet on
   a 4-entry ``sensor`` mesh of the card (``FleetPipeline(mesh=...)``,
   four blocks of 4 slots), every round equal to phase 4's unsharded
   rounds, ``event_unpack``, ``cluster_accum`` and ``patch_metrics`` each
   launched 4 times a step, the per-round latency beside phase 4's; (b)
   ``ConstellationService`` with 2 shards of 2 mesh entries each and a
   migration, every session equal to its dedicated stream; (c) the int8
   collectives at world size 1 over NCCL on the card (their 4-rank gloo
   group runs in the tests and in ``tools/torch_lm_phase.py 13``); (d)
   ``examples/torch_multi_node_array.py --nodes 4``. Its summary is the
   line starting ``[13] {``; the kernels line's fleet kernels carry
   13a's launches as ``mesh_launches``.

Since the loop driver and the accuracy sweep were ported, phase 2 also
holds both stage kernels past their small path (E = 1025, 4096 and
20,000; K = 160; a cell table outside shared memory; cell t sums past
2^24, centroid_t within its stated bound; ``patch_metrics`` also with
every slot valid, at 70,000 events a window and at 1-32 slots a CTA) and
times them on the scale recording's 100 ms stride windows at capacity
4096 (``patch_metrics``' bound also as every pixel counted,
``dense_bound_ms``); phase 3 also runs the
loop driver (``run_recording``) on the quickstart recording, equal window
for window to the scan with one launch per window of each path kernel,
and ``threshold_sweep(make_validation_suite())`` with the scan and the
fleet driver on both datapaths, equal to the JAX reference's scores; phase
4 also runs the scale recording in those stride windows, equal to the CPU
run.

Then one JSON line of per-kernel numbers (with each path kernel's
launches in phase 6's depth-1 service run as ``service_launches``, in
phase 7a's chaos run as ``chaos_launches``, in 7b as
``constellation_launches`` and in 7c as ``shard_chaos_launches``; phase
8's ``cluster_accum`` launches per route as ``routes_launches``, its
``event_unpack`` launches as ``atlas_stream_launches`` and
``window_entropy``'s real-frame check as ``real_frames``; ``window_entropy``'s
row also carries its K6_PROBE probe as ``probe``, the path each launch
took, and ``floor_ms``, a one-element ``fill_`` alone under the same
profiler helper, beside its bound at each of its three shapes), the
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
import os
import statistics
import subprocess
import sys
import time
import traceback
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
# the stride windows' capacity, and 20,000 (about five times that);
# K = 160.
LARGE_E = (1025, 4096, 20_000)
LARGE_K = 160
# patch_metrics past 65,535 events a window: 32-bit patch tables, and the
# row index and events past shared memory, in per-CTA device scratch.
K3_SCRATCH_E = 70_000
# patch_metrics with one pixel of 48,000 of a window's 50,000 events: its
# count squared passes 2^31 (hot_pixel_window).
K3_HOT_E = 50_000
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
# window_entropy's throughput probe: K6_PROBE seeded centres over
# entropy_frame(), enough slices to fill every SM several times.
K6_PROBE = 8192
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
# Phase 13, the multi-device slice on the one card: 13a the phase-4 fleet
# (16 sensors, seed 11 + s, the scale density) on a 4-entry sensor mesh
# of the card, four blocks of 4 slots; 13b a constellation of 2 shards of
# 2 entries each (tiers 4, 8), 8 sessions of phase 6's recordings over 60
# rounds, one migrated at round 20; 13c the collectives at world size 1
# over NCCL on the card; 13d examples/torch_multi_node_array.py --nodes 4.
MESH_ENTRIES = 4
MESH_CONST = dict(shards=2, entries=4, tiers=(4, 8), sessions=8, rounds=60, migrate_at=20)
# Phase 8, the reference's other float routes: the four float route
# configurations on the scale recording; the atlas of the ragged stream
# over its first 10 s (compared every 50th feed) and over a 2 s cut with
# a forced rollover; a 16-sensor event-route fleet of the phase-4
# recordings cut to 4 s, each sensor against a dedicated stream fed in
# 200 ms chunks; window_entropy on 64 real frames.
ROUTES = (("event", dict(use_kernels=True)), ("frame", dict(use_kernels=True, metrics_impl="frame")),
          ("kernel", dict(use_kernels=True, metrics_impl="kernel")), ("event, plain", {}))
ATLAS_S, ATLAS_CUT_S, ATLAS_EVERY = 10, 2, 50
ROUTE_FLEET_S, ROUTE_STREAM_US = 4, 200_000
K6_WINDOWS = 64
# Phase 9, the LM serving path at Llama-3.2-1B's full width: weights from
# torch.Generator seed 0 on the card; 24 requests of 16-64 prompt tokens
# (np.random.default_rng(0)) and 16 new tokens, served in batches of 8 with
# max_seq = 64 + 16 + 1 as serve_demo sizes it. Teacher forcing holds the
# served bf16 logits against forward_train within 0.125, four bf16 ULPs of
# a logit in [4, 8): the same check on the CPU at full width read 0.039 at
# depth 2 and 0.047 at depth 6. The card against the CPU at depth 2 in
# float32 (TF32 off) within rtol = atol = 1e-4.
LM_ARCH, LM_SEED = "llama3.2-1b", 0
LM_ENGINE = dict(max_delay_s=0.02, max_batch=8, max_seq=81)
LM_REQUESTS, LM_PROMPT, LM_NEW = 24, (16, 64), 16
LM_TEACHER_ATOL = 0.125
LM_CARD_CPU = dict(n_layers=2, decode=4, rtol=1e-4, atol=1e-4)
# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet).
PEAK_BF16_S = 989e12
# Phase 10, the MLA, MoE, RG-LRU and xLSTM families at full width, each in
# turn: weights from torch.Generator seed 0 on the card, served in bf16 by
# ServingEngine (the float32 masters dropped once cast); 8 requests of 16-64
# prompt tokens (the first 8 of phase 9's) and 16 new tokens, one batch of
# 8, max_seq 81. moonshot-v1-16b-a3b is cut to 16 of its 48 layers: its
# float32 masters (104.5 GiB) do not fit the 80 GB card. Teacher forcing
# holds the served bf16 logits against forward_train within each family's
# bound, measured on the CPU at full width and the served depth
# (tools/torch_lm_teacher_bound.py) before the first card run; the card
# against the CPU in float32 at one block-pattern cycle (2 layers for the
# single-block patterns) within rtol = atol = 1e-4.
LM10_FAMILIES = {"recurrentgemma-9b": None, "minicpm3-4b": None, "xlstm-350m": None,
                 "moonshot-v1-16b-a3b": 16}
LM10_REQUESTS = 8
# Teacher forcing on the CPU at full width and the served depth, MoE without
# drops (tools/torch_lm_teacher_bound.py on the NVIDIA H100 80GB HBM3 host's
# CPU, 8 threads, torch 2.11): the largest reading of seeds 0-2 on sound
# runs, and the control at seed 0, the batch served with a cache that decode
# never writes. The bound is twice the sound reading rounded up to 1/32; it
# must lie below the control, or the check could not fail.
LM10_TEACHER_CPU = {"recurrentgemma-9b": (0.236328125, 6.03125), "minicpm3-4b": (0.0859375, 1.431640625),
                    "xlstm-350m": (0.13134765625, 6.21875), "moonshot-v1-16b-a3b": (0.38671875, 0.9228515625)}
LM10_TEACHER_ATOL = {arch: math.ceil(64 * sound) / 32 for arch, (sound, _) in LM10_TEACHER_CPU.items()}
LM10_CARD_CPU = dict(decode=4, rtol=1e-4, atol=1e-4)
# Phase 11, LM training and the paged decode at Llama-3.2-1B's full width.
# 11a: phase 9's first batch (bf16 served copy) through the paged decode
# with a page of 4, every layer flushed each 4 steps (four wraps in 16 new
# tokens), within phase 9's teacher-forcing bound; depth 2 in float32 on the
# card and the CPU within LM_CARD_CPU. 11b: train() at full width, float32
# masters and bf16 compute, batch 8 x seq 128 on the Markov stream, lr 1e-3
# (the reference example's 100M run), 20 steps; then LM11_TIMED steps under
# CUDA events, one under the profiler and one with remat. 11c: one train step
# at depth 2 in float32, card against CPU. 11d: ElasticRunner over the tiny
# preset's train step, a node lost at step 7 and a NaN at step 9, against an
# uninterrupted run (the card's embedding backward may sum in another order
# between runs, hence a bound and not equality). 11e: the training example.
LM11_PAGE = 4
LM11_TRAIN = dict(batch=8, seq=128, steps=20, lr=1e-3)
LM11_TIMED = 5
LM11_CARD_CPU = dict(n_layers=2, rtol=1e-4, atol=1e-4)
LM11_ELASTIC = dict(steps=12, ckpt_every=5, lose_at=7, nan_at=9)
LM11_ELASTIC_ATOL = 1e-5
# Phase 12, the launch tooling at Llama-3.2-1B's full width. 12a: the op
# counter (launch/op_analysis.py) on the card over phase 9's decode step
# (the first batch prefilled, batch 8, the bf16 served copy), a prefill of
# phase 9's first batch and phase 11's train step (8 x 128, float32 masters,
# remat=False), beside the roofline of its counts and phases 9 and 11's
# hand bounds and medians. 12b: the same three steps counted on the meta
# device, equal to the card's. 12c: phase 9's first batch decoded with
# attention.CACHE_DTYPE_DOTS (products in the cache's bf16) against teacher
# forcing within phase 9's bound, its decode step timed against the
# default's on the same batch, in turns (default, switch, switch, default).
# 12d: the dry run of Llama-3.2-1B's three cells on both production meshes.
LM12_TURNS = (False, True, True, False)


PHASE = "0 (set-up)"  # the phase running, named in the failure report


def enter(phase) -> None:
    global PHASE
    PHASE = str(phase)


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
    pass 2^24; K3 also at ``K3_SCRATCH_E``, on a window of ``K3_HOT_E``
    events with one pixel past 46,340 events, and with every slot valid
    (:func:`check_patch_metrics_large`). Every integer field identical,
    centroid_t and sum_t within their stated bounds, K3's metrics at the
    stated tolerances. Returns the largest difference of each kernel and
    of centroid_t."""
    from repro_torch.core.grid_clustering import GridConfig
    from repro_torch.data.adversarial import hot_pixel_window, large_windows, stacked_batch, sum_t_window
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
        err["patch_metrics"] = max(err["patch_metrics"], check_patch_metrics_large(name, b))
    b = stacked_batch(large_windows(K3_SCRATCH_E, n_windows=2), dev)
    err["patch_metrics"] = max(err["patch_metrics"], check_patch_metrics_large(f"E = {K3_SCRATCH_E}", b))
    b = stacked_batch([hot_pixel_window(K3_HOT_E)], dev)
    err["patch_metrics"] = max(err["patch_metrics"], check_patch_metrics_large(
        f"E = {K3_HOT_E}, a hot pixel", b, slots=lambda b, k: [("its clusters", ref.cluster_accum_topk_ref(
            b.x, b.y, b.t, b.valid, GridConfig(min_events=1, max_clusters=k)))]))
    log(f"  large sizes (E {', '.join(map(str, LARGE_E))}; K 32 and {LARGE_K}; K2's table outside shared "
        f"memory at cell 4; the sum_t window; K3 also at E = {K3_SCRATCH_E}, at E = {K3_HOT_E} with a "
        f"pixel of 48,000 events, and with every slot valid): "
        f"cluster_accum's integer fields and both entries' sums identical but t (centroid_t within its "
        f"bound, largest difference {err['centroid_t']:.3g} us); patch_metrics event_count/edge_density "
        f"identical, others max abs err {err['patch_metrics']:.3e}, the same to the bit at 1-32 slots a CTA")
    return err


def check_patch_metrics_large(name, b, slots=None) -> float:
    """``patch_metrics`` on ``b`` at K = 32 and ``LARGE_K``, the slots of
    ``edge_slot_clusters`` and then every slot valid
    (``full_slot_clusters``), or those of ``slots(b, k)`` (a list of
    ``(label, clusters)``), against its plain version: one launch each,
    event_count and edge_density identical, the rest within RTOL/ATOL.
    On the large path (E past 1,024 or K past 128) the outputs at 1, 7 and
    32 slots a CTA equal the default's to the bit. Returns the largest
    difference."""
    import torch

    from repro_torch.data.adversarial import edge_slot_clusters, full_slot_clusters
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import patch_metrics as _pm

    if slots is None:
        slots = lambda b, k: [("edge slots", edge_slot_clusters(b, k)),  # noqa: E731
                              ("every slot valid", full_slot_clusters(b, k))]
    err = 0.0
    for k in (32, LARGE_K):
        for label, cl in slots(b, k):
            what = f"patch_metrics ({name}, K = {k}, {label})"
            before = ops.LAUNCHES["patch_metrics"]
            got = ops.patch_metrics(b, cl)
            require(ops.LAUNCHES["patch_metrics"] == before + 1, f"{what}: not one launch")
            err = max(err, compare_metrics(got, ref.patch_metrics_stage_ref(b, cl, width=640, height=480), what))
            if b.x.shape[1] > 1024 or k > 128:
                for group in (1, 7, 32):
                    other = _pm._launch(b, cl, 640, 480, group)
                    require(all(torch.equal(other[m], got[m]) for m in got),
                            f"{what}: {group} slots a CTA differ from the default")
    return err


def stride_blocks(rec, cfg, dev):
    """``rec`` in ``STRIDE_US`` stride windows at ``STRIDE_CAPACITY``,
    conditioned and clustered as the scan's window core does it: the
    ``(batch, clusters)`` blocks the stage kernels see there, and the
    windows."""
    import dataclasses

    from repro_torch.core.events import BatcherConfig, EventBatch, pad_windows
    from repro_torch.core.pipeline import config as C
    from repro_torch.core.pipeline.window_core import WINDOW_BLOCK, _cluster, _condition

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
    arguments. Bytes: of each window that holds a valid slot, the valid
    flag of every event slot and x and y of each valid event (a padding
    slot needs no more than its flag); the valid flag of every cluster
    slot, centroids and count of each valid slot, six floats out per slot. Operations: per window
    that holds a valid slot, about 12 per w in-sensor valid event (an
    index of the events by sensor row: count, scan, place; the
    normalizer's repeat count); per valid slot, 2 per patch row (its
    events' range), ~8 per event inside its patch (offset, compares, the
    count, the bin: only the events the patch holds, not the window's),
    ~25 per candidate pixel, a pixel with an event in its 3x3
    neighbourhood (the Sobel, e2, sqrt, the sums, the edge test: every
    other pixel's gradient is zero and its terms are one product a slot),
    ~320 for the epilogue. ``dense_ops``: the work of a kernel that
    evaluates every pixel, a sort of the events (2 log2 w each and 8 for
    the runs), a binary search per patch row (2 log2 w) and ~27 per pixel
    of every patch."""
    import torch

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
    in_patch, candidates = 0, 0
    for lo in range(0, len(wi), 2048):  # slots in chunks: (slots, E) masks
        sw, sk = wi[lo:lo + 2048], ki[lo:lo + 2048]
        dx = batch.x[sw] - x0[sw, sk][:, None]
        dy = batch.y[sw] - y0[sw, sk][:, None]
        inp = inb[sw] & (dx >= 0) & (dx < M.WINDOW) & (dy >= 0) & (dy < M.WINDOW)
        in_patch += int(inp.sum())
        flat = (dy.clamp(0, M.WINDOW - 1) * M.WINDOW + dx.clamp(0, M.WINDOW - 1)).long()
        occ = torch.zeros((len(sw), M.WINDOW * M.WINDOW), device=inp.device).scatter_add_(
            -1, flat, inp.float()) > 0
        near = torch.nn.functional.max_pool2d(
            occ.float().view(-1, 1, M.WINDOW, M.WINDOW), 3, stride=1, padding=1)
        candidates += int((near > 0).sum())
    w_slot = inb[wi].sum(-1).double()
    search_ops = int((M.WINDOW * 2 * w_slot.clamp_min(2).log2().ceil()).sum())
    n_events = int(batch.valid[busy].sum())
    return dict(bytes=n_busy * e + 8 * n_events + n_win * k * (1 + 24) + n_valid * 12,
                ops=int(12 * w.sum()) + n_valid * (2 * M.WINDOW + 320) + 8 * in_patch + 25 * candidates,
                dense_ops=sort_ops + search_ops + 8 * in_patch
                + n_valid * (27 * M.WINDOW * M.WINDOW + 320),
                valid_slots=n_valid, busy_windows=n_busy, candidate_pixels=candidates)


def window_entropy_cost(shape, cx, cy, window: int = 48) -> dict:
    """Bytes and operations a ``window_entropy`` launch needs on an
    ``shape`` frame and centres ``cx``, ``cy`` (array-likes on the host):
    each distinct frame pixel that the K slices cover read once (origins
    clipped as the kernel clips them, so slices that overlap or clip to
    one origin count their pixels once), 8 bytes of centre in and 12 out
    a centre; about 10 operations a pixel of each slice."""
    import numpy as np

    h, w = shape
    x0 = np.clip(np.asarray(cx, np.int64) - window // 2, 0, w - window)
    y0 = np.clip(np.asarray(cy, np.int64) - window // 2, 0, h - window)
    covered = np.zeros((h, w), bool)
    for x, y in zip(x0.tolist(), y0.tolist()):
        covered[y:y + window, x:x + window] = True
    k, pixels = len(x0), int(covered.sum())
    return dict(bytes=4 * pixels + 20 * k, ops=10 * window * window * k, pixels=pixels)


def per_launch(rows: list[dict]) -> dict:
    """The mean over one launch each of ``rows`` (times, bytes,
    operations; counts summed), so a row's numbers are per launch of the
    run they stand for."""
    out = {}
    for key, v in rows[0].items():
        vals = [r[key] for r in rows]
        if key == "shape":
            out[key] = " + ".join(str(tuple(a)) for a in vals)
        elif key in ("valid_slots", "busy_windows", "candidate_pixels"):
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
    timed on the scale recording's words, and at K = 32 centres and the
    K6_PROBE probe (with the floor of a launch)."""
    import numpy as np
    import torch

    from repro_torch.core.events import pack_wire, wire_tensors
    from repro_torch.data.adversarial import (
        adversarial_wires, dual_bounds3, entropy_frame, entropy_probe_centres, fleet_wire,
        overlay_wires,
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

    # window_entropy: rtol 1e-5 (float32 sums in another order, log2f),
    # at K = 0, 1, 32 and the K6_PROBE probe, on the frame and the empty
    # frame, one launch a call; each path forced where both could run.
    frame, cx, cy = entropy_frame()
    px, py = entropy_probe_centres(K6_PROBE)
    centres = {"K = 0": (cx[:0], cy[:0]), "K = 1": (cx[:1], cy[:1]),
               f"K = {len(cx)}": (cx, cy), f"K = {K6_PROBE} probe": (px, py)}
    err = 0.0
    for fname, f in (("frame", frame), ("empty frame", np.zeros_like(frame))):
        for cname, (a, b) in centres.items():
            args = [torch.from_numpy(v).to(dev) for v in (f, a, b)]
            what = f"window_entropy ({fname}, {cname})"
            before = ops.LAUNCHES["window_entropy"]
            got = ops.window_entropy(*args)
            require(ops.LAUNCHES["window_entropy"] == before + (len(a) > 0), f"{what}: launches")
            want = ref.window_entropy_ref(*args)
            err = max(err, close(got, want, what, ENTROPY_RTOL, ENTROPY_ATOL))
            if len(a) >= len(cx):
                for path in ("wide", "warp"):
                    err = max(err, close(_we._launch(*args, path), want,
                                         f"{what}, {path} path", ENTROPY_RTOL, ENTROPY_ATOL))
    log(f"  window_entropy: within rtol {ENTROPY_RTOL} of the plain version at {', '.join(centres)} "
        f"(corner-clipped, single hot pixel, random and probe centres; frame and empty frame; "
        f"both paths forced at K >= {len(cx)}), one launch a call, max abs err {err:.3e}")
    floor = fill_floor_ms(dev)
    rows = {}
    for name, (a, b) in (("entropy_frame", (cx, cy)), ("probe", (px, py))):
        args = tuple(torch.from_numpy(v).to(dev) for v in (frame, a, b))
        rows[name] = r = dict(time_window_entropy([args], floor), path=_we.plan(len(a), dev))
        log_kernel(f"window_entropy (K = {len(a)}, {r['path']} path)", r)
    r = dict(rows["entropy_frame"], max_abs_err=err, probe=rows["probe"])
    results["window_entropy"] = r
    return results


def fill_floor_ms(dev) -> float:
    """The floor of a launch on this card: a one-element ``fill_`` alone
    under the profiler (:func:`kernel_device_ms`), as the kernels are timed."""
    import torch

    t = torch.empty(1, device=dev)
    ms = kernel_device_ms(lambda: t.fill_(1.0), ("FillFunctor",))
    require(ms > 0, "fill_: no device time under the profiler")
    return ms


def sm_clock_mhz() -> str:
    """The card's SM clock now, as ``nvidia-smi`` reads it (``"?"`` if it
    cannot): sampled beside a reading that may depend on it."""
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip() or "?"
    except (OSError, subprocess.SubprocessError):
        return "?"


def time_window_entropy(calls, floor_ms: float, path: str | None = None) -> dict:
    """Per launch over ``calls``, each a ``(frame, cx, cy)`` of CUDA
    tensors: the kernel alone (profiler), the call (CUDA events), the plain
    version, the bound from :func:`window_entropy_cost`, the floor, and
    the SM clock just after the kernel's profile. ``path`` forces the
    kernel's path (``window_entropy._launch``); by default the wrapper's."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import window_entropy as _we

    launch = _we.window_entropy if path is None else (lambda *a: _we._launch(*a, path))
    n = len(calls)
    costs = [window_entropy_cost(tuple(f.shape), cx.cpu().numpy(), cy.cpu().numpy())
             for f, cx, cy in calls]
    kw = [(c, {}) for c in calls]
    iters = max(2, 20 // n)
    ks = [c[1].shape[0] for c in calls]
    r = dict(
        ms=kernel_device_ms(lambda: replay(launch, kw), ("window_entropy_kernel",), iters=iters) / n,
        sm_clock=sm_clock_mhz(),
        call_ms=replay_ms(launch, kw, iters), plain_ms=replay_ms(ref.window_entropy_ref, kw),
        library_ms=None, floor_ms=floor_ms,
        bytes=sum(c["bytes"] for c in costs) / n, ops=sum(c["ops"] for c in costs) / n,
        pixels=sum(c["pixels"] for c in costs) / n,
        shape=(ks[0],) if n == 1 else f"{n} launches of K {min(ks)}-{max(ks)} on (480, 640) frames",
    )
    bound(r)
    return r


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
    if "dense_ops" in r:  # patch_metrics: the bound with the Sobel at every pixel
        r["dense_bound_ms"] = max(t_bytes, r["dense_ops"] / PEAK_OPS_S * 1e3)


def log_kernel(name: str, r: dict) -> None:
    lib = r["library_ms"]
    per = f", per launch of {r['n_launches_timed']}" if r.get("n_launches_timed", 1) > 1 else ""
    log(f"  {name} at {r['shape']}{per}: kernels alone {r['ms']:.4f} ms (call {r['call_ms']:.4f} ms), "
        f"plain {r['plain_ms']:.4f} ms, library {lib if lib is None else round(lib, 4)} ms, "
        f"bound {r['bound_ms']:.4g} ms by {r['bound_by']} ({r['bytes']:.0f} B, {r['ops']:.0f} ops"
        + (f", {r['valid_slots']} valid slots in {r['busy_windows']} windows" if "valid_slots" in r else "")
        + (f", {r['candidate_pixels']} candidate pixels; every pixel counted: {r['dense_bound_ms']:.4g} ms"
           if "dense_bound_ms" in r else "") + ")"
        + (f"; floor {r['floor_ms']:.4f} ms (a one-element fill_), {r['pixels']:.0f} distinct pixels, "
           f"SM clock {r['sm_clock']}"
           if "floor_ms" in r else ""))


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


def run_fleet(cfg, rounds, n, dev, sync_each: bool = False, mesh=None):
    """Feed every round and flush; returns the round results, the host ms
    of each round (closed by a synchronize when ``sync_each``), the ms of
    garbage collection inside each round and the pipeline (sharded over
    ``mesh`` when one is given)."""
    import torch

    from repro_torch.core.pipeline import FleetPipeline

    fp = FleetPipeline(cfg, n_sensors=n, device=dev, mesh=mesh)
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
    return counts, sync, round_stats(lat)


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


def check_migration(cfg, dev, phase: int = 6) -> None:
    """A session exported on one device and adopted by a service on the
    other (through the numpy form), both ways, with chunks still queued
    at the export and a neighbour streaming on each side: equal to a
    never-migrated stream on the card, its atlas included (at the export,
    that of a stream fed the chunks stepped so far; after the last chunk,
    the never-migrated stream's)."""
    import torch

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
    feeds = []
    for i, c in enumerate(mover):
        feeds.append(sp.feed(*c))
        if i == cut - 3:
            atlas_at_export = sp.state.atlas.clone()
    atlas_at_end = sp.state.atlas.clone()
    never = concat_parts(feeds + [sp.flush()])
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
        what = f"session migrated {src_dev} -> {dst_dev}"
        equal(torch.from_numpy(exp.carry.atlas), atlas_at_export, f"{what}: atlas at the export")
        dn = dst.attach("neighbour")
        dst.feed(dn, *other[0])
        new = dst.adopt_session(exp)
        for i in range(cut, len(mover)):
            dst.feed(new, *mover[i])
            parts += [fd.result for fd in dst.pump(force=True) if fd.sid == new]
        dst.drain()
        carry = dst._fleet.export_slot(dst.session(new).slot)
        equal(torch.from_numpy(carry.atlas), atlas_at_end, f"{what}: atlas after the last chunk")
        parts.append(dst.detach(new))
        require_clean(src, "migration source")
        require_clean(dst, "migration destination")
        compare_parts(concat_parts(parts), never, what, exact=False)
    log(f"[{phase}] a session exported on the card and adopted on the cpu, and the other way, "
        f"{cut} chunks in, two still queued: equal to a never-migrated stream on the card, "
        f"atlas included ({int((atlas_at_end != 0).sum())} pixels written, {cfg.metrics_impl} route)")


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


# ---------------------------------------------------------------------------
# Phase 8: the reference's other float routes (the frame oracle, the atlas
# event core) against each other and against the CPU.
# ---------------------------------------------------------------------------

def cut_recording(rec, seconds: float):
    """The first ``seconds`` of a recording."""
    import dataclasses

    import numpy as np

    n = int(np.searchsorted(rec.t, rec.t[0] + int(seconds * 1e6)))
    return dataclasses.replace(rec, **{f: getattr(rec, f)[:n] for f in ("x", "y", "t", "p", "kind", "obj")})


def route_config(name: str):
    from repro_torch.core.pipeline import PipelineConfig

    return PipelineConfig(**dict(ROUTES)[name])


def check_routes(scale, kernel_run, dev) -> dict:
    """(a) The scale recording through each float route configuration,
    launch counters set to 0 just before each: ``run_recording_scan``
    (tracked on the event route; the kernel route's tracked scan is phase
    4's ``kernel_run``; the frame and plain event routes untracked, as
    their tracker inputs are then held equal to the event route's bit for
    bit) and ``evaluate_detection``. Cluster fields, tracker integers and
    tp/fp/fn/tn equal across the four; the frame and plain event metrics
    equal the event route's bit for bit, the kernel route's within the
    stated bound; ``cluster_accum`` launched on each ``use_kernels`` run,
    ``patch_metrics`` on the kernel route only. Then the frame route on
    the CPU, untracked: integers equal to the card's, metrics within the
    bound. Returns each route's run, score and launches, and the CPU run."""
    import torch

    from repro_torch.core.pipeline import evaluate_detection, run_recording_scan
    from repro_torch.kernels import ops

    runs = {}
    for name, _ in ROUTES:
        c = route_config(name)
        if name == "kernel":
            result, score = kernel_run
            counts = None
            wall = None
        else:
            ops.reset_launches()
            t0 = time.perf_counter()
            result = run_recording_scan(scale, c, with_tracking=name == "event", device=dev)
            score = evaluate_detection(scale, c, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(ops.LAUNCHES)
            require((counts["cluster_accum"] > 0) == c.use_kernels and counts["patch_metrics"] == 0,
                    f"[8] {name} route: launches {counts}")
        runs[name] = dict(result=result, score=score, launches=counts, wall_s=wall)
    base = runs["event"]["result"]
    err = 0.0
    for name, r in runs.items():
        res = r["result"]
        require(res.num_windows == base.num_windows, f"[8] {name}: window count")
        for f in res.clusters._fields:
            equal(getattr(res.clusters, f), getattr(base.clusters, f), f"[8] {name} vs event: clusters.{f}")
        require(r["score"] == runs["event"]["score"], f"[8] {name}: score {r['score']}")
        if name == "kernel":
            err = compare_metrics(res.metrics, base.metrics, "[8] kernel vs event")
            for f in ("hits", "misses", "age", "active"):
                equal(getattr(res.tracks, f), getattr(base.tracks, f), f"[8] kernel vs event: tracks.{f}")
            for f in ("x", "y", "vx", "vy", "entropy"):
                close(getattr(res.tracks, f), getattr(base.tracks, f), f"[8] kernel vs event: tracks.{f}",
                      TRACK_RTOL, TRACK_ATOL)
        else:
            for k in res.metrics:
                equal(res.metrics[k], base.metrics[k], f"[8] {name} vs event: {k}")
    t0 = time.perf_counter()
    cpu = run_recording_scan(scale, route_config("frame"), with_tracking=False, device="cpu")
    cpu_s = time.perf_counter() - t0
    frame = runs["frame"]["result"]
    for f in frame.clusters._fields:
        equal(getattr(frame.clusters, f), getattr(cpu.clusters, f), f"[8] frame cuda vs cpu: clusters.{f}")
    cpu_err = compare_metrics(frame.metrics, cpu.metrics, "[8] frame cuda vs cpu")
    for name, r in runs.items():
        s = r["score"]
        log(f"[8] scale recording, {name} route ({dict(ROUTES)[name]}): {r['result'].num_windows} "
            f"windows, {int(r['result'].clusters.valid.sum())} valid clusters, tp/fp/fn/tn "
            f"{s.tp}/{s.fp}/{s.fn}/{s.tn}; "
            + ("phase 4's tracked scan" if r["wall_s"] is None else
               f"{'tracked' if name == 'event' else 'untracked'} scan + evaluate_detection "
               f"{r['wall_s']:.2f} s, launches {r['launches']}"))
    log(f"    cluster fields and tp/fp/fn/tn equal across the four routes, tracker integers equal "
        f"(event vs kernel route); event, frame and plain event metrics equal bit for bit; kernel "
        f"route max abs err {err:.3g}; frame route on the cpu, untracked ({cpu_s:.1f} s): integers "
        f"equal, metrics max abs err {cpu_err:.3g}")
    return dict(runs=runs, cpu=cpu, kernel_err=err, cpu_err=cpu_err)


def check_atlas_stream(scale, dev) -> dict:
    """(b) The scale recording's first ``ATLAS_S`` s through
    ``StreamingPipeline(wire="ragged")`` on the event route, on the card
    and on the CPU, in 20 ms chunks: the atlases equal after every
    ``ATLAS_EVERY``-th feed and at the end; then its first ``ATLAS_CUT_S``
    s with ``_tag_limit = 4`` (a rollover every few windows), compared
    after every tenth feed. The card's launch counters are set to 0 just
    before; ``event_unpack`` must have run."""
    import torch

    from repro_torch.core.pipeline import StreamingPipeline
    from repro_torch.data.evas import iter_chunks
    from repro_torch.kernels import ops

    cfg = route_config("event")
    out = {}
    for label, seconds, limit, every in (("epoch", ATLAS_S, None, ATLAS_EVERY),
                                         ("rollover", ATLAS_CUT_S, 4, 10)):
        rec = cut_recording(scale, seconds)
        chunks = list(iter_chunks(rec, CHUNK_US))
        gpu = StreamingPipeline(cfg, wire="ragged", device=dev)
        cpu = StreamingPipeline(cfg, wire="ragged", device="cpu")
        if limit:
            gpu._tag_limit = cpu._tag_limit = limit
        ops.reset_launches()
        checks, rolled, windows = 0, 0, 0
        for i, c in enumerate(chunks):
            before = gpu.state.next_tag
            windows += gpu.feed(*c).num_windows
            cpu.feed(*c)
            rolled += gpu.state.next_tag < before
            if (i + 1) % every == 0:
                equal(gpu.state.atlas, cpu.state.atlas, f"[8] atlas ({label}) after feed {i}")
                checks += 1
        windows += gpu.flush().num_windows
        cpu.flush()
        torch.cuda.synchronize()
        counts = dict(ops.LAUNCHES)
        equal(gpu.state.atlas, cpu.state.atlas, f"[8] atlas ({label}) at the end")
        require(gpu.state.next_tag == cpu.state.next_tag, f"[8] atlas ({label}): tags differ")
        require(counts["event_unpack"] > 0 and counts["cluster_accum"] > 0,
                f"[8] atlas ({label}): launches {counts}")
        require(rolled > 0 if limit else rolled == 0, f"[8] atlas ({label}): {rolled} rollovers")
        written = int((gpu.state.atlas != 0).sum())
        log(f"[8] atlas on the card, ragged stream of the scale recording's first {seconds} s "
            f"({len(chunks)} feeds, {windows} windows{', _tag_limit 4' if limit else ''}): equal to "
            f"the cpu stream's at {checks + 1} checks, {rolled} rollovers, {written} pixels written "
            f"at the end; launches {counts}")
        out[label] = counts
    return out


def check_atlas_sync(scale, dev) -> dict:
    """The event core's live path under ``torch.cuda.set_sync_debug_mode``:
    one core call (tracked, 64 windows of the scale recording) under
    "warn" must warn of no synchronizing call; the atlas update alone runs
    under "error", where any synchronization raises."""
    import warnings

    import torch

    from repro_torch.core.events import EventBatch, pad_windows
    from repro_torch.core.pipeline import make_atlas, make_core
    from repro_torch.core.metrics import event_normalizer
    from repro_torch.core.pipeline.event_core import _write_atlas
    from repro_torch.core.pipeline.window_core import _condition
    from repro_torch.core.tracking import init_tracks

    cfg = route_config("event")
    win = pad_windows(*(a[:20_000] for a in (scale.x, scale.y, scale.t, scale.p)), cfg.batcher, dev)
    batch = EventBatch(*(a[:K6_WINDOWS] for a in win.batch))
    core = make_core(cfg)
    tracks, atlas = init_tracks(cfg.tracker, dev), make_atlas(cfg, device=dev)
    core(batch, tracks, atlas, 3)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            core(batch, tracks, atlas, 3)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "synchroniz" in str(w.message) and "prototype feature" not in str(w.message)]
    require(not syncs, f"[8] the event core synchronized the host: {sorted(set(syncs))[:3]}")
    g = cfg.grid
    cond = _condition(cfg, batch)
    c, leader, _, _ = event_normalizer(cond, g.width, g.height)
    ix = torch.arange(batch.x.shape[0], device=dev)
    flat = atlas.clone().view(-1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _write_atlas(flat, cond, c, leader, ix, batch.x.shape[0], 3,
                     max(batch.x.shape[-1].bit_length(), 1), atlas.numel(), atlas.shape[-1],
                     g.height)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    log(f"[8] event core under set_sync_debug_mode: no synchronizing call in one tracked core call "
        f"of {batch.x.shape[0]} windows ('warn'); the atlas update alone ran under 'error'")
    return dict(core_syncs=len(syncs))


def check_route_fleet(fleet_recs, dev) -> None:
    """(c) 16 sensors (the phase-4 recordings cut to ``ROUTE_FLEET_S`` s)
    through one fleet on the event route, 20 ms rounds: every sensor's
    exported tags and atlas, clusters and metrics equal to its dedicated
    untracked stream's on the card, fed in ``ROUTE_STREAM_US`` chunks (the
    outputs and the atlas do not depend on the split). Then phase 6's
    session migration on the event route, atlas included."""
    import torch

    from repro_torch.core.pipeline import StreamingPipeline
    from repro_torch.data.evas import iter_chunks

    cfg = route_config("event")
    recs = [cut_recording(r, ROUTE_FLEET_S) for r in fleet_recs]
    rounds = fleet_rounds(recs)
    out, ms, _, fp = run_fleet(cfg, rounds, len(recs), dev)
    written = 0
    for s, rec in enumerate(recs):
        sp = StreamingPipeline(cfg, with_tracking=False, wire="ragged", device=dev)
        parts = [sp.feed(*c) for c in iter_chunks(rec, ROUTE_STREAM_US)] + [sp.flush()]
        got = sensor_parts(out, s)
        require(got["windows"] == sum(p.num_windows for p in parts), f"[8] event fleet sensor {s}: windows")
        for k, v in got["clusters"].items():
            equal(v, torch.cat([getattr(p.clusters, k) for p in parts]),
                  f"[8] event fleet sensor {s} vs stream: clusters.{k}")
        for k, v in got["metrics"].items():
            equal(v, torch.cat([p.metrics[k] for p in parts]), f"[8] event fleet sensor {s} vs stream: {k}")
        carry = fp.export_slot(s)
        require(carry.cursor.next_tag == sp.state.next_tag, f"[8] event fleet sensor {s}: tags")
        equal(torch.from_numpy(carry.atlas), sp.state.atlas, f"[8] event fleet sensor {s}: atlas")
        written += int((sp.state.atlas != 0).sum())
    log(f"[8] event route fleet: {len(recs)} sensors of {ROUTE_FLEET_S} s, {len(rounds)} rounds, "
        f"{sum(r.total_windows for r in out)} windows, round p50 {statistics.median(ms):.2f} ms; every "
        f"sensor's clusters, metrics, tags and exported atlas equal to its dedicated stream's on the "
        f"card ({written} atlas pixels written in all)")
    check_migration(cfg, dev, phase=8)


def check_k6_real_frames(scale, routes, dev) -> dict:
    """(d) ``reconstruct_frame`` of the first ``K6_WINDOWS`` conditioned
    scale windows that hold a valid cluster, and the frame route's valid
    clusters there, centres rounded:
    ``window_entropy`` (one launch a frame) against its plain version
    under phase 2's tolerance, its Shannon and Renyi entropy against
    ``cluster_metrics_frame``'s and its contrast against ``local_contrast``
    of the same patch, within the stated bound."""
    import torch

    from repro_torch.core import metrics as M
    from repro_torch.core.events import EventBatch, pad_windows
    from repro_torch.core.pipeline.window_core import _condition
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import window_entropy as _we

    cfg = route_config("frame")
    frame_run = routes["runs"]["frame"]["result"]
    win = pad_windows(scale.x, scale.y, scale.t, scale.p, cfg.batcher, dev)
    # The first K6_WINDOWS windows that hold a valid cluster.
    pick = torch.nonzero(frame_run.clusters.valid.any(-1)).flatten()[:K6_WINDOWS]
    batch = _condition(cfg, EventBatch(*(a[pick] for a in win.batch)))
    frames = M.reconstruct_frame(batch, cfg.grid.width, cfg.grid.height)
    cl = type(frame_run.clusters)(*(a[pick] for a in frame_run.clusters))
    mets = {k: v[pick] for k, v in frame_run.metrics.items()}
    ops.reset_launches()
    plain_err = oracle_err = 0.0
    n_clusters = 0
    calls = []
    for w in range(len(pick)):
        sel = cl.valid[w]
        cx = torch.round(cl.centroid_x[w][sel]).to(torch.int32).contiguous()
        cy = torch.round(cl.centroid_y[w][sel]).to(torch.int32).contiguous()
        if cx.numel() == 0:
            continue
        n_clusters += cx.numel()
        f = frames[w].contiguous()
        got = ops.window_entropy(f, cx, cy)
        calls.append(((f, cx, cy), {}))
        plain_err = max(plain_err, close(got, ref.window_entropy_ref(f, cx, cy),
                                         f"[8] window_entropy vs plain, window {w}",
                                         ENTROPY_RTOL, ENTROPY_ATOL))
        oracle_err = max(oracle_err, close(got[0], mets["shannon_entropy"][w][sel],
                                           f"[8] window_entropy vs frame oracle: shannon, window {w}"))
        oracle_err = max(oracle_err, close(got[1], mets["renyi_entropy"][w][sel],
                                           f"[8] window_entropy vs frame oracle: renyi, window {w}"))
        patches = M.extract_window(f, cl.centroid_x[w][sel], cl.centroid_y[w][sel])
        oracle_err = max(oracle_err, close(got[2], M.local_contrast(patches),
                                           f"[8] window_entropy vs local_contrast, window {w}"))
    torch.cuda.synchronize()
    launches = ops.LAUNCHES["window_entropy"]
    require(launches == len(calls) > 0, f"[8] window_entropy launches {launches}, calls {len(calls)}")
    require(len(calls) == K6_WINDOWS, f"[8] window_entropy: {len(calls)} frames with a valid cluster")
    r = dict(time_window_entropy([a for a, _ in calls], fill_floor_ms(dev)),
             path=_we.plan(max(a[1].shape[0] for a, _ in calls), dev))
    log(f"[8] window_entropy on {len(calls)} real frames ({n_clusters} valid clusters, centres rounded): "
        f"against its plain version max abs err {plain_err:.3g}; against the frame oracle (shannon, "
        f"renyi) and local_contrast max abs err {oracle_err:.3g}")
    log_kernel("[8] window_entropy, real frames", r)
    return dict(r, launches=launches, max_abs_err=plain_err, oracle_err=oracle_err, clusters=n_clusters)


def check_fig7(routes, dev) -> None:
    """(e) Fig. 7 on the card: ``metric_matrix`` of the frame route's
    valid clusters over the scale recording and its ``correlation_matrix``,
    against the CPU run's within the stated bound."""
    import torch

    from repro_torch.core import metrics as M

    gpu = routes["runs"]["frame"]["result"]
    cpu = routes["cpu"]
    sg = M.metric_matrix(gpu.metrics)[gpu.clusters.valid]
    sc = M.metric_matrix(cpu.metrics)[cpu.clusters.valid]
    close(sg, sc, "[8] metric_matrix, cuda vs cpu")
    cg, cc = M.correlation_matrix(sg), M.correlation_matrix(sc)
    err = close(cg, cc, "[8] correlation_matrix, cuda vs cpu")
    require(bool(torch.isfinite(cg).all()), "[8] correlation_matrix: not finite")
    names = [n.replace("_entropy", "").replace("_", " ") for n in M.METRIC_NAMES]
    log(f"[8] Fig. 7 on the card: {sg.shape[0]} valid clusters x {sg.shape[1]} metrics; correlation "
        f"within the bound of the cpu run's (max abs err {err:.3g}):")
    log("    " + " ".join(f"{n[:10]:>10}" for n in [""] + names))
    for n, row in zip(names, cg.cpu().tolist()):
        log("    " + f"{n[:10]:>10} " + " ".join(f"{v:10.4f}" for v in row))


def route_times(scale, dev) -> dict:
    """(f) For each route: the untracked window core at scale (best of 3,
    closed by a synchronize), a profile of it (host ms, device-busy ms,
    device kernels per block in each stage) and the atlas update's own
    device ms."""
    from repro_torch.core.events import pad_windows
    from repro_torch.core.pipeline import run_recording_scan

    stages = ("conditioning", "clustering", "metrics", "atlas")
    win = pad_windows(scale.x, scale.y, scale.t, scale.p, route_config("event").batcher, dev)
    out = {}
    for name, _ in ROUTES:
        c = route_config(name)
        core_ms, _ = best_ms(lambda: run_recording_scan(scale, c, with_tracking=False, windows=win, device=dev))
        prof = window_core_profile(scale, c, dev, win, stages)
        out[name] = dict(window_core_ms=core_ms, host_ms=prof["host_ms"],
                         device_busy_ms=prof["device_busy_ms"],
                         atlas_device_ms=prof["ranges"]["atlas"][1],
                         kernels={k: v for k, v in prof["kernels"].items() if v})
        log(f"[8] {name} route, untracked window core at scale: {core_ms:.2f} ms best of 3 "
            f"({core_ms / win.num_windows * 1e3:.2f} us a window); profiled host {prof['host_ms']:.1f} ms, "
            f"device busy {prof['device_busy_ms']:.2f} ms; atlas update {prof['ranges']['atlas'][1]:.3f} "
            f"device ms; by stage (host ms, kernel ms, device span ms): "
            + ", ".join(f"{k} ({h:.2f}, {d:.2f}, {sp:.2f})" for k, (h, d, sp) in prof["ranges"].items() if h)
            + "; device launches per block: "
            + ", ".join(f"{k} {v}" for k, v in out[name]["kernels"].items()))
    return out


def phase8(scale, kernel_run, fleet_recs, dev) -> dict:
    """Phase 8, run on the card with no error caught."""
    t8 = time.perf_counter()
    enter("8a")
    routes = check_routes(scale, kernel_run, dev)
    enter("8b")
    atlas = check_atlas_stream(scale, dev)
    sync = check_atlas_sync(scale, dev)
    enter("8c")
    check_route_fleet(fleet_recs, dev)
    enter("8d")
    k6 = check_k6_real_frames(scale, routes, dev)
    enter("8e")
    check_fig7(routes, dev)
    enter("8f")
    times = route_times(scale, dev)
    log(f"[8] phase wall time {time.perf_counter() - t8:.1f} s")
    return dict(routes=routes, atlas=atlas, sync=sync, k6=k6, times=times)


# ---------------------------------------------------------------------------
# Phase 9: the LM serving path at full width.
# ---------------------------------------------------------------------------

def count_syncs(fn):
    """(``fn()``, the host synchronizations it made under
    ``torch.cuda.set_sync_debug_mode("warn")``)."""
    import warnings

    import torch

    mode = torch.cuda.get_sync_debug_mode()  # calls may nest
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    return out, sum("synchroniz" in str(w.message) and "prototype feature" not in str(w.message)
                    for w in caught)


def lm_requests(vocab: int, n: int = LM_REQUESTS, seed: int = 0) -> list:
    """Phase 9's prompts (phase 10's are its first 8): lengths 16-64 and
    tokens from default_rng(seed)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lo, hi = LM_PROMPT
    return [[int(t) for t in rng.integers(0, vocab, int(rng.integers(lo, hi + 1)))]
            for _ in range(n)]


def padded_prompts(vocab: int):
    """Phase 9's first batch, left-padded as the engine pads it."""
    import numpy as np

    prompts = lm_requests(vocab)[:LM_ENGINE["max_batch"]]
    max_len = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), max_len), np.int32)
    for i, p in enumerate(prompts):
        toks[i, max_len - len(p):] = p
    return toks


def lm_bounds(cfg, tokens: int, batch: int, cache_len: int) -> dict:
    """Least time of a prefill of ``tokens`` prompt tokens and of one
    decode step of ``batch`` rows: the bf16 weights read once (embedding
    included) over HBM bandwidth, against the matmul operations over the
    dense bf16 peak; attention's and the cache's share is counted too."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    weight_bytes = 2 * cfg.param_count()
    nonembed = cfg.param_count() - cfg.vocab * d
    kv_bytes = lambda n: 2 * 2 * cfg.n_layers * n * cfg.n_kv_heads * hd  # noqa: E731  k, v in bf16
    # Prefill: every token through the blocks, the last position's logits;
    # causal attention over the prompt (scores and PV, half the square).
    pre_ops = 2 * nonembed * tokens + 2 * batch * d * cfg.vocab \
        + 2 * 2 * cfg.n_layers * cfg.n_heads * hd * tokens * (tokens // batch) // 2
    pre_bytes = weight_bytes + kv_bytes(tokens)
    dec_ops = 2 * cfg.param_count() * batch + 2 * 2 * cfg.n_layers * cfg.n_heads * hd * batch * cache_len
    dec_bytes = weight_bytes + kv_bytes(batch * cache_len)
    out = {}
    for name, ops, nbytes in (("prefill", pre_ops, pre_bytes), ("decode", dec_ops, dec_bytes)):
        t_ops, t_bytes = ops / PEAK_BF16_S * 1e3, nbytes / PEAK_BYTES_S * 1e3
        out[name] = dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops > t_bytes else "bytes",
                         ops=ops, bytes=nbytes)
    return out


class TimedEngineCalls:
    """Wraps an engine's prefill and decode calls with CUDA events and keeps
    each call's logits: per batch, the prefill's ms and each decode step's."""

    def __init__(self, engine):
        import torch

        self.torch = torch
        self.events, self.logits = [], []
        pre, dec = engine._prefill, engine._decode
        engine._prefill = lambda *a: self._timed("prefill", pre, a)
        engine._decode = lambda *a: self._timed("decode", dec, a)

    def _timed(self, kind, fn, args):
        start = self.torch.cuda.Event(enable_timing=True)
        stop = self.torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        stop.record()
        if kind == "prefill":
            self.events.append([])
            self.logits.append([])
        self.events[-1].append((kind, start, stop))
        self.logits[-1].append(out[0])
        return out

    def batches(self) -> list[dict]:
        self.torch.cuda.synchronize()
        return [dict(prefill_ms=ev[0][1].elapsed_time(ev[0][2]),
                     decode_ms=[a.elapsed_time(b) for _, a, b in ev[1:]]) for ev in self.events]


def lm_serve(dev, smi: str) -> dict:
    """9a: ServingEngine at full width on the card, 24 requests; then one
    batch again under set_sync_debug_mode."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Transformer
    from repro_torch.serve.lm import EngineConfig, Request, ServingEngine

    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    masters = Transformer(cfg, LM_SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = ServingEngine(masters, EngineConfig(**LM_ENGINE), device=dev)
    del masters  # the engine serves its own bf16 copy
    prompts = lm_requests(cfg.vocab)
    # Warm-up, not timed: one request of two tokens (cuBLAS handles and
    # kernel modules load on first use).
    engine.submit(Request(rid=-1, tokens=prompts[0], max_new_tokens=2))
    engine.run_until_drained()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    timed = TimedEngineCalls(engine)
    reqs = [Request(rid=i, tokens=p, max_new_tokens=LM_NEW) for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    done = engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    require(sorted(r.rid for r in done) == list(range(LM_REQUESTS)), f"[9a] served {len(done)} requests")
    require(all(len(r.output) == LM_NEW and all(0 <= t < cfg.vocab for t in r.output) for r in done),
            "[9a] every answer holds 16 tokens of the vocabulary")
    batches = timed.batches()
    require(len(batches) == LM_REQUESTS // LM_ENGINE["max_batch"], f"[9a] {len(batches)} batches")
    n_tok = sum(len(r.output) for r in done)
    lens = [[len(r.tokens) for r in done[i:i + LM_ENGINE["max_batch"]]]
            for i in range(0, len(done), LM_ENGINE["max_batch"])]
    for i, (b, ln) in enumerate(zip(batches, lens)):
        require(len(b["decode_ms"]) == LM_NEW - 1, f"[9a] batch {i}: {len(b['decode_ms'])} decode calls")
        bd = lm_bounds(cfg, len(ln) * max(ln), len(ln), LM_ENGINE["max_seq"])
        log(f"[9a] batch {i}: prompts {min(ln)}-{max(ln)} tokens (padded to {max(ln)}); prefill "
            f"{b['prefill_ms']:.3f} ms (bound {bd['prefill']['bound_ms']:.3f} ms, "
            f"{bd['prefill']['bound_by']}); decode steps ms " + " ".join(f"{x:.3f}" for x in b["decode_ms"])
            + f" (bound {bd['decode']['bound_ms']:.3f} ms, {bd['decode']['bound_by']}) [{smi}]")
    dec = [x for b in batches for x in b["decode_ms"]]
    lat = float(np.mean([r.batch_latency_s for r in done]))
    log(f"[9a] {LM_ARCH} full width ({cfg.param_count():,} parameters, bf16 served copy), "
        f"{len(done)} requests, {n_tok} tokens in {wall:.3f} s: {n_tok / wall:.1f} tokens/s, mean batch "
        f"latency {lat * 1e3:.1f} ms; decode step median {statistics.median(dec):.3f} ms (min "
        f"{min(dec):.3f}, max {max(dec):.3f}); peak memory {peak / 2**30:.2f} GiB "
        f"(max_memory_allocated); masters init {init_s:.2f} s [{smi}]")
    # The first batch again, each decode step and the whole step under
    # set_sync_debug_mode("warn"): the same tokens, no synchronization in
    # a decode step, one a token (the read-back) besides the prompt upload.
    first = done[:LM_ENGINE["max_batch"]]
    for r in first:
        engine.submit(Request(rid=100 + r.rid, tokens=r.tokens, max_new_tokens=LM_NEW))
    dec_syncs = []
    inner = engine._decode

    def counted(*a):
        out, n = count_syncs(lambda: inner(*a))
        dec_syncs.append(n)
        return out

    engine._decode = counted
    again, total = count_syncs(engine.step)
    engine._decode = inner
    require([r.output for r in again] == [r.output for r in first], "[9a] the first batch served again differs")
    require(dec_syncs == [0] * (LM_NEW - 1), f"[9a] decode_step synchronized the host: {dec_syncs}")
    require(LM_NEW <= total <= LM_NEW + 2, f"[9a] {total} host synchronizations in one batch")
    log(f"[9a] host synchronizations under set_sync_debug_mode('warn'): {dec_syncs[0]} in each of "
        f"{len(dec_syncs)} decode_step calls, {total} in the whole batch: one a token ({LM_NEW} "
        f"read-backs) and {total - LM_NEW} for the prompt's upload")
    return dict(engine=engine, cfg=cfg, done=done, timed=timed, batches=batches, wall_s=wall,
                tokens=n_tok, peak_bytes=peak, syncs=total, decode_syncs=dec_syncs[0],
                mean_batch_latency_s=lat, decode_median_ms=statistics.median(dec))


def teacher_forcing(engine, done, logits, bound: float) -> dict:
    """forward_train over the batch's prompts and answers against the
    prefill / decode ``logits`` (B, new tokens, V) that served them: the
    largest difference, and the tokens where the served top-1/top-2 margin
    exceeds twice ``bound``."""
    import numpy as np
    import torch

    from repro_torch.models import forward_train

    lens = [len(r.tokens) for r in done]
    max_len = max(lens)
    toks = np.zeros((len(done), max_len + LM_NEW - 1), np.int32)
    for i, r in enumerate(done):
        toks[i, max_len - lens[i]:max_len] = r.tokens
        toks[i, max_len:] = r.output[:-1]
    tf = forward_train(engine.model, {"tokens": toks})[0][:, max_len - 1:]
    top = torch.topk(logits, 2, -1).values
    clear = (top[..., 0] - top[..., 1]) > 2 * bound
    served_tok = torch.tensor([r.output for r in done], device=logits.device)
    return dict(max_abs_err=float((tf - logits).abs().max()),
                served=bool((logits.argmax(-1) == served_tok).all()),
                agree=bool(((tf.argmax(-1) == served_tok) | ~clear).all()),
                clear=int(clear.sum()), positions=clear.numel(), shape=toks.shape)


def lm_teacher_forcing(served: dict) -> dict:
    """9b: forward_train over the first batch's prompts and answers against
    the prefill / decode logits that served them."""
    import torch

    done = served["done"][:LM_ENGINE["max_batch"]]
    logits = torch.stack(served["timed"].logits[0], 1)  # (B, new tokens, V)
    r = teacher_forcing(served["engine"], done, logits, LM_TEACHER_ATOL)
    err = r["max_abs_err"]
    require(r["served"], "[9b] the kept logits did not serve the tokens")
    require(err <= LM_TEACHER_ATOL, f"[9b] teacher forcing: max abs logit difference {err} > {LM_TEACHER_ATOL}")
    require(r["agree"], "[9b] teacher forcing picks another token where the margin exceeds twice the bound")
    log(f"[9b] teacher forcing at full width, batch 0 ({r['shape'][0]} x {r['shape'][1]} tokens, bf16): "
        f"max abs logit difference {err:.4f} (bound {LM_TEACHER_ATOL}); tokens equal at all "
        f"{r['clear']} of {r['positions']} positions whose top-1/top-2 margin exceeds "
        f"{2 * LM_TEACHER_ATOL}")
    return dict(max_abs_err=err, clear=r["clear"], positions=r["positions"])


def lm_card_against_cpu(dev, smi: str) -> dict:
    """9c: the same float32 weights at full width, depth 2, on the card and
    on the CPU: a prefill of a padded batch of 8 and 4 decode steps; the
    port's flash_attention at the prefill's shapes."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Transformer, cast_weights, decode_step, prefill
    from repro_torch.models.attention import flash_attention

    c = LM_CARD_CPU
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=c["n_layers"], dtype="float32")
    gpu = Transformer(cfg, LM_SEED, device=dev)
    cpu = cast_weights(gpu, torch.float32, "cpu")
    toks = padded_prompts(cfg.vocab)
    n, max_len = toks.shape
    log(f"[9c] the CPU side: {torch.backends.cpu.get_cpu_capability()}, {torch.get_num_threads()} "
        f"threads, float32 matmul precision {torch.get_float32_matmul_precision()}")
    lg, cg = prefill(gpu, {"tokens": toks}, cache_len=LM_ENGINE["max_seq"])
    lc, cc = prefill(cpu, {"tokens": toks}, cache_len=LM_ENGINE["max_seq"])
    errs, clear, total = [], 0, 0
    for step in range(c["decode"] + 1):
        errs.append(close(lg, lc, f"[9c] logits, step {step}", c["rtol"], c["atol"]))
        top = torch.topk(lc, 2, -1).values
        ok = (top[:, 0] - top[:, 1]) > 2 * (c["atol"] + c["rtol"] * top[:, 0].abs())
        require(bool(((lg.argmax(-1).cpu() == lc.argmax(-1)) | ~ok).all()), f"[9c] tokens differ, step {step}")
        clear, total = clear + int(ok.sum()), total + ok.numel()
        if step == c["decode"]:
            break
        nxt = {"tokens": lc.argmax(-1)[:, None].numpy()}  # the CPU's tokens feed both
        lg, cg = decode_step(gpu, nxt, cg, max_len + step)
        lc, cc = decode_step(cpu, nxt, cc, max_len + step)
    hd, kvh = cfg.resolved_head_dim, cfg.n_kv_heads
    g = cfg.n_heads // kvh
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((n, max_len, kvh, g, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((n, max_len, kvh, hd)).astype(np.float32))
            for _ in "kv")
    pos = torch.arange(max_len, dtype=torch.int32)
    flash_err = close(flash_attention(*(a.to(dev) for a in (q, k, v, pos, pos))),
                      flash_attention(q, k, v, pos, pos), "[9c] flash_attention", RTOL, ATOL)
    log(f"[9c] card against CPU, {LM_ARCH} full width at depth {c['n_layers']}, float32, "
        f"allow_tf32={torch.backends.cuda.matmul.allow_tf32}: prefill of {toks.shape} then "
        f"{c['decode']} decode steps, max abs logit difference per step "
        + " ".join(f"{e:.2e}" for e in errs) + f" (rtol = atol = {c['atol']}); tokens equal at "
        f"{clear} of {total} rows with a clear margin; flash_attention at {tuple(q.shape)} within "
        f"{flash_err:.2e} [{smi}]")
    return dict(max_abs_err=max(errs), flash_err=flash_err)


def lm_yardsticks(served: dict, smi: str) -> dict:
    """9d: the port's flash_attention at the served prefill's shapes (bf16)
    against F.scaled_dot_product_attention of the same function (GQA
    expanded, causal), and one decode step with cuBLAS's reduced-precision
    bf16 reduction off (the phase's setting) and on."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import decode_step, prefill
    from repro_torch.models.attention import flash_attention

    engine, cfg = served["engine"], served["cfg"]
    dev = engine.device
    b, s = LM_ENGINE["max_batch"], LM_PROMPT[1]
    hd, kvh = cfg.resolved_head_dim, cfg.n_kv_heads
    g = cfg.n_heads // kvh
    gen = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn(b, s, kvh, g, hd, device=dev, generator=gen).to(torch.bfloat16)
    k = torch.randn(b, s, kvh, hd, device=dev, generator=gen).to(torch.bfloat16)
    v = torch.randn(b, s, kvh, hd, device=dev, generator=gen).to(torch.bfloat16)
    pos = torch.arange(s, dtype=torch.int32, device=dev)
    qs = q.reshape(b, s, kvh * g, hd).transpose(1, 2)  # head h = kv * G + g
    ks, vs = (a.repeat_interleave(g, dim=2).transpose(1, 2) for a in (k, v))
    ours = flash_attention(q, k, v, pos, pos)
    lib = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True).transpose(1, 2).reshape(ours.shape)
    lib_err = close(ours, lib, "[9d] flash_attention against SDPA (bf16 rounding)", 2 ** -7, 2 ** -7)
    flash_ms = cuda_ms(lambda: flash_attention(q, k, v, pos, pos))
    sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True))
    n_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    n_ops = 2 * 2 * b * cfg.n_heads * hd * s * (s + 1) // 2
    attn_bound = max(n_bytes / PEAK_BYTES_S, n_ops / PEAK_BF16_S) * 1e3
    # One decode step at the served shapes (batch 8, position 64).
    toks = torch.zeros((b, s), dtype=torch.int32)
    _, cache = prefill(engine.model, {"tokens": toks}, cache_len=LM_ENGINE["max_seq"])
    nxt = {"tokens": torch.zeros((b, 1), dtype=torch.long, device=dev)}
    step_ms = {}
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    for setting in (False, True):
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = setting
        step_ms[setting] = cuda_ms(lambda: decode_step(engine.model, nxt, cache, s), iters=20)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
    # Where a step's time goes: the device's busy time and operations per
    # call under the profiler, against the call's time under CUDA events.
    step = lambda: decode_step(engine.model, nxt, cache, s)  # noqa: E731
    full = lambda: prefill(engine.model, {"tokens": toks}, cache_len=LM_ENGINE["max_seq"])  # noqa: E731
    dec_busy, dec_ops = kernel_device_profile(step, ("",), iters=5)
    pre_ms = cuda_ms(full, iters=10)
    pre_busy, pre_ops = kernel_device_profile(full, ("",), iters=5)
    bd = lm_bounds(cfg, b * s, b, LM_ENGINE["max_seq"])
    log(f"[9d] attention at the served prefill's shapes (B {b}, S {s}, {cfg.n_heads} q heads over "
        f"{kvh} kv heads, head_dim {hd}, bf16): the port's flash_attention {flash_ms:.4f} ms, "
        f"F.scaled_dot_product_attention (GQA expanded, causal; timed only) {sdpa_ms:.4f} ms, bound "
        f"{attn_bound:.4f} ms; outputs within {lib_err:.2e}. One decode step (batch {b}, position {s}): "
        f"{step_ms[False]:.3f} ms with allow_bf16_reduced_precision_reduction False, "
        f"{step_ms[True]:.3f} ms with it True; bound {bd['decode']['bound_ms']:.3f} ms "
        f"({bd['decode']['bound_by']}) [{smi}]")
    log(f"[9d] under the profiler: a decode step keeps the device busy {dec_busy:.3f} ms in "
        f"{dec_ops:.0f} device operations ({dec_busy / step_ms[False]:.1%} of its {step_ms[False]:.3f} ms); "
        f"a prefill of {b} x {s} tokens takes {pre_ms:.3f} ms, the device busy {pre_busy:.3f} ms in "
        f"{pre_ops:.0f} operations (bound {bd['prefill']['bound_ms']:.3f} ms, {bd['prefill']['bound_by']}) "
        f"[{smi}]")
    return dict(flash_ms=flash_ms, sdpa_ms=sdpa_ms, attn_bound_ms=attn_bound,
                decode_ms=step_ms[False], decode_reduced_ms=step_ms[True], decode_busy_ms=dec_busy,
                decode_device_ops=dec_ops, prefill_64_ms=pre_ms, prefill_busy_ms=pre_busy,
                prefill_device_ops=pre_ops)


def phase9(dev, smi: str) -> dict:
    """Phase 9, the LM serving path at full width, on the card with no
    error caught."""
    import torch

    t9 = time.perf_counter()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    log(f"[9] allow_bf16_reduced_precision_reduction="
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}, "
        f"allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    served = lm_serve(dev, smi)
    teacher = lm_teacher_forcing(served)
    card_cpu = lm_card_against_cpu(dev, smi)
    yard = lm_yardsticks(served, smi)
    out = dict(
        tokens_per_s=served["tokens"] / served["wall_s"], mean_batch_latency_s=served["mean_batch_latency_s"],
        prefill_ms=[b["prefill_ms"] for b in served["batches"]], decode_median_ms=served["decode_median_ms"],
        peak_gib=served["peak_bytes"] / 2**30, syncs_per_batch=served["syncs"],
        teacher_max_abs_err=teacher["max_abs_err"], card_cpu_max_abs_err=card_cpu["max_abs_err"], **yard)
    log(f"[9] {json.dumps(out)}")
    log(f"[9] phase wall time {time.perf_counter() - t9:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 10: the MLA, MoE, RG-LRU and xLSTM families at full width.
# ---------------------------------------------------------------------------

def family_config(arch: str, dtype: str | None = None, n_layers: int | None = None):
    """The family's registered config at full width, cut to the served depth
    (``LM10_FAMILIES``) or to ``n_layers``."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    over = {}
    if n_layers or LM10_FAMILIES[arch]:
        over["n_layers"] = n_layers or LM10_FAMILIES[arch]
    if dtype:
        over["dtype"] = dtype
    return dataclasses.replace(cfg, **over)


def family_bounds(cfg, tokens: int, batch: int) -> dict:
    """Least time of a prefill of ``tokens`` prompt tokens in ``batch`` rows
    and of one decode step of ``batch`` rows: the bf16 weights read once
    over HBM bandwidth, against the matmul operations over the dense bf16
    peak. The reference's MoE runs every expert over its capacity rows, so
    those rows are counted; attention's score products are left out (under
    1% at 81 positions)."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    embed = v * d * (1 if cfg.tie_embeddings else 2)
    n_moe = sum(t in ("attn", "local") for t in cfg.layer_types) if cfg.n_experts else 0
    expert = 3 * d * f * cfg.n_experts * n_moe
    dense = cfg.param_count() - embed - expert

    def ops(t: int) -> int:
        cap = int(max(cfg.top_k, t * cfg.top_k / cfg.n_experts * cfg.capacity_factor)) if n_moe else 0
        return 2 * t * dense + 2 * 3 * d * f * cfg.n_experts * cap * n_moe + 2 * batch * d * v

    nbytes = 2 * cfg.param_count()
    out = {}
    for name, n_ops in (("prefill", ops(tokens)), ("decode", ops(batch))):
        t_ops, t_bytes = n_ops / PEAK_BF16_S * 1e3, nbytes / PEAK_BYTES_S * 1e3
        out[name] = dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops > t_bytes else "bytes",
                         ops=n_ops, bytes=nbytes)
    return out


def family_serve(arch: str, dev, smi: str) -> dict:
    """10a: ServingEngine at full width on the card, one batch of 8; every
    decode step under set_sync_debug_mode."""
    import numpy as np
    import torch

    from repro_torch.models import Transformer, decode_step, prefill
    from repro_torch.serve.lm import EngineConfig, Request, ServingEngine

    cfg = family_config(arch)
    t0 = time.perf_counter()
    masters = Transformer(cfg, LM_SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    masters_gib = sum(p.numel() * p.element_size() for p in masters.parameters()) / 2**30
    engine = ServingEngine(masters, EngineConfig(**LM_ENGINE), device=dev)
    del masters  # the engine serves its own bf16 copy
    torch.cuda.empty_cache()
    prompts = lm_requests(cfg.vocab, LM10_REQUESTS)
    # Warm-up, not timed: one request, two new tokens.
    engine.submit(Request(rid=-1, tokens=prompts[0], max_new_tokens=2))
    engine.run_until_drained()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = TimedEngineCalls(engine)
    dec_syncs = []
    inner = engine._decode

    def counted(*a):
        out, n = count_syncs(lambda: inner(*a))
        dec_syncs.append(n)
        return out

    engine._decode = counted
    reqs = [Request(rid=i, tokens=p, max_new_tokens=LM_NEW) for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    done = engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    engine._decode = inner
    peak = torch.cuda.max_memory_allocated()
    tag = f"[10a] {arch}"
    require(sorted(r.rid for r in done) == list(range(LM10_REQUESTS)), f"{tag}: served {len(done)} requests")
    require(all(len(r.output) == LM_NEW and all(0 <= t < cfg.vocab for t in r.output) for r in done),
            f"{tag}: every answer holds 16 tokens of the vocabulary")
    (batch,) = timed.batches()
    require(len(batch["decode_ms"]) == LM_NEW - 1, f"{tag}: {len(batch['decode_ms'])} decode calls")
    require(dec_syncs == [0] * (LM_NEW - 1), f"{tag}: decode_step synchronized the host: {dec_syncs}")
    lens = [len(r.tokens) for r in done]
    bd = family_bounds(cfg, len(lens) * max(lens), len(lens))
    dec = batch["decode_ms"]
    # Where a decode step's time goes: the device's busy time and operations
    # per step under the profiler, on the batch's own cache.
    toks = np.zeros((len(lens), max(lens)), np.int32)
    for i, r in enumerate(done):
        toks[i, max(lens) - lens[i]:] = r.tokens
    _, cache = prefill(engine.model, {"tokens": toks}, cache_len=LM_ENGINE["max_seq"])
    nxt = {"tokens": torch.tensor([[r.output[0]] for r in done], device=dev)}
    busy, n_ops = kernel_device_profile(lambda: decode_step(engine.model, nxt, cache, max(lens)), ("",),
                                        iters=3)
    del cache
    n_tok = sum(len(r.output) for r in done)
    lat = float(np.mean([r.batch_latency_s for r in done]))
    log(f"{tag}: {cfg.n_layers} layers at full width ({cfg.param_count():,} parameters, bf16 served copy "
        f"{2 * cfg.param_count() / 2**30:.2f} GiB; float32 masters {masters_gib:.2f} GiB made in {init_s:.2f} s, "
        f"dropped); prompts {min(lens)}-{max(lens)} tokens (padded to {max(lens)}): prefill "
        f"{batch['prefill_ms']:.3f} ms (bound {bd['prefill']['bound_ms']:.3f} ms, {bd['prefill']['bound_by']}); "
        f"decode step median {statistics.median(dec):.3f} ms (min {min(dec):.3f}, max {max(dec):.3f}; bound "
        f"{bd['decode']['bound_ms']:.3f} ms, {bd['decode']['bound_by']}); {n_tok} tokens in {wall:.3f} s: "
        f"{n_tok / wall:.1f} tokens/s, batch latency {lat * 1e3:.1f} ms; peak memory {peak / 2**30:.2f} GiB "
        f"(max_memory_allocated); host synchronizations {dec_syncs[0]} in each of {len(dec_syncs)} decode "
        f"steps; under the profiler a decode step keeps the device busy {busy:.3f} ms in {n_ops:.0f} device "
        f"operations ({busy / statistics.median(dec):.1%} of the median step) [{smi}]")
    return dict(engine=engine, cfg=cfg, done=done, timed=timed, prefill_ms=batch["prefill_ms"],
                decode_busy_ms=busy, decode_device_ops=n_ops,
                decode_ms=dec, decode_median_ms=statistics.median(dec), tokens_per_s=n_tok / wall,
                batch_latency_s=lat, peak_gib=peak / 2**30, masters_gib=masters_gib, init_s=init_s,
                prefill_bound_ms=bd["prefill"]["bound_ms"], decode_bound_ms=bd["decode"]["bound_ms"])


def served_logits(engine, prompts, stale_cache: bool = False) -> tuple[list, "torch.Tensor"]:
    """Serves ``prompts`` (16 new tokens each) in one batch and keeps the
    logits of each prefill / decode call: (requests, logits (B, 16, V)).
    With ``stale_cache``, the control of 10b, every decode step reads a
    copy of the cache as the prefill left it: a cache that decode never
    writes."""
    import torch

    from repro_torch.serve.lm import Request

    calls, logits, prefilled = (engine._prefill, engine._decode), [], []

    def copy(cache):
        return [{k: v.clone() for k, v in layer.items()} for layer in cache]

    def pre(*a):
        out = calls[0](*a)
        logits.append(out[0])
        prefilled[:] = [copy(out[1])] if stale_cache else []
        return out

    def dec(inputs, cache, position):
        out = calls[1](inputs, copy(prefilled[0]) if stale_cache else cache, position)
        logits.append(out[0])
        return out

    engine._prefill, engine._decode = pre, dec
    try:
        for i, p in enumerate(prompts):
            engine.submit(Request(rid=i, tokens=p, max_new_tokens=LM_NEW))
        done = engine.run_until_drained(budget_s=1e9)
    finally:
        engine._prefill, engine._decode = calls
    return done, torch.stack(logits, 1)


def no_drop(cfg):
    """The config with a capacity every expert's load fits (E / k: capacity
    >= tokens), so no MoE assignment is dropped: the reference's own teacher
    forcing test raises the capacity factor for the same reason."""
    import dataclasses

    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k) if cfg.n_experts else cfg


def family_teacher_forcing(arch: str, served: dict) -> dict:
    """10b: the served logits against forward_train within the family's
    bound, measured on the CPU. A MoE router's capacity depends on how many
    tokens a call holds (a prefill of 8 x 64, a decode step of 8, a forward
    of 8 x 79), so the same token can be dropped in one and kept in the
    other: for the MoE family the batch is served again without drops
    (``no_drop``) and that is held to the bound; the served batch's own
    difference is printed beside it. The control, the batch served with a
    cache that decode never writes, must exceed the bound: the check can
    fail."""
    import torch

    bound = LM10_TEACHER_ATOL[arch]
    engine, cfg = served["engine"], served["cfg"]
    done, logits = served["done"], torch.stack(served["timed"].logits[0], 1)  # (B, new tokens, V)
    prompts = [r.tokens for r in done]
    note = ""
    if cfg.n_experts:
        with_drops = teacher_forcing(engine, done, logits, bound)["max_abs_err"]
        note = (f"; served again with capacity_factor {no_drop(cfg).capacity_factor:.4g} (no drop); the "
                f"batch served at capacity_factor {cfg.capacity_factor} reads {with_drops:.4f} (not held)")
    engine.model.cfg = no_drop(cfg)
    try:
        if cfg.n_experts:
            done, logits = served_logits(engine, prompts)
        r = teacher_forcing(engine, done, logits, bound)
        control = teacher_forcing(engine, *served_logits(engine, prompts, stale_cache=True), bound)["max_abs_err"]
    finally:
        engine.model.cfg = cfg
    tag = f"[10b] {arch}"
    require(r["served"], f"{tag}: the kept logits did not serve the tokens")
    require(r["max_abs_err"] <= bound, f"{tag}: teacher forcing: max abs logit difference {r['max_abs_err']} > {bound}")
    require(r["agree"], f"{tag}: teacher forcing picks another token where the margin exceeds twice the bound")
    require(control > bound, f"{tag}: the control (a cache decode never writes) reads {control}, within the bound "
            f"{bound}: the check could not fail")
    log(f"{tag}: teacher forcing ({r['shape'][0]} x {r['shape'][1]} tokens, bf16): max abs logit difference "
        f"{r['max_abs_err']:.4f} (bound {bound}, measured on the CPU); tokens equal at all {r['clear']} of "
        f"{r['positions']} positions whose top-1/top-2 margin exceeds {2 * bound}; the control, served with a "
        f"cache that decode never writes, reads {control:.4f}" + note)
    return dict(r, control_max_abs_err=control)


class FirstRouting:
    """Keeps the routing of the first MoE layer a prefill runs (the first
    ``moe_route`` call while active)."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.route, self.first = moe, moe.moe_route, None

    def __enter__(self):
        def spy(*a, **kw):
            r = self.route(*a, **kw)
            if self.first is None:
                self.first = r
            return r

        self.moe.moe_route = spy
        return self

    def __exit__(self, *exc):
        self.moe.moe_route = self.route


def compare_routing(rg, rc, what: str, margin: float) -> str:
    """The card's first-layer routing against the CPU's: expert choices
    equal on every token whose k-th / (k+1)-th router margin exceeds
    ``margin``; the keep mask equal on every assignment before the first
    token whose choice differs (all of them when none does)."""
    import torch

    k = rc.experts.shape[1]
    top = torch.sort(rc.probs, -1, descending=True).values
    clear = (top[:, k - 1] - top[:, k]) > margin
    differ = (rg.experts.cpu() != rc.experts).any(1)
    require(not bool((differ & clear).any()), f"{what}: expert choices differ on a token with a clear margin")
    upto = int(differ.nonzero()[0, 0]) * k if bool(differ.any()) else rc.keep.numel()
    require(torch.equal(rg.keep.cpu()[:upto], rc.keep[:upto]), f"{what}: keep masks differ")
    require(rg.capacity == rc.capacity, f"{what}: capacities differ")
    return (f"first MoE layer: expert choices equal on {int(clear.sum())} of {clear.numel()} tokens with a "
            f"clear margin ({int(differ.sum())} differ), keep equal on {upto} of {rc.keep.numel()} "
            f"assignments ({int((~rc.keep).sum())} dropped), capacity {rc.capacity}")


def family_card_against_cpu(arch: str, dev, smi: str) -> dict:
    """10c: the same float32 weights at full width, one block-pattern cycle
    deep (2 layers for single-block patterns), on the card and on the CPU:
    a prefill of the padded batch of 8 and 4 decode steps."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Transformer, cast_weights, decode_step, prefill

    plen = len(get_config(arch).block_pattern)
    cfg = family_config(arch, "float32", plen if plen > 1 else 2)
    c = LM10_CARD_CPU
    gpu = Transformer(cfg, LM_SEED, device=dev)
    cpu = cast_weights(gpu, torch.float32, "cpu")
    prompts = lm_requests(cfg.vocab, LM10_REQUESTS)
    max_len = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), max_len), np.int32)
    for i, p in enumerate(prompts):
        toks[i, max_len - len(p):] = p
    tag = f"[10c] {arch}"
    with FirstRouting() as rg_spy:
        lg, cg = prefill(gpu, {"tokens": toks}, cache_len=LM_ENGINE["max_seq"])
    with FirstRouting() as rc_spy:
        lc, cc = prefill(cpu, {"tokens": toks}, cache_len=LM_ENGINE["max_seq"])
    routing = ""
    if cfg.n_experts:
        routing = "; " + compare_routing(rg_spy.first, rc_spy.first, tag, c["atol"])
    errs, clear, total = [], 0, 0
    for step in range(c["decode"] + 1):
        errs.append(close(lg, lc, f"{tag}: logits, step {step}", c["rtol"], c["atol"]))
        top = torch.topk(lc, 2, -1).values
        ok = (top[:, 0] - top[:, 1]) > 2 * (c["atol"] + c["rtol"] * top[:, 0].abs())
        require(bool(((lg.argmax(-1).cpu() == lc.argmax(-1)) | ~ok).all()), f"{tag}: tokens differ, step {step}")
        clear, total = clear + int(ok.sum()), total + ok.numel()
        if step == c["decode"]:
            break
        nxt = {"tokens": lc.argmax(-1)[:, None].numpy()}  # the CPU's tokens feed both
        lg, cg = decode_step(gpu, nxt, cg, max_len + step)
        lc, cc = decode_step(cpu, nxt, cc, max_len + step)
    log(f"{tag}: card against CPU at full width, {cfg.n_layers} layers ({', '.join(cfg.layer_types)}), "
        f"float32, allow_tf32={torch.backends.cuda.matmul.allow_tf32}: prefill of {toks.shape} then "
        f"{c['decode']} decode steps, max abs logit difference per step " + " ".join(f"{e:.2e}" for e in errs)
        + f" (rtol = atol = {c['atol']}); tokens equal at {clear} of {total} rows with a clear margin"
        + routing + f" [{smi}]")
    return dict(max_abs_err=max(errs), errs=errs)


def phase10(dev, smi: str) -> dict:
    """Phase 10, the MLA, MoE, RG-LRU and xLSTM families at full width, on
    the card with no error caught; each family's engine is dropped before
    the next is made."""
    import torch

    t10 = time.perf_counter()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    out = {}
    for arch in LM10_FAMILIES:
        t = time.perf_counter()
        served = family_serve(arch, dev, smi)
        teacher = family_teacher_forcing(arch, served)
        card_cpu = family_card_against_cpu(arch, dev, smi)
        out[arch] = {k: v for k, v in served.items() if isinstance(v, (int, float))}
        out[arch].update(teacher_max_abs_err=teacher["max_abs_err"],
                         teacher_control_max_abs_err=teacher["control_max_abs_err"],
                         card_cpu_max_abs_err=card_cpu["max_abs_err"],
                         card_cpu_errs=card_cpu["errs"], wall_s=time.perf_counter() - t)
        del served
        torch.cuda.empty_cache()
    log(f"[10] {json.dumps(out)}")
    log(f"[10] phase wall time {time.perf_counter() - t10:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 11: LM training at full width and the paged decode.
# ---------------------------------------------------------------------------

def paged_graft(cache, cfg, batch: int, cache_len: int, dev):
    """Give a prefilled cache's full-attention layers the hot page of
    ``LM11_PAGE`` slots (``init_cache`` under ``PAGED_DECODE``), as the
    reference's test grafts its paged template onto a prefill cache."""
    from repro_torch.models import transformer as T

    old, T.PAGED_DECODE = T.PAGED_DECODE, LM11_PAGE
    try:
        pages = T.init_cache(cfg, batch, cache_len, device=dev)
    finally:
        T.PAGED_DECODE = old
    for c, p in zip(cache, pages):
        c.update({k: v for k, v in p.items() if k not in c})
    return cache


def decode_run(model, toks, feed=None, paged: bool = True, timed: bool = False) -> dict:
    """A prefill of ``toks`` and ``LM_NEW - 1`` decode steps, greedy or fed
    ``feed`` (B, LM_NEW - 1), paged (every layer flushed each ``LM11_PAGE``
    steps) or dense: the logits of each new token (B, LM_NEW, V) and, when
    ``timed``, each decode step's and flush's ms under CUDA events and
    host synchronizations."""
    import torch

    from repro_torch.models import decode_step, prefill
    from repro_torch.models.attention import flush_page

    b, s = toks.shape
    cache_len = s + LM_NEW
    logits, cache = prefill(model, {"tokens": toks}, cache_len=cache_len)
    if paged:
        cache = paged_graft(cache, model.cfg, b, cache_len, model.device)
    out, steps, flushes, syncs = [logits], [], [], []

    def run(fn, into):
        if not timed:
            return fn()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        res, n = count_syncs(fn)
        ev[1].record()
        into.append(ev)
        syncs.append(n)
        return res

    for i in range(LM_NEW - 1):
        if paged and i > 0 and i % LM11_PAGE == 0:
            cache = run(lambda: [flush_page(c) for c in cache], flushes)
        tok = logits.argmax(-1) if feed is None else torch.as_tensor(feed[:, i]).to(model.device)
        logits, cache = run(lambda: decode_step(model, {"tokens": tok[:, None]}, cache, s + i), steps)
        out.append(logits)
    logits = torch.stack(out, 1)
    if timed:
        torch.cuda.synchronize()
    ms = lambda evs: [a.elapsed_time(z) for a, z in evs]  # noqa: E731
    return dict(logits=logits, tokens=logits.argmax(-1), step_ms=ms(steps), flush_ms=ms(flushes),
                syncs=syncs, cache=cache)


def lm_paged_decode(dev, smi: str) -> dict:
    """11a: phase 9's first batch of Llama-3.2-1B at full width, bf16, through
    the paged decode, against forward_train; the dense decode of the same
    tokens timed beside it; then depth 2 in float32, card against CPU."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Transformer, cast_weights, forward_train

    cfg = get_config(LM_ARCH)
    masters = Transformer(cfg, LM_SEED, device=dev)
    model = cast_weights(masters)  # the served bf16 copy, as ServingEngine's
    del masters
    toks = padded_prompts(cfg.vocab)
    s = toks.shape[1]
    decode_run(model, toks)  # warm-up, not timed
    paged = decode_run(model, toks, timed=True)
    fed = paged["tokens"][:, :-1].cpu().numpy()
    dense = decode_run(model, toks, feed=fed, paged=False, timed=True)
    require(paged["syncs"] == [0] * len(paged["syncs"]),
            f"[11a] a paged decode step or flush synchronized the host: {paged['syncs']}")
    tf = forward_train(model, {"tokens": np.concatenate([toks, fed], 1)})[0][:, s - 1:]
    err = float((tf - paged["logits"]).abs().max())
    vs_dense = float((dense["logits"] - paged["logits"]).abs().max())
    require(err <= LM_TEACHER_ATOL, f"[11a] paged decode against forward_train: {err} > {LM_TEACHER_ATOL}")
    top = torch.topk(paged["logits"], 2, -1).values
    clear = (top[..., 0] - top[..., 1]) > 2 * LM_TEACHER_ATOL
    require(bool(((tf.argmax(-1) == paged["tokens"]) | ~clear).all()),
            "[11a] teacher forcing picks another token where the margin exceeds twice the bound")
    last_flush = max(i for i in range(1, LM_NEW - 1) if i % LM11_PAGE == 0)
    for c in paged["cache"]:
        pos = {int(p) for p in c["pos"].cpu() if p >= 0}
        require(set(range(s + last_flush)) <= pos, "[11a] a flushed position is missing from the main cache")
        require(sorted(int(p) for p in c["page_pos"].cpu() if p >= 0) == list(range(s + last_flush, s + LM_NEW - 1)),
                "[11a] the page does not hold the positions since the last flush")
    pm, dm = statistics.median(paged["step_ms"]), statistics.median(dense["step_ms"])
    fm = statistics.median(paged["flush_ms"])
    log(f"[11a] {LM_ARCH} full width, bf16, batch {toks.shape}, {LM_NEW} new tokens, page {LM11_PAGE} "
        f"(every layer flushed each {LM11_PAGE} steps): paged decode step median {pm:.3f} ms (min "
        f"{min(paged['step_ms']):.3f}, max {max(paged['step_ms']):.3f}), flush of all {cfg.n_layers} layers "
        f"median {fm:.3f} ms; dense decode step on the same tokens median {dm:.3f} ms (min "
        f"{min(dense['step_ms']):.3f}); teacher forcing max abs logit difference {err:.4f} (bound "
        f"{LM_TEACHER_ATOL}), tokens equal at {int(clear.sum())} of {clear.numel()} positions with a clear "
        f"margin; paged against dense {vs_dense:.4f}; {sum(paged['syncs'])} host synchronizations in "
        f"{len(paged['syncs'])} paged steps and flushes [{smi}]")
    del model, paged, dense, tf
    torch.cuda.empty_cache()
    # Depth 2, float32: the CPU's tokens feed both.
    c = LM_CARD_CPU
    cfg2 = dataclasses.replace(cfg, n_layers=c["n_layers"], dtype="float32")
    gpu = Transformer(cfg2, LM_SEED, device=dev)
    cpu = cast_weights(gpu, torch.float32, "cpu")
    rc = decode_run(cpu, toks)
    rg = decode_run(gpu, toks, feed=rc["tokens"][:, :-1].numpy())
    errs = [close(rg["logits"][:, i], rc["logits"][:, i], f"[11a] card against CPU, token {i}",
                  c["rtol"], c["atol"]) for i in range(LM_NEW)]
    for a, b in zip(rg["cache"], rc["cache"]):
        for k in b:
            close(a[k], b[k], f"[11a] card against CPU, cache {k}", c["rtol"], c["atol"])
    log(f"[11a] card against CPU, {LM_ARCH} at depth {c['n_layers']}, float32, paged: max abs logit "
        f"difference per token " + " ".join(f"{e:.2e}" for e in errs) + f" (rtol = atol = {c['atol']}); "
        f"the flushed caches within the same bound")
    return dict(paged_step_ms=pm, dense_step_ms=dm, flush_ms=fm, teacher_max_abs_err=err,
                paged_vs_dense=vs_dense, card_cpu_max_abs_err=max(errs))


def train_bounds(cfg, tokens: int) -> dict:
    """Least time of one train step, reckoned from the code: the matmuls'
    6 x parameters x tokens operations over the dense bf16 peak, then
    AdamW's 28 bytes a parameter (p, g, mu, nu read; p, mu, nu written, all
    float32) over HBM bandwidth. The two run one after the other."""
    n = cfg.param_count()
    mm = 6 * n * tokens / PEAK_BF16_S * 1e3
    adam = 28 * n / PEAK_BYTES_S * 1e3
    return dict(matmul_ms=mm, adamw_ms=adam, bound_ms=mm + adam, ops=6 * n * tokens, adamw_bytes=28 * n)


# Kernel name parts of each kind, for a train step's device time by kind.
KERNEL_KINDS = (("matmul", ("gemm", "cutlass", "nvjet", "xmma", "cublas")), ("multi_tensor", ("multi_tensor",)),
                ("reduction", ("reduce",)), ("copy", ("memcpy", "memset")))


def device_time_by_kind(fn) -> tuple[float, int, dict]:
    """One call of ``fn()`` (after one unprofiled) under the profiler: the
    device's busy ms, its operation count, and ms and count by kernel kind
    (``KERNEL_KINDS``; the rest "elementwise and other") with the three
    longest kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ran = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kinds: dict = {}
    for e in ran:
        name = e.name.lower()
        kind = next((k for k, parts in KERNEL_KINDS if any(p in name for p in parts)), "elementwise and other")
        d = kinds.setdefault(kind, dict(ms=0.0, n=0))
        d["ms"] += e.device_time_total / 1e3
        d["n"] += 1
    top = sorted(ran, key=lambda e: -e.device_time_total)[:3]
    kinds["longest"] = [(e.name[:60], e.device_time_total / 1e3) for e in top]
    return sum(e.device_time_total for e in ran) / 1e3, len(ran), kinds


def lm_train_full(dev, smi: str) -> dict:
    """11b: ``train`` of Llama-3.2-1B at full width (float32 masters, bf16
    compute) on the Markov stream; then steps of the same model under CUDA
    events and the profiler, and one with ``remat=True``."""
    import torch

    from repro_torch.data import lm_data
    from repro_torch.launch.train import train
    from repro_torch.models import Transformer
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import TrainConfig, loss_fn, make_train_step

    t = LM11_TRAIN
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, hist = train(arch=LM_ARCH, preset=None, steps=t["steps"], batch=t["batch"], seq=t["seq"],
                        lr=t["lr"], log_every=1, seed=LM_SEED, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    loop_peak = torch.cuda.max_memory_allocated()
    cfg = model.cfg
    losses = [m["loss"] for m in hist]
    require(len(losses) == t["steps"] and all(math.isfinite(x) for x in losses), f"[11b] losses {losses}")
    require(losses[-1] < losses[0], f"[11b] the loss did not fall: {losses[0]} -> {losses[-1]}")
    fresh = Transformer(cfg, LM_SEED, device=dev)
    moved = sum(not torch.equal(a, b) for a, b in zip(model.parameters(), fresh.parameters()))
    require(moved == len(list(fresh.parameters())), f"[11b] {moved} parameter tensors moved")
    del fresh
    # Further steps on the trained model, timed.
    tcfg = TrainConfig(opt=OptConfig(lr=t["lr"], warmup_steps=2, total_steps=t["steps"]), remat=False)
    step = make_train_step(cfg, tcfg)
    opt = init_opt_state(model)
    data = list(lm_data.batches(cfg.vocab, t["batch"], t["seq"], LM11_TIMED + 1, seed=LM_SEED + 1, device=dev))
    step(model, opt, data[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for b in data[1:]:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        step(model, opt, b)
        ev[1].record()
        times.append(ev)
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(z) for a, z in times]
    peak = torch.cuda.max_memory_allocated()
    busy, n_ops, kinds = device_time_by_kind(lambda: step(model, opt, data[1]))
    # remat=True, after a warm-up step: the same batch's loss without remat
    # first (no update).
    rstep = make_train_step(cfg, TrainConfig(opt=tcfg.opt, remat=True))
    rstep(model, opt, data[3])  # warm-up
    with torch.no_grad():
        loss0 = float(loss_fn(model, data[2], cfg, TrainConfig(remat=False))[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    _, _, rm = rstep(model, opt, data[2])
    ev[1].record()
    torch.cuda.synchronize()
    remat_ms, remat_peak = ev[0].elapsed_time(ev[1]), torch.cuda.max_memory_allocated()
    remat_err = abs(float(rm["loss"]) - loss0)
    require(remat_err <= 1e-5 * abs(loss0), f"[11b] remat loss {float(rm['loss'])} against {loss0}")
    bd = train_bounds(cfg, t["batch"] * t["seq"])
    med = statistics.median(step_ms)
    tok = t["batch"] * t["seq"]
    log(f"[11b] train({LM_ARCH}, preset=None): {cfg.param_count():,} parameters, float32 masters, "
        f"{cfg.dtype} compute, batch {t['batch']} x seq {t['seq']}, lr {t['lr']}, {t['steps']} steps in "
        f"{wall:.2f} s ({t['steps'] * tok / wall:.0f} tokens/s, init and the first step included); loss "
        + " ".join(f"{x:.4f}" for x in losses) + f"; peak memory {loop_peak / 2**30:.2f} GiB [{smi}]")
    log(f"[11b] train step (CUDA events, {LM11_TIMED} steps): median {med:.2f} ms (min {min(step_ms):.2f}, "
        f"max {max(step_ms):.2f}), {tok / med * 1e3:.0f} tokens/s, peak memory {peak / 2**30:.2f} GiB; under "
        f"the profiler the device is busy {busy:.2f} ms of a step in {n_ops:.0f} operations "
        f"({busy / med:.1%}); bound {bd['bound_ms']:.2f} ms = matmuls {bd['ops']:.3e} operations / "
        f"{PEAK_BF16_S:.3g} ({bd['matmul_ms']:.2f} ms) + AdamW {bd['adamw_bytes'] / 1e9:.1f} GB / "
        f"{PEAK_BYTES_S:.3g} B/s ({bd['adamw_ms']:.2f} ms); remat=True: {remat_ms:.2f} ms, peak "
        f"{remat_peak / 2**30:.2f} GiB, loss {float(rm['loss']):.6f} against {loss0:.6f} without [{smi}]")
    log("[11b] a step's device time by kind: " + ", ".join(
        f"{k} {v['ms']:.2f} ms in {v['n']}" for k, v in kinds.items() if k != "longest")
        + "; longest: " + ", ".join(f"{n} {ms:.2f} ms" for n, ms in kinds["longest"]))
    out = dict(losses=losses, loop_wall_s=wall, loop_tokens_per_s=t["steps"] * tok / wall,
               loop_peak_gib=loop_peak / 2**30, step_ms=med, step_ms_all=step_ms, tokens_per_s=tok / med * 1e3,
               peak_gib=peak / 2**30, busy_ms=busy, device_ops=n_ops, busy_by_kind=kinds, remat_ms=remat_ms,
               remat_peak_gib=remat_peak / 2**30, remat_loss_err=remat_err, **bd)
    del model, opt, data
    torch.cuda.empty_cache()
    return out


def lm_train_card_against_cpu(dev, smi: str) -> dict:
    """11c: one train step of Llama-3.2-1B at full width, depth 2, float32
    (TF32 off), from the same weights and batch on the card and the CPU."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import lm_data
    from repro_torch.models import Transformer, cast_weights
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import TrainConfig, make_train_step

    c, t = LM11_CARD_CPU, LM11_TRAIN
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=c["n_layers"], dtype="float32")
    gpu = Transformer(cfg, LM_SEED, device=dev)
    cpu = cast_weights(gpu, torch.float32, "cpu")
    batch = next(lm_data.batches(cfg.vocab, t["batch"], t["seq"], 1, seed=LM_SEED, device="cpu"))
    step = make_train_step(cfg, TrainConfig(opt=OptConfig(lr=t["lr"]), remat=False))
    log(f"[11c] the CPU side: {torch.backends.cpu.get_cpu_capability()}, {torch.get_num_threads()} threads")
    t0 = time.perf_counter()
    _, oc, mc = step(cpu, init_opt_state(cpu), batch)
    cpu_s = time.perf_counter() - t0
    _, og, mg = step(gpu, init_opt_state(gpu), {k: v.to(dev) for k, v in batch.items()})
    errs = {k: close(mg[k], mc[k], f"[11c] {k}", c["rtol"], c["atol"]) for k in ("loss", "grad_norm", "xent")}
    perr = max(close(a.detach(), b.detach(), f"[11c] parameter {n}", c["rtol"], c["atol"])
               for (n, a), b in zip(gpu.named_parameters(), cpu.parameters()))
    log(f"[11c] card against CPU, one train step of {LM_ARCH} at depth {c['n_layers']}, float32, "
        f"allow_tf32={torch.backends.cuda.matmul.allow_tf32}, batch {t['batch']} x {t['seq']}: loss "
        f"{float(mc['loss']):.6f} (difference {errs['loss']:.2e}), gradient norm {float(mc['grad_norm']):.4f} "
        f"({errs['grad_norm']:.2e}), every updated parameter within {perr:.2e} (rtol = atol = {c['atol']}); "
        f"the CPU step took {cpu_s:.1f} s")
    return dict(loss_err=errs["loss"], grad_norm_err=errs["grad_norm"], param_max_abs_err=perr, cpu_step_s=cpu_s)


def elastic_lm_run(cfg, dev, ckpt_dir, batches, *, lose_at=None, nan_at=None, ckpt_every: int = 5):
    """The port's real train step under ``ElasticRunner``: the state is
    ``{"params", "opt"}`` keyed by parameter name, a restored state copied
    into the model before its step. ``lose_at`` raises a node loss once;
    ``nan_at`` poisons the weights once before that step, so its loss is
    NaN and the runner restores the last good checkpoint."""
    import torch

    from repro_torch.distributed.fault_tolerance import ElasticRunner, FailureEvent
    from repro_torch.models import init_params
    from repro_torch.models.transformer import load_named_
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import TrainConfig, make_train_step

    model = init_params(LM_SEED, cfg, device=dev)
    own = dict(model.named_parameters())
    step = make_train_step(cfg, TrainConfig(
        opt=OptConfig(lr=3e-3, warmup_steps=1, total_steps=len(batches)), remat=False))
    armed = {"lose": lose_at, "nan": nan_at}

    def make_state(mesh):
        fresh = init_params(LM_SEED, cfg, device=dev)
        return {"params": dict(fresh.named_parameters()), "opt": init_opt_state(fresh)}

    def step_fn(state, batch):
        load_named_(own, state["params"])
        if armed["nan"] is not None and batch is batches[armed["nan"]]:
            armed["nan"] = None
            with torch.no_grad():
                own["final_norm"].fill_(float("nan"))
        _, opt, metrics = step(model, state["opt"], batch)
        return {"params": own, "opt": opt}, metrics

    def hook(i):
        if i == armed["lose"]:
            armed["lose"] = None
            return FailureEvent(i, "node_lost", "simulated")
        return None

    runner = ElasticRunner(lambda n: f"mesh<{n}>", make_state, step_fn,
                           CheckpointManager(ckpt_dir, keep_n=3), ckpt_every=ckpt_every, failure_hook=hook)
    state, hist = runner.run(batches)
    return runner, state, hist


def lm_elastic(dev, smi: str) -> dict:
    """11d: ``ElasticRunner`` over the tiny preset's real train step on the
    card: a node lost and a NaN injected, against an uninterrupted run;
    a checkpoint written on the card restored on the CPU."""
    import tempfile

    import torch

    from repro_torch.data import lm_data
    from repro_torch.launch.train import reduced_config
    from repro_torch.train.checkpoint import CheckpointManager

    e = LM11_ELASTIC
    cfg = reduced_config(LM_ARCH, "tiny")
    data = list(lm_data.batches(cfg.vocab, 8, 64, e["steps"], seed=1, device=dev))
    with tempfile.TemporaryDirectory() as tmp:
        clean, clean_state, _ = elastic_lm_run(cfg, dev, Path(tmp) / "clean", data, ckpt_every=e["ckpt_every"])
        runner, state, hist = elastic_lm_run(cfg, dev, Path(tmp) / "faulted", data, lose_at=e["lose_at"],
                                             nan_at=e["nan_at"], ckpt_every=e["ckpt_every"])
        events = [(ev.step, ev.kind) for ev in runner.events]
        require(clean.events == [] and events == [(e["lose_at"], "node_lost"), (e["nan_at"], "nan_loss")],
                f"[11d] events {events}")
        steps = [m["step"] for m in hist]
        last_ckpt = e["lose_at"] - e["lose_at"] % e["ckpt_every"]
        require(steps[:e["lose_at"] + 1] == list(range(e["lose_at"])) + [last_ckpt + 1],
                f"[11d] the node loss did not resume after the step-{last_ckpt} checkpoint: {steps}")
        require(steps[-1] == e["steps"] - 1 and int(state["opt"]["step"]) == e["steps"], f"[11d] steps {steps}")
        diff = max(float((state["params"][k] - v).detach().abs().max()) for k, v in clean_state["params"].items())
        exact = all(torch.equal(state["params"][k], v) for k, v in clean_state["params"].items())
        require(diff <= LM11_ELASTIC_ATOL, f"[11d] final parameters differ from the uninterrupted run by {diff}")
        mgr = CheckpointManager(Path(tmp) / "faulted")
        mgr.save(e["steps"], state)
        _, back = mgr.restore(state, device="cpu")
        for k, v in state["params"].items():
            require(torch.equal(back["params"][k], v.detach().cpu()), f"[11d] {k} restored on the CPU differs")
        require(int(back["opt"]["step"]) == e["steps"], "[11d] the step restored on the CPU differs")
    log(f"[11d] ElasticRunner over the tiny preset's train step on the card, {e['steps']} steps, a checkpoint "
        f"every {e['ckpt_every']}: events {events}, {runner.restarts} restart, steps run {steps}; final "
        f"parameters against the uninterrupted run: max abs difference {diff:.2e} "
        f"({'bit for bit' if exact else 'not bit for bit'}); the checkpoint of the card's state restored on "
        f"the CPU leaf for leaf")
    return dict(events=events, final_max_abs_diff=diff, bit_for_bit=exact)


def lm_train_example(smi: str) -> dict:
    """11e: ``examples/torch_train_lm.py``'s default run (small100m, 300
    steps, batch 8 x seq 256, lr 1e-3, a checkpoint every 20 steps) in its
    own process on the card."""
    import re
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, str(ROOT / "examples" / "torch_train_lm.py"), "--ckpt-dir", tmp],
                             capture_output=True, text=True, cwd=ROOT, timeout=600,
                             env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        wall = time.perf_counter() - t0
    require(out.returncode == 0, f"[11e] the example failed: {out.stderr[-2000:]}")
    traj = [(int(a), float(b)) for a, b in re.findall(r"^step\s+(\d+) loss ([\d.]+)", out.stdout, re.M)]
    drop = float(re.search(r"\(drop ([-\d.]+)\)", out.stdout)[1])
    require(drop > 0.05 and "on cuda" in out.stdout, f"[11e] loss drop {drop}")
    log(f"[11e] examples/torch_train_lm.py (small100m, 300 steps, batch 8 x 256): wall {wall:.1f} s, loss "
        + " ".join(f"{s}:{x:.3f}" for s, x in traj) + f", drop {drop:.3f} [{smi}]")
    return dict(wall_s=wall, trajectory=traj, drop=drop)


def phase11(dev, smi: str) -> dict:
    """Phase 11, LM training at full width and the paged decode, on the
    card with no error caught."""
    import torch

    t11 = time.perf_counter()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    out = dict(paged=lm_paged_decode(dev, smi))
    out["train"] = lm_train_full(dev, smi)
    out["card_cpu"] = lm_train_card_against_cpu(dev, smi)
    out["elastic"] = lm_elastic(dev, smi)
    out["example"] = lm_train_example(smi)
    out["train"].pop("step_ms_all")
    log(f"[11] {json.dumps(out)}")
    log(f"[11] phase wall time {time.perf_counter() - t11:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 12: the launch tooling (op counter, roofline, dry run) and the
# cache-dtype decode products.
# ---------------------------------------------------------------------------

def lm12_steps(dev) -> dict:
    """Phase 12's three steps of Llama-3.2-1B at full width on ``dev`` (the
    card, or the meta device with weights and batches of the same shapes
    and dtypes): each a function of no argument. decode: one step of the
    bf16 served copy at position 64 after a prefill of phase 9's first
    batch (not counted); prefill: that batch; train: phase 11's step, float32
    masters, batch 8 x 128, remat=False."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import lm_data
    from repro_torch.models import Transformer, cast_weights, decode_step, prefill
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import TrainConfig, make_train_step

    cfg = get_config(LM_ARCH)
    t = LM11_TRAIN
    meta = dev.type == "meta"
    if meta:
        served = Transformer(cfg, None, device=dev, weight_dtype=torch.bfloat16)
    else:
        served = cast_weights(Transformer(cfg, LM_SEED, device=dev))
    toks = torch.from_numpy(padded_prompts(cfg.vocab)).to(dev)
    s = toks.shape[1]
    logits, cache = prefill(served, {"tokens": toks}, cache_len=LM_ENGINE["max_seq"])
    nxt = {"tokens": logits.argmax(-1)[:, None]}
    masters = Transformer(cfg, None if meta else LM_SEED, device=dev)
    opt = init_opt_state(masters)
    if meta:
        batch = {k: torch.empty(t["batch"], t["seq"], dtype=torch.int32, device=dev) for k in ("tokens", "labels")}
    else:
        batch = next(lm_data.batches(cfg.vocab, t["batch"], t["seq"], 1, seed=LM_SEED + 1, device=dev))
    step = make_train_step(cfg, TrainConfig(opt=OptConfig(lr=t["lr"], warmup_steps=2, total_steps=t["steps"]),
                                            remat=False))
    return dict(
        decode=lambda: decode_step(served, nxt, cache, s),
        prefill=lambda: prefill(served, {"tokens": toks}, cache_len=LM_ENGINE["max_seq"]),
        train=lambda: step(masters, opt, batch),
    )


def lm12_counts(dev) -> dict:
    """The op counter's records of phase 12's three steps on ``dev``."""
    from repro_torch.launch import op_analysis as O

    steps = lm12_steps(dev)
    return {name: O.count(fn) for name, fn in steps.items()}


def lm12_roofline(card: dict, p9: dict | None, p11: dict | None, smi: str) -> dict:
    """12a: each step's counts, their roofline on one card, model_flops and
    the useful ratio, beside the phase's hand bound and measured median."""
    from repro_torch.configs import get_config
    from repro_torch.launch import op_analysis as O
    from repro_torch.launch import roofline as R

    cfg = get_config(LM_ARCH)
    b, s = padded_prompts(cfg.vocab).shape
    hand = lm_bounds(cfg, b * s, b, LM_ENGINE["max_seq"])
    tr = LM11_TRAIN
    hand["train"] = train_bounds(cfg, tr["batch"] * tr["seq"])
    tokens = dict(decode=b, prefill=b * s, train=tr["batch"] * tr["seq"])
    medians = dict(decode=p9 and p9["decode_median_ms"], prefill=p9 and p9["prefill_ms"][0],
                   train=p11 and p11["train"]["step_ms"])
    device_ops = dict(decode=p9 and p9["decode_device_ops"], prefill=p9 and p9["prefill_device_ops"],
                      train=p11 and p11["train"]["device_ops"])
    out = {}
    for name, counter in card.items():
        c = O.analyze(counter)
        terms = R.extract_terms(c, 1)
        mf = R.model_flops(cfg.param_count(), tokens[name], kind=name)
        bound_ms = terms.t_bound * 1e3
        med = medians[name]
        out[name] = dict(flops=c["flops"], bytes=c["bytes"], n_ops=c["n_ops"], n_views=c["n_views"],
                         t_compute_ms=terms.t_compute * 1e3, t_memory_ms=terms.t_memory * 1e3, bound_ms=bound_ms,
                         bottleneck=terms.bottleneck, model_flops=mf, useful_flops_ratio=mf / c["flops"],
                         hand_bound_ms=hand[name]["bound_ms"], median_ms=med,
                         share=bound_ms / med if med else None, profiler_device_ops=device_ops[name])
        r = out[name]
        top = O.top_bytes(counter, 3)
        log(f"[12a] {name}: {c['flops']:.4e} FLOPs, {c['bytes']:.4e} bytes, {c['n_ops']:.0f} aten operators "
            f"({c['n_views']:.0f} of them views; the profiler saw {device_ops[name] or 'not measured'} device "
            f"operations); roofline on one card: compute {r['t_compute_ms']:.3f} ms, memory "
            f"{r['t_memory_ms']:.3f} ms -> bound {bound_ms:.3f} ms ({terms.bottleneck}); model_flops "
            f"{mf:.4e}, useful ratio {r['useful_flops_ratio']:.3f}; the phase's hand bound "
            f"{r['hand_bound_ms']:.3f} ms; measured median "
            + (f"{med:.3f} ms, bound / median {r['share']:.4f}" if med else "not measured")
            + f"; most bytes: " + ", ".join(f"{d['op']} {d['shapes'][:48]} {d['bytes']:.3e}" for d in top)
            + f" [{smi}]")
    return out


def lm12_meta_equals_card(card: dict) -> dict:
    """12b: the same steps counted on the meta device: FLOPs, bytes and
    operators equal to the card's, record for record."""
    import torch

    from repro_torch.launch import op_analysis as O

    t0 = time.perf_counter()
    meta = lm12_counts(torch.device("meta"))
    wall = time.perf_counter() - t0
    for name, counter in card.items():
        a, m = O.analyze(counter), O.analyze(meta[name])
        if a != m:
            keys = sorted(set(counter.records) | set(meta[name].records))
            for k in keys:
                rc, rm = counter.records.get(k), meta[name].records.get(k)
                vc = (rc.calls, rc.flops, rc.bytes) if rc else None
                vm = (rm.calls, rm.flops, rm.bytes) if rm else None
                if vc != vm:
                    log(f"[12b] {name} differs at {k}: card {vc}, meta {vm}")
        require(a == m, f"[12b] {name}: the meta count {m} differs from the card's {a}")
    log(f"[12b] the meta device counts what the card ran: FLOPs, bytes and operators equal for "
        + ", ".join(f"{n} ({O.analyze(c)['n_ops']:.0f} operators)" for n, c in card.items())
        + f"; the three meta counts took {wall:.2f} s")
    return dict(equal=True, meta_wall_s=wall)


def lm12_cache_dtype_dots(dev, smi: str) -> dict:
    """12c: phase 9's first batch decoded with CACHE_DTYPE_DOTS against
    teacher forcing; the decode step timed against the default's, in
    turns; no host synchronization in a step."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Transformer, cast_weights, forward_train
    from repro_torch.models import attention as A

    cfg = get_config(LM_ARCH)
    model = cast_weights(Transformer(cfg, LM_SEED, device=dev))
    toks = padded_prompts(cfg.vocab)
    s = toks.shape[1]
    saved = A.CACHE_DTYPE_DOTS
    runs = []
    try:
        A.CACHE_DTYPE_DOTS = True
        greedy = decode_run(model, toks, paged=False)  # its tokens feed every timed run; also a warm-up
        fed = greedy["tokens"][:, :-1].cpu().numpy()
        for on in LM12_TURNS:
            A.CACHE_DTYPE_DOTS = on
            runs.append((on, decode_run(model, toks, feed=fed, paged=False, timed=True)))
    finally:
        A.CACHE_DTYPE_DOTS = saved
    on_run = next(r for on, r in runs if on)
    syncs = [n for on, r in runs if on for n in r["syncs"]]
    require(syncs == [0] * len(syncs), f"[12c] a CACHE_DTYPE_DOTS decode step synchronized the host: {syncs}")
    require(bool((on_run["tokens"] == greedy["tokens"]).all()), "[12c] the fed run served other tokens")
    tf = forward_train(model, {"tokens": np.concatenate([toks, fed], 1)})[0][:, s - 1:]
    err = float((tf - on_run["logits"]).abs().max())
    require(err <= LM_TEACHER_ATOL, f"[12c] CACHE_DTYPE_DOTS decode against forward_train: {err} > {LM_TEACHER_ATOL}")
    top = torch.topk(on_run["logits"], 2, -1).values
    clear = (top[..., 0] - top[..., 1]) > 2 * LM_TEACHER_ATOL
    require(bool(((tf.argmax(-1) == on_run["tokens"]) | ~clear).all()),
            "[12c] teacher forcing picks another token where the margin exceeds twice the bound")
    default_run = next(r for on, r in runs if not on)  # the same tokens fed
    vs_default = float((default_run["logits"] - on_run["logits"]).abs().max())
    med = {on: statistics.median([x for o, r in runs if o == on for x in r["step_ms"]]) for on in (False, True)}
    turns = [round(statistics.median(r["step_ms"]), 3) for _, r in runs]
    log(f"[12c] {LM_ARCH} full width, bf16, batch {toks.shape}, CACHE_DTYPE_DOTS: teacher forcing max abs logit "
        f"difference {err:.4f} (bound {LM_TEACHER_ATOL}), tokens equal at {int(clear.sum())} of {clear.numel()} "
        f"positions with a clear margin, against the default's logits on the same tokens {vs_default:.4f}; "
        f"decode step median "
        f"{med[True]:.3f} ms with it, {med[False]:.3f} ms without (turn medians {turns}, in the order "
        f"{list(LM12_TURNS)}); {sum(syncs)} host synchronizations in {len(syncs)} steps [{smi}]")
    del model, runs, tf
    torch.cuda.empty_cache()
    return dict(teacher_max_abs_err=err, vs_default=vs_default, step_ms=med[True], default_step_ms=med[False],
                turns=turns)


def lm12_dryrun(smi: str) -> dict:
    """12d: the dry run of Llama-3.2-1B's cells on both production meshes,
    on the meta device in this process."""
    from repro_torch.configs.base import applicable_shapes, get_config
    from repro_torch.launch import dryrun as D

    t0 = time.perf_counter()
    counts: dict = {}
    recs = [D.run_cell(LM_ARCH, shape, mk, ROOT / D.DEFAULT_OUT, counts=counts)
            for shape in applicable_shapes(get_config(LM_ARCH)) for mk in ("single", "multi")]
    wall = time.perf_counter() - t0
    bad = [(r["shape"], r["mesh"], r.get("error")) for r in recs if not r["ok"]]
    require(not bad, f"[12d] dry-run cells failed: {bad}")
    for r in recs:
        rf = r["roofline"]
        log(f"[12d] {r['shape']} x {r['mesh']} ({r['n_devices']} devices): {rf['flops_per_device']:.4e} FLOPs and "
            f"{rf['hbm_bytes_per_device']:.4e} bytes a device, bound {max(rf['t_compute_s'], rf['t_memory_s']) * 1e3:.3f}"
            f" ms ({rf['bottleneck']}), arguments {r['memory']['argument_size_in_bytes'] / 2**30:.3f} GiB a device, "
            f"useful ratio {r['useful_flops_ratio']:.3f}")
    log(f"[12d] dry run of {len(recs)} cells, all ok, in {wall:.2f} s on the host (meta device)")
    return dict(cells=len(recs), wall_s=wall)


def phase12(dev, smi: str, p9: dict | None = None, p11: dict | None = None) -> dict:
    """Phase 12, the launch tooling and the cache-dtype decode products at
    full width, on the card with no error caught."""
    import torch

    t12 = time.perf_counter()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = lm12_counts(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = dict(counts=lm12_roofline(card, p9, p11, smi))
    out["meta"] = lm12_meta_equals_card(card)
    del card
    torch.cuda.empty_cache()
    out["cache_dtype_dots"] = lm12_cache_dtype_dots(dev, smi)
    out["dryrun"] = lm12_dryrun(smi)
    log(f"[12] {json.dumps(out)}")
    log(f"[12] phase wall time {time.perf_counter() - t12:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 13: the multi-device slice on the one card.
# ---------------------------------------------------------------------------

def mesh13_fleet(cfg, recs, plain_sync, plain_lat, dev, smi: str) -> dict:
    """13a: phase 4's fleet on a 4-entry sensor mesh of the card, every
    round's stacked outputs equal to phase 4's unsharded rounds."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh

    n = len(recs)
    mesh = make_mesh((MESH_ENTRIES,), ("sensor",), devices=[dev] * MESH_ENTRIES)
    rounds = fleet_rounds(recs)
    run_fleet(cfg, rounds[:20], n, dev, mesh=mesh)  # warm-up
    ops.reset_launches()
    sync, ms, _, fp = run_fleet(cfg, rounds, n, dev, sync_each=True, mesh=mesh)
    counts = dict(ops.LAUNCHES)
    steps = sum(1 for r in sync if r.clusters is not None)
    require(all(counts[k] == MESH_ENTRIES * steps for k in FLEET_KERNELS),
            f"[13a] {steps} steps on {MESH_ENTRIES} blocks, launches {counts}")
    require(fp.state.atlas.spec == ("sensor",) and all(a.spec == ("sensor",) for a in fp.state.tracks),
            f"[13a] carry specs {fp.state.atlas.spec}")
    require(len(sync) == len(plain_sync), f"[13a] {len(sync)} rounds against {len(plain_sync)}")
    for i, (a, b) in enumerate(zip(sync, plain_sync)):
        require(np.array_equal(a.n_windows, b.n_windows), f"[13a] round {i}: windows differ")
        if b.clusters is None:
            require(a.clusters is None, f"[13a] round {i}: clusters")
            continue
        for group in ("clusters", "tracks", "final_tracks"):
            for f, u, v in zip(getattr(b, group)._fields, getattr(a, group), getattr(b, group)):
                equal(u, v, f"[13a] round {i}: {group}.{f}")
        for k in b.metrics:
            equal(a.metrics[k], b.metrics[k], f"[13a] round {i}: {k}")
    lat = round_stats(ms[:-1])
    log(f"[13a] fleet on a {MESH_ENTRIES}-entry sensor mesh of the one card ({smi}): {n} sensors, "
        f"{len(rounds)} rounds + flush, {steps} steps of {MESH_ENTRIES} blocks; every round's "
        f"clusters, metrics, per-window tracks and final carry equal to phase 4's unsharded fleet; "
        f"carry spec ('sensor',); launches {counts} ({counts['cluster_accum'] / (len(rounds) + 1):.3f} "
        f"a round of each kernel, {MESH_ENTRIES} a step)")
    log(f"    per-round latency (host clock, synchronize per round): p50 {lat['p50']:.3f} ms, p99 "
        f"{lat['p99']:.3f} ms, max {lat['max']:.3f} ms (budget {BUDGET_MS} ms); phase 4's unsharded "
        f"fleet in this run: p50 {plain_lat['p50']:.3f} ms, p99 {plain_lat['p99']:.3f} ms, max "
        f"{plain_lat['max']:.3f} ms")
    return dict(launches=counts, steps=steps, rounds=len(rounds), latency=lat, plain_latency=plain_lat)


def mesh13_constellation(cfg, dev) -> dict:
    """13b: 2 shards of 2 mesh entries each on the one card, a migration,
    every session equal to its dedicated stream on the card."""
    import torch

    from repro_torch.core.pipeline import StreamingPipeline
    from repro_torch.data.evas import iter_chunks
    from repro_torch.kernels import ops
    from repro_torch.serve import AdmissionConfig, ConstellationService
    from repro_torch.serve.chaos import _FakeClock

    c = MESH_CONST
    recs = service_recordings(c["sessions"])
    chunks = [list(iter_chunks(rec, CHUNK_US)) for rec in recs]
    clock = _FakeClock()
    cs = ConstellationService(cfg, n_shards=c["shards"], tiers=c["tiers"], devices=[dev] * c["entries"],
                              admission=AdmissionConfig(max_delay_s=0.02, max_items=250 * 16),
                              clock=clock, sleep=lambda s: None)
    require([len(cs.shard(i).devices) for i in range(c["shards"])] == [2] * c["shards"]
            and all(cs.shard(i).mesh is not None for i in range(c["shards"])),
            f"[13b] shard groups {[cs.shard(i).devices for i in range(c['shards'])]}")
    gids = [cs.attach(rec.name) for rec in recs]
    fed = {g: [] for g in gids}
    parts = {g: [] for g in gids}
    ms = []
    ops.reset_launches()
    for r in range(c["rounds"]):
        t0 = time.perf_counter()
        clock.now += CHUNK_US / 1e6
        got = []
        if r == c["migrate_at"]:
            cs.migrate(gids[0], 1 - cs.shard_of(gids[0]))
        for k, g in enumerate(gids):
            if r < len(chunks[k]):
                fed[g].append(chunks[k][r])
                got += cs.feed(g, *chunks[k][r])
        got += cs.pump(force=True)
        for f in got:
            parts[f.gid].append(f.result)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    for g in gids:
        parts[g].append(cs.detach(g))
    cs.drain()
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    path_launches("float", counts, "[13b] constellation on shard meshes")
    require(cs.migrations == 1, f"[13b] migrations {cs.migrations}")
    ratio = cs.exchange.stats["compression_ratio"]
    require(ratio > 3.0, f"[13b] compression ratio {ratio}")
    windows = 0
    for g in gids:
        sp = StreamingPipeline(cfg, wire="ragged", device=dev)
        want = [sp.feed(*ch) for ch in fed[g]] + [sp.flush()]
        compare_parts(concat_parts(parts[g]), concat_parts(want),
                      f"[13b] session {g} vs its dedicated stream")
        windows += sum(p.num_windows for p in parts[g])
    lat = round_stats(ms)
    log(f"[13b] constellation of {c['shards']} shards x 2 mesh entries on the one card (tiers "
        f"{c['tiers']}): {c['sessions']} sessions, {c['rounds']} rounds, session {gids[0]} migrated at "
        f"round {c['migrate_at']}; {windows} windows, every session, detach tail included, equal to "
        f"its dedicated StreamingPipeline on the card; compression_ratio {ratio:.3f}; launches "
        f"{counts}; per-round p50 {lat['p50']:.3f} ms, p99 {lat['p99']:.3f} ms, max {lat['max']:.3f} ms")
    return dict(launches=counts, windows=windows, compression_ratio=ratio, latency=lat)


def mesh13_collectives(dev) -> dict:
    """13c: the int8 collectives at world size 1 over NCCL on the card
    (see :func:`mesh13_gloo` for the group of four)."""
    import socket

    import torch
    import torch.distributed as dist

    from repro_torch.distributed import compression as C

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(torch.cuda.current_device() if dev.index is None else dev.index)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        gen = torch.Generator(device=dev).manual_seed(13)
        x = torch.randn(1 << 20, generator=gen, device=dev)
        q, scale = C.quantize_int8(x)
        out = C.compressed_psum_int8(x)
        equal(out, q.to(torch.float32) * scale, "[13c] compressed_psum_int8 of one rank")
        tree = C.dp_grad_sync_int8({"w": x[:4096].reshape(64, 64), "b": x[:3]})
        equal(tree["w"].reshape(-1), C.compressed_psum_int8(x[:4096]), "[13c] dp_grad_sync_int8")
        require(C.ring_allreduce_int8(x) is x, "[13c] ring_allreduce_int8 of one rank")
        try:
            C.compressed_psum_int8(x.cpu())
            refused = False
        except ValueError:
            refused = True
        require(refused, "[13c] a CPU tensor on a NCCL group was not refused")
        psum_ms = cuda_ms(lambda: C.compressed_psum_int8(x), iters=20)
    finally:
        dist.destroy_process_group()
    log(f"[13c] collectives at world size 1 over NCCL on the card: compressed_psum_int8 of 2^20 "
        f"float32 equal to the rank's own dequantized payload, {psum_ms:.4f} ms a call (CUDA events); "
        f"dp_grad_sync_int8 leaf for leaf; ring_allreduce_int8 returns its input; a CPU tensor "
        f"refused. The 4-rank gloo group runs in the tests and in tools/torch_lm_phase.py 13")
    return dict(psum_ms=psum_ms)


def mesh13_gloo() -> dict:
    """The int8 collectives in a 4-rank gloo group on this machine's CPU
    (one card forms no NCCL group of more than one rank), held by
    ``tools/torch_collective_ranks.py``'s check. Run by
    ``tools/torch_lm_phase.py 13``, not by the script: it measures nothing
    on the card, and the tests run the same group against the reference."""
    import shutil

    out_dir = ROOT / "build" / "collective_ranks"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT / "src"), os.environ.get("PYTHONPATH")])))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "tools" / "torch_collective_ranks.py"), str(out_dir)],
                          env=env, capture_output=True, text=True, timeout=120)
    wall = time.perf_counter() - t0
    require(proc.returncode == 0, f"[13c] the 4-rank gloo group failed: {proc.stderr[-3000:]}")
    sys.path.insert(0, str(ROOT / "tools"))
    import torch_collective_ranks as R

    errs = R.check(out_dir)
    log(f"[13c] a 4-rank gloo group on this machine's CPU (not the card), {wall:.1f} s with its "
        f"start-up: every rank's output equal to every other's, largest error against the float32 "
        f"mean {json.dumps(errs)}, each ring hop one chunk of int16")
    return dict(gloo_wall_s=wall, errors=errs)


def mesh13_node_array() -> dict:
    """13d: examples/torch_multi_node_array.py --nodes 4 on the card."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT / "src"),
                                                                    os.environ.get("PYTHONPATH")])))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / "torch_multi_node_array.py"),
                           "--nodes", "4"], env=env, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    require(proc.returncode == 0 and "equal to one call over the stacked array" in proc.stdout,
            f"[13d] node array: rc {proc.returncode}, {proc.stdout[-2000:]} {proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    log(f"[13d] examples/torch_multi_node_array.py --nodes 4 ({wall:.1f} s): " + " | ".join(lines[-3:]))
    return dict(wall_s=wall, lines=lines[-3:])


def phase13(cfg, fleet_recs, fleet_sync, fleet_lat, dev, smi: str) -> dict:
    """Phase 13, the multi-device slice on the card, with no error caught."""
    t13 = time.perf_counter()
    enter("13a")
    out = dict(mesh=mesh13_fleet(cfg, fleet_recs, fleet_sync, fleet_lat, dev, smi))
    enter("13b")
    out["constellation"] = mesh13_constellation(cfg, dev)
    enter("13c")
    out["collectives"] = mesh13_collectives(dev)
    enter("13d")
    out["node_array"] = mesh13_node_array()
    log(f"[13] {json.dumps(out)}")
    log(f"[13] phase wall time {time.perf_counter() - t13:.1f} s")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    # Fails outside a checkout of the repo, before any result is printed.
    from repro_torch.core.events import EventBatch, pad_windows
    from repro_torch.core.pipeline import PipelineConfig, config as C
    from repro_torch.core.pipeline import evaluate_detection, run_recording_scan
    from repro_torch.core.pipeline.window_core import WINDOW_BLOCK, _cluster, _condition
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
    enter(1)
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
    enter(2)
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
    enter(3)
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
    enter(4)
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
    kernel_run = gpu  # the kernel route's tracked scan at scale, for phase 8
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
    fleet_counts, fleet_sync, fleet_lat = check_full_fleet(cfg, fleet_recs, dev)

    # Phase 5: the kernels ran on their paths.
    enter(5)
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
    enter(6)
    t6 = time.perf_counter()
    service = {name: check_service(name, c, dev) for name, c in (("float", cfg), ("fixed", fixed))}
    check_migration(cfg, dev)
    check_table1(dev, scale)
    log(f"[6] phase wall time {time.perf_counter() - t6:.1f} s")

    # Phase 7: fault injection and scale-out serving, each run's counters
    # set to 0 just before it.
    enter(7)
    t7 = time.perf_counter()
    chaos = {name: check_chaos(name, c, dev) for name, c in (("float", cfg), ("fixed", fixed))}
    constellation = check_constellation(cfg, dev)
    shard_chaos = check_shard_chaos(cfg, dev)
    log(f"[7] phase wall time {time.perf_counter() - t7:.1f} s")

    # Phase 8: the frame oracle and the atlas event core against the other
    # float routes and the CPU, each run's counters set to 0 just before it.
    p8 = phase8(scale, kernel_run, fleet_recs, dev)

    # Phase 9: the LM serving path at Llama-3.2-1B's full width.
    enter(9)
    p9 = phase9(dev, smi)

    # Phase 10: the MLA, MoE, RG-LRU and xLSTM families at full width.
    enter(10)
    phase10(dev, smi)

    # Phase 11: LM training at full width and the paged decode.
    enter(11)
    p11 = phase11(dev, smi)

    # Phase 12: the launch tooling (op counter, roofline, dry run) and the
    # cache-dtype decode products.
    enter(12)
    phase12(dev, smi, p9, p11)

    # Phase 13: the multi-device slice on the one card (a 4-entry sensor
    # mesh, 2 shards of 2 entries) and the collectives; each run's
    # counters set to 0 just before it.
    p13 = phase13(cfg, fleet_recs, fleet_sync, fleet_lat, dev, smi)

    enter("5 (the kernels line)")
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
        if name in FLEET_KERNELS:
            row["mesh_launches"] = p13["mesh"]["launches"][name]
            row["mesh_launches_on"] = (
                f"FleetPipeline on a {MESH_ENTRIES}-entry sensor mesh of the one card, "
                f"{FLEET_SENSORS} sensors, {p13['mesh']['rounds']} rounds + flush "
                f"({p13['mesh']['steps']} steps, {MESH_ENTRIES} blocks a step)")
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
                **{key: lg[key] for key in ("valid_slots", "candidate_pixels", "dense_bound_ms") if key in lg},
                launches_on=f"run_recording_scan of the scale recording in {STRIDE_US // 1000} ms stride "
                            f"windows at capacity {STRIDE_CAPACITY} (float, untracked)",
            )
        if name == "cluster_accum":  # phase 8: one pass of the scale recording per route
            row["routes_launches"] = {k: r8["launches"]["cluster_accum"]
                                      for k, r8 in p8["routes"]["runs"].items() if r8["launches"]}
        if name == "event_unpack":  # phase 8: the event route's ragged streams
            row["atlas_stream_launches"] = {k: v["event_unpack"] for k, v in p8["atlas"].items()}
        if name == "window_entropy":  # phase 2's probe; phase 8: the frame oracle's real frames
            row.update(floor_ms=r["floor_ms"], path_taken=r["path"],
                       probe=dict(r["probe"], timed_on=str(r["probe"]["shape"])))
            row["real_frames"] = dict(p8["k6"], timed_on=f"{p8['k6']['launches']} frames of the "
                                      f"scale recording, one launch a frame")
            row["max_abs_err"] = max(row["max_abs_err"], p8["k6"]["max_abs_err"])
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

def run() -> int:
    """:func:`main`; when a phase raises, its number and the traceback go
    to standard output (the end of which a chip run's record keeps) and the
    exit code is 1."""
    try:
        return main()
    except Exception:
        print(f"chip_smoke: phase {PHASE} failed:\n{traceback.format_exc()}", flush=True)
        return 1


if __name__ == "__main__":
    sys.exit(run())
