"""The least time the window stages' work needs on one H100, frozen here.

Bytes and operations are counted from the inputs the harness generated,
window by window, with the counts of ``chip_smoke.py``'s
``cluster_accum_topk_cost`` and ``patch_metrics_cost`` (a flag a padding
slot and 9 bytes a valid event) and of its ``event_unpack`` bound, over
the real windows only: padding a driver adds is work the stage need not
do. A stage's least time is the larger of its bytes over the HBM
bandwidth and its operations over the published peak (NVIDIA's data
sheet, H100 SXM at 700 W: 3.35 TB/s; 67 TFLOP/s float32 outside the
tensor cores; a quarter of that for 32-bit integers, 64 INT32 lanes an
SM against 128 FP32 ones).
"""
from __future__ import annotations

import numpy as np

PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_I32_S = PEAK_F32_S / 4
PATCH = 48


def cluster_stage(fig: dict, e: int, k: int, n_cells: int) -> tuple[float, float]:
    """``cluster_accum_topk`` on these windows: x, y and valid of every
    event slot and t of each kept event read, seven ``(K,)`` fields (25
    bytes a slot) written; 12 operations an event slot, 2 a cell, a sort
    of the cells at ``min_events`` or more, 10 a slot."""
    cells = fig["cells"].astype(np.float64)
    sort_ops = 2 * cells * np.ceil(np.log2(np.maximum(cells, 2)))
    w = len(cells)
    return (float(w * e * 9 + 4 * fig["kept"].sum() + w * k * 25),
            float(w * e * 12 + w * n_cells * 2 + sort_ops.sum() + w * k * 10))


def metrics_stage(fig: dict, e: int, k: int) -> tuple[float, float]:
    """``patch_metrics`` on these windows: of each window holding a valid
    slot, the flag of every event slot and 8 bytes of each kept event;
    25 bytes of every cluster slot, 12 more of each valid one. Operations:
    12 a kept event of such a window, 416 a valid slot, 8 an event inside
    its patch, 25 a candidate pixel (an event within one pixel)."""
    busy = fig["slots"] > 0
    kept = fig["kept"].astype(np.float64)
    w = len(busy)
    nbytes = busy.sum() * e + 8 * kept[busy].sum() + w * k * 25 + 12 * fig["slots"].sum()
    ops = (12 * kept[busy].sum() + fig["slots"].sum() * (2 * PATCH + 320)
           + 8 * fig["in_patch"].sum() + 25 * fig["candidates"].sum())
    return float(nbytes), float(ops)


def wire_stage(fig: dict, cap: int, sensors: int) -> tuple[float, float]:
    """``event_unpack`` of these windows off the ragged wire: each event's
    word, delta and polarity bit (6.125 bytes), an offset a window and a
    sensor, 17 bytes out a slot; 10 integer operations a slot."""
    w = len(fig["events"])
    return (float(6.125 * fig["events"].sum() + 4 * (w + sensors) + 17 * w * cap),
            float(10 * w * cap))


def seconds(nbytes: float, ops: float, ops_peak: float = PEAK_F32_S) -> float:
    """The least time of one stage: bytes or operations, whichever binds."""
    return max(nbytes / PEAK_BYTES_S, ops / ops_peak)


def least_seconds(fig: dict, e: int, k: int, n_cells: int, wire: int | None = None) -> float:
    """The least time of the clustering and metrics stages on these
    windows, and of the wire decode when ``wire`` (the sensors of a
    round) is given."""
    t = seconds(*cluster_stage(fig, e, k, n_cells)) + seconds(*metrics_stage(fig, e, k))
    if wire is not None:
        t += seconds(*wire_stage(fig, e, wire), ops_peak=PEAK_I32_S)
    return t
