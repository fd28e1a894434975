"""Adversarial inputs for the kernels: windows, cluster slots, ingest
wires and frames that the main path rarely produces but every kernel
must get right."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.events import (
    SPILL_SENTINEL,
    BatcherConfig,
    EventBatch,
    dual_threshold_bounds,
    pack_bounds_into,
    pack_polarity,
    pack_wire,
    spill_pad,
    wire_pad,
)
from repro_torch.core.grid_clustering import Clusters, GridConfig, clusters_from_histogram
from repro_torch.kernels import ref

# Slots forced onto the sensor's corners: (centroid_x, centroid_y).
EDGE_SLOTS = ((0.0, 479.0), (639.4, 0.5), (2.5, 2.5), (636.5, 477.5))


def adversarial_windows(e: int = 256):
    """(5, e) numpy event planes x, y, t, valid: random; out-of-sensor and
    negative coordinates; empty; every event on one pixel; events at the
    sensor's edges. Window 0 holds a clump, so it has a cluster above one
    event per cell."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 640, (5, e))
    y = rng.integers(0, 480, (5, e))
    t = rng.integers(0, 20_000, (5, e))
    v = rng.random((5, e)) < 0.9
    x[1], y[1], v[1] = rng.integers(-100, 740, e), rng.integers(-100, 580, e), True
    v[2] = False
    x[3], y[3], v[3] = 300, 200, True
    x[4] = rng.choice(np.r_[0:6, 634:640], e)
    y[4] = rng.choice(np.r_[0:6, 474:480], e)
    v[4] = True
    x[0, :60], y[0, :60] = rng.integers(100, 112, 60), rng.integers(50, 58, 60)
    return x, y, t, v


def adversarial_batch(device: str | torch.device = "cpu", e: int = 256) -> EventBatch:
    """:func:`adversarial_windows` as an int32 :class:`EventBatch` on ``device``."""
    x, y, t, v = adversarial_windows(e)
    as_int = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
    return EventBatch(as_int(x), as_int(y), as_int(t), as_int(np.zeros_like(x)),
                      torch.as_tensor(v, device=device))


def edge_slot_clusters(batch: EventBatch, k: int = 32) -> Clusters:
    """``k`` clusters at ``min_events=1`` from each window of ``batch``
    (plain cluster_accum), with the first slots forced onto the sensor's
    corners (valid, 7 events, none nearby) and the last two slots invalid."""
    g = GridConfig(min_events=1, max_clusters=k)
    hist = ref.cluster_accum_ref(
        batch.x, batch.y, batch.t, batch.valid,
        cell_size=16, grid_w=g.grid_w, grid_h=g.grid_h, width=640, height=480,
    )
    f = {k: v.clone() for k, v in clusters_from_histogram(*hist, g)._asdict().items()}
    for j, (px, py) in enumerate(EDGE_SLOTS):
        f["centroid_x"][:, j], f["centroid_y"][:, j] = px, py
        f["count"][:, j], f["valid"][:, j] = 7, True
    f["valid"][:, -2:] = False
    f["count"] = torch.where(f["valid"], f["count"], 0)
    return Clusters(**f)


def full_slot_clusters(batch: EventBatch, k: int = 32, seed: int = 0) -> Clusters:
    """:func:`edge_slot_clusters` with every slot of every window valid:
    a slot with no cell of an event (and the last two) gets a seeded
    centroid anywhere on the sensor and a count of 1. The large metrics
    path runs a window's valid slots side by side; this fills them all."""
    f = {n: v.clone() for n, v in edge_slot_clusters(batch, k)._asdict().items()}
    rng = np.random.default_rng(seed)
    shape = tuple(f["valid"].shape)
    free = ~f["valid"]
    for name, hi in (("centroid_x", 640.0), ("centroid_y", 480.0)):
        drawn = torch.as_tensor(rng.uniform(0.0, hi, shape), dtype=torch.float32, device=free.device)
        f[name] = torch.where(free, drawn, f[name])
    f["count"] = torch.where(free, 1, f["count"])
    f["valid"] = torch.ones_like(f["valid"])
    return Clusters(**f)


def _pad_window(x, y, t, capacity: int):
    """Host planes ``(x, y, t, valid)`` of one window padded or cut to
    ``capacity``, as the reference's ``batch_from_arrays`` packs them."""
    n = min(len(x), capacity)
    pad = lambda a: np.pad(np.asarray(a[:n], np.int32), (0, capacity - n))  # noqa: E731
    return pad(x), pad(y), pad(t), np.pad(np.ones(n, bool), (0, capacity - n))


def clustered_window(seed: int, n: int = 160, capacity: int = 128):
    """One window of ``n`` events in four clumps, about a tenth of the
    slots invalid: the reference's random fixed-point test window
    (``tests/test_fixed_point.py:_random_batch``), the same arrays per
    seed."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(40, 580, (4, 2))
    pick = rng.integers(0, 4, n)
    x = np.clip(centers[pick, 0] + rng.integers(-12, 13, n), 0, 639)
    y = np.clip(centers[pick, 1] % 440 + rng.integers(-12, 13, n), 0, 479)
    t = np.sort(rng.integers(0, 20_000, n))
    rng.integers(0, 2, n)  # polarity, drawn to keep the reference's stream
    x, y, t, v = _pad_window(x, y, t, capacity)
    return x, y, t, v & (rng.random(capacity) > 0.1)


def named_windows(capacity: int = 128) -> dict:
    """The reference's six named edge-shape windows for the fixed-point
    datapath (``tests/test_fixed_point.py:_adversarial_batches``), as host
    planes ``(x, y, t, valid)``: empty, a single event, every event on one
    pixel, capacity saturated, out-of-sensor events beside a cluster, and
    a cluster cut by the ROI's edge."""
    rng = np.random.default_rng(0xF1)
    out = {}
    x, y, t, _ = clustered_window(1, capacity=capacity)
    out["empty"] = (x, y, t, np.zeros(capacity, bool))
    out["single_event"] = _pad_window([300], [200], [5], capacity)
    n = 40
    out["all_same_pixel"] = _pad_window(np.full(n, 321), np.full(n, 234), np.arange(n), capacity)
    x = 100 + rng.integers(0, 25, capacity)
    y = 100 + rng.integers(0, 25, capacity)
    out["capacity_saturated"] = _pad_window(x, y, np.sort(rng.integers(0, 9_000, capacity)), capacity)
    x = np.concatenate([640 + rng.integers(0, 50, 30), 200 + rng.integers(0, 10, 50)])
    y = np.concatenate([rng.integers(500, 600, 30), 300 + rng.integers(0, 10, 50)])
    out["out_of_bounds"] = _pad_window(x, y, np.arange(80), capacity)
    x = 14 + rng.integers(0, 12, 90)
    y = 200 + rng.integers(0, 12, 90)
    out["roi_boundary"] = _pad_window(x, y, np.arange(90), capacity)
    return out


@dataclasses.dataclass(frozen=True)
class ClippedGrid(GridConfig):
    """A grid narrower and shorter than the sensor: a pixel past column
    ``cols * cell_size`` wraps into the next row's cells, and one past
    the last row clips into the last cell, so one cell holds pixels with
    the same in-cell offset. No pipeline config builds one; the
    megakernel takes it (its whole-pixel sort key), and the plain
    version computes the same clipped cells from it."""

    cols: int = 30
    rows: int = 20

    @property
    def grid_w(self) -> int:
        return self.cols

    @property
    def grid_h(self) -> int:
        return self.rows


def run_and_tie_windows(seed: int = 7, e: int = 256, hot_pixel_max: int = 12) -> list:
    """Host windows ``(x, y, t, valid)`` that stress the fixed-point
    megakernel's runs and its slot prefix: a pixel at exactly
    ``hot_pixel_max`` events and one at ``hot_pixel_max + 1`` beside a
    clump; 40 cells tied at 6 events (more than K = 32); a few events in
    few cells (fewer than K at ``min_events``); three windows of random
    events crowded into a 60 x 40 corner (many repeats per pixel)."""
    rng = np.random.default_rng(seed)
    hot = hot_pixel_max

    def pad(xs, ys):
        n = len(xs)
        z = lambda a: np.pad(np.asarray(a, np.int64), (0, e - n))  # noqa: E731
        return z(xs), z(ys), z(rng.integers(0, 20_000, n)), np.pad(np.ones(n, bool), (0, e - n))

    out = [pad(np.r_[np.full(hot, 300), np.full(hot + 1, 310), rng.integers(290, 320, 60)],
               np.r_[np.full(hot, 200), np.full(hot + 1, 205), rng.integers(190, 215, 60)])]
    cells = np.arange(40)
    out.append(pad(np.repeat(40 + cells % 30 * 16, 6) + rng.integers(0, 16, 240),
                   np.repeat(100 + cells // 30 * 32, 6) + rng.integers(0, 16, 240)))
    out.append(pad(rng.integers(100, 140, 30), rng.integers(100, 140, 30)))
    for _ in range(3):
        out.append(pad(rng.integers(20, 80, e), rng.integers(20, 60, e)))
    return out


def large_windows(capacity: int, n_windows: int = 3, seed: int = 0, t_max: int = 100_000) -> list:
    """Host windows ``(x, y, t, valid)`` of ``capacity`` events (the last
    one half full) for the kernels' large-size paths: a dense 16 px cell
    holding an eighth of the events at window-relative t near ``t_max``
    (its t sum passes 2^24 from about 170 events at 100,000 us), a hot
    pixel of 40 repeats, ten clumps, and the rest spread over the sensor,
    so most cells hold an event (more than 1,024 counted cells at 16 px
    and 4,096 events); 5% invalid and 2% outside the sensor."""
    rng = np.random.default_rng(seed)
    out = []
    for w in range(n_windows):
        n = capacity if w < n_windows - 1 else capacity // 2
        n_dense, n_hot, n_clump = n // 8, 40, 10 * max(1, n // 160)
        n_rest = n - n_dense - n_hot - n_clump
        centers = rng.integers(40, 600, (10, 2)) % [600, 440]
        pick = rng.integers(0, 10, n_clump)
        x = np.concatenate([
            rng.integers(320, 336, n_dense), np.full(n_hot, 100),
            centers[pick, 0] + rng.integers(-8, 9, n_clump), rng.integers(0, 640, n_rest)])
        y = np.concatenate([
            rng.integers(240, 256, n_dense), np.full(n_hot, 100),
            centers[pick, 1] + rng.integers(-8, 9, n_clump), rng.integers(0, 480, n_rest)])
        t = np.concatenate([rng.integers(t_max - 5_000, t_max, n_dense),
                            rng.integers(0, t_max, n - n_dense)])
        order = rng.permutation(n)
        x, y, t = x[order], y[order], t[order]
        out_of_sensor = rng.random(n) < 0.02
        x = np.where(out_of_sensor, rng.integers(-50, 700, n), x)
        y = np.where(out_of_sensor, rng.integers(-50, 540, n), y)
        x, y, t, v = _pad_window(x, y, t, capacity)
        out.append((x, y, t, v & (rng.random(capacity) > 0.05)))
    return out


def hot_pixel_window(capacity: int = 50_000, n_hot: int = 48_000, seed: int = 4) -> tuple:
    """One host window of ``capacity`` events, ``n_hot`` of them on pixel
    (320, 240) and the rest spread over the sensor: a pixel count whose
    square passes 2^31 (from 46,341 events), so a metric kernel that sums
    c * c in 32-bit integers wraps."""
    rng = np.random.default_rng(seed)
    n_rest = capacity - n_hot
    x = np.concatenate([np.full(n_hot, 320), rng.integers(0, 640, n_rest)])
    y = np.concatenate([np.full(n_hot, 240), rng.integers(0, 480, n_rest)])
    t = rng.integers(0, 100_000, capacity)
    order = rng.permutation(capacity)
    return _pad_window(x[order], y[order], t, capacity)


def sum_t_window(capacity: int = 1024, seed: int = 3) -> tuple:
    """One window whose cell t sums pass 2^24 = 16,777,216: 600 events of
    one 16 px cell at window-relative t in [95,000, 100,000) (a sum near
    5.8e7), 168 of another at t = 100,000 (16,800,000, just past 2^24)
    and 167 of a third (16,700,000, just below), beside 60 scattered
    events at small t."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.integers(320, 336, 600), rng.integers(96, 112, 168),
                        rng.integers(400, 416, 167), rng.integers(0, 640, 60)])
    y = np.concatenate([rng.integers(240, 256, 600), rng.integers(96, 112, 168),
                        rng.integers(288, 304, 167), rng.integers(0, 480, 60)])
    t = np.concatenate([rng.integers(95_000, 100_000, 600), np.full(335, 100_000),
                        rng.integers(0, 1_000, 60)])
    order = rng.permutation(len(x))
    return _pad_window(x[order], y[order], t[order], capacity)


def stacked_batch(windows, device: str | torch.device = "cpu") -> EventBatch:
    """Host windows ``(x, y, t, valid)`` of one capacity as a ``(W, E)``
    int32 :class:`EventBatch` on ``device``."""
    x, y, t, v = (np.stack(a) for a in zip(*windows))
    as_int = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)  # noqa: E731
    return EventBatch(as_int(x), as_int(y), as_int(t), as_int(np.zeros_like(x)),
                      torch.as_tensor(v, device=device))


# ---------------------------------------------------------------------------
# Ingest wires for the event_unpack kernel.
# ---------------------------------------------------------------------------

def wire_stream(seed: int, n: int = 700, span_us: int = 120_000, garbage: bool = False):
    """A sorted random event stream (the reference's wire test stream);
    with ``garbage``, four events no sensor emits: x = -3, y = 70,000,
    p = 7 and x = 2**33 + 11, which wraps in int32."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 640, n).astype(np.int64)
    y = rng.integers(0, 480, n).astype(np.int64)
    t = np.sort(rng.integers(0, span_us, n))
    p = rng.integers(0, 2, n).astype(np.int64)
    if garbage:
        x[5], y[9], p[13], x[17] = -3, 70_000, 7, 2**33 + 11
    return x, y, t, p


def dual_bounds3(t: np.ndarray, batcher: BatcherConfig = BatcherConfig()):
    """Dual-threshold ``(start, stop, t0)`` bounds of a sorted stream."""
    return [(s, e, int(t[s])) for s, e in dual_threshold_bounds(t, batcher)]


def fleet_wire(sensors, capacity: int, n_windows: int | None = None):
    """Pack several sensors' windows into one ragged wire, as a fleet round
    does: ``sensors`` is a list of ``(x, y, t, p, bounds3)``; every sensor
    gets ``n_windows`` rows (default: the most any sensor has), the extra
    ones empty. Returns ``(words, dt, pol, offsets, spill)`` numpy."""
    s = len(sensors)
    w = max(len(b[4]) for b in sensors) if n_windows is None else n_windows
    n_max = wire_pad(s * w * capacity)
    words = np.zeros(n_max, np.uint32)
    dt16 = np.zeros(n_max, np.uint16)
    pbits = np.zeros(n_max, np.uint8)
    offsets = np.zeros((s, w + 1), np.int32)
    base, entries = 0, []
    for i, (x, y, t, p, bounds) in enumerate(sensors):
        *_, base, e = pack_bounds_into(
            x, y, t, p, bounds, out=(words, dt16, pbits, offsets[i]),
            layout="ragged", base=base, capacity=capacity,
        )
        entries.append(e)
    n_pad = wire_pad(base)
    pol = np.zeros(n_pad // 32, np.uint32)
    pack_polarity(pbits[:base], pol)
    ent = np.concatenate(entries, axis=1)
    spill = np.full((5, spill_pad(ent.shape[1])), SPILL_SENTINEL, np.int32)
    spill[:, : ent.shape[1]] = ent
    return words[:n_pad], dt16[:n_pad], pol, offsets, spill


def adversarial_wires() -> dict:
    """Named ``(wire, capacity)`` cases for the decoder: a spill lane with
    out-of-lane and int32-wrapped values; capacity truncation (capacity
    32 under a 200-event size cut); a three-sensor round with an idle
    sensor, empty windows, padded rows and spills behind a base offset;
    a spill lane of sentinels only; a spill lane out of position order,
    with a position counted from the end and one on the wire's last
    event."""
    out = {}
    x, y, t, p = wire_stream(3, garbage=True)
    out["spill lane"] = (pack_wire(x, y, t, p, dual_bounds3(t), 256)[0], 256)
    trunc = BatcherConfig(capacity=32, size_threshold=200)
    x, y, t, p = wire_stream(7, n=500, span_us=50_000)
    out["capacity truncation"] = (pack_wire(x, y, t, p, dual_bounds3(t, trunc), 32)[0], 32)
    a, b = wire_stream(11, n=600), wire_stream(12, n=300, garbage=True)
    empty = [(0, 0, 0), (10, 10, int(a[2][10]))]  # zero-event windows
    out["round with idle, empty and padded rows"] = (fleet_wire([
        (*a, dual_bounds3(a[2])[:4] + empty),
        (*a, []),
        (*b, dual_bounds3(b[2])[:3]),
    ], 256), 256)
    wire = list(pack_wire(*wire_stream(4), dual_bounds3(wire_stream(4)[2]), 256)[0])
    wire[4] = np.full((5, 8), SPILL_SENTINEL, np.int32)
    out["sentinel-only spill lane"] = (tuple(wire), 256)
    # The packer's entries in reverse order, then entries at the last
    # event's position, at one counted from the end (-n + 30 is 30) and at
    # two more, each position once; a padding sentinel between them.
    wire = list(out["spill lane"][0])
    n = wire[0].shape[0]
    real = wire[4][:, wire[4][0] != SPILL_SENTINEL]
    extra = [q for q in (int(wire[3][0, -1]) - 1, -n + 30, 100, 2) if q % n not in set(real[0] % n)]
    spill = np.full((5, spill_pad(real.shape[1] + len(extra) + 1)), SPILL_SENTINEL, np.int32)
    spill[:, : real.shape[1]] = real[:, ::-1]
    for j, q in enumerate(extra):
        spill[:, real.shape[1] + 1 + j] = (q, 70_000 + j, -5 - j, 65_536 + j, j % 2)
    wire[4] = spill
    out["unsorted and negative spill positions"] = (tuple(wire), 256)
    return out


def overlay_wires() -> dict:
    """Named ``(wire, capacity)`` cases for the decoder's spill overlay
    beyond what the packer writes: two entries on one slot (the later in
    the lane wins, as an index_put on the CPU does), rows whose offsets
    reach past the wire (clipped sources, so one entry covers several
    slots), capacities of 40 (a partial warp) and 1,100 (two passes of a
    CTA), and an empty wire with counts. Compare a kernel with the plain
    version run on the CPU: on a card an index_put with two entries on
    one slot keeps either."""
    wire, cap = adversarial_wires()["spill lane"]
    n = wire[0].shape[0]
    spill = np.full((5, 16), SPILL_SENTINEL, np.int32)
    for j, (q, *vals) in enumerate([(40, 1, 2, 3, 0), (-n + 7, 5, 6, 7, 1), (40, 9, 9, 9, 1),
                                    (n - 1, 70, 71, 72, 1), (0, 80, 81, 82, 0), (-n - 4, 1, 1, 1, 1)]):
        spill[:, j] = (q, *vals)
    off = wire[3].copy()
    off[0, 0], off[0, -1] = -5, n + 40
    z = np.zeros(0, np.uint32)
    return {
        "two entries on one slot": ((*wire[:4], spill), cap),
        "rows reaching past the wire": ((*wire[:3], off, spill), cap),
        "capacity 40": (wire, 40),
        "capacity 1100": ((*wire[:3], off, spill), 1100),
        "empty wire": ((z, np.zeros(0, np.uint16), z, np.array([[0, 3, 3]], np.int32), spill), 8),
    }


def entropy_frame(seed: int = 0, h: int = 480, w: int = 640):
    """A normalized ``(h, w)`` float32 frame in [0, 1] (sparse, like an
    accumulated event frame) and ``(K,)`` int32 centres: random ones,
    the four corners and points past them (clipped origins), and a
    single hot pixel's centre. A second, empty frame is all zeros."""
    rng = np.random.default_rng(seed)
    frame = np.where(rng.random((h, w)) < 0.05, rng.random((h, w)), 0.0).astype(np.float32)
    frame[70:130, 270:330] = 0.0
    frame[100, 300] = 1.0  # a hot pixel alone in its window
    cx = np.r_[rng.integers(0, w, 24), 0, w - 1, -40, w + 40, 300, 5, w - 3, 24]
    cy = np.r_[rng.integers(0, h, 24), 0, h - 1, -40, h + 40, 100, h - 2, 7, 24]
    return frame, cx.astype(np.int32), cy.astype(np.int32)


def entropy_probe_centres(k: int = 8192, seed: int = 1, h: int = 480, w: int = 640):
    """``(k,)`` int32 centres for ``entropy_frame``'s throughput probe:
    uniform over the frame and 40 px past each edge, so some origins clip
    and many slices overlap."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-40, w + 40, k).astype(np.int32),
            rng.integers(-40, h + 40, k).astype(np.int32))
