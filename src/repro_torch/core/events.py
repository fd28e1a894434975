"""Event-stream representation, dual-threshold windowing and conditioning.

The port of ``repro.core.events``:

* events are (x, y, t, polarity) tuples from a 640x480 event camera;
* the 32-bit wire word has ``x = bits[15:0]`` and ``y = bits[31:16]``;
* conditioning = the ROI filter plus persistent-event (hot pixel) removal;
* windows close after ``time_threshold_us`` OR ``size_threshold`` events
  (the dual policy), or every ``window_us`` of wall time (the stride
  policy), stacked by :func:`pad_windows` or one at a time
  (:func:`dual_threshold_batches`, :func:`window_batches`);
* the ragged ingest wire (packed words, 16-bit deltas, a polarity
  bitplane, CSR offsets and an exact int32 spill lane) and its decoder.

Windowing and wire packing stay host numpy, the same code as the
reference, so the window planes and the wire arrays are identical to the
bit; only the packed planes become tensors on the requested device.
Conditioning runs on a written-out window axis: every function here takes
``(..., E)`` tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device

SENSOR_WIDTH = 640
SENSOR_HEIGHT = 480
DEFAULT_ROI = (20, 20, 580, 420)  # x0, y0, x1, y1 (paper Sec. III-A)
DEFAULT_TIME_THRESHOLD_US = 20_000
DEFAULT_SIZE_THRESHOLD = 250
DEFAULT_CAPACITY = 256


class EventBatch(NamedTuple):
    """Fixed-capacity struct-of-arrays event buffer; leaves ``(..., E)``."""

    x: torch.Tensor  # int32 pixel column
    y: torch.Tensor  # int32 pixel row
    t: torch.Tensor  # int32 window-relative microseconds
    p: torch.Tensor  # int32 polarity in {0, 1}
    valid: torch.Tensor  # bool validity mask

    @property
    def capacity(self) -> int:
        return self.x.shape[-1]

    def count(self) -> torch.Tensor:
        return self.valid.sum(-1, dtype=torch.int32)


def make_empty_batch(
    capacity: int = DEFAULT_CAPACITY, device: str | torch.device = DEFAULT_DEVICE
) -> EventBatch:
    """An all-invalid ``(capacity,)`` window on ``device``."""
    z = torch.zeros((capacity,), dtype=torch.int32, device=resolve_device(device))
    return EventBatch(z, z, z, z, torch.zeros((capacity,), dtype=torch.bool, device=z.device))


def batch_from_arrays(
    x: np.ndarray,
    y: np.ndarray,
    t: np.ndarray,
    p: np.ndarray,
    capacity: int = DEFAULT_CAPACITY,
    device: str | torch.device = DEFAULT_DEVICE,
) -> EventBatch:
    """Pad or truncate host arrays into one ``(capacity,)`` window on
    ``device``, as the reference packs it: the ``len(x) - capacity``
    trailing events are dropped (the stacked path counts them in
    ``WindowedEvents.overflow``)."""
    dev = resolve_device(device)
    n = min(len(x), capacity)
    pad = capacity - n

    def prep(a):
        return torch.from_numpy(np.pad(np.asarray(a[:n], np.int32), (0, pad))).to(dev)

    valid = torch.from_numpy(np.pad(np.ones(n, bool), (0, pad))).to(dev)
    return EventBatch(prep(x), prep(y), prep(t), prep(p), valid)


# ---------------------------------------------------------------------------
# 32-bit wire format (paper Sec. IV-B): x in bits 15:0, y in bits 31:16.
# Built in int64: PyTorch has no ``>>`` or ``//`` for uint32 on the CPU.
# ---------------------------------------------------------------------------

def pack_words(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pack coordinate pairs into the 32-bit word, held in int64."""
    xi = x.to(torch.int64) & 0xFFFF
    yi = y.to(torch.int64) & 0xFFFF
    return (yi << 16) | xi


def unpack_words(words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_words` (bit slicing)."""
    w = words.to(torch.int64)
    x = (w & 0xFFFF).to(torch.int32)
    y = ((w >> 16) & 0xFFFF).to(torch.int32)
    return x, y


# ---------------------------------------------------------------------------
# Conditioning: ROI filter + persistent-event removal (Sec. III-A).
# ---------------------------------------------------------------------------

def roi_filter(batch: EventBatch, roi: Sequence[int] = DEFAULT_ROI) -> EventBatch:
    """Invalidate events outside the rectangular region of interest."""
    x0, y0, x1, y1 = roi
    keep = (batch.x >= x0) & (batch.x < x1) & (batch.y >= y0) & (batch.y < y1)
    return batch._replace(valid=batch.valid & keep)


# Up to this capacity the same-pixel test is one (E, E) compare block;
# above it a stable sort keeps the cost at O(E log E).
_PAIRWISE_MAX_EVENTS = 1024
# Compare elements per pairwise block: windows are taken this many
# E x E planes at a time so the block stays small on either device.
_PAIRWISE_BLOCK_ELEMS = 1 << 24


def _window_blocks(n_rows: int, e: int):
    """Row slices of a (rows, E) plane sized for one pairwise block."""
    step = max(1, _PAIRWISE_BLOCK_ELEMS // max(1, e * e))
    for lo in range(0, n_rows, step):
        yield slice(lo, min(n_rows, lo + step))


def persistent_event_filter(batch: EventBatch, max_repeats: int = 8) -> EventBatch:
    """Remove events from pixels firing more than ``max_repeats`` times in
    the window (hot pixels), counted over the window's own valid events."""
    e = batch.x.shape[-1]
    if e > _PAIRWISE_MAX_EVENTS:
        counts, _ = coincidence_counts(batch.x, batch.y, batch.valid)
    else:
        lead = batch.x.shape[:-1]
        x = batch.x.reshape(-1, e)
        y = batch.y.reshape(-1, e)
        v = batch.valid.reshape(-1, e)
        counts = torch.empty(x.shape, dtype=torch.int32, device=x.device)
        for rows in _window_blocks(x.shape[0], e):
            xb, yb, vb = x[rows], y[rows], v[rows]
            same = (xb[:, :, None] == xb[:, None, :]) & (yb[:, :, None] == yb[:, None, :])
            counts[rows] = (same & vb[:, None, :]).sum(-1, dtype=torch.int32)
        counts = counts.reshape(*lead, e)
    return batch._replace(valid=batch.valid & (counts <= max_repeats))


def persistent_event_filter_hist(
    batch: EventBatch,
    max_repeats: int = 8,
    width: int = SENSOR_WIDTH,
    height: int = SENSOR_HEIGHT,
) -> EventBatch:
    """The histogram oracle for :func:`persistent_event_filter`: each
    window scattered into a sensor-sized per-pixel count, the original
    O(sensor area) form, kept to hold the event-space filter to the bit.
    Takes ``(..., E)`` windows of in-sensor events."""
    e = batch.x.shape[-1]
    flat = (batch.y.to(torch.int64) * width + batch.x.to(torch.int64)).reshape(-1, e)
    v = batch.valid.reshape(-1, e)
    counts = torch.zeros((flat.shape[0], height * width), dtype=torch.int32, device=flat.device)
    counts.scatter_add_(-1, flat, v.to(torch.int32))
    keep = (torch.gather(counts, -1, flat) <= max_repeats).reshape(batch.valid.shape)
    return batch._replace(valid=batch.valid & keep)


_SENTINEL = 0xFFFFFFFF


def coincidence_counts(
    x: torch.Tensor, y: torch.Tensor, weight: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-event pixel coincidence counts and run leaders over ``(..., E)``.

    ``counts[i]`` is the number of weighted events sharing the packed
    pixel key of event ``i`` (itself included); ``leader[i]`` marks the
    lowest-index weighted event of each occupied pixel. For E up to
    ``_PAIRWISE_MAX_EVENTS`` this is one pairwise (E, E) block per window
    (the reference's CPU branch); above it, a stable sort of packed keys
    with run lengths from prefix max/min scans (the reference's sort
    branch). Unweighted events get the count each branch gives them and
    are never leaders.
    """
    e = x.shape[-1]
    lead_shape = x.shape[:-1]
    key = pack_words(x, y).reshape(-1, e)
    wt = weight.reshape(-1, e)
    if e <= _PAIRWISE_MAX_EVENTS:
        counts = torch.empty(key.shape, dtype=torch.int32, device=key.device)
        leader = torch.empty(key.shape, dtype=torch.bool, device=key.device)
        for rows in _window_blocks(key.shape[0], e):
            kb, wb = key[rows], wt[rows]
            same = (kb[:, :, None] == kb[:, None, :]) & wb[:, None, :]  # (., i, j)
            counts[rows] = same.sum(-1, dtype=torch.int32)
            earlier = torch.tril(same, diagonal=-1).any(-1)  # weighted j < i
            leader[rows] = wb & ~earlier
        return counts.reshape(*lead_shape, e), leader.reshape(*lead_shape, e)
    key = torch.where(wt, key, torch.full_like(key, _SENTINEL))
    perm = torch.argsort(key, dim=-1, stable=True)
    sk = torch.gather(key, -1, perm)
    idx = torch.arange(e, dtype=torch.int64, device=key.device).expand_as(sk)
    brk = sk[:, 1:] != sk[:, :-1]
    ones = torch.ones_like(brk[:, :1])
    start = torch.cat([ones, brk], dim=-1)
    end = torch.cat([brk, ones], dim=-1)
    first = torch.cummax(torch.where(start, idx, 0), dim=-1).values
    last = torch.cummin(torch.where(end, idx, e).flip(-1), dim=-1).values.flip(-1)
    counts_s = (last - first + 1).to(torch.int32)
    leader_s = start & (sk != _SENTINEL)
    inv = torch.empty_like(perm).scatter_(-1, perm, idx.contiguous())
    counts = torch.gather(counts_s, -1, inv)
    leader = torch.gather(leader_s, -1, inv)
    return counts.reshape(*lead_shape, e), leader.reshape(*lead_shape, e)


# ---------------------------------------------------------------------------
# Dual-threshold batcher (host side; the same numpy code as the reference).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BatcherConfig:
    time_threshold_us: int = DEFAULT_TIME_THRESHOLD_US
    size_threshold: int = DEFAULT_SIZE_THRESHOLD
    capacity: int = DEFAULT_CAPACITY


def validate_monotone(
    t: np.ndarray, last_t: int | None = None, label: str = "feed"
) -> None:
    """Reject a chunk whose timestamps would mis-window the stream:
    timestamps must be non-decreasing within the chunk and must not
    precede ``last_t``, the newest timestamp the stream has absorbed.
    Raises ``ValueError`` on violation."""
    t = np.asarray(t, np.int64)
    if not len(t):
        return
    if len(t) > 1 and np.any(t[1:] < t[:-1]):
        bad = int(np.argmax(t[1:] < t[:-1]))
        raise ValueError(
            f"{label}: chunk timestamps are not non-decreasing "
            f"(t[{bad + 1}]={int(t[bad + 1])} < t[{bad}]={int(t[bad])}); "
            "events must be time-sorted"
        )
    if last_t is not None and int(t[0]) < last_t:
        raise ValueError(
            f"{label}: chunk starts at t={int(t[0])} us, before the "
            f"stream's newest absorbed timestamp {last_t} us; feeds "
            "must be monotonically non-decreasing across boundaries"
        )


def monotone_merge(
    pending: tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray],
    x: np.ndarray,
    y: np.ndarray,
    t: np.ndarray,
    p: np.ndarray,
    last_t: int | None = None,
    label: str = "feed",
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Validate a raw chunk (:func:`validate_monotone`) and append it to
    the batcher remainder, as int64 arrays. A bad chunk raises before any
    state is touched, so the caller's carry stays valid."""
    px, py, pt, pp = pending
    t = np.asarray(t, np.int64)
    validate_monotone(t, last_t, label)
    return (
        np.concatenate([px, np.asarray(x, np.int64)]),
        np.concatenate([py, np.asarray(y, np.int64)]),
        np.concatenate([pt, t]),
        np.concatenate([pp, np.asarray(p, np.int64)]),
    )


def dual_threshold_bounds(
    t: np.ndarray, config: BatcherConfig = BatcherConfig()
) -> list[tuple[int, int]]:
    """Window boundaries (start, stop) under the dual-threshold policy:
    the closed windows plus the trailing remainder, force-closed at the
    last event."""
    bounds, start = dual_threshold_closed_bounds(t, config)
    if start < len(t):
        bounds.append((start, len(t)))
    return bounds


def dual_threshold_closed_bounds(
    t: np.ndarray, config: BatcherConfig = BatcherConfig()
) -> tuple[list[tuple[int, int]], int]:
    """Window bounds no future event can change, and the prefix length
    they cover: a window closes once an event at or past
    ``t0 + time_threshold_us`` is buffered or ``size_threshold`` events
    have accumulated."""
    n = len(t)
    bounds: list[tuple[int, int]] = []
    start = 0
    while start < n:
        t0 = t[start]
        end_size = start + config.size_threshold
        end_time = int(np.searchsorted(t, t0 + config.time_threshold_us, side="left"))
        if end_time > start:
            if end_time >= n and end_size > n:
                break  # neither cut provably lands inside the buffer yet
            end = min(end_size, end_time)
        else:  # degenerate time threshold: only the size cut can close
            if end_size > n:
                break
            end = end_size
        end = max(start + 1, min(end, n))
        bounds.append((start, end))
        start = end
    return bounds, start


def stride_bounds(
    t: np.ndarray, window_us: int = DEFAULT_TIME_THRESHOLD_US
) -> list[tuple[int, int, int]]:
    """Fixed-stride window boundaries ``(start, stop, window_t0_us)``,
    anchored to wall time: a window may be empty and its origin is the
    stride start, not the first event's timestamp."""
    if len(t) == 0:
        return []
    bounds: list[tuple[int, int, int]] = []
    t_end = int(t[-1])
    w0 = int(t[0])
    while w0 <= t_end:
        lo = int(np.searchsorted(t, w0, side="left"))
        hi = int(np.searchsorted(t, w0 + window_us, side="left"))
        bounds.append((lo, hi, w0))
        w0 += window_us
    return bounds


def dual_threshold_batches(
    x: np.ndarray,
    y: np.ndarray,
    t: np.ndarray,
    p: np.ndarray,
    config: BatcherConfig = BatcherConfig(),
    device: str | torch.device = DEFAULT_DEVICE,
) -> Iterator[tuple[EventBatch, slice]]:
    """One ``(capacity,)`` window on ``device`` at a time over a
    time-sorted recording, under the dual-threshold policy (250 events or
    20 ms): yields ``(batch, slice_into_recording)``, the reference's
    windows to the bit."""
    for start, end in dual_threshold_bounds(t, config):
        sl = slice(start, end)
        yield batch_from_arrays(x[sl], y[sl], t[sl] - t[start], p[sl], config.capacity,
                                device), sl


def window_batches(
    x: np.ndarray,
    y: np.ndarray,
    t: np.ndarray,
    p: np.ndarray,
    window_us: int = DEFAULT_TIME_THRESHOLD_US,
    capacity: int = DEFAULT_CAPACITY,
    device: str | torch.device = DEFAULT_DEVICE,
) -> Iterator[tuple[EventBatch, slice]]:
    """Fixed-stride windows of ``window_us``, one ``(capacity,)`` window
    on ``device`` at a time, times relative to the stride start."""
    for lo, hi, w0 in stride_bounds(t, window_us):
        sl = slice(lo, hi)
        yield batch_from_arrays(x[sl], y[sl], t[sl] - w0, p[sl], capacity, device), sl


class WindowedEvents(NamedTuple):
    """A recording pre-windowed into ``(W, capacity)`` planes.

    ``batch`` leaves are tensors on the run's device; the host bookkeeping
    (window origins, slice bounds into the recording, per-window events
    dropped past capacity) stays numpy for ground-truth matching.
    """

    batch: EventBatch  # leaves (W, capacity)
    t_start_us: np.ndarray  # (W,) int64 absolute window origin
    starts: np.ndarray  # (W,) int64 slice start into the recording
    stops: np.ndarray  # (W,) int64 slice stop (exclusive)
    overflow: np.ndarray  # (W,) int64 events dropped past capacity

    @property
    def num_windows(self) -> int:
        return self.batch.x.shape[0]

    @property
    def capacity(self) -> int:
        return self.batch.x.shape[-1]


def pack_bounds_into(
    x: np.ndarray,
    y: np.ndarray,
    t: np.ndarray,
    p: np.ndarray,
    bounds: list[tuple[int, int, int]],
    bx: np.ndarray | None = None,
    by: np.ndarray | None = None,
    bt: np.ndarray | None = None,
    bp: np.ndarray | None = None,
    bv: np.ndarray | None = None,
    *,
    out: tuple[np.ndarray, ...] | None = None,
    layout: str = "dense",
    base: int = 0,
    capacity: int | None = None,
    spill: bool = True,
) -> tuple[np.ndarray, ...]:
    """Scatter ``(start, stop, t0_us)`` windows into preallocated numpy
    arrays. Rows longer than the capacity are truncated.

    ``layout="dense"``: five ``(>= W, capacity)`` planes, positional or
    as ``out=(bx, by, bt, bp, bv)``; returns ``(starts, stops, t_start,
    overflow)``. ``layout="ragged"``: ``out=(words, dt, pbits,
    offsets_row)`` and ``capacity=`` (see :func:`_pack_bounds_ragged`);
    returns ``(starts, stops, t_start, overflow, new_base,
    spill_entries)``. The same contract as the reference's."""
    if layout == "ragged":
        if out is None or bx is not None:
            raise TypeError("layout='ragged' requires the out= wire tuple")
        if capacity is None:
            raise TypeError("layout='ragged' requires capacity=")
        return _pack_bounds_ragged(
            x, y, t, p, bounds, out, base=base, capacity=capacity, spill=spill
        )
    if layout != "dense":
        raise ValueError(f"unknown pack layout: {layout!r}")
    if out is not None:
        if bx is not None:
            raise TypeError("pass destination planes positionally OR as out=")
        bx, by, bt, bp, bv = out
    if bx is None or by is None or bt is None or bp is None or bv is None:
        raise TypeError("five destination planes required (positional or out=)")
    w = len(bounds)
    cap = bx.shape[-1]
    starts = np.fromiter((b[0] for b in bounds), np.int64, count=w)
    stops = np.fromiter((b[1] for b in bounds), np.int64, count=w)
    t_start = np.fromiter((b[2] for b in bounds), np.int64, count=w)
    n = np.minimum(stops - starts, cap)
    overflow = stops - starts - n
    total = int(n.sum())
    if total:
        rows = np.repeat(np.arange(w), n)
        cols = np.arange(total) - np.repeat(np.cumsum(n) - n, n)
        src = np.repeat(starts, n) + cols
        bx[rows, cols] = x[src]
        by[rows, cols] = y[src]
        bt[rows, cols] = t[src] - np.repeat(t_start, n)
        bp[rows, cols] = p[src]
        bv[rows, cols] = True
    return starts, stops, t_start, overflow


def pack_bounds(
    x: np.ndarray,
    y: np.ndarray,
    t: np.ndarray,
    p: np.ndarray,
    bounds: list[tuple[int, int, int]],
    capacity: int,
    device: str | torch.device = DEFAULT_DEVICE,
) -> WindowedEvents:
    """Pack ``(start, stop, t0_us)`` bounds into ``WindowedEvents`` whose
    planes are tensors on ``device``."""
    dev = resolve_device(device)
    w = len(bounds)
    planes = [np.zeros((w, capacity), np.int32) for _ in range(4)]
    bv = np.zeros((w, capacity), bool)
    starts, stops, t_start, overflow = pack_bounds_into(
        x, y, t, p, bounds, *planes, bv
    )
    batch = EventBatch(*(torch.from_numpy(a).to(dev) for a in (*planes, bv)))
    return WindowedEvents(batch, t_start, starts, stops, overflow)


def pad_windows(
    x: np.ndarray,
    y: np.ndarray,
    t: np.ndarray,
    p: np.ndarray,
    config: BatcherConfig = BatcherConfig(),
    device: str | torch.device = DEFAULT_DEVICE,
    policy: str = "dual",
    window_us: int | None = None,
) -> WindowedEvents:
    """Slice a time-sorted recording into ``(W, capacity)`` windows on
    ``device``, with the same boundaries, relative timestamps and
    truncation as the reference's ``pad_windows``: ``policy="dual"``
    gives :func:`dual_threshold_batches`' windows, ``policy="stride"``
    :func:`window_batches`' (strides of ``window_us``, by default the
    batcher's time threshold). Events past a window's capacity are
    counted in ``overflow``."""
    x, y, t, p = (np.asarray(a) for a in (x, y, t, p))
    if policy == "dual":
        bounds = [(s, e, int(t[s])) for s, e in dual_threshold_bounds(t, config)]
    elif policy == "stride":
        bounds = stride_bounds(t, window_us or config.time_threshold_us)
    else:
        raise ValueError(f"unknown windowing policy: {policy!r}")
    return pack_bounds(x, y, t, p, bounds, config.capacity, device)


# ---------------------------------------------------------------------------
# Ragged ingest wire (host packing; the device decoder is below).
#
#   words  (N,) uint32   packed (y << 16) | x, 16-bit lanes
#   dt     (N,) uint16   window-relative timestamp delta
#   pol    (N/32,) uint32 polarity bitplane: event i is bit i & 31 of word
#                        i >> 5 (np.packbits(..., bitorder="little"))
#   offsets (S, W+1) int32 CSR row starts per (sensor, window)
#   spill  (5, M) int32  (position, x, y, dt, p) rows for events the
#                        packed lanes cannot hold, as the exact int32 the
#                        dense planes would ship
#
# PyTorch has no ``>>`` on uint32 on the CPU and little uint16 support, so
# the torch side carries words, pol and spill as int32 and dt as int16
# views of the same bits, masks after every shift and zero-extends dt.
# ---------------------------------------------------------------------------

WIRE_QUANTUM = 512  # wire length bucket (multiple of 32 for the bitplane)
SPILL_QUANTUM = 8  # spill lane length bucket
# Padding entries in the spill lane point past any possible wire length,
# so the decoder drops them.
SPILL_SENTINEL = np.int32(2**31 - 1)

_DT_MAX = 0xFFFF  # widest window-relative delta the packed lane holds


def wire_pad(n: int) -> int:
    """Events ``n`` rounded up to the wire-length bucket (minimum one)."""
    return max(WIRE_QUANTUM, -(-n // WIRE_QUANTUM) * WIRE_QUANTUM)


def spill_pad(m: int) -> int:
    """Spill entries ``m`` rounded up to the spill bucket (0 stays 0)."""
    return -(-m // SPILL_QUANTUM) * SPILL_QUANTUM


def dense_wire_bytes(s: int, w: int, cap: int) -> int:
    """Host->device bytes for one dense round: four int32 planes, the
    bool validity mask, and the (2, S) int32 meta rows."""
    return 17 * s * w * cap + 8 * s


def ragged_wire_bytes(n_pad: int, s: int, w: int, m_pad: int) -> int:
    """Host->device bytes for one ragged round: words + dt + bitplane
    (6.125 B/slot over the padded wire length), CSR offsets, spill lane,
    and the same (2, S) meta rows as the dense path."""
    return (
        4 * n_pad + 2 * n_pad + 4 * (n_pad // 32)  # words, dt, pol
        + 4 * s * (w + 1)  # offsets
        + 4 * 5 * m_pad  # spill
        + 8 * s  # meta
    )


def _pack_bounds_ragged(
    x: np.ndarray,
    y: np.ndarray,
    t: np.ndarray,
    p: np.ndarray,
    bounds: list[tuple[int, int, int]],
    out: tuple[np.ndarray, ...],
    *,
    base: int,
    capacity: int,
    spill: bool,
) -> tuple[np.ndarray, ...]:
    """Ragged-mode core of :func:`pack_bounds_into` (one sensor's rows).

    ``out`` is ``(words, dt, pbits, offsets_row)``: the shared 1-D wire
    arrays (written from ``base``) plus this sensor's ``(>= W+1,)``
    offsets row; ``pbits`` holds one polarity byte per event, packed into
    the bitplane once per round by the caller. Windows longer than
    ``capacity`` truncate exactly like the dense planes. Returns
    ``(starts, stops, t_start, overflow, new_base, spill_entries)`` with
    ``spill_entries`` a (5, k) int32 block of (position, x, y, dt, p)
    rows. With ``spill=False`` an event the packed lanes cannot hold
    raises ``ValueError`` instead.
    """
    words, dt16, pbits, offsets_row = out
    w = len(bounds)
    starts = np.fromiter((b[0] for b in bounds), np.int64, count=w)
    stops = np.fromiter((b[1] for b in bounds), np.int64, count=w)
    t_start = np.fromiter((b[2] for b in bounds), np.int64, count=w)
    n = np.minimum(stops - starts, np.int64(capacity))
    overflow = stops - starts - n
    total = int(n.sum())
    offsets_row[0] = base
    offsets_row[1 : w + 1] = base + np.cumsum(n)
    offsets_row[w + 1 :] = base + total  # padding windows: zero count
    none = np.zeros((5, 0), np.int32)
    if not total:
        return starts, stops, t_start, overflow, base, none
    cols = np.arange(total) - np.repeat(np.cumsum(n) - n, n)
    src = np.repeat(starts, n) + cols
    xv, yv, pv = x[src], y[src], p[src]
    tv = t[src] - np.repeat(t_start, n)
    dst = slice(base, base + total)
    words[dst] = (
        (yv.astype(np.uint32) & np.uint32(0xFFFF)) << np.uint32(16)
    ) | (xv.astype(np.uint32) & np.uint32(0xFFFF))
    dt16[dst] = tv.astype(np.uint16)
    pbits[dst] = (pv & 1).astype(np.uint8)
    wide = (
        (xv < 0) | (xv > 0xFFFF) | (yv < 0) | (yv > 0xFFFF)
        | (tv < 0) | (tv > _DT_MAX) | (pv < 0) | (pv > 1)
    )
    if not wide.any():
        return starts, stops, t_start, overflow, base + total, none
    if not spill:
        k = int(np.argmax(wide))
        raise ValueError(
            f"event (x={int(xv[k])}, y={int(yv[k])}, dt={int(tv[k])}, "
            f"p={int(pv[k])}) does not fit the packed wire lanes "
            "(coords/deltas in [0, 65535], polarity in {0, 1}) and the "
            "spill lane is disabled; enable spill or pre-filter the stream"
        )
    k = np.flatnonzero(wide)
    # Exact int32 values, wrapping like the dense planes' int64 -> int32
    # assignment.
    entries = np.stack([
        (base + k).astype(np.int64), xv[k], yv[k], tv[k], pv[k],
    ]).astype(np.int32)
    return starts, stops, t_start, overflow, base + total, entries


def pack_polarity(pbits: np.ndarray, pol: np.ndarray) -> None:
    """Pack per-event polarity bytes into the uint32 bitplane ``pol``
    (event i is bit i & 31 of word i >> 5), in place."""
    if len(pbits):
        packed = np.packbits(pbits, bitorder="little")
        pol.view(np.uint8)[: len(packed)] = packed


def pack_wire(
    x: np.ndarray,
    y: np.ndarray,
    t: np.ndarray,
    p: np.ndarray,
    bounds: list[tuple[int, int, int]],
    capacity: int,
    *,
    spill: bool = True,
) -> tuple[tuple[np.ndarray, ...], np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Allocate-and-pack one sensor's windows into ragged wire arrays:
    returns ``(wire, starts, stops, t_start, overflow)`` where ``wire`` is
    the ``(words, dt, pol, offsets, spill)`` tuple :func:`unpack_wire`
    consumes, ``offsets`` shaped (1, W+1) and the wire length padded to
    :data:`WIRE_QUANTUM`. Rows longer than ``capacity`` are truncated
    exactly like :func:`pack_bounds`."""
    w = len(bounds)
    total = sum(min(e - s, capacity) for s, e, _ in bounds)
    n_pad = wire_pad(total)
    words = np.zeros(n_pad, np.uint32)
    dt16 = np.zeros(n_pad, np.uint16)
    pbits = np.zeros(n_pad, np.uint8)
    offsets = np.zeros((1, w + 1), np.int32)
    starts, stops, t_start, overflow, _, entries = pack_bounds_into(
        x, y, t, p, bounds,
        out=(words, dt16, pbits, offsets[0]),
        layout="ragged", base=0, capacity=capacity, spill=spill,
    )
    pol = np.zeros(n_pad // 32, np.uint32)
    pack_polarity(pbits[:total], pol)
    m = entries.shape[1]
    spill_lane = np.full((5, spill_pad(m)), SPILL_SENTINEL, np.int32)
    spill_lane[:, :m] = entries
    return (words, dt16, pol, offsets, spill_lane), starts, stops, t_start, overflow


def wire_tensors(
    wire: tuple[np.ndarray, ...], device: str | torch.device,
    non_blocking: bool = False,
) -> tuple[torch.Tensor, ...]:
    """The numpy wire ``(words, dt, pol, offsets, spill)`` as tensors on
    ``device``: words and pol as int32 and dt as int16 views of the same
    bits."""
    words, dt16, pol, offsets, spill = wire
    views = (
        np.ascontiguousarray(words).view(np.int32),
        np.ascontiguousarray(dt16).view(np.int16),
        np.ascontiguousarray(pol).view(np.int32),
        np.ascontiguousarray(offsets, np.int32),
        np.ascontiguousarray(spill, np.int32),
    )
    return tuple(
        torch.from_numpy(v).to(device, non_blocking=non_blocking) for v in views
    )


def unpack_wire(
    words: torch.Tensor,
    dt16: torch.Tensor,
    pol: torch.Tensor,
    offsets: torch.Tensor,
    spill: torch.Tensor,
    capacity: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The ragged-wire decoder in plain torch, on the tensors' device.

    Takes the wire as :func:`wire_tensors` gives it (words, pol, offsets,
    spill int32; dt int16) and returns ``(packed (4, S, W, capacity)
    int32, valid (S, W, capacity) bool)``, the dense planes bit for bit.
    The same steps as the reference's ``unpack_wire``: unpack every wire
    position, overlay the spill lane in wire-position space (positions
    outside ``[-N, N)`` dropped, negative ones counted from the end, as a
    ``mode="drop"`` scatter does), then gather each window's slots and
    zero every slot past its count.
    """
    n = words.shape[0]
    xs, ys = unpack_words(words)
    ts = dt16.to(torch.int32) & 0xFFFF  # zero-extend the int16 view
    shifts = torch.arange(32, dtype=torch.int32, device=pol.device)
    ps = ((pol[:, None] >> shifts[None, :]) & 1).reshape(-1).to(torch.int32)
    pos = spill[0].to(torch.int64)
    pos = torch.where(pos < 0, pos + n, pos)
    # Dropped entries land in a dump slot past the lane: an index, not a
    # boolean mask, so the overlay never waits for the device.
    pos = torch.where((pos >= 0) & (pos < n), pos, n)
    planes = []
    for lane, row in zip((xs, ys, ts, ps), spill[1:]):
        lane = torch.cat([lane.to(torch.int32), lane.new_zeros(1, dtype=torch.int32)])
        lane[pos] = row.to(torch.int32)
        planes.append(lane[:n])
    off = offsets.to(torch.int64)
    counts = off[:, 1:] - off[:, :-1]  # (S, W)
    slot = torch.arange(capacity, dtype=torch.int64, device=off.device)
    src = off[:, :-1, None] + slot  # (S, W, cap)
    valid = slot < counts[..., None]
    take = src.clamp(0, max(n - 1, 0))
    packed = torch.stack([
        torch.where(valid, lane[take], 0) if n else torch.zeros_like(valid, dtype=torch.int32)
        for lane in planes
    ])
    return packed, valid
