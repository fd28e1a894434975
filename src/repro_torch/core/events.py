"""Event-stream representation, dual-threshold windowing and conditioning.

The port of ``repro.core.events`` (windowing and conditioning half):

* events are (x, y, t, polarity) tuples from a 640x480 event camera;
* the 32-bit wire word has ``x = bits[15:0]`` and ``y = bits[31:16]``;
* conditioning = the ROI filter plus persistent-event (hot pixel) removal;
* windows close after ``time_threshold_us`` OR ``size_threshold`` events.

Windowing stays host numpy, the same code as the reference, so the window
planes are identical to the bit; only the packed planes become tensors on
the requested device. Conditioning runs on a written-out window axis:
every function here takes ``(..., E)`` tensors.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

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
    bx: np.ndarray,
    by: np.ndarray,
    bt: np.ndarray,
    bp: np.ndarray,
    bv: np.ndarray,
) -> tuple[np.ndarray, ...]:
    """Scatter ``(start, stop, t0_us)`` windows into preallocated
    ``(>= W, capacity)`` numpy planes (dense layout). Rows longer than
    the capacity are truncated. Returns ``(starts, stops, t_start,
    overflow)``."""
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
) -> WindowedEvents:
    """Slice a time-sorted recording into dual-threshold ``(W, capacity)``
    windows: the same boundaries, relative timestamps and truncation as
    the reference's ``pad_windows(policy="dual")``."""
    x, y, t, p = (np.asarray(a) for a in (x, y, t, p))
    bounds = [(s, e, int(t[s])) for s, e in dual_threshold_bounds(t, config)]
    return pack_bounds(x, y, t, p, bounds, config.capacity, device)
