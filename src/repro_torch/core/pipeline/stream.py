"""Resumable streaming driver: chunked feeds of a live event feed.

The port of ``repro.core.pipeline.stream``. Raw event chunks of any size
go in through :meth:`StreamingPipeline.feed`; every feed returns the
clusters, metrics and tracks of the windows that provably closed,
windowed with the dual-threshold semantics of the offline driver, so
the concatenation of all feeds plus a final :meth:`flush` equals
:func:`~repro_torch.core.pipeline.scan.run_recording_scan` over the same
recording for any chunking, on one device to the bit.

The carry (:class:`StreamState`) holds what the next feed needs: the
batcher remainder (host events of the still-open trailing window), the
stream index of its first event, the next atlas tag (epoch-local), the
atlas and the tracker state. On the float event route the atlas event
core writes the atlas feed after feed, so :func:`stream_state_to_numpy`
and :func:`stream_state_from_numpy` carry the reference's atlas exactly;
the other routes leave it zero, as the reference's do.
``wire="ragged"`` packs each feed's windows into the compressed ingest
wire on the host and decodes it on the device (the ``event_unpack``
kernel under ``use_kernels``), to the same planes as ``wire="dense"``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core import metrics as M
from repro_torch.core.events import (
    SPILL_SENTINEL,
    EventBatch,
    WindowedEvents,
    dense_wire_bytes,
    dual_threshold_bounds,
    dual_threshold_closed_bounds,
    monotone_merge,
    pack_bounds,
    pack_wire,
    ragged_wire_bytes,
    wire_tensors,
)
from repro_torch.core.grid_clustering import Clusters
from repro_torch.core.pipeline.config import PipelineConfig
from repro_torch.core.pipeline.scan import ScanResult, make_atlas, make_core
from repro_torch.core.tracking import (
    TrackState,
    init_tracks,
    tracks_from_numpy,
    tracks_to_numpy,
)

_EMPTY = np.zeros(0, np.int64)


def tag_limit(config: PipelineConfig) -> int:
    """Windows addressable within one atlas tag epoch for this config:
    tags are encoded as ``(tag + 1) << shift`` in int32, so the drivers
    wrap to a fresh epoch (atlas re-zeroed) before that overflows."""
    shift = max(config.batcher.capacity.bit_length(), 1)
    return (1 << (31 - shift)) - 2


def empty_scan_result(
    config: PipelineConfig,
    with_tracking: bool,
    tracks: TrackState,
    windows: WindowedEvents,
) -> ScanResult:
    """Zero-window result (a feed that closed nothing): empty stacked
    outputs on the device of ``tracks``, which passes through as
    ``final_tracks``."""
    k = config.grid.max_clusters
    dev = tracks.x.device
    z = lambda dt: torch.zeros((0, k), dtype=dt, device=dev)  # noqa: E731
    clusters = Clusters(
        centroid_x=z(torch.float32), centroid_y=z(torch.float32),
        centroid_t=z(torch.float32), count=z(torch.int32),
        cell_x=z(torch.int32), cell_y=z(torch.int32), valid=z(torch.bool),
    )
    mets = {name: z(torch.float32) for name in M.METRIC_NAMES}
    states = TrackState(*(a.new_zeros((0,) + tuple(a.shape)) for a in tracks))
    return ScanResult(
        t_start_us=windows.t_start_us,
        clusters=clusters,
        metrics=mets,
        tracks=states if with_tracking else None,
        final_tracks=tracks if with_tracking else None,
        windows=windows,
    )


@dataclasses.dataclass
class StreamState:
    """Everything carried between feeds; savable and restorable as a unit."""

    pending: tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]  # x, y, t, p
    events_consumed: int  # stream index of pending[0]
    next_tag: int  # next atlas tag (epoch-local: resets at tag rollover)
    atlas: torch.Tensor  # persistent tagged event surface
    tracks: TrackState
    last_t: int | None = None  # newest absorbed timestamp (feed monotonicity)

    @property
    def pending_count(self) -> int:
        return len(self.pending[2])


def stream_state_to_numpy(state: StreamState) -> dict:
    """The carry as host numpy: ``pending`` (four int64 arrays),
    ``events_consumed``, ``next_tag``, ``last_t``, ``atlas`` and
    ``tracks`` (a dict of arrays by field). The same fields as the
    reference's ``StreamState``, so a stream moves between the packages."""
    return dict(
        pending=tuple(np.array(a, np.int64) for a in state.pending),
        events_consumed=int(state.events_consumed),
        next_tag=int(state.next_tag),
        last_t=None if state.last_t is None else int(state.last_t),
        atlas=state.atlas.cpu().numpy(),
        tracks=tracks_to_numpy(state.tracks),
    )


def stream_state_from_numpy(
    d: dict, device: str | torch.device = DEFAULT_DEVICE
) -> StreamState:
    """A :class:`StreamState` on ``device`` from the numpy form of
    :func:`stream_state_to_numpy`, e.g. built from the reference's
    ``StreamState`` field by field: a stream started in the JAX package
    resumes here."""
    dev = resolve_device(device)
    return StreamState(
        pending=tuple(np.array(a, np.int64) for a in d["pending"]),
        events_consumed=int(d["events_consumed"]),
        next_tag=int(d["next_tag"]),
        atlas=torch.as_tensor(np.array(d["atlas"], np.int32), device=dev),
        tracks=tracks_from_numpy(d["tracks"], dev),
        last_t=None if d["last_t"] is None else int(d["last_t"]),
    )


class StreamingPipeline:
    """Incremental driver over a live event stream on ``device``.

    >>> sp = StreamingPipeline(PipelineConfig(), device="cuda")
    >>> for x, y, t, p in sensor_chunks():      # any chunk sizes
    ...     result = sp.feed(x, y, t, p)        # windows closed this feed
    >>> tail = sp.flush()                       # close the trailing window

    Each feed runs one step core call over the newly closed windows.
    ``state`` may be saved and restored to resume a stream.
    """

    def __init__(
        self,
        config: PipelineConfig = PipelineConfig(),
        with_tracking: bool = True,
        state: StreamState | None = None,
        wire: str = "dense",
        device: str | torch.device = DEFAULT_DEVICE,
    ):
        if wire not in ("dense", "ragged"):
            raise ValueError(f"unknown wire mode: {wire!r}")
        self.config = config
        self.with_tracking = with_tracking
        self.wire = wire
        self.device = resolve_device(device)
        self._core = make_core(config, with_tracking)
        # Lazy import: fleet.py imports this module at load time.
        from repro_torch.core.pipeline.fleet import WireStats, make_wire_fn

        self.wire_stats = WireStats()
        self._wire = make_wire_fn(config.use_kernels) if wire == "ragged" else None
        self._tag_limit = tag_limit(config)
        self.state = self.init_state() if state is None else state

    def init_state(self) -> StreamState:
        return StreamState(
            pending=(_EMPTY, _EMPTY, _EMPTY, _EMPTY),
            events_consumed=0,
            next_tag=0,
            atlas=make_atlas(self.config, device=self.device),
            tracks=init_tracks(self.config.tracker, self.device),
        )

    def feed(
        self, x: np.ndarray, y: np.ndarray, t: np.ndarray, p: np.ndarray
    ) -> ScanResult:
        """Ingest a raw event chunk; process and return the closed windows.

        Events must be time-sorted within the chunk and non-decreasing
        across feeds; a violating chunk raises ``ValueError`` before any
        state changes. A feed may close no window: the result is then
        empty and the events wait in the remainder. A feed that would
        close more windows than one tag epoch can address raises
        ``ValueError`` without absorbing the chunk.
        """
        merged = monotone_merge(self.state.pending, x, y, t, p, self.state.last_t)
        bounds, consumed = dual_threshold_closed_bounds(merged[2], self.config.batcher)
        return self._emit(merged, bounds, consumed)

    def feed_chunk(
        self, chunk: tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray] | None
    ) -> ScanResult:
        """:meth:`feed` over an ``(x, y, t, p)`` tuple; ``None`` is an
        idle (empty) feed."""
        if chunk is None:
            chunk = (_EMPTY, _EMPTY, _EMPTY, _EMPTY)
        return self.feed(*chunk)

    @property
    def backlog(self) -> int:
        """Events absorbed but not yet windowed (the batcher remainder)."""
        return self.state.pending_count

    def flush(self) -> ScanResult:
        """Close and process the trailing partial window (end of stream).
        The pipeline keeps accepting feeds afterwards."""
        pending = self.state.pending
        bounds = dual_threshold_bounds(pending[2], self.config.batcher)
        return self._emit(pending, bounds, len(pending[2]))

    def _emit(self, pending, bounds, consumed: int) -> ScanResult:
        n = len(bounds)
        if n > self._tag_limit:
            # Refuse before touching any state: the stream stays usable
            # and the chunk can be re-fed in pieces.
            raise ValueError(
                f"feed closed {n} windows, more than one tag epoch "
                f"({self._tag_limit}) can address; split the feed"
            )
        st = self.state
        px, py, pt, pp = pending
        last_t = int(pt[-1]) if len(pt) else st.last_t
        cap = self.config.batcher.capacity
        bounds3 = [(s, e, int(pt[s])) for s, e in bounds]
        stats = self.wire_stats
        if self.wire == "ragged" and n:
            wire, starts, stops, t_start, overflow = pack_wire(px, py, pt, pp, bounds3, cap)
            with record_function("wire decode"):
                packed, valid = self._wire(*wire_tensors(wire, self.device), cap)
            batch = EventBatch(packed[0, 0], packed[1, 0], packed[2, 0], packed[3, 0], valid[0])
            windows = WindowedEvents(batch, t_start, starts, stops, overflow)
            stats.wire_bytes += ragged_wire_bytes(wire[0].shape[0], 1, n, wire[4].shape[1])
            stats.spilled += int((wire[4][0] != SPILL_SENTINEL).sum())
        else:
            windows = pack_bounds(px, py, pt, pp, bounds3, cap, self.device)
            if n:
                stats.wire_bytes += dense_wire_bytes(1, n, cap)
        if n:
            stats.rounds += 1
            stats.events += int(np.minimum(windows.stops - windows.starts, cap).sum())
            stats.dense_bytes += dense_wire_bytes(1, n, cap)
        # Slice indices are stream-global, like pad_windows over the
        # whole recording.
        windows = windows._replace(
            starts=windows.starts + st.events_consumed,
            stops=windows.stops + st.events_consumed,
        )
        if n == 0:
            self.state = dataclasses.replace(st, pending=pending, last_t=last_t)
            return empty_scan_result(self.config, self.with_tracking, st.tracks, windows)

        atlas, tag0 = st.atlas, st.next_tag
        if tag0 + n > self._tag_limit:  # tag epoch rollover
            atlas, tag0 = torch.zeros_like(atlas), 0
        final, clusters, mets, states, atlas = self._core(windows.batch, st.tracks, atlas, tag0)
        self.state = StreamState(
            pending=(px[consumed:], py[consumed:], pt[consumed:], pp[consumed:]),
            events_consumed=st.events_consumed + consumed,
            next_tag=tag0 + n,
            atlas=atlas,
            tracks=final,
            last_t=last_t,
        )
        return ScanResult(
            t_start_us=windows.t_start_us,
            clusters=clusters,
            metrics=mets,
            tracks=states if self.with_tracking else None,
            final_tracks=final if self.with_tracking else None,
            windows=windows,
        )
