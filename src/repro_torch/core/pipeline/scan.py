"""The step core with a carry, and the whole-recording driver.

The port of ``repro.core.pipeline.scan``. The central object is the step
core built by :func:`make_core`:

    core(batch, state, atlas, tag0) -> (final, clusters, mets, states, atlas)

over ``(W, E)`` windows of one sensor or ``(S, W, E)`` windows of a
fleet: conditioning, clustering and metrics run over the flattened
windows in blocks of :data:`WINDOW_BLOCK` on the device, then the
tracker, the one stage with a carry, runs from ``state`` as a loop over
the window axis, every sensor at once. The reference's straight core
(``use_kernels`` / ``metrics_impl="kernel"``) and its fixed-point core
(``numerics="fixed"``, staged or megakernel) are ported; the atlas event
core is not yet, so the persistent atlas rides the carry untouched, as
on the reference's straight route, in the reference's shape, so carries
convert across the two packages. :func:`run_recording_scan` is one core
call over a whole recording with a fresh carry; the streaming and fleet
drivers call it feed after feed.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core.events import EventBatch, WindowedEvents, pad_windows
from repro_torch.core.grid_clustering import Clusters
from repro_torch.core.pipeline.config import (
    PipelineConfig,
    _histogram_fn,
    _metrics_fn,
    check_supported,
)
from repro_torch.core.pipeline.window_core import _fixed_window_core, _window_core
from repro_torch.core.tracking import TrackState, init_tracks, track_recording

if TYPE_CHECKING:
    from repro_torch.data.synthetic import Recording

# Windows per block through the stateless stages: bounds the device
# memory of one block (about 4 MB of event planes per 1024 windows)
# while keeping a launch per kernel per block.
WINDOW_BLOCK = 4096


@dataclasses.dataclass
class ScanResult:
    """Stacked outputs: ``clusters`` leaves and ``metrics`` values are
    ``(W, K)``; ``tracks`` leaves (with tracking on) are ``(W, T)``, the
    state after each window. Tensors stay on the run's device."""

    t_start_us: np.ndarray  # (W,) int64
    clusters: Clusters  # leaves (W, K)
    metrics: dict[str, torch.Tensor]  # (W, K)
    tracks: TrackState | None  # leaves (W, T)
    final_tracks: TrackState | None
    windows: WindowedEvents

    @property
    def num_windows(self) -> int:
        return int(self.t_start_us.shape[0])


def atlas_shape(config: PipelineConfig, capacity: int | None = None) -> tuple[int, int]:
    """Shape of the persistent tagged event surface for this config (the
    reference's, so carries convert across the two packages)."""
    cap = config.batcher.capacity if capacity is None else capacity
    return (config.grid.height + 1, max(config.grid.width, cap))


def make_atlas(
    config: PipelineConfig,
    capacity: int | None = None,
    device: str | torch.device = DEFAULT_DEVICE,
) -> torch.Tensor:
    """Fresh (all-stale) tagged event atlas; rides the stream's carry."""
    return torch.zeros(atlas_shape(config, capacity), dtype=torch.int32,
                       device=resolve_device(device))


def make_core(config: PipelineConfig, with_tracking: bool = True):
    """The step core for ``config``:

        core(batch, state, atlas, tag0) ->
            (final, clusters, mets, states, atlas)

    ``batch`` leaves are ``(W, E)`` or ``(S, W, E)``, ``state`` leaves
    ``(T,)`` or ``(S, T)``. Returns the tracker state after the last
    window, ``(..., W, K)`` clusters and metrics, the ``(..., W, T)``
    state after each window (``None`` without tracking; ``final`` is then
    ``state``) and the atlas, untouched (``tag0`` is only for the atlas
    event core, not ported yet)."""
    check_supported(config)
    if config.numerics == "fixed":
        window_fn = lambda batch: _fixed_window_core(config, batch)  # noqa: E731
    else:
        hist_fn, metrics_fn = _histogram_fn(config), _metrics_fn(config)
        window_fn = lambda batch: _window_core(config, hist_fn, metrics_fn, batch)  # noqa: E731

    def core(batch: EventBatch, state: TrackState, atlas: torch.Tensor, tag0=0):
        del tag0
        lead = batch.x.shape[:-1]  # (..., W)
        e = batch.x.shape[-1]
        flat = EventBatch(*(a.reshape(-1, e) for a in batch))
        n = flat.x.shape[0]
        parts = [
            window_fn(EventBatch(*(a[lo:lo + WINDOW_BLOCK] for a in flat)))
            for lo in range(0, max(n, 1), WINDOW_BLOCK)
        ]
        unflat = lambda a: a.reshape(*lead, *a.shape[1:])  # noqa: E731
        clusters = Clusters(*(unflat(torch.cat(f)) for f in zip(*(p[0] for p in parts))))
        mets = {k: unflat(torch.cat([p[1][k] for p in parts])) for k in parts[0][1]}
        if not with_tracking:
            return state, clusters, mets, None, atlas
        # The tracker loops over a leading window axis, every sensor at once.
        axis = len(lead) - 1
        final, states = track_recording(
            Clusters(*(a.movedim(axis, 0) for a in clusters)),
            mets["shannon_entropy"].movedim(axis, 0), config.tracker, state,
        )
        return final, clusters, mets, TrackState(*(a.movedim(0, axis) for a in states)), atlas

    return core


def run_recording_scan(
    recording: Recording,
    config: PipelineConfig = PipelineConfig(),
    with_tracking: bool = True,
    windows: WindowedEvents | None = None,
    device: str | torch.device = DEFAULT_DEVICE,
) -> ScanResult:
    """Run the detection chain over a whole recording on ``device``.

    Windows are the reference's dual-threshold windows. Pass precomputed
    ``windows`` (from :func:`pad_windows` on the same device) to skip the
    host windowing pass.
    """
    dev = resolve_device(device)
    core = make_core(config, with_tracking)
    if windows is None:
        windows = pad_windows(
            recording.x, recording.y, recording.t, recording.p, config.batcher, dev
        )
    final, clusters, mets, states, _ = core(
        windows.batch, init_tracks(config.tracker, dev),
        make_atlas(config, windows.capacity, dev), 0,
    )
    if not with_tracking:
        final = None
    return ScanResult(
        t_start_us=windows.t_start_us,
        clusters=clusters,
        metrics=mets,
        tracks=states,
        final_tracks=final,
        windows=windows,
    )
