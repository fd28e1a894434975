"""Whole-recording driver: windows on the host, the rest on the device.

The port of ``repro.core.pipeline.scan.run_recording_scan`` along the
reference's straight core (the ``use_kernels`` / ``metrics_impl="kernel"``
route) and its fixed-point core (``numerics="fixed"``, staged or
megakernel): the recording is windowed once on the host, conditioning,
clustering and metrics run over blocks of windows on the device, and the
tracker, the one stage with a carry, runs as a loop over windows on the
same device.
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
    check_supported(config)
    dev = resolve_device(device)
    if windows is None:
        windows = pad_windows(
            recording.x, recording.y, recording.t, recording.p, config.batcher, dev
        )
    if config.numerics == "fixed":
        core = lambda batch: _fixed_window_core(config, batch)  # noqa: E731
    else:
        hist_fn, metrics_fn = _histogram_fn(config), _metrics_fn(config)
        core = lambda batch: _window_core(config, hist_fn, metrics_fn, batch)  # noqa: E731
    n = windows.num_windows
    parts = [
        core(EventBatch(*(a[lo:lo + WINDOW_BLOCK] for a in windows.batch)))
        for lo in range(0, max(n, 1), WINDOW_BLOCK)
    ]
    clusters = Clusters(*(torch.cat(f) for f in zip(*(p[0] for p in parts))))
    mets = {k: torch.cat([p[1][k] for p in parts]) for k in parts[0][1]}
    final = states = None
    if with_tracking:
        final, states = track_recording(
            clusters, mets["shannon_entropy"], config.tracker,
            init_tracks(config.tracker, dev),
        )
    return ScanResult(
        t_start_us=windows.t_start_us,
        clusters=clusters,
        metrics=mets,
        tracks=states,
        final_tracks=final,
        windows=windows,
    )
