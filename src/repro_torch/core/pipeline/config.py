"""Pipeline configuration + per-stage implementation selectors.

The same fields and defaults as ``repro.core.pipeline.config``:

* ``use_kernels`` routes the clustering stage (quantization, cluster
  accumulation and the top-K clusters) through ``ops.cluster_accum_topk``
  (one launch of the ``cluster_accum`` kernel on the card), else the
  tensor scatter :func:`cell_histogram` and ``clusters_from_histogram``;
  :func:`_histogram_fn` gives the cell rows of either route;
* ``metrics_impl``: ``"event"`` (the default) routes the metrics stage
  through :func:`cluster_metrics_events`, and the scan, stream and fleet
  drivers through the atlas event core
  (:mod:`repro_torch.core.pipeline.event_core`), which also writes the
  persistent window-tagged atlas; ``"frame"`` through the frame oracle
  :func:`cluster_metrics_frame` (a sensor-sized image per window, equal
  to ``"event"`` bit for bit on one device); ``"kernel"`` through
  ``ops.patch_metrics`` (one launch of its CUDA kernel on the card);
* ``scan_chunk`` is the reference's scheduling knob for its atlas event
  core; the port's event core runs whole window blocks and accepts it,
  and no result depends on it;
* ``numerics``: ``"float"`` (default) or ``"fixed"``, the integer
  datapath of :mod:`repro_torch.core.fixed_point`. Under ``"fixed"``,
  ``metrics_impl`` selects ``"event"``/``"staged"`` (the staged integer
  path, plain torch) or ``"megakernel"`` (``ops.window_pipeline``, one
  CUDA launch per window block on the card); ``"frame"``/``"kernel"``,
  ``use_kernels`` and ``merge_neighbors`` are float-only and raise
  ``ValueError``, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.core import metrics as M
from repro_torch.core.events import DEFAULT_ROI, BatcherConfig, EventBatch
from repro_torch.core.fixed_point import _check_fixed_config
from repro_torch.core.grid_clustering import Clusters, GridConfig, cell_histogram
from repro_torch.core.tracking import TrackerConfig


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    grid: GridConfig = GridConfig()
    batcher: BatcherConfig = BatcherConfig()
    tracker: TrackerConfig = TrackerConfig()
    roi: tuple[int, int, int, int] = DEFAULT_ROI
    hot_pixel_max: int = 12
    merge_neighbors: bool = False
    use_kernels: bool = False  # route quantize+accumulate through the kernel
    metrics_impl: str = "event"  # "event" | "frame" | "kernel"; "staged" | "megakernel" when fixed
    scan_chunk: int = 8  # the reference's scheduling knob; changes no result here
    numerics: str = "float"  # "float" | "fixed"


def config_from_dict(d: dict[str, Any]) -> PipelineConfig:
    """A ``PipelineConfig`` from ``dataclasses.asdict`` of this one or of
    the reference's, with the nested configs rebuilt."""
    d = dict(d)
    d["grid"] = GridConfig(**d["grid"])
    d["batcher"] = BatcherConfig(**d["batcher"])
    d["tracker"] = TrackerConfig(**d["tracker"])
    d["roi"] = tuple(d["roi"])
    return PipelineConfig(**d)


def atlas_shape(config: PipelineConfig, capacity: int | None = None) -> tuple[int, int]:
    """Shape of the persistent tagged event surface for this config (the
    reference's, so carries convert across the two packages)."""
    cap = config.batcher.capacity if capacity is None else capacity
    return (config.grid.height + 1, max(config.grid.width, cap))


def check_supported(config: PipelineConfig) -> None:
    """Raise ``ValueError`` for an unknown ``numerics`` and for the knobs
    the fixed datapath rejects."""
    if config.numerics == "fixed":
        _check_fixed_config(config)
    elif config.numerics != "float":
        raise ValueError(f"unknown numerics: {config.numerics!r}")


def _histogram_fn(config: PipelineConfig) -> Callable[[EventBatch], tuple]:
    if config.use_kernels:
        from repro_torch.kernels import ops as kops

        g = config.grid
        return lambda batch: kops.cluster_accum(
            batch.x, batch.y, batch.t, batch.valid,
            cell_size=g.cell_size, grid_w=g.grid_w, grid_h=g.grid_h,
            width=g.width, height=g.height,
        )
    return lambda batch: cell_histogram(batch, config.grid)


def _metrics_fn(
    config: PipelineConfig,
) -> Callable[[EventBatch, Clusters], dict[str, Any]]:
    """Metrics stage over ``(W, E)`` windows for the configured route."""
    impl = config.metrics_impl
    w, h = config.grid.width, config.grid.height
    if impl == "event":
        return lambda batch, clusters: M.cluster_metrics_events(batch, clusters, w, h)
    if impl == "kernel":
        from repro_torch.kernels import ops as kops

        return lambda batch, clusters: kops.patch_metrics(batch, clusters, width=w, height=h)
    if impl == "frame":
        return lambda batch, clusters: M.cluster_metrics_frame(batch, clusters, w, h)
    raise ValueError(f"unknown metrics_impl: {impl!r}")
