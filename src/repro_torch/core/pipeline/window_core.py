"""The per-window stage: conditioning -> clustering -> metrics.

The port of ``repro.core.pipeline.window_core``'s ``_condition``,
``_cluster`` and ``_window_core``, written over a window axis: the stages
of one window do not depend on another window's, so each runs over a
whole ``(W, E)`` block of windows at once, and each kernel launches once
per block, not once per window: on the float kernel route
(``use_kernels=True, metrics_impl="kernel"``) the clustering and the
metrics stage are one launch each. Each stage runs inside a
``torch.profiler.record_function`` range named after it, so a profile
of any entry point splits its time by stage; the fixed datapath's
megakernel runs inside one range, ``"fixed window core"``.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.profiler import record_function

from repro_torch.core.events import EventBatch, persistent_event_filter, roi_filter
from repro_torch.core.fixed_point import fixed_window_stage
from repro_torch.core.grid_clustering import Clusters, clusters_from_histogram, merge_adjacent
from repro_torch.core.pipeline.config import PipelineConfig


def _condition(config: PipelineConfig, batch: EventBatch) -> EventBatch:
    batch = roi_filter(batch, config.roi)
    return persistent_event_filter(batch, config.hot_pixel_max)


def _cluster(
    config: PipelineConfig, hist_fn: Callable[[EventBatch], tuple], batch: EventBatch
) -> Clusters:
    """Top-K clusters of ``(W, E)`` windows. Under ``use_kernels`` the
    whole stage is one kernel launch (``ops.cluster_accum_topk``); else
    ``hist_fn``'s cell rows, then :func:`clusters_from_histogram`."""
    if config.use_kernels:
        from repro_torch.kernels import ops as kops

        clusters = kops.cluster_accum_topk(batch.x, batch.y, batch.t, batch.valid, config.grid)
    else:
        clusters = clusters_from_histogram(*hist_fn(batch), config.grid)
    if config.merge_neighbors:
        clusters = merge_adjacent(clusters, config.grid)
    return clusters


def _window_core(
    config: PipelineConfig,
    hist_fn: Callable[[EventBatch], tuple],
    metrics_fn: Callable[[EventBatch, Clusters], dict[str, torch.Tensor]],
    batch: EventBatch,
) -> tuple[Clusters, dict[str, torch.Tensor]]:
    """Conditioning, clustering and metrics over ``(W, E)`` windows;
    returns ``(W, K)`` clusters and metrics."""
    with record_function("conditioning"):
        batch = _condition(config, batch)
    with record_function("clustering"):
        clusters = _cluster(config, hist_fn, batch)
    with record_function("metrics"):
        return clusters, metrics_fn(batch, clusters)


def _fixed_window_core(
    config: PipelineConfig, batch: EventBatch
) -> tuple[Clusters, dict[str, torch.Tensor]]:
    """The ``numerics="fixed"`` stage over ``(W, E)`` windows: the
    megakernel (``metrics_impl="megakernel"``) or the staged integer
    path; returns dequantized ``(W, K)`` clusters and metrics."""
    if config.metrics_impl == "megakernel":
        from repro_torch.kernels import ops as kops

        with record_function("fixed window core"):
            fc, mets, _ = kops.window_pipeline(batch, config)
    else:
        fc, mets = fixed_window_stage(config, batch)
    return fc.to_clusters(), mets
