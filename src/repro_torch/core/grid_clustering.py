"""Grid clustering (Schikuta 1996) for streaming event windows.

The port of ``repro.core.grid_clustering``: :func:`quantize` is the
stateless spatial quantization (the paper's FPGA IP core, ``cell = coord
// cell_size``), :func:`quantize_packed` the same on the 32-bit wire word;
:func:`cell_histogram` plus :func:`clusters_from_histogram` (together
:func:`form_clusters`, or :func:`grid_cluster`) form the per-cell
clusters, thresholded at ``min_events`` and kept as the top-K cells by
count. Every function takes a leading window axis
``(..., E)`` / ``(..., K)``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.events import EventBatch, pack_words, unpack_words

DEFAULT_CELL_SIZE = 16  # paper: "grid size is fixed to 16x16"
DEFAULT_MIN_EVENTS = 5  # paper Table IV
DEFAULT_MAX_CLUSTERS = 32


@dataclasses.dataclass(frozen=True)
class GridConfig:
    width: int = 640
    height: int = 480
    cell_size: int = DEFAULT_CELL_SIZE
    min_events: int = DEFAULT_MIN_EVENTS
    max_clusters: int = DEFAULT_MAX_CLUSTERS

    @property
    def grid_w(self) -> int:
        return -(-self.width // self.cell_size)

    @property
    def grid_h(self) -> int:
        return -(-self.height // self.cell_size)

    @property
    def n_cells(self) -> int:
        return self.grid_w * self.grid_h


class Clusters(NamedTuple):
    """Fixed-capacity cluster sets; leaves ``(..., K)`` (K = max_clusters)."""

    centroid_x: torch.Tensor  # float32
    centroid_y: torch.Tensor  # float32
    centroid_t: torch.Tensor  # float32 mean event time (us, window-relative)
    count: torch.Tensor  # int32 events contributing
    cell_x: torch.Tensor  # int32 grid cell column
    cell_y: torch.Tensor  # int32 grid cell row
    valid: torch.Tensor  # bool: count >= min_events

    def num_valid(self) -> torch.Tensor:
        return self.valid.sum(-1, dtype=torch.int32)


def quantize(
    x: torch.Tensor, y: torch.Tensor, cell_size: int = DEFAULT_CELL_SIZE
) -> tuple[torch.Tensor, torch.Tensor]:
    """Spatial quantization: a shift for power-of-two cells, else floor
    division (both floor negative coordinates, as the reference does)."""
    if cell_size & (cell_size - 1) == 0:
        shift = cell_size.bit_length() - 1
        return (x >> shift).to(torch.int32), (y >> shift).to(torch.int32)
    div = lambda a: torch.div(a, cell_size, rounding_mode="floor").to(torch.int32)
    return div(x), div(y)


def quantize_packed(words: torch.Tensor, cell_size: int = DEFAULT_CELL_SIZE) -> torch.Tensor:
    """The IP core end to end on the 32-bit wire word: unpack (bit slice),
    quantize, repack. Plain tensor ops, as the reference's is plain
    ``jnp``; the ``grid_quantize_packed`` kernel computes the same words.
    Returns the packed cell words in int64 (:func:`pack_words`)."""
    x, y = unpack_words(words)
    return pack_words(*quantize(x, y, cell_size))


def cell_histogram(
    batch: EventBatch, config: GridConfig
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-cell count, sum_x, sum_y, sum_t over ``(..., E)`` windows.

    Events outside the sensor are masked out of the weights, never
    clipped into a neighbouring cell. The four float32 sums are sums of
    integers below 2^24, so they are exact whatever the order.
    """
    e = batch.x.shape[-1]
    lead = batch.x.shape[:-1]
    cx, cy = quantize(batch.x, batch.y, config.cell_size)
    inb = (
        (batch.x >= 0) & (batch.x < config.width)
        & (batch.y >= 0) & (batch.y < config.height)
    )
    w = (batch.valid & inb).to(torch.float32)
    flat = torch.clamp(cy * config.grid_w + cx, 0, config.n_cells - 1)
    stats = torch.stack([w, w * batch.x, w * batch.y, w * batch.t], dim=-1)
    rows = flat.reshape(-1, e).to(torch.int64)
    rows = rows + config.n_cells * torch.arange(
        rows.shape[0], device=rows.device
    )[:, None]
    acc = torch.zeros(
        (rows.shape[0] * config.n_cells, 4), dtype=torch.float32, device=w.device
    ).index_add_(0, rows.reshape(-1), stats.reshape(-1, 4))
    acc = acc.reshape(*lead, config.n_cells, 4)
    return acc[..., 0].to(torch.int32), acc[..., 1], acc[..., 2], acc[..., 3]


def _top_k_cells(count: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``'s contract: values descending, ties to the lowest
    index. ``torch.topk`` breaks ties otherwise, so this is a stable
    descending sort cut to K."""
    vals, idx = torch.sort(count, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def clusters_from_histogram(
    count: torch.Tensor,
    sum_x: torch.Tensor,
    sum_y: torch.Tensor,
    sum_t: torch.Tensor,
    config: GridConfig,
) -> Clusters:
    """Threshold cells and emit the top-K clusters by event count."""
    top_count, top_idx = _top_k_cells(count, config.max_clusters)
    valid = top_count >= config.min_events
    denom = torch.clamp_min(top_count.to(torch.float32), 1.0)
    gather = lambda a: torch.gather(a, -1, top_idx.to(torch.int64))
    neg = lambda a, fill: torch.where(valid, a, fill)
    return Clusters(
        centroid_x=neg(gather(sum_x) / denom, -1.0),
        centroid_y=neg(gather(sum_y) / denom, -1.0),
        centroid_t=neg(gather(sum_t) / denom, -1.0),
        count=neg(top_count, 0).to(torch.int32),
        cell_x=neg(top_idx % config.grid_w, -1).to(torch.int32),
        cell_y=neg(top_idx // config.grid_w, -1).to(torch.int32),
        valid=valid,
    )


def form_clusters(batch: EventBatch, config: GridConfig) -> Clusters:
    """The paper's client-side cluster formation, single pass."""
    return clusters_from_histogram(*cell_histogram(batch, config), config)


def grid_cluster(batch: EventBatch, config: GridConfig = GridConfig()) -> Clusters:
    """End-to-end grid clustering of event windows (quantize + form) on
    the batch's device: the Table I entry of the paper's method."""
    return form_clusters(batch, config)


def merge_adjacent(clusters: Clusters, config: GridConfig) -> Clusters:
    """Merge each cluster into its heaviest 8-adjacent cluster (ties to
    the lowest index), weight-averaging centroids; fixed shape, O(K^2)."""
    del config  # the reference keeps it for signature symmetry
    k = clusters.count.shape[-1]
    dev = clusters.count.device
    ar = torch.arange(k, device=dev)
    dx = torch.abs(clusters.cell_x[..., :, None] - clusters.cell_x[..., None, :])
    dy = torch.abs(clusters.cell_y[..., :, None] - clusters.cell_y[..., None, :])
    adjacent = (
        (dx <= 1) & (dy <= 1)
        & clusters.valid[..., :, None] & clusters.valid[..., None, :]
    )
    counts = clusters.count.to(torch.float32)
    score = torch.where(adjacent, counts[..., None, :], -1.0)
    parent = torch.argmax(score - 1e-6 * ar.to(torch.float32), dim=-1)
    parent = torch.where(clusters.valid, parent, ar)
    is_root = parent == ar
    onehot = torch.nn.functional.one_hot(parent, k).to(torch.float32)  # (child, root)
    w = counts * clusters.valid
    mix = lambda v: (v[..., None, :] @ onehot)[..., 0, :]
    merged_count = mix(w).to(torch.int32)
    merged_x = mix(w * clusters.centroid_x)
    merged_y = mix(w * clusters.centroid_y)
    merged_t = mix(w * clusters.centroid_t)
    denom = torch.clamp_min(merged_count.to(torch.float32), 1.0)
    valid = is_root & clusters.valid & (merged_count >= 1)
    neg = lambda a, fill: torch.where(valid, a, fill)
    return Clusters(
        centroid_x=neg(merged_x / denom, -1.0),
        centroid_y=neg(merged_y / denom, -1.0),
        centroid_t=neg(merged_t / denom, -1.0),
        count=neg(merged_count, 0).to(torch.int32),
        cell_x=neg(clusters.cell_x, -1).to(torch.int32),
        cell_y=neg(clusters.cell_y, -1).to(torch.int32),
        valid=valid,
    )
