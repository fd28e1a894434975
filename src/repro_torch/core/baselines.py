"""Clustering baselines from the paper's Table I: K-Means and DBSCAN.

The port of ``repro.core.baselines``. The paper argues grid clustering
dominates both for streaming event data (O(n), single pass, no k, minimal
state); these fixed-shape versions let the comparison be timed
head-to-head on the same batches. They are plain tensor code and run on
the device the batch lies on.

* :func:`kmeans`: Lloyd's algorithm, O(n * k * i), a deterministic
  farthest-point init, masked for padded events.
* :func:`dbscan`: O(n^2) pairwise-distance density clustering; the
  labels spread over the core-point graph by an iterated min-label
  diffusion with pointer jumping, ``2 * n.bit_length()`` steps, as the
  reference runs them.

On integer pixel coordinates every distance here is an integer below
2^24, so DBSCAN is exact and k-means' distances and sums are too; the
centroids are quotients of exact sums.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.events import EventBatch


class KMeansResult(NamedTuple):
    centroids: torch.Tensor  # (k, 2) float32
    assignment: torch.Tensor  # (E,) int32, -1 for invalid events
    counts: torch.Tensor  # (k,) int32


def _points(batch: EventBatch) -> torch.Tensor:
    return torch.stack([batch.x, batch.y], dim=-1).to(torch.float32)


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, 2) x (m, 2) -> (n, m) squared distances."""
    return ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)


def kmeans(batch: EventBatch, k: int = 8, iters: int = 16) -> KMeansResult:
    """Lloyd's k-means over one ``(E,)`` window's valid events.

    The init picks the first valid event, then k - 1 times the valid
    event farthest from the centroids chosen so far (ties to the lowest
    index: ``torch.argmax`` keeps the first maximum, as ``jnp.argmax``
    does). A cluster left empty keeps its centroid.
    """
    pts = _points(batch)
    valid = batch.valid
    dev = pts.device
    big = 1e12
    ar_k = torch.arange(k, device=dev)

    cents = torch.zeros((k, 2), dtype=torch.float32, device=dev)
    cents[0] = pts[torch.argmax(valid.to(torch.int32))]
    for n_chosen in range(1, k):
        d = (_sq_dist(pts, cents) + torch.where(ar_k[None, :] < n_chosen, 0.0, big)).amin(1)
        d = torch.where(valid, d, -1.0)
        cents[n_chosen] = pts[torch.argmax(d)]

    w = valid.to(torch.float32)[:, None]
    for _ in range(iters):
        assign = torch.argmin(_sq_dist(pts, cents), dim=1)
        onehot = torch.nn.functional.one_hot(assign, k).to(torch.float32) * w
        counts = onehot.sum(0)
        sums = onehot.T @ pts
        cents = torch.where(
            counts[:, None] > 0, sums / torch.clamp_min(counts[:, None], 1.0), cents
        )
    assign = torch.argmin(_sq_dist(pts, cents), dim=1)
    assign = torch.where(valid, assign, -1).to(torch.int32)
    counts = torch.zeros(k, dtype=torch.int32, device=dev).index_add_(
        0, assign.clamp_min(0).to(torch.int64), valid.to(torch.int32)
    )
    return KMeansResult(cents, assign, counts)


class DBSCANResult(NamedTuple):
    labels: torch.Tensor  # (E,) int32 cluster label; -1 = noise/invalid
    n_clusters: torch.Tensor  # () int32
    core_mask: torch.Tensor  # (E,) bool


def dbscan(batch: EventBatch, eps: float = 8.0, min_pts: int = 5) -> DBSCANResult:
    """DBSCAN over one ``(E,)`` window's valid events.

    Core points have at least ``min_pts`` valid events within ``eps``
    (themselves included); core-core edges connect clusters, and a border
    point takes the smallest label among its core neighbours. Labels are
    compacted to ``0..C-1`` in order of each cluster's smallest core index.
    """
    pts = _points(batch)
    valid = batch.valid
    n = pts.shape[0]
    dev = pts.device
    ar = torch.arange(n, dtype=torch.int32, device=dev)
    within = (_sq_dist(pts, pts) <= eps * eps) & valid[:, None] & valid[None, :]
    core = (within.sum(-1) >= min_pts) & valid
    core_adj = within & core[:, None] & core[None, :]

    # Min-label diffusion with pointer jumping; n is the +inf sentinel.
    labels = torch.where(core, ar, n)
    for _ in range(2 * max(1, n.bit_length())):
        new = torch.minimum(labels, torch.where(core_adj, labels[None, :], n).amin(-1))
        jumped = torch.where(new < n, new[new.clamp(0, n - 1).to(torch.int64)], n)
        labels = torch.minimum(new, jumped)

    border = torch.where(within & core[None, :], labels[None, :], n).amin(-1)
    final = torch.where(core, labels, torch.where(valid & (border < n), border, -1))
    is_root = (final == ar) & core
    rank = torch.cumsum(is_root.to(torch.int32), 0, dtype=torch.int32) - 1
    compact = torch.where(final >= 0, rank[final.clamp(0, n - 1).to(torch.int64)], -1)
    return DBSCANResult(
        compact.to(torch.int32), is_root.sum().to(torch.int32), core
    )


def dbscan_centroids(
    batch: EventBatch, result: DBSCANResult, max_clusters: int = 32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster centroids ``(max_clusters, 2)`` and counts, padded with
    -1; labels at or past ``max_clusters`` are left out, as the
    reference's ``one_hot`` leaves them."""
    labels = result.labels.to(torch.int64)
    keep = (labels >= 0) & (labels < max_clusters)
    onehot = torch.nn.functional.one_hot(
        torch.where(keep, labels, 0), max_clusters
    ).to(torch.float32) * (keep & batch.valid).to(torch.float32)[:, None]
    counts = onehot.sum(0)
    sums = onehot.T @ _points(batch)
    cents = torch.where(
        counts[:, None] > 0, sums / torch.clamp_min(counts[:, None], 1.0), -1.0
    )
    return cents, counts.to(torch.int32)
