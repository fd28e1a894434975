"""Plain PyTorch versions of the hand-written kernels.

Each function has its kernel's contract and repeats its arithmetic step
by step. The wrappers in :mod:`repro_torch.kernels.ops` take these for
tensors on the CPU; the tests hold them against the JAX package, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core import fixed_point as FX
from repro_torch.core import metrics as M
from repro_torch.core.events import EventBatch, unpack_wire
from repro_torch.core.grid_clustering import Clusters, GridConfig, clusters_from_histogram

# The event_unpack kernel's plain version is the port's plain decoder.
unpack_wire_ref = unpack_wire


def _cells(xi, yi, valid, cell_size, grid_w, grid_h, width, height):
    """Each event's flat cell (int64) and whether it counts (valid and in
    the sensor; ``width`` and ``height`` default to the grid's extent),
    over ``(rows, E)`` coordinates. Out-of-sensor events are masked,
    never clipped into a cell."""
    width = grid_w * cell_size if width is None else width
    height = grid_h * cell_size if height is None else height
    cx = torch.div(xi, cell_size, rounding_mode="floor")
    cy = torch.div(yi, cell_size, rounding_mode="floor")
    flat = torch.clamp(cy * grid_w + cx, 0, grid_w * grid_h - 1).to(torch.int64)
    inb = (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
    return flat, valid.reshape(xi.shape) & inb


def cluster_accum_ref(
    x: torch.Tensor,
    y: torch.Tensor,
    t: torch.Tensor,
    valid: torch.Tensor,
    *,
    cell_size: int,
    grid_w: int,
    grid_h: int,
    width: int | None = None,
    height: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize + per-cell count, sum_x, sum_y, sum_t over ``(..., E)``
    events. Out-of-sensor events are masked, never clipped into a cell.
    Returns count int32 and three float32 tensors, each ``(..., n_cells)``."""
    n_cells = grid_w * grid_h
    e = x.shape[-1]
    lead = x.shape[:-1]
    xi = x.to(torch.int32).reshape(-1, e)
    yi = y.to(torch.int32).reshape(-1, e)
    flat, v = _cells(xi, yi, valid, cell_size, grid_w, grid_h, width, height)
    vf = v.to(torch.float32)

    def acc(vals: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((xi.shape[0], n_cells), dtype=vals.dtype, device=xi.device)
        return out.scatter_add_(-1, flat, vals).reshape(*lead, n_cells)

    count = acc(v.to(torch.int32))
    sum_x = acc(vf * xi.to(torch.float32))
    sum_y = acc(vf * yi.to(torch.float32))
    sum_t = acc(vf * t.reshape(-1, e).to(torch.float32))
    return count, sum_x, sum_y, sum_t


# Unit roundoff of float32.
_U32 = 2.0 ** -24


def abs_t_rows(
    x: torch.Tensor,
    y: torch.Tensor,
    t: torch.Tensor,
    valid: torch.Tensor,
    *,
    cell_size: int,
    grid_w: int,
    grid_h: int,
    width: int | None = None,
    height: int | None = None,
) -> torch.Tensor:
    """The exact sum of |t| over each cell's events, as :func:`cluster_accum_ref`
    bins them: ``(..., n_cells)`` int64. It sizes :func:`sum_t_bound`."""
    n_cells = grid_w * grid_h
    e = x.shape[-1]
    xi = x.to(torch.int64).reshape(-1, e)
    flat, v = _cells(xi, y.to(torch.int64).reshape(-1, e), valid, cell_size, grid_w, grid_h,
                     width, height)
    a = torch.where(v, t.to(torch.int64).reshape(-1, e).abs(), 0)
    out = torch.zeros((xi.shape[0], n_cells), dtype=torch.int64, device=x.device)
    return out.scatter_add_(-1, flat, a).reshape(*x.shape[:-1], n_cells)


def sum_t_bound(count: torch.Tensor, abs_t_sum: torch.Tensor) -> torch.Tensor:
    """The most two float32 routes of the cell sums may differ in sum_t,
    for a cell of ``count`` events whose |t| sum to ``abs_t_sum``.

    Below 2^24 every partial sum of integer t is exact in float32, so every
    route (the reference's per-add float32 scatter, a one-hot matmul in any
    order, the kernel's int64 sum rounded once) gives the same value: 0.
    Above it a float32 sum of n terms in any order is within (n - 1) u
    sum|t| of the exact sum (u = 2^-24, each partial sum at most sum|t|),
    and the kernel's once-rounded sum within u sum|t|: (n + 1) u sum|t|.
    Returns float64."""
    n = count.to(torch.float64).clamp_min(1.0)
    a = abs_t_sum.to(torch.float64)
    return torch.where(a < 2.0 ** 24, 0.0, (n + 1.0) * _U32 * a)


def centroid_t_bound(count: torch.Tensor, abs_t_sum: torch.Tensor) -> torch.Tensor:
    """The most two float32 routes may differ in ``centroid_t`` = sum_t /
    max(count, 1): :func:`sum_t_bound` over n, plus one rounding of each
    quotient (at most u sum|t| / n each). Zero below sum|t| = 2^24, where
    both routes divide the same exact sum. Returns float64."""
    n = count.to(torch.float64).clamp_min(1.0)
    a = abs_t_sum.to(torch.float64)
    return torch.where(a < 2.0 ** 24, 0.0, (n + 3.0) * _U32 * a / n)


def cluster_accum_topk_ref(
    x: torch.Tensor,
    y: torch.Tensor,
    t: torch.Tensor,
    valid: torch.Tensor,
    grid: GridConfig,
) -> Clusters:
    """The clustering stage the ``cluster_accum`` kernel's stage entry
    computes: :func:`cluster_accum_ref` under ``grid``, then the top-K
    clusters of :func:`clusters_from_histogram`. Returns ``(..., K)``
    clusters."""
    rows = cluster_accum_ref(
        x, y, t, valid, cell_size=grid.cell_size, grid_w=grid.grid_w, grid_h=grid.grid_h,
        width=grid.width, height=grid.height,
    )
    return clusters_from_histogram(*rows, grid)


def patch_metrics_stage_ref(
    batch: EventBatch,
    clusters: Clusters,
    *,
    width: int,
    height: int,
    window: int = M.WINDOW,
    bins: int = M.HIST_BINS,
) -> dict[str, torch.Tensor]:
    """The metrics stage the ``patch_metrics`` kernel computes over ``(W,
    E)`` events and ``(W, K)`` clusters: the frame normalizer, coincidence
    counts and leaders (:func:`event_normalizer`), the patch origins
    (:func:`window_origin`), then :func:`patch_metrics_ref` per slot.
    Returns the metric dict keyed by ``METRIC_NAMES``, each ``(W, K)``."""
    c, leader, w, norm = M.event_normalizer(batch, width, height)
    x0, y0 = M.window_origin(clusters.centroid_x, clusters.centroid_y, width, height, window)
    out = patch_metrics_ref(
        batch.x, batch.y, w, c, leader, x0, y0, clusters.count, clusters.valid, norm,
        window=window, bins=bins,
    )
    return {name: out[..., i] for i, name in enumerate(M.METRIC_NAMES)}


def patch_metrics_ref(
    x: torch.Tensor,
    y: torch.Tensor,
    w: torch.Tensor,
    c: torch.Tensor,
    leader: torch.Tensor,
    x0: torch.Tensor,
    y0: torch.Tensor,
    count: torch.Tensor,
    cvalid: torch.Tensor,
    norm: torch.Tensor,
    *,
    window: int = M.WINDOW,
    bins: int = M.HIST_BINS,
) -> torch.Tensor:
    """Six metrics per cluster slot from one event window each.

    Event tensors are ``(B, E)`` (x, y int; weight, leader bool; c the
    coincidence counts), slot tensors ``(B, K)`` (patch origins, event
    count, validity), ``norm`` ``(B,)``. Per slot: the 48x48 count patch
    scattered from in-patch weighted events, the leader histogram with
    the unoccupied pixels in bin 0, then the shared metric core with
    dense moments. Returns ``(B, K, 6)`` float32 in ``METRIC_NAMES`` order.
    """

    def block(x, y, w, c, leader, x0, y0, count, cvalid, norm):
        patches = M._count_patches(x, y, w, x0, y0, window)
        hist, _ = M._leader_histogram(x, y, w, c, leader, norm, x0, y0, window, bins)
        return M._exact_cluster_metrics(patches, hist, norm[:, None], count, cvalid)

    mets = M._blocked(block, x, y, w, c, leader, x0, y0, count, cvalid, norm)
    return torch.stack([mets[name] for name in M.METRIC_NAMES], dim=-1)


def window_pipeline_ref(batch, config):
    """The staged fixed-point path over ``(W, E)`` windows: conditioning,
    integer clustering and integer metric surfaces one tensor stage at a
    time, then the shared epilogue. Returns ``(FixedClusters, metrics,
    surfaces)`` with ``(W, K)`` leaves; ``surfaces`` holds the ``(W, K,
    bins)`` histogram, ``s1``, ``s2``, ``s_g``, ``s_e2``, ``edges`` and the
    ``(W,)`` normalizer ``norm_i``."""
    fc, surf = FX.fixed_stage_surfaces(config, batch)
    return fc, FX.fixed_metrics_from_surfaces(fc, surf), surf


def grid_quantize_packed_ref(words: torch.Tensor, cell_size: int = 16) -> torch.Tensor:
    """Packed event words -> packed cell words ``(cy << 16) | cx``, each
    16-bit field floor-divided by ``cell_size``. Takes and returns int32
    tensors that hold the uint32 bits (the arithmetic runs in int64)."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    cx = torch.div(w & 0xFFFF, cell_size, rounding_mode="floor")
    cy = torch.div((w >> 16) & 0xFFFF, cell_size, rounding_mode="floor")
    out = (cy << 16) | cx
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)


def window_entropy_ref(
    frame: torch.Tensor,
    cx: torch.Tensor,
    cy: torch.Tensor,
    *,
    window: int = 48,
    bins: int = 32,
) -> torch.Tensor:
    """Per centre, the ``window``-square slice of an ``(H, W)`` [0, 1]
    frame, its origin clipped into the frame -> ``bins``-bin Shannon
    entropy, Renyi entropy of order 2 and the population standard
    deviation. Returns ``(3, K)`` float32."""
    h, w = frame.shape
    dev = frame.device
    x0 = torch.clamp(cx.to(torch.int64) - window // 2, 0, w - window)
    y0 = torch.clamp(cy.to(torch.int64) - window // 2, 0, h - window)
    r = torch.arange(window, device=dev)
    rows = (y0[:, None] + r)[:, :, None]
    cols = (x0[:, None] + r)[:, None, :]
    flat = frame.to(torch.float32)[rows, cols].reshape(cx.shape[0], window * window)
    idx = torch.clamp((flat * bins).to(torch.int32), 0, bins - 1).to(torch.int64)
    counts = torch.zeros((cx.shape[0], bins), dtype=torch.float32, device=dev)
    counts.scatter_add_(1, idx, torch.ones_like(flat))
    p = counts / torch.clamp_min(counts.sum(-1, keepdim=True), 1.0)
    shannon = -torch.where(p > 0, p * torch.log2(torch.clamp_min(p, 1e-12)), 0.0).sum(-1)
    renyi = -torch.log2(torch.clamp_min((p * p).sum(-1), 1e-12))
    mean = flat.mean(-1, keepdim=True)
    contrast = torch.sqrt(((flat - mean) ** 2).mean(-1))
    return torch.stack([shannon, renyi, contrast])
