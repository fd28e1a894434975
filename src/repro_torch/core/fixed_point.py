"""Hardware-faithful fixed-point window datapath (``numerics="fixed"``).

The port of ``repro.core.fixed_point``, written over a window axis: every
function takes ``(W, E)`` event planes and ``(W, K)`` cluster slots. Every
accumulation of the per-window chain runs in int32 (grid quantization,
cell histogram, coincidence counts, patch scatter, intensity histogram,
Sobel, moment sums, edge count); only the per-cluster scalar epilogue
(:func:`fixed_metric_epilogue`, log2/sqrt of exact integers) touches
float32.

Number formats (the reference's, DESIGN.md Sec. 12):

* all accumulators int32: per-cell ``count <= capacity``, ``sum_x <
  capacity * width``, ``sum_t < capacity * time_threshold_us``;
* centroids UQ10.8 (``CENTROID_FRAC`` fractional bits), rounded half to
  even; patch origins by one exact round-half-even division of the raw
  sums, never by re-rounding the Q10.8 centroid;
* Sobel ``|g| <= 4 * capacity``, ``g2 <= 32 * capacity^2`` and its patch
  sum ``<= 64 * capacity^2``: int32-safe for capacity <= 4096.

The megakernel (``repro_torch.kernels.ops.window_pipeline``) computes the
same integer surfaces in one launch per window block and shares
:func:`fixed_metric_epilogue`, so on one device the two routes agree to
the bit by construction.
"""
from __future__ import annotations

import math
from typing import TYPE_CHECKING, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.core import metrics as M
from repro_torch.core.events import EventBatch, coincidence_counts
from repro_torch.core.grid_clustering import Clusters, GridConfig, _top_k_cells, quantize

if TYPE_CHECKING:
    from repro_torch.core.pipeline.config import PipelineConfig

CENTROID_FRAC = 8  # UQ10.8 centroid format (1/256 px resolution)
CENTROID_ONE = 1 << CENTROID_FRAC

# The integer surfaces the epilogue consumes, besides the (W, K, bins)
# histogram and the (W,) normalizer ``norm_i``.
SURF_FIELDS = ("s1", "s2", "s_g", "s_e2", "edges")


class FixedClusters(NamedTuple):
    """Integer cluster slots, leaves ``(..., K)`` int32 (``valid`` bool).
    ``x0``/``y0`` are the 48x48 metric-patch origins."""

    cq_x: torch.Tensor  # UQ10.8 centroid column
    cq_y: torch.Tensor  # UQ10.8 centroid row
    cq_t: torch.Tensor  # UQ23.8 mean event time (us, window-relative)
    count: torch.Tensor
    cell_x: torch.Tensor
    cell_y: torch.Tensor
    x0: torch.Tensor
    y0: torch.Tensor
    valid: torch.Tensor

    def to_clusters(self) -> Clusters:
        """Dequantize to the float cluster struct; invalid slots keep the
        float path's -1 sentinels. ``cq * f32(1/256)`` is exact (``cq_t``
        < 2^24), so it equals the reference's product."""
        scale = float(np.float32(1.0 / CENTROID_ONE))

        def dq(cq: torch.Tensor) -> torch.Tensor:
            return torch.where(self.valid, cq.to(torch.float32) * scale, -1.0)

        return Clusters(
            centroid_x=dq(self.cq_x),
            centroid_y=dq(self.cq_y),
            centroid_t=dq(self.cq_t),
            count=self.count,
            cell_x=self.cell_x,
            cell_y=self.cell_y,
            valid=self.valid,
        )


def _floor_div(num: torch.Tensor, den) -> torch.Tensor:
    return torch.div(num, den, rounding_mode="floor")


def round_div_half_even(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """Exact round-half-to-even integer division for non-negative
    operands, with the reference's floor ``//``: equals ``round(num /
    den)`` for every ratio the pipeline produces."""
    q = _floor_div(num, den)
    r = num - q * den
    two_r = 2 * r
    round_up = (two_r > den) | ((two_r == den) & ((q & 1) == 1))
    return q + round_up.to(num.dtype)


def isqrt(v: torch.Tensor) -> torch.Tensor:
    """Exact integer floor-sqrt of int32 values below 2^26: the float32
    sqrt is within 1/2 of it, and one correction step each way pins it."""
    r = torch.floor(torch.sqrt(v.to(torch.float32))).to(torch.int32)
    r = r - (r * r > v).to(torch.int32)
    return r + ((r + 1) * (r + 1) <= v).to(torch.int32)


def _in_sensor(batch: EventBatch, width: int, height: int) -> torch.Tensor:
    return (batch.x >= 0) & (batch.x < width) & (batch.y >= 0) & (batch.y < height)


# ---------------------------------------------------------------------------
# Grid quantization + integer cell histogram; top-K clusters.
# ---------------------------------------------------------------------------

def cell_stats_fixed(
    batch: EventBatch, grid: GridConfig
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """int32 (count, sum_x, sum_y, sum_t) per grid cell, ``(..., n_cells)``
    each. Out-of-sensor events get weight 0; the flat index is clipped as
    the reference clips it."""
    e = batch.x.shape[-1]
    lead = batch.x.shape[:-1]
    cx, cy = quantize(batch.x, batch.y, grid.cell_size)
    w = (batch.valid & _in_sensor(batch, grid.width, grid.height)).to(torch.int32)
    flat = torch.clamp(cy * grid.grid_w + cx, 0, grid.n_cells - 1)
    stats = torch.stack([w, w * batch.x, w * batch.y, w * batch.t], dim=-1).to(torch.int32)
    rows = flat.reshape(-1, e).to(torch.int64)
    rows = rows + grid.n_cells * torch.arange(rows.shape[0], device=rows.device)[:, None]
    acc = torch.zeros(
        (rows.shape[0] * grid.n_cells, 4), dtype=torch.int32, device=w.device
    ).index_add_(0, rows.reshape(-1), stats.reshape(-1, 4))
    acc = acc.reshape(*lead, grid.n_cells, 4)
    return acc[..., 0], acc[..., 1], acc[..., 2], acc[..., 3]


def clusters_fixed_from_stats(
    count: torch.Tensor,
    sum_x: torch.Tensor,
    sum_y: torch.Tensor,
    sum_t: torch.Tensor,
    grid: GridConfig,
    width: int | None = None,
    height: int | None = None,
    window: int = M.WINDOW,
) -> FixedClusters:
    """Top-K cells (``lax.top_k``'s tie order), UQ10.8 centroids and exact
    integer patch origins. Invalid slots: count 0, cells -1, ``cq_*`` =
    -256 (the -1.0 sentinel) and origins ``clip(-1 - window // 2)``."""
    width = grid.width if width is None else width
    height = grid.height if height is None else height
    top_count, top_idx = _top_k_cells(count, grid.max_clusters)
    valid = top_count >= grid.min_events
    den = torch.clamp_min(top_count, 1)
    gather = lambda a: torch.gather(a, -1, top_idx.to(torch.int64))  # noqa: E731
    sx, sy, st = gather(sum_x), gather(sum_y), gather(sum_t)

    def q8(s: torch.Tensor) -> torch.Tensor:
        # Split form q*2^f + rdiv(r*2^f, den): no int32 overflow for any
        # sum below 2^31, and the same rounding (q*2^f is even).
        q = _floor_div(s, den)
        r = s - q * den
        return q * CENTROID_ONE + round_div_half_even(r * CENTROID_ONE, den)

    ox = torch.where(valid, round_div_half_even(sx, den), -1)
    oy = torch.where(valid, round_div_half_even(sy, den), -1)
    neg = -CENTROID_ONE
    i32 = lambda a: a.to(torch.int32)  # noqa: E731
    return FixedClusters(
        cq_x=i32(torch.where(valid, q8(sx), neg)),
        cq_y=i32(torch.where(valid, q8(sy), neg)),
        cq_t=i32(torch.where(valid, q8(st), neg)),
        count=i32(torch.where(valid, top_count, 0)),
        cell_x=i32(torch.where(valid, top_idx % grid.grid_w, -1)),
        cell_y=i32(torch.where(valid, _floor_div(top_idx, grid.grid_w), -1)),
        x0=i32(torch.clamp(ox - window // 2, 0, width - window)),
        y0=i32(torch.clamp(oy - window // 2, 0, height - window)),
        valid=valid,
    )


# ---------------------------------------------------------------------------
# Integer metric surfaces + the shared float epilogue.
# ---------------------------------------------------------------------------

def sobel_int(patch: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """3x3 Sobel over the last two axes of an int32 patch, zero padded."""
    h, w = patch.shape[-2:]
    padded = F.pad(patch, (1, 1, 1, 1))

    def shift(dy: int, dx: int) -> torch.Tensor:
        return padded[..., dy:dy + h, dx:dx + w]

    left, right = shift(1, 0), shift(1, 2)
    up, down = shift(0, 1), shift(2, 1)
    ul, ur = shift(0, 0), shift(0, 2)
    dl, dr = shift(2, 0), shift(2, 2)
    gx = (ur - ul) + 2 * (right - left) + (dr - dl)
    gy = (dl - ul) + 2 * (down - up) + (dr - ur)
    return gx, gy


def fixed_metric_epilogue(
    hist_i: torch.Tensor,  # (..., bins) int32 histogram counts
    s1: torch.Tensor,  # (...) int32 sum of patch counts
    s2: torch.Tensor,  # (...) int32 sum of squared leader counts
    s_g: torch.Tensor,  # (...) int32 sum of floor-sqrt gradient magnitudes
    s_e2: torch.Tensor,  # (...) int32 sum of squared gradient magnitudes
    edges: torch.Tensor,  # (...) int32 exact edge count
    count: torch.Tensor,  # (...) int32 cluster event count
    valid: torch.Tensor,  # (...) bool
    norm_i: torch.Tensor,  # (...) int32 frame normalizer (max coincidence)
    n: int,  # patch pixel count (window**2)
) -> dict[str, torch.Tensor]:
    """The one float stage of the fixed datapath, per cluster slot.

    Both routes (staged and megakernel) call this on the same integers.
    The reference runs it under jit, where XLA turns a division by the
    constant ``n`` into a product with the float32 reciprocal. Held
    against the jitted reference (``tests/test_torch_fixed_point.py::
    test_epilogue_matches_reference_jitted``), the product makes
    ``edge_density`` exact where true division is off by one ulp, and it
    leaves fewer one-ulp differences in ``local_contrast`` and
    ``differential_entropy`` through ``s1``, ``s2``, ``s_g`` and
    ``s_e2``; those two are not bit-exact either way (XLA lowers the
    rest of their expressions differently). So all five multiply by
    ``inv_n``. The histogram normalization and the divisions by ``norm``
    are not by a constant and stay IEEE divisions of two tensors.
    """
    inv_n = float(np.float32(1.0) / np.float32(n))
    histf = hist_i.to(torch.float32)
    p = histf / torch.clamp_min(histf.sum(-1, keepdim=True), 1.0)
    norm = norm_i.to(torch.float32)

    mean = s1.to(torch.float32) * inv_n
    var_c = torch.clamp_min(s2.to(torch.float32) * inv_n - mean * mean, 0.0)
    contrast = torch.sqrt(var_c) / norm

    m1 = (s_g.to(torch.float32) * inv_n) / norm
    m2 = (s_e2.to(torch.float32) * inv_n) / (norm * norm)
    var_g = torch.clamp_min(m2 - m1 * m1, 1e-12)
    diff_entropy = 0.5 * torch.log2(2.0 * math.pi * math.e * var_g)

    m = {
        "shannon_entropy": M._shannon_from_hist(p),
        "renyi_entropy": M._renyi_from_hist(p),
        "differential_entropy": diff_entropy,
        "local_contrast": contrast,
        "edge_density": edges.to(torch.float32) * inv_n,
        "event_count": count.to(torch.float32),
    }
    return {k: torch.where(valid, v, 0.0) for k, v in m.items()}


def fixed_metric_surfaces(
    batch: EventBatch,
    x0: torch.Tensor,
    y0: torch.Tensor,
    width: int,
    height: int,
    window: int = M.WINDOW,
    bins: int = M.HIST_BINS,
) -> dict[str, torch.Tensor]:
    """Every integer surface the epilogue consumes, for ``(W, E)`` events
    and ``(W, K)`` patch origins, plus the ``(W, K, window, window)``
    count patches. Pure int32: coincidence counts, bin index ``(c * bins)
    // norm``, patch scatter, Sobel, the exact edge compare ``16 * g2 >
    max(g2)`` and integer floor-sqrt sums."""
    i32 = torch.int32
    w = batch.valid & _in_sensor(batch, width, height)
    c, leader = coincidence_counts(batch.x, batch.y, w)
    norm_i = torch.clamp_min(torch.where(w, c, 0).amax(-1), 1).to(i32)  # (W,)
    bin_idx = torch.clamp(_floor_div(c * bins, norm_i[..., None]), 0, bins - 1)

    rx = batch.x[..., None, :] - x0[..., :, None]  # (W, K, E)
    ry = batch.y[..., None, :] - y0[..., :, None]
    inp = (rx >= 0) & (rx < window) & (ry >= 0) & (ry < window) & w[..., None, :]
    inp_i = inp.to(i32)
    lead_inp = (inp & leader[..., None, :]).to(i32)

    hist = torch.zeros((*inp.shape[:-1], bins), dtype=i32, device=inp.device).scatter_add_(
        -1, bin_idx[..., None, :].expand(inp.shape).to(torch.int64), lead_inp
    )
    occ = lead_inp.sum(-1, dtype=i32)
    hist[..., 0] += window * window - occ
    s1 = inp_i.sum(-1, dtype=i32)
    s2 = (lead_inp * (c * c)[..., None, :]).sum(-1, dtype=i32)

    pflat = torch.clamp(ry, 0, window - 1) * window + torch.clamp(rx, 0, window - 1)
    patches = torch.zeros((*inp.shape[:-1], window * window), dtype=i32, device=inp.device)
    patches = patches.scatter_add_(-1, pflat.to(torch.int64), inp_i)
    patches = patches.reshape(*inp.shape[:-1], window, window)
    gx, gy = sobel_int(patches)
    g2 = gx * gx + gy * gy
    g2max = g2.amax((-2, -1))
    return {
        "hist": hist,
        "s1": s1,
        "s2": s2,
        "s_g": isqrt(g2).sum((-2, -1), dtype=i32),
        "s_e2": g2.sum((-2, -1), dtype=i32),
        "edges": (16 * g2 > g2max[..., None, None]).sum((-2, -1), dtype=i32),
        "norm_i": norm_i,
        "patches": patches,
    }


def _surfaces_blocked(
    batch: EventBatch, x0: torch.Tensor, y0: torch.Tensor, width: int, height: int,
    window: int = M.WINDOW, bins: int = M.HIST_BINS,
) -> dict[str, torch.Tensor]:
    """:func:`fixed_metric_surfaces` over blocks of windows, without the
    patches: a 4,096-window block's patches alone would take 1.2 GB."""

    def block(x, y, t, p, valid, x0, y0):
        s = fixed_metric_surfaces(EventBatch(x, y, t, p, valid), x0, y0, width, height, window, bins)
        del s["patches"]
        return s

    return M._blocked(block, *batch, x0, y0)


def fixed_metrics_from_surfaces(
    fc: FixedClusters, surf: dict[str, torch.Tensor], window: int = M.WINDOW
) -> dict[str, torch.Tensor]:
    """The six ``(W, K)`` metrics: the epilogue over the integer surfaces."""
    return fixed_metric_epilogue(
        surf["hist"], *(surf[f] for f in SURF_FIELDS), fc.count, fc.valid,
        surf["norm_i"][..., None].expand(fc.count.shape), n=window * window,
    )


def fixed_cluster_metrics(
    batch: EventBatch,
    fc: FixedClusters,
    width: int,
    height: int,
    window: int = M.WINDOW,
    bins: int = M.HIST_BINS,
) -> dict[str, torch.Tensor]:
    """Six metrics for ``(W, K)`` cluster slots, integer datapath end to end."""
    surf = _surfaces_blocked(batch, fc.x0, fc.y0, width, height, window, bins)
    return fixed_metrics_from_surfaces(fc, surf, window)


# ---------------------------------------------------------------------------
# The window stage (the staged golden path).
# ---------------------------------------------------------------------------

def _check_fixed_config(config: PipelineConfig) -> None:
    """Raise ``ValueError`` for exactly the knobs the reference rejects
    under ``numerics="fixed"``."""
    if config.merge_neighbors:
        raise ValueError(
            "numerics='fixed' does not support merge_neighbors (the merge "
            "weight-averages float centroids); run the float path instead"
        )
    if config.use_kernels:
        raise ValueError(
            "numerics='fixed' ignores use_kernels: the staged fixed path is "
            "plain integer torch, and metrics_impl='megakernel' is the fused "
            "kernel route; set use_kernels=False"
        )
    if config.metrics_impl not in ("event", "staged", "megakernel"):
        raise ValueError(
            "numerics='fixed' supports metrics_impl 'event'/'staged' (the "
            "staged integer path) or 'megakernel' (the fused kernel); got "
            f"{config.metrics_impl!r}"
        )


def fixed_stage_surfaces(
    config: PipelineConfig, batch: EventBatch
) -> tuple[FixedClusters, dict[str, torch.Tensor]]:
    """Conditioning -> integer clustering -> integer metric surfaces over
    ``(W, E)`` windows, one tensor stage at a time."""
    from repro_torch.core.pipeline.window_core import _condition

    g = config.grid
    with record_function("conditioning"):
        batch = _condition(config, batch)
    with record_function("clustering"):
        fc = clusters_fixed_from_stats(*cell_stats_fixed(batch, g), g)
    with record_function("metrics"):
        return fc, _surfaces_blocked(batch, fc.x0, fc.y0, g.width, g.height)


def fixed_window_stage(
    config: PipelineConfig, batch: EventBatch
) -> tuple[FixedClusters, dict[str, torch.Tensor]]:
    """The staged golden path over ``(W, E)`` windows: ``(W, K)``
    :class:`FixedClusters` and the six metrics, that is
    :func:`repro_torch.kernels.ref.window_pipeline_ref` without its
    surfaces."""
    from repro_torch.kernels.ref import window_pipeline_ref

    fc, mets, _ = window_pipeline_ref(batch, config)
    return fc, mets


def make_fixed_process_window(config: PipelineConfig):
    """The per-window fixed stage returning the float cluster struct, a
    drop-in for ``make_process_window``: one ``(E,)`` window in, ``(K,)``
    clusters and metrics out. Under ``metrics_impl="megakernel"`` it is
    one ``window_pipeline`` launch a window on the card."""
    from repro_torch.core.pipeline.window_core import _fixed_window_core, _one_window

    _check_fixed_config(config)
    return _one_window(lambda batch: _fixed_window_core(config, batch))
