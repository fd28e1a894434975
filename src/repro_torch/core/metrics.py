"""Cluster quality metrics (paper Sec. III-E).

The port of ``repro.core.metrics``: for every cluster a 48x48 count patch
around the centroid gives six statistics (Shannon and Renyi entropy of
the intensity histogram, differential entropy of the Sobel gradient
magnitude, local contrast, edge density, event count). Two routes give
them, as in the reference:

* the **frame oracle** (:func:`cluster_metrics_frame`) scatters each
  window into a sensor-sized accumulation image (:func:`accumulate_image`),
  takes its global maximum as the normalizer and slices the patches out
  of it: the paper's own data flow, O(sensor area) per window;
* the **event route** (:func:`cluster_metrics_events`) builds the patch
  and the histogram straight from the window's events; the normalizer
  comes from per-pixel coincidence counts.

Every quantity that crosses into :func:`_exact_cluster_metrics` is an
exact small integer, so the patches, histograms, moments and edge counts
match the reference exactly; only the order-dependent float reductions
(``s_g``, ``s_e2``, the entropy sums) and ``log2`` differ in the last
bits. Both routes hand that core the same ``(block, K, 48, 48)`` shapes
in the same :data:`_METRIC_BLOCK`-window blocks, so on one device they
agree bit for bit. The per-patch functions (:func:`shannon_entropy` ...
:func:`edge_density`) and the legacy :func:`cluster_metrics` work on a
normalized frame, as the reference's do; :func:`metric_matrix` and
:func:`correlation_matrix` give the paper's Fig. 7. All functions take a
leading window axis (the per-patch ones any leading axes).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.events import EventBatch, coincidence_counts
from repro_torch.core.grid_clustering import Clusters

WINDOW = 48  # paper: 48x48 pixel window
HIST_BINS = 32
EDGE_THRESHOLD = 0.25

METRIC_NAMES = (
    "shannon_entropy",
    "renyi_entropy",
    "differential_entropy",
    "local_contrast",
    "edge_density",
    "event_count",
)

# Windows per block when patches are materialized densely (the plain
# route): (block, K, 48, 48) float32 temporaries stay in the tens of MB.
_METRIC_BLOCK = 64


def window_origin(
    cx: torch.Tensor, cy: torch.Tensor, width: int, height: int, window: int = WINDOW
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-left corner of the edge-clamped patch around a centroid;
    ``torch.round`` rounds half to even like ``jnp.round``."""
    x0 = torch.clamp(torch.round(cx).to(torch.int32) - window // 2, 0, width - window)
    y0 = torch.clamp(torch.round(cy).to(torch.int32) - window // 2, 0, height - window)
    return x0.to(torch.int32), y0.to(torch.int32)


def _in_sensor(x: torch.Tensor, y: torch.Tensor, width: int, height: int) -> torch.Tensor:
    return (x >= 0) & (x < width) & (y >= 0) & (y < height)


def _accumulate(x, y, valid, width: int, height: int) -> torch.Tensor:
    """(..., H, W) per-pixel counts of ``(..., E)`` events; off-sensor
    events weigh 0 (their clipped index lands nowhere)."""
    e = x.shape[-1]
    wt = (valid & _in_sensor(x, y, width, height)).to(torch.float32).reshape(-1, e)
    flat = torch.clamp(y.to(torch.int64) * width + x, 0, width * height - 1).reshape(-1, e)
    img = torch.zeros((flat.shape[0], height * width), dtype=torch.float32, device=x.device)
    return img.scatter_add_(-1, flat, wt).reshape(*x.shape[:-1], height, width)


def accumulate_image(batch: EventBatch, width: int = 640, height: int = 480) -> torch.Tensor:
    """``(..., H, W)`` event-count image of ``(..., E)`` windows (the
    un-normalized accumulation frame). Events outside the sensor are
    masked out of the weights, not clipped into a neighbouring pixel."""
    return _accumulate(batch.x, batch.y, batch.valid, width, height)


def reconstruct_frame(batch: EventBatch, width: int = 640, height: int = 480) -> torch.Tensor:
    """Accumulate each window into an intensity frame normalized to [0, 1]."""
    img = accumulate_image(batch, width, height)
    return img / torch.clamp_min(img.amax((-2, -1), keepdim=True), 1.0)


def _slice_patches(frame: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor, window: int = WINDOW):
    """``(..., K, window, window)`` slices of ``(..., H, W)`` frames at the
    ``(..., K)`` top-left corners ``(x0, y0)``, by one gather."""
    h, w = frame.shape[-2:]
    lead = frame.shape[:-2]
    ar = torch.arange(window, device=frame.device)
    rows = (y0.to(torch.int64)[..., None] + ar) * w  # (..., K, window)
    idx = rows[..., :, None] + (x0.to(torch.int64)[..., None] + ar)[..., None, :]
    patches = torch.gather(frame.reshape(*lead, h * w), -1, idx.reshape(*lead, -1))
    return patches.reshape(*x0.shape, window, window)


def extract_window(frame: torch.Tensor, cx, cy, window: int = WINDOW) -> torch.Tensor:
    """Edge-clamped ``(window, window)`` patches of ``(..., H, W)`` frames
    centred at ``(cx, cy)``: the centres have the frames' leading axes and
    then, optionally, one of their own (``(..., K)`` centres give
    ``(..., K, window, window)``); the geometry is :func:`window_origin`'s."""
    h, w = frame.shape[-2:]
    cx = torch.as_tensor(cx, dtype=torch.float32, device=frame.device)
    cy = torch.as_tensor(cy, dtype=torch.float32, device=frame.device)
    x0, y0 = window_origin(cx, cy, w, h, window)
    if x0.dim() == frame.dim() - 2:  # one centre a frame
        return _slice_patches(frame, x0[..., None], y0[..., None], window)[..., 0, :, :]
    return _slice_patches(frame, x0, y0, window)


def _sobel(patch: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """3x3 Sobel cross-correlation over the last two axes, zero padded."""
    h, w = patch.shape[-2:]
    padded = F.pad(patch, (1, 1, 1, 1))

    def shift(dy: int, dx: int) -> torch.Tensor:
        return padded[..., dy:dy + h, dx:dx + w]

    left, right = shift(1, 0), shift(1, 2)
    up, down = shift(0, 1), shift(2, 1)
    ul, ur = shift(0, 0), shift(0, 2)
    dl, dr = shift(2, 0), shift(2, 2)
    gx = (ur - ul) + 2.0 * (right - left) + (dr - dl)
    gy = (dl - ul) + 2.0 * (down - up) + (dr - ur)
    return gx, gy


def gradient_magnitude(patch: torch.Tensor) -> torch.Tensor:
    gx, gy = _sobel(patch)
    return torch.sqrt(gx * gx + gy * gy + 1e-12)


def _diff_entropy_from_g(g: torch.Tensor) -> torch.Tensor:
    # jnp.var divides by n: no Bessel correction.
    var = torch.clamp_min(g.var((-2, -1), correction=0), 1e-12)
    return 0.5 * torch.log2(2.0 * math.pi * math.e * var)


def _edge_density_from_g(g: torch.Tensor, threshold: float = EDGE_THRESHOLD) -> torch.Tensor:
    g = g / torch.clamp_min(g.amax((-2, -1), keepdim=True), 1e-3)
    return (g > threshold).to(torch.float32).mean((-2, -1))


def differential_entropy(patch: torch.Tensor) -> torch.Tensor:
    """Gaussian-model differential entropy of gradient magnitudes:
    h = 0.5 * log2(2 pi e sigma^2)."""
    return _diff_entropy_from_g(gradient_magnitude(patch))


def local_contrast(patch: torch.Tensor) -> torch.Tensor:
    """Standard deviation (over n, as ``jnp.std``) of each patch's pixels."""
    return patch.std((-2, -1), correction=0)


def edge_density(patch: torch.Tensor, threshold: float = EDGE_THRESHOLD) -> torch.Tensor:
    """Ratio of edge pixels to all pixels (Sobel-magnitude detector, 1e-3
    normalization floor so flat patches stay edge-free)."""
    return _edge_density_from_g(gradient_magnitude(patch), threshold)


def _shannon_from_hist(p: torch.Tensor) -> torch.Tensor:
    terms = torch.where(p > 0, p * torch.log2(torch.clamp_min(p, 1e-12)), 0.0)
    return -terms.sum(-1)


def _renyi_from_hist(p: torch.Tensor) -> torch.Tensor:
    return -torch.log2(torch.clamp_min((p * p).sum(-1), 1e-12))


def _histogram_counts(patch: torch.Tensor, bins: int = HIST_BINS) -> torch.Tensor:
    """``(..., bins)`` integer intensity-histogram counts of ``(..., h, w)``
    patches in [0, 1], as float32 (exact: sums of ones)."""
    flat = patch.reshape(*patch.shape[:-2], -1)
    idx = torch.clamp((flat * bins).to(torch.int32), 0, bins - 1).to(torch.int64)
    counts = torch.zeros((*flat.shape[:-1], bins), dtype=torch.float32, device=patch.device)
    return counts.scatter_add_(-1, idx, torch.ones_like(flat))


def _histogram(patch: torch.Tensor, bins: int = HIST_BINS) -> torch.Tensor:
    """Normalized intensity histogram, ``(..., bins)``."""
    counts = _histogram_counts(patch, bins)
    return counts / torch.clamp_min(counts.sum(-1, keepdim=True), 1.0)


def shannon_entropy(patch: torch.Tensor, bins: int = HIST_BINS) -> torch.Tensor:
    """H = -sum p_i log2 p_i over the intensity histogram of each patch."""
    return _shannon_from_hist(_histogram(patch, bins))


def renyi_entropy(patch: torch.Tensor, bins: int = HIST_BINS) -> torch.Tensor:
    """H2 = -log2 sum p_i^2 (collision entropy) of each patch."""
    return _renyi_from_hist(_histogram(patch, bins))


def _exact_cluster_metrics(
    cnt_patch: torch.Tensor,  # (..., window, window) integer counts, as f32
    hist_counts: torch.Tensor,  # (..., bins) integer histogram counts, as f32
    norm: torch.Tensor,  # (...,) frame normalizer: max(global max count, 1)
    count: torch.Tensor,  # (...,) cluster event count
    valid: torch.Tensor,  # (...,) cluster validity
    moments: tuple[torch.Tensor, torch.Tensor] | None = None,  # (sum c, sum c^2)
) -> dict[str, torch.Tensor]:
    """Six metrics per cluster from its integer count patch, the same
    arithmetic as the reference step by step. Invalid slots get zeros."""
    # The reference runs under jit, where XLA turns ``a / n`` by the
    # constant pixel count into ``a * (1 / n)`` with the float32
    # reciprocal; the port computes that same product (the edge density
    # then matches to the bit).
    inv_n = float(np.float32(1.0) / np.float32(cnt_patch.shape[-1] * cnt_patch.shape[-2]))
    p = hist_counts / torch.clamp_min(hist_counts.sum(-1, keepdim=True), 1.0)

    if moments is None:
        s1 = cnt_patch.sum((-2, -1))
        s2 = (cnt_patch * cnt_patch).sum((-2, -1))
    else:
        s1, s2 = moments
    mean = s1 * inv_n
    var_c = torch.clamp_min(s2 * inv_n - mean * mean, 0.0)
    contrast = torch.sqrt(var_c) / norm

    gx, gy = _sobel(cnt_patch)
    nn = (norm * norm)[..., None, None]
    e2 = (gx * gx + gy * gy) / nn + 1e-12  # squared gradient magnitude
    g = torch.sqrt(e2)
    s_g = g.sum((-2, -1))
    s_e2 = e2.sum((-2, -1))
    mx_e2 = e2.amax((-2, -1))
    m1 = s_g * inv_n
    var_g = torch.clamp_min(s_e2 * inv_n - m1 * m1, 1e-12)
    diff_entropy = 0.5 * torch.log2(2.0 * math.pi * math.e * var_g)

    # Edge density in squared-magnitude space (sqrt is monotone); the
    # edge count is an exact integer.
    den = torch.clamp_min(torch.sqrt(mx_e2), 1e-3)
    thr = (EDGE_THRESHOLD * den) * (EDGE_THRESHOLD * den)
    edges = (e2 > thr[..., None, None]).to(torch.float32).sum((-2, -1))

    m = {
        "shannon_entropy": _shannon_from_hist(p),
        "renyi_entropy": _renyi_from_hist(p),
        "differential_entropy": diff_entropy,
        "local_contrast": contrast,
        "edge_density": edges * inv_n,
        "event_count": count.to(torch.float32),
    }
    return {k: torch.where(valid, v, 0.0) for k, v in m.items()}


def event_normalizer(batch: EventBatch, width: int, height: int):
    """Per-event coincidence counts, leaders, in-sensor weights and the
    frame normalizer (per window). Returns ``(counts, leader, weight, norm)``."""
    inb = (batch.x >= 0) & (batch.x < width) & (batch.y >= 0) & (batch.y < height)
    w = batch.valid & inb
    c, leader = coincidence_counts(batch.x, batch.y, w)
    norm = torch.clamp_min(torch.where(w, c, 0).amax(-1).to(torch.float32), 1.0)
    return c, leader, w, norm


def _in_patch(x, y, w, x0, y0, window: int):
    """(..., K, E) in-patch weights and clipped patch-relative coords."""
    rx = x[..., None, :] - x0[..., :, None]
    ry = y[..., None, :] - y0[..., :, None]
    inp = (rx >= 0) & (rx < window) & (ry >= 0) & (ry < window) & w[..., None, :]
    flat = torch.clamp(ry, 0, window - 1) * window + torch.clamp(rx, 0, window - 1)
    return inp.to(torch.float32), flat.to(torch.int64)


def _count_patches(x, y, w, x0, y0, window: int = WINDOW) -> torch.Tensor:
    """(..., K, window, window) integer count patches scattered from events."""
    inp, flat = _in_patch(x, y, w, x0, y0, window)
    patches = torch.zeros(
        (*inp.shape[:-1], window * window), dtype=torch.float32, device=inp.device
    ).scatter_add_(-1, flat, inp)
    return patches.reshape(*inp.shape[:-1], window, window)


def _leader_histogram(x, y, w, c, leader, norm, x0, y0, window: int = WINDOW, bins: int = HIST_BINS):
    """(..., K, bins) histogram counts from leader events, unoccupied
    pixels in bin 0, plus the integer moments ``(sum c, sum c^2)``."""
    inp, _ = _in_patch(x, y, w, x0, y0, window)
    val = c.to(torch.float32) / norm[..., None]
    bin_idx = torch.clamp((val * bins).to(torch.int32), 0, bins - 1).to(torch.int64)
    lead_inp = inp * leader.to(torch.float32)[..., None, :]
    hist = torch.zeros(
        (*inp.shape[:-1], bins), dtype=torch.float32, device=inp.device
    ).scatter_add_(-1, bin_idx[..., None, :].expand(inp.shape), lead_inp)
    occ = lead_inp.sum(-1)
    hist[..., 0] += window * window - occ
    s1 = inp.sum(-1)
    s2 = (lead_inp * (c * c).to(torch.float32)[..., None, :]).sum(-1)
    return hist, (s1, s2)


def event_histogram_counts(
    batch: EventBatch,
    c: torch.Tensor,
    leader: torch.Tensor,
    w: torch.Tensor,
    norm: torch.Tensor,
    x0: torch.Tensor,
    y0: torch.Tensor,
    window: int = WINDOW,
    bins: int = HIST_BINS,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Patch intensity-histogram counts straight from events, ``(..., K,
    bins)``, and the per-cluster integer moments ``(sum c, sum c^2)``."""
    return _leader_histogram(batch.x, batch.y, w, c, leader, norm, x0, y0, window, bins)


def cluster_count_patches(
    batch: EventBatch,
    clusters: Clusters,
    width: int = 640,
    height: int = 480,
    window: int = WINDOW,
) -> torch.Tensor:
    """(..., K, window, window) count patches from centroid-relative events."""
    inb = (batch.x >= 0) & (batch.x < width) & (batch.y >= 0) & (batch.y < height)
    x0, y0 = window_origin(clusters.centroid_x, clusters.centroid_y, width, height, window)
    return _count_patches(batch.x, batch.y, batch.valid & inb, x0, y0, window)


def _blocked(fn, *tensors):
    """Apply ``fn`` to ``_METRIC_BLOCK``-window slices of ``(B, ...)``
    tensors and concatenate the metric dicts it returns."""
    parts = [
        fn(*(a[lo:lo + _METRIC_BLOCK] for a in tensors))
        for lo in range(0, max(tensors[0].shape[0], 1), _METRIC_BLOCK)
    ]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def cluster_metrics_events(
    batch: EventBatch,
    clusters: Clusters,
    width: int = 640,
    height: int = 480,
) -> dict[str, torch.Tensor]:
    """Frame-free metrics over ``(W, E)`` windows and ``(W, K)`` clusters:
    normalizer from coincidence counts, histogram from leaders, moments
    from events, count patches accumulated from events."""
    return _event_metrics(batch, clusters, *event_normalizer(batch, width, height), width, height)


def _event_metrics(batch, clusters, c, leader, w, norm, width: int, height: int):
    """:func:`cluster_metrics_events` from a precomputed
    :func:`event_normalizer` (the atlas event core computes it once for
    the metrics and the atlas)."""
    x0, y0 = window_origin(clusters.centroid_x, clusters.centroid_y, width, height)

    def block(x, y, w, c, leader, norm, x0, y0, count, valid):
        hist, moments = _leader_histogram(x, y, w, c, leader, norm, x0, y0)
        patches = _count_patches(x, y, w, x0, y0)
        return _exact_cluster_metrics(
            patches, hist, norm[..., None], count, valid, moments
        )

    return _blocked(
        block, batch.x, batch.y, w, c, leader, norm, x0, y0,
        clusters.count, clusters.valid,
    )


def cluster_metrics_frame(
    batch: EventBatch,
    clusters: Clusters,
    width: int = 640,
    height: int = 480,
) -> dict[str, torch.Tensor]:
    """The frame oracle over ``(W, E)`` windows and ``(W, K)`` clusters:
    per block of :data:`_METRIC_BLOCK` windows, a sensor-sized count image
    each, its global maximum as the normalizer, each cluster's count patch
    sliced out of it and the histogram counted on the patch; then the
    shared exact core, with the event route's shapes."""
    x0, y0 = window_origin(clusters.centroid_x, clusters.centroid_y, width, height)

    def block(x, y, v, x0, y0, count, valid):
        img = _accumulate(x, y, v, width, height)  # (b, H, W): 1.2 MB a window
        norm = torch.clamp_min(img.amax((-2, -1)), 1.0)
        cnt = _slice_patches(img, x0, y0)
        hist = _histogram_counts(cnt / norm[:, None, None, None])
        return _exact_cluster_metrics(cnt, hist, norm[..., None], count, valid)

    return _blocked(
        block, batch.x, batch.y, batch.valid, x0, y0, clusters.count, clusters.valid,
    )


def cluster_metrics(frame: torch.Tensor, clusters: Clusters) -> dict[str, torch.Tensor]:
    """The legacy metrics on pre-normalized ``(B, H, W)`` frames for
    ``(B, K)`` clusters: float statistics of each sliced patch, as the
    reference's; they agree with the exact core to float tolerance, not
    bit for bit. Invalid slots get zeros."""
    patch = extract_window(frame, clusters.centroid_x, clusters.centroid_y)
    p = _histogram(patch)
    g = gradient_magnitude(patch)
    m = {
        "shannon_entropy": _shannon_from_hist(p),
        "renyi_entropy": _renyi_from_hist(p),
        "differential_entropy": _diff_entropy_from_g(g),
        "local_contrast": local_contrast(patch),
        "edge_density": _edge_density_from_g(g),
        "event_count": clusters.count.to(torch.float32),
    }
    return {k: torch.where(clusters.valid, v, 0.0) for k, v in m.items()}


def metric_matrix(metrics: dict[str, torch.Tensor]) -> torch.Tensor:
    """Stack the metric dict into ``(..., 6)`` in :data:`METRIC_NAMES` order."""
    return torch.stack([metrics[name] for name in METRIC_NAMES], dim=-1)


def correlation_matrix(samples: torch.Tensor) -> torch.Tensor:
    """Pearson correlation across the columns of ``(N, M)`` samples
    (paper Fig. 7)."""
    x = samples - samples.mean(0, keepdim=True)
    cov = (x.T @ x) / max(samples.shape[0] - 1, 1)
    std = torch.sqrt(torch.clamp_min(torch.diagonal(cov), 1e-12))
    return cov / (std[:, None] * std[None, :])
