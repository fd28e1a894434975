"""Public wrappers around the kernels, with the JAX wrappers' contracts.

A wrapper given CPU tensors runs its kernel's plain PyTorch version
(:mod:`repro_torch.kernels.ref`); given CUDA tensors it launches the
hand-written kernel or raises. There is no fallback from one to the
other. ``LAUNCHES`` counts kernel launches per wrapper, so a run can show
that its path went through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.core import fixed_point as FX
from repro_torch.core import metrics as M
from repro_torch.core.grid_clustering import Clusters, GridConfig
from repro_torch.kernels import cluster_accum as _ca
from repro_torch.kernels import event_unpack as _eu
from repro_torch.kernels import patch_metrics as _pm
from repro_torch.kernels import ref

LAUNCHES = {
    "cluster_accum": 0, "patch_metrics": 0, "window_pipeline": 0,
    "event_unpack": 0, "grid_quantize_packed": 0, "window_entropy": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel route for device {t.device}")
    return t.device.type


def cluster_accum(
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
    """Fused quantize + per-cell count/centroid sums over ``(..., E)``
    events (integer x, y, t; bool valid). Returns count int32 and sum_x,
    sum_y, sum_t float32, each ``(..., grid_w * grid_h)``; ``width`` and
    ``height`` bound the sensor (default: the grid's extent)."""
    width = grid_w * cell_size if width is None else width
    height = grid_h * cell_size if height is None else height
    if t.is_floating_point():
        raise TypeError("cluster_accum takes integer window-relative t")
    kw = dict(cell_size=cell_size, grid_w=grid_w, grid_h=grid_h, width=width, height=height)
    if _route(x) == "cpu":
        return ref.cluster_accum_ref(x, y, t, valid, **kw)
    e = x.shape[-1]
    lead = x.shape[:-1]
    flat = lambda a, dt: a.to(dt).reshape(-1, e).contiguous()
    out = _ca.cluster_accum(
        flat(x, torch.int32), flat(y, torch.int32), flat(t, torch.int32),
        flat(valid, torch.bool), **kw,
    )
    LAUNCHES["cluster_accum"] += 1
    return tuple(a.reshape(*lead, grid_w * grid_h) for a in out)


def cluster_accum_topk(
    x: torch.Tensor,
    y: torch.Tensor,
    t: torch.Tensor,
    valid: torch.Tensor,
    grid: GridConfig,
) -> Clusters:
    """The clustering stage in one launch: over ``(W, E)`` events, what
    ``clusters_from_histogram(*cluster_accum(...), grid)`` returns, the
    ``(W, K)`` top-K clusters. On the card it takes x, y, t int32 and valid
    bool, contiguous, as the drivers hand them over (the kernel's wrapper
    raises on anything else), any E and any K in [1, n_cells]."""
    if t.is_floating_point():
        raise TypeError("cluster_accum_topk takes integer window-relative t")
    if _route(x) == "cpu":
        return ref.cluster_accum_topk_ref(x, y, t, valid, grid)
    clusters = _ca.cluster_accum_topk(x, y, t, valid, grid)
    if x.shape[0]:  # with no windows the launcher returns before launching
        LAUNCHES["cluster_accum"] += 1
    return clusters


def patch_metrics(
    batch,
    clusters,
    *,
    width: int = 640,
    height: int = 480,
    window: int | None = None,
    bins: int | None = None,
) -> dict[str, torch.Tensor]:
    """The metrics stage in one launch: six metrics per cluster over ``(W,
    E)`` windows and ``(W, K)`` clusters, the coincidence counts, leaders,
    frame normalizer and patch origins included. Returns the metric dict
    keyed by ``METRIC_NAMES``, each ``(W, K)``. On the card it takes the
    types the window core hands over (the kernel's wrapper raises on
    anything else), any E and any K."""
    window = M.WINDOW if window is None else window
    bins = M.HIST_BINS if bins is None else bins
    if _route(batch.x) == "cpu":
        return ref.patch_metrics_stage_ref(
            batch, clusters, width=width, height=height, window=window, bins=bins)
    if (window, bins) != (_pm.WINDOW, _pm.BINS):
        raise ValueError(
            f"the CUDA patch_metrics kernel is built for window={_pm.WINDOW}, "
            f"bins={_pm.BINS}; got window={window}, bins={bins}"
        )
    out = _pm.patch_metrics(batch, clusters, width=width, height=height)
    if clusters.valid.numel():  # with no slots the launcher returns before launching
        LAUNCHES["patch_metrics"] += 1
    return out


def window_pipeline(batch, config):
    """The fixed-point per-window chain over ``(W, E)`` windows, one launch
    for the whole block: conditioning, integer clustering and the integer
    metric surfaces, then the shared float epilogue. Returns
    ``(FixedClusters, metrics, surfaces)`` with ``(W, K)`` leaves, as
    :func:`repro_torch.kernels.ref.window_pipeline_ref` does. Raises
    ``ValueError`` for E > 1024 and K > 128, as the reference does."""
    from repro_torch.kernels import window_pipeline as _wp

    g = config.grid
    e = batch.x.shape[-1]
    k = g.max_clusters
    if e > _wp.MAX_EVENTS:
        raise ValueError(f"E ({e}) exceeds the megakernel's bound ({_wp.MAX_EVENTS})")
    if k > _wp.MAX_SLOTS:
        raise ValueError(f"max_clusters ({k}) must be <= {_wp.MAX_SLOTS}")
    if _route(batch.x) == "cpu":
        return ref.window_pipeline_ref(batch, config)
    fields, norm, surf = _wp.window_pipeline(
        *(a.to(torch.int32).contiguous() for a in (batch.x, batch.y, batch.t)),
        batch.valid.to(torch.bool).contiguous(),
        roi=tuple(config.roi), hot_pixel_max=config.hot_pixel_max,
        cell_size=g.cell_size, grid_w=g.grid_w, grid_h=g.grid_h,
        min_events=g.min_events, k=k, width=g.width, height=g.height,
    )
    if fields.shape[0]:  # with no windows the launcher returns before launching
        LAUNCHES["window_pipeline"] += 1
    rows = {f: fields[:, r] for r, f in enumerate(_wp.CL_FIELDS)}
    fc = FX.FixedClusters(
        **{f: rows[f] for f in FX.FixedClusters._fields if f != "valid"},
        valid=rows["valid"] != 0,
    )
    bins = _wp.BINS
    s = {"hist": surf[..., :bins], "norm_i": norm}
    s.update({f: surf[..., bins + i] for i, f in enumerate(FX.SURF_FIELDS)})
    return fc, FX.fixed_metrics_from_surfaces(fc, s), s


def event_unpack(
    words: torch.Tensor,
    dt16: torch.Tensor,
    pol: torch.Tensor,
    offsets: torch.Tensor,
    spill: torch.Tensor,
    capacity: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The ragged-wire decode: wire tensors as
    :func:`repro_torch.core.events.wire_tensors` gives them -> packed
    ``(4, S, W, capacity)`` int32 x/y/t/p planes and ``(S, W, capacity)``
    bool validity, the dense planes bit for bit. On the card it takes
    exactly those types, contiguous (the kernel's wrapper raises else)."""
    if _route(words) == "cpu":
        return ref.unpack_wire_ref(words, dt16, pol, offsets, spill, capacity)
    # The decoders hand over the wire as wire_tensors types it; the kernel's
    # wrapper checks and raises rather than converting on the hot path.
    packed, valid = _eu.event_unpack(words, dt16, pol, offsets, spill, capacity)
    if valid.numel():  # with no slots the launcher returns before launching
        LAUNCHES["event_unpack"] += 1
    return packed, valid


def grid_quantize_packed(words: torch.Tensor, cell_size: int = 16) -> torch.Tensor:
    """The paper's IP core over a 1-D stream of packed words (int32
    holding the uint32 bits): returns the packed cell words, as int32
    holding the uint32 bits."""
    if _route(words) == "cpu":
        return ref.grid_quantize_packed_ref(words, cell_size)
    from repro_torch.kernels import grid_quantize as _gq

    out = _gq.grid_quantize_packed(words.to(torch.int32).contiguous(), cell_size)
    if out.numel():
        LAUNCHES["grid_quantize_packed"] += 1
    return out


def window_entropy(
    frame: torch.Tensor,
    cx: torch.Tensor,
    cy: torch.Tensor,
    *,
    window: int = 48,
    bins: int = 32,
) -> torch.Tensor:
    """Per-cluster ``(3, K)`` [shannon, renyi, contrast] over ``window``
    slices of an ``(H, W)`` [0, 1] frame."""
    if _route(frame) == "cpu":
        return ref.window_entropy_ref(frame, cx, cy, window=window, bins=bins)
    from repro_torch.kernels import window_entropy as _we

    if (window, bins) != (_we.WINDOW, _we.BINS):
        raise ValueError(
            f"the CUDA window_entropy kernel is built for window={_we.WINDOW}, "
            f"bins={_we.BINS}; got window={window}, bins={bins}"
        )
    out = _we.window_entropy(
        frame.to(torch.float32).contiguous(),
        cx.to(torch.int32).contiguous(), cy.to(torch.int32).contiguous(),
    )
    if out.shape[1]:
        LAUNCHES["window_entropy"] += 1
    return out
