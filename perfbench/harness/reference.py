"""The plain reference of the detection chain, written from the paper's
definitions (Sec. III) for the benchmark's comparison.

It imports nothing of the program and takes nothing the program made: it
windows the generated event streams again, conditions and clusters every
window, computes the six metrics of every valid cluster and runs the
tracker, in plain PyTorch on any device, with the float arithmetic in the
precision it is given (float32 as the configuration states; bfloat16 for
the control). Integer work (windows, counts, cells, validity) is exact in
any precision.

* **Windows** (Sec. III-A): dual threshold. A window opens at an event
  and closes at ``size_threshold`` events or at the first event at least
  ``time_threshold_us`` after its first, whichever comes first; a live
  stream closes a window only once that is certain from the events
  already fed. Events past ``capacity`` are dropped; times are relative
  to the window's first event.
* **Conditioning**: events outside the ROI are dropped, then every event
  of a pixel firing more than ``hot_pixel_max`` times in the window.
* **Clusters** (Sec. III-B): per ``cell_size`` cell, the count and the
  mean x, y, t of its events; the ``max_clusters`` cells with most events
  (ties to the lower cell index); valid at ``min_events`` events or more.
  Invalid slots read count 0 and -1 elsewhere.
* **Metrics** (Sec. III-E), per valid cluster, on the 48x48 patch of
  per-pixel event counts around the rounded centroid (clamped inside the
  sensor), scaled by the window's largest pixel count: Shannon and Renyi
  entropy of its 32-bin intensity histogram, the Gaussian differential
  entropy of the Sobel magnitude (zero padded), the contrast (standard
  deviation over the patch), the edge density (share of pixels whose
  magnitude exceeds a quarter of the patch's largest, floored at 1e-3)
  and the event count. Invalid slots read 0.
* **Tracker** (Sec. III-D): constant-velocity alpha-beta tracks. Tracks
  in index order take the nearest free valid cluster within the gate;
  matched tracks update, the others coast and count a miss, and a track
  past ``max_misses`` misses is dropped. A cluster counts as taken when
  the highest-index track that points at it (an unmatched track points
  at slot 0) matched it; free slots then take the free clusters in index
  order, as new tracks. Entropy is an EMA (0.7 / 0.3) of the matched
  cluster's Shannon entropy.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

PATCH = 48
BINS = 32
EDGE = 0.25
CLUSTER_FIELDS = ("centroid_x", "centroid_y", "centroid_t", "count", "cell_x", "cell_y", "valid")
METRICS = ("shannon_entropy", "renyi_entropy", "differential_entropy",
           "local_contrast", "edge_density", "event_count")
TRACK_FIELDS = ("x", "y", "vx", "vy", "hits", "misses", "age", "active", "entropy")
_WINDOW_BLOCK = 16384
_SLOT_BLOCK = 4096


@dataclasses.dataclass(frozen=True)
class Params:
    """The configuration's sizes, as its file states them."""

    width: int
    height: int
    cell_size: int
    min_events: int
    max_clusters: int
    time_threshold_us: int
    size_threshold: int
    capacity: int
    roi: tuple[int, int, int, int]
    hot_pixel_max: int
    gate: float
    alpha: float
    beta: float
    confirm_hits: int
    max_misses: int
    max_tracks: int

    @classmethod
    def from_config(cls, pipeline: dict) -> "Params":
        if pipeline["numerics"] != "float" or pipeline["merge_neighbors"]:
            raise ValueError("the reference is the float chain without neighbour merging")
        g, b, t = pipeline["grid"], pipeline["batcher"], pipeline["tracker"]
        return cls(g["width"], g["height"], g["cell_size"], g["min_events"], g["max_clusters"],
                   b["time_threshold_us"], b["size_threshold"], b["capacity"],
                   tuple(pipeline["roi"]), pipeline["hot_pixel_max"], t["gate"], t["alpha"],
                   t["beta"], t["confirm_hits"], t["max_misses"], t["max_tracks"])

    @property
    def grid_w(self) -> int:
        return -(-self.width // self.cell_size)

    @property
    def n_cells(self) -> int:
        return self.grid_w * -(-self.height // self.cell_size)


def windows(t: np.ndarray, p: Params, final: bool) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dual-threshold windows of a time-sorted stream: ``(starts, stops,
    ready)``, ``ready[i]`` the number of events that must have been fed
    before window ``i`` is certain. ``final``: the trailing partial window
    closes at the last event (a recording); otherwise it stays open (a
    live stream)."""
    n = len(t)
    starts, stops, ready = [], [], []
    start = 0
    while start < n:
        by_size = start + p.size_threshold
        by_time = int(np.searchsorted(t, t[start] + p.time_threshold_us, side="left"))
        if by_time < n or by_size <= n:
            stop = min(by_size, by_time)
            ready.append(min(by_time + 1, by_size))
        elif final:
            stop = n
            ready.append(n)
        else:
            break
        starts.append(start)
        stops.append(stop)
        start = stop
    as64 = lambda a: np.asarray(a, np.int64)  # noqa: E731
    return as64(starts), as64(stops), as64(ready)


def pack(ev, starts: np.ndarray, stops: np.ndarray, capacity: int, device) -> dict:
    """``(W, capacity)`` planes of the windows: x, y, t relative to each
    window's first event, and valid; events past capacity dropped."""
    w = len(starts)
    n = np.minimum(stops - starts, capacity)
    rows = np.repeat(np.arange(w), n)
    cols = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
    src = np.repeat(starts, n) + cols
    out = {k: np.zeros((w, capacity), np.int64) for k in ("x", "y", "t")}
    valid = np.zeros((w, capacity), bool)
    out["x"][rows, cols] = ev.x[src]
    out["y"][rows, cols] = ev.y[src]
    out["t"][rows, cols] = ev.t[src] - ev.t[np.repeat(starts, n)]
    valid[rows, cols] = True
    planes = {k: torch.from_numpy(v).to(device) for k, v in out.items()}
    planes["valid"] = torch.from_numpy(valid).to(device)
    return planes


def _pixel_counts(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, width: int) -> torch.Tensor:
    """``(W, E)``: how many ``mask`` events of its window share each
    event's pixel (0 off the mask)."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    key = (rows * (1 << 32) + y * width + x)[mask]
    _, inv, cnt = torch.unique(key, return_inverse=True, return_counts=True)
    out = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    out[mask] = cnt[inv]
    return out


def condition(planes: dict, p: Params) -> tuple[torch.Tensor, torch.Tensor]:
    """Conditioned validity ``(W, E)`` and each window's largest pixel
    count (at least 1)."""
    x, y = planes["x"], planes["y"]
    x0, y0, x1, y1 = p.roi
    roi = planes["valid"] & (x >= x0) & (x < x1) & (y >= y0) & (y < y1)
    inside = (x >= 0) & (x < p.width) & (y >= 0) & (y < p.height)
    cnt = _pixel_counts(x, y, roi & inside, p.width)
    keep = roi & inside & (cnt <= p.hot_pixel_max)
    # Every event of a kept pixel is kept, so its count stands.
    norm = torch.where(keep, cnt, 0).amax(-1).clamp_min(1)
    return keep, norm


def cluster(planes: dict, keep: torch.Tensor, p: Params, dtype) -> tuple[dict, torch.Tensor]:
    """``(W, K)`` clusters of the conditioned windows, and per window the
    number of cells at ``min_events`` or more."""
    x, y, t = planes["x"], planes["y"], planes["t"]
    cell = (y // p.cell_size) * p.grid_w + x // p.cell_size
    cell = torch.where(keep, cell, 0)
    w = keep.to(torch.int64)
    acc = lambda v: torch.zeros((x.shape[0], p.n_cells), dtype=torch.int64,  # noqa: E731
                                device=x.device).scatter_add_(1, cell, v * w)
    count, sx, sy, st = acc(torch.ones_like(x)), acc(x), acc(y), acc(t)
    top, idx = torch.sort(count, dim=1, descending=True, stable=True)
    top, idx = top[:, :p.max_clusters], idx[:, :p.max_clusters]
    valid = top >= p.min_events
    denom = top.clamp_min(1).to(dtype)
    mean = lambda s: torch.where(valid, s.gather(1, idx).to(dtype) / denom, -1.0).to(dtype)  # noqa: E731
    out = dict(
        centroid_x=mean(sx), centroid_y=mean(sy), centroid_t=mean(st),
        count=torch.where(valid, top, 0),
        cell_x=torch.where(valid, idx % p.grid_w, -1),
        cell_y=torch.where(valid, idx // p.grid_w, -1),
        valid=valid,
    )
    return out, (count >= max(p.min_events, 1)).sum(1)


def _sobel(c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    z = F.pad(c, (1, 1, 1, 1))
    s = lambda dy, dx: z[:, dy:dy + PATCH, dx:dx + PATCH]  # noqa: E731
    gx = (s(0, 2) - s(0, 0)) + 2.0 * (s(1, 2) - s(1, 0)) + (s(2, 2) - s(2, 0))
    gy = (s(2, 0) - s(0, 0)) + 2.0 * (s(2, 1) - s(0, 1)) + (s(2, 2) - s(0, 2))
    return gx, gy


def slot_metrics(x, y, keep, norm, cx, cy, count, p: Params, dtype) -> tuple[dict, torch.Tensor, torch.Tensor]:
    """The six metrics of ``N`` valid slots, each given its window's
    events ``(N, E)``, normalizer and centroid; with the events inside
    each patch and its candidate pixels (an event within one pixel)."""
    half = PATCH // 2
    ox = (torch.round(cx).to(torch.int64) - half).clamp(0, p.width - PATCH)
    oy = (torch.round(cy).to(torch.int64) - half).clamp(0, p.height - PATCH)
    rx, ry = x - ox[:, None], y - oy[:, None]
    inp = keep & (rx >= 0) & (rx < PATCH) & (ry >= 0) & (ry < PATCH)
    flat = (ry.clamp(0, PATCH - 1) * PATCH + rx.clamp(0, PATCH - 1))
    counts = torch.zeros((x.shape[0], PATCH * PATCH), dtype=torch.float32, device=x.device)
    counts.scatter_add_(1, flat, inp.to(torch.float32))
    occupied = (counts > 0).to(torch.float32).view(-1, 1, PATCH, PATCH)
    candidates = (F.max_pool2d(occupied, 3, stride=1, padding=1) > 0).sum((1, 2, 3))

    n = float(PATCH * PATCH)
    c = counts.to(dtype)
    nrm = norm.to(dtype)[:, None]
    v = c / nrm
    b = (v * BINS).to(torch.int64).clamp(0, BINS - 1)
    hist = torch.zeros((c.shape[0], BINS), dtype=torch.int64, device=c.device)
    hist.scatter_add_(1, b, torch.ones_like(b))
    pr = hist.to(dtype) / n
    shannon = -torch.where(pr > 0, pr * torch.log2(pr.clamp_min(1e-12)), 0.0).sum(1)
    renyi = -torch.log2((pr * pr).sum(1).clamp_min(1e-12))
    mean = c.sum(1) / n
    contrast = torch.sqrt(((c * c).sum(1) / n - mean * mean).clamp_min(0.0)) / nrm[:, 0]
    gx, gy = _sobel(c.view(-1, PATCH, PATCH))
    e2 = (gx * gx + gy * gy) / (nrm * nrm)[:, :, None] + 1e-12
    g = torch.sqrt(e2)
    m1 = g.sum((1, 2)) / n
    var_g = (e2.sum((1, 2)) / n - m1 * m1).clamp_min(1e-12)
    diff = 0.5 * torch.log2(2.0 * math.pi * math.e * var_g)
    den = torch.sqrt(e2.amax((1, 2))).clamp_min(1e-3)
    thr = (EDGE * den) * (EDGE * den)
    edge = (e2 > thr[:, None, None]).sum((1, 2)).to(dtype) / n
    mets = dict(shannon_entropy=shannon, renyi_entropy=renyi, differential_entropy=diff,
                local_contrast=contrast, edge_density=edge, event_count=count.to(dtype))
    return mets, inp.sum(1), candidates


def window_stages(planes: dict, p: Params, dtype) -> dict:
    """Conditioning, clusters and metrics of ``(W, E)`` windows, and the
    per-window figures the cost counts read."""
    keep, norm = condition(planes, p)
    cl, n_cand = cluster(planes, keep, p, dtype)
    w_count, k = cl["valid"].shape
    mets = {m: torch.zeros((w_count, k), dtype=dtype, device=keep.device) for m in METRICS}
    in_patch = torch.zeros(w_count, dtype=torch.int64, device=keep.device)
    cand = torch.zeros(w_count, dtype=torch.int64, device=keep.device)
    wi, ki = cl["valid"].nonzero(as_tuple=True)
    for lo in range(0, len(wi), _SLOT_BLOCK):
        sw, sk = wi[lo:lo + _SLOT_BLOCK], ki[lo:lo + _SLOT_BLOCK]
        got, inp, cnd = slot_metrics(
            planes["x"][sw], planes["y"][sw], keep[sw], norm[sw],
            cl["centroid_x"][sw, sk], cl["centroid_y"][sw, sk], cl["count"][sw, sk], p, dtype)
        for m in METRICS:
            mets[m][sw, sk] = got[m]
        in_patch.index_add_(0, sw, inp)
        cand.index_add_(0, sw, cnd)
    return dict(
        clusters=cl, metrics=mets,
        figures=dict(events=planes["valid"].sum(1), kept=keep.sum(1), cells=n_cand,
                     slots=cl["valid"].sum(1), in_patch=in_patch, candidates=cand),
    )


def _greedy(cost: torch.Tensor, gate: float) -> torch.Tensor:
    """``(B, T, K)`` costs -> ``(B, T)`` cluster of each track or -1:
    tracks in index order take the cheapest cluster still free (the
    first on ties) if it lies within the gate."""
    b, t, k = cost.shape
    taken = torch.zeros((b, k), dtype=cost.dtype)
    out = torch.full((b, t), -1, dtype=torch.int64)
    rows = torch.arange(b)
    for i in range(t):
        row = cost[:, i] + taken
        j = torch.argmin(row, dim=1)
        ok = row[rows, j] <= gate
        taken[rows[ok], j[ok]] = float("inf")
        out[ok, i] = j[ok]
    return out


def track(cx, cy, valid, entropy, lengths, p: Params, dtype) -> dict:
    """Run the tracker over ``(B, W, K)`` clusters (CPU tensors), stream
    ``b`` for its first ``lengths[b]`` windows, from fresh tracks. Returns
    the ``(B, W, T)`` state after each window (rows past a stream's end
    repeat its last state)."""
    b, w_count, k = valid.shape
    t = p.max_tracks
    z = lambda dt: torch.zeros((b, t), dtype=dt)  # noqa: E731
    st = dict(x=z(dtype), y=z(dtype), vx=z(dtype), vy=z(dtype), hits=z(torch.int32),
              misses=z(torch.int32), age=z(torch.int32), active=z(torch.bool), entropy=z(dtype))
    out = {f: torch.zeros((b, w_count, t), dtype=v.dtype) for f, v in st.items()}
    rows = torch.arange(b)[:, None]
    lengths = torch.as_tensor(lengths)
    for w in range(w_count):
        live = (lengths > w)[:, None]
        vx_, vy_, v_, ent_ = cx[:, w], cy[:, w], valid[:, w], entropy[:, w]
        px, py = st["x"] + st["vx"], st["y"] + st["vy"]
        dx = px[:, :, None] - vx_[:, None, :]
        dy = py[:, :, None] - vy_[:, None, :]
        dist = torch.sqrt(dx * dx + dy * dy)
        cost = torch.where(st["active"][:, :, None] & v_[:, None, :], dist, float("inf"))
        assign = _greedy(cost, p.gate)
        matched = assign >= 0
        ai = assign.clamp(0, k - 1)
        rx, ry = vx_.gather(1, ai) - px, vy_.gather(1, ai) - py
        nx = torch.where(matched, px + p.alpha * rx, px)
        ny = torch.where(matched, py + p.alpha * ry, py)
        nvx = torch.where(matched, st["vx"] + p.beta * rx, st["vx"])
        nvy = torch.where(matched, st["vy"] + p.beta * ry, st["vy"])
        hits = torch.where(matched, st["hits"] + 1, st["hits"])
        misses = torch.where(matched, 0, st["misses"] + st["active"].to(torch.int32))
        ent = torch.where(matched, 0.7 * st["entropy"] + 0.3 * ent_.gather(1, ai), st["entropy"])
        active = st["active"] & (misses <= p.max_misses)
        # The highest-index track pointing at a cluster decides whether it
        # is taken.
        last = torch.full((b, k), -1, dtype=torch.int64)
        for i in range(t):
            last[rows[:, 0], ai[:, i]] = i
        taken = (last >= 0) & matched.gather(1, last.clamp_min(0))
        free_det = v_ & ~taken
        free_slot = ~active
        slot_rank = free_slot.to(torch.int64).cumsum(1) - 1
        det_order = torch.sort(torch.where(free_det, torch.arange(k), k), dim=1).values
        n_free = free_det.sum(1, keepdim=True)
        spawn = free_slot & (slot_rank < n_free)
        di = det_order.gather(1, slot_rank.clamp(0, k - 1)).clamp(0, k - 1)
        nx = torch.where(spawn, vx_.gather(1, di), nx)
        ny = torch.where(spawn, vy_.gather(1, di), ny)
        nvx = torch.where(spawn, 0.0, nvx).to(dtype)
        nvy = torch.where(spawn, 0.0, nvy).to(dtype)
        hits = torch.where(spawn, 1, hits)
        misses = torch.where(spawn, 0, misses)
        ent = torch.where(spawn, ent_.gather(1, di), ent)
        age = torch.where(spawn, 0, st["age"] + active.to(torch.int32))
        active = active | spawn
        new = dict(x=nx, y=ny, vx=nvx, vy=nvy, hits=hits, misses=misses, age=age,
                   active=active, entropy=ent)
        for f in TRACK_FIELDS:
            st[f] = torch.where(live, new[f].to(st[f].dtype), st[f])
            out[f][:, w] = st[f]
    return out


def run(streams: list, p: Params, final: bool, dtype=torch.float32, device="cpu") -> list[dict]:
    """The whole chain over each stream (an object with x, y, t, p
    arrays) from a fresh state: for each, its windows (``starts``,
    ``stops``, ``t_start``, ``ready``), ``(n, K)`` clusters and metrics,
    ``(n, T)`` tracks after each window, and the per-window figures, all
    numpy (floats as float32)."""
    bounds = [windows(ev.t, p, final) for ev in streams]
    lengths = [len(b[0]) for b in bounds]
    index = [(s, i) for s, n in enumerate(lengths) for i in range(n)]
    parts = []
    for lo in range(0, len(index), _WINDOW_BLOCK):
        blk = index[lo:lo + _WINDOW_BLOCK]
        planes = _block_planes(streams, bounds, blk, p.capacity, device)
        parts.append(window_stages(planes, p, dtype))
    cat = lambda get: torch.cat([get(q) for q in parts]).cpu() if parts else None  # noqa: E731
    flat_cl = {f: cat(lambda q, f=f: q["clusters"][f]) for f in CLUSTER_FIELDS}
    flat_m = {m: cat(lambda q, m=m: q["metrics"][m]) for m in METRICS}
    flat_fig = {f: cat(lambda q, f=f: q["figures"][f]) for f in parts[0]["figures"]} if parts else {}
    b, w_max, k = len(streams), max(lengths, default=0), p.max_clusters
    grid = lambda v, fill: _to_grid(v, lengths, w_max, fill)  # noqa: E731
    tracks = track(grid(flat_cl["centroid_x"], -1.0), grid(flat_cl["centroid_y"], -1.0),
                   grid(flat_cl["valid"], False), grid(flat_m["shannon_entropy"], 0.0),
                   lengths, p, dtype) if w_max else {}
    out, off = [], 0
    for s, (starts, stops, ready) in enumerate(bounds):
        n = lengths[s]
        sl = slice(off, off + n)
        ev = streams[s]
        out.append(dict(
            starts=starts, stops=stops, ready=ready,
            t_start=ev.t[starts] if n else np.zeros(0, np.int64),
            clusters={f: _np(flat_cl[f][sl]) if n else np.zeros((0, k)) for f in CLUSTER_FIELDS},
            metrics={m: _np(flat_m[m][sl]) if n else np.zeros((0, k)) for m in METRICS},
            tracks={f: _np(tracks[f][s, :n]) if n else np.zeros((0, p.max_tracks)) for f in TRACK_FIELDS},
            figures={f: _np(v[sl]) if n else np.zeros(0, np.int64) for f, v in flat_fig.items()},
        ))
        off += n
    return out


def _np(v: torch.Tensor) -> np.ndarray:
    return (v.to(torch.float32) if v.is_floating_point() else v).numpy()


def _to_grid(flat: torch.Tensor, lengths: list[int], w_max: int, fill) -> torch.Tensor:
    """Flat per-window rows back to ``(B, w_max, ...)``, padded with ``fill``."""
    out = torch.full((len(lengths), w_max) + tuple(flat.shape[1:]), fill, dtype=flat.dtype)
    off = 0
    for s, n in enumerate(lengths):
        out[s, :n] = flat[off:off + n]
        off += n
    return out


def _block_planes(streams, bounds, blk, capacity: int, device) -> dict:
    """The planes of the windows ``blk`` (pairs of stream, window) drawn
    from several streams, stacked."""
    parts = []
    by_stream: dict[int, list[int]] = {}
    for s, i in blk:
        by_stream.setdefault(s, []).append(i)
    for s, idx in by_stream.items():
        starts, stops, _ = bounds[s]
        idx = np.asarray(idx)
        parts.append(pack(streams[s], starts[idx], stops[idx], capacity, device))
    return {k: torch.cat([q[k] for q in parts]) for k in parts[0]}
