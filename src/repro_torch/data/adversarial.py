"""Adversarial inputs for the kernels: windows and cluster slots that the
main path rarely produces but every kernel must get right."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.events import EventBatch
from repro_torch.core.grid_clustering import Clusters, GridConfig, clusters_from_histogram
from repro_torch.kernels import ref

# Slots forced onto the sensor's corners: (centroid_x, centroid_y).
EDGE_SLOTS = ((0.0, 479.0), (639.4, 0.5), (2.5, 2.5), (636.5, 477.5))


def adversarial_windows(e: int = 256):
    """(5, e) numpy event planes x, y, t, valid: random; out-of-sensor and
    negative coordinates; empty; every event on one pixel; events at the
    sensor's edges. Window 0 holds a clump, so it has a cluster above one
    event per cell."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 640, (5, e))
    y = rng.integers(0, 480, (5, e))
    t = rng.integers(0, 20_000, (5, e))
    v = rng.random((5, e)) < 0.9
    x[1], y[1], v[1] = rng.integers(-100, 740, e), rng.integers(-100, 580, e), True
    v[2] = False
    x[3], y[3], v[3] = 300, 200, True
    x[4] = rng.choice(np.r_[0:6, 634:640], e)
    y[4] = rng.choice(np.r_[0:6, 474:480], e)
    v[4] = True
    x[0, :60], y[0, :60] = rng.integers(100, 112, 60), rng.integers(50, 58, 60)
    return x, y, t, v


def adversarial_batch(device: str | torch.device = "cpu", e: int = 256) -> EventBatch:
    """:func:`adversarial_windows` as an int32 :class:`EventBatch` on ``device``."""
    x, y, t, v = adversarial_windows(e)
    as_int = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
    return EventBatch(as_int(x), as_int(y), as_int(t), as_int(np.zeros_like(x)),
                      torch.as_tensor(v, device=device))


def edge_slot_clusters(batch: EventBatch) -> Clusters:
    """Clusters at ``min_events=1`` from each window of ``batch`` (plain
    cluster_accum), with the first slots forced onto the sensor's corners
    (valid, 7 events, none nearby) and the last two slots invalid."""
    g = GridConfig(min_events=1)
    hist = ref.cluster_accum_ref(
        batch.x, batch.y, batch.t, batch.valid,
        cell_size=16, grid_w=g.grid_w, grid_h=g.grid_h, width=640, height=480,
    )
    f = {k: v.clone() for k, v in clusters_from_histogram(*hist, g)._asdict().items()}
    for j, (px, py) in enumerate(EDGE_SLOTS):
        f["centroid_x"][:, j], f["centroid_y"][:, j] = px, py
        f["count"][:, j], f["valid"][:, j] = 7, True
    f["valid"][:, -2:] = False
    f["count"] = torch.where(f["valid"], f["count"], 0)
    return Clusters(**f)
