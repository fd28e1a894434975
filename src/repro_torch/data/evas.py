"""Chunked replay of a recording, the shape a live event-camera client
feeds: the port of ``repro.data.evas.iter_chunks`` (the dataset loader
is not ported yet)."""
from __future__ import annotations

from typing import Iterator

import numpy as np

from repro_torch.core.events import stride_bounds
from repro_torch.data.synthetic import Recording


def iter_chunks(
    rec: Recording, chunk_us: int = 20_000
) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Yield ``(x, y, t, p)`` slices covering fixed ``chunk_us`` spans of
    event time, anchored at the first event. The chunks partition the
    stream exactly, and a span with no events yields empty arrays (a live
    client's heartbeat), so chunk index x ``chunk_us`` tracks wall time."""
    if chunk_us < 1:
        raise ValueError(f"chunk_us must be >= 1, got {chunk_us}")
    for lo, hi, _ in stride_bounds(rec.t, chunk_us):
        yield rec.x[lo:hi], rec.y[lo:hi], rec.t[lo:hi], rec.p[lo:hi]
