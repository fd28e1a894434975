"""EVAS dataset interface (Valdivia et al. 2025): the port of
``repro.data.evas``.

The dataset is not available offline, so this module defines the on-disk
interchange format the pipeline consumes and a loader that falls back to
the calibrated synthetic suite; no download is involved. A real EVAS
recording converted to this ``.npz`` layout drops in without code
changes, and a file written by either package loads identically in the
other:

  arrays: x (N,) int32, y (N,) int32, t (N,) int64 microseconds,
          p (N,) int32 polarity; optional: kind, obj, rso_tracks
  attrs (0-d arrays): duration_us, name

:func:`iter_chunks` replays a recording in fixed spans of event time, the
shape a live event-camera client feeds.
"""
from __future__ import annotations

from pathlib import Path
from typing import Iterator

import numpy as np

from repro_torch.core.events import stride_bounds
from repro_torch.data.synthetic import Recording, make_validation_suite


def save_recording(rec: Recording, path: str | Path) -> None:
    np.savez_compressed(
        path,
        x=rec.x, y=rec.y, t=rec.t, p=rec.p,
        kind=rec.kind, obj=rec.obj, rso_tracks=rec.rso_tracks,
        duration_us=np.int64(rec.duration_us),
        name=np.str_(rec.name),
    )


def load_recording(path: str | Path) -> Recording:
    with np.load(path, allow_pickle=False) as z:
        n = len(z["t"])
        return Recording(
            x=z["x"].astype(np.int32),
            y=z["y"].astype(np.int32),
            t=z["t"].astype(np.int64),
            p=z["p"].astype(np.int32),
            kind=z["kind"].astype(np.int32) if "kind" in z else np.zeros(n, np.int32),
            obj=z["obj"].astype(np.int32) if "obj" in z else np.full(n, -1, np.int32),
            rso_tracks=z["rso_tracks"] if "rso_tracks" in z else np.zeros((0, 4)),
            duration_us=int(z["duration_us"]),
            name=str(z["name"]) if "name" in z else Path(path).stem,
        )


def load_validation_suite(directory: str | Path | None = None) -> list[Recording]:
    """The ``.npz`` recordings in ``directory`` if there are any, else the
    synthetic suite (:func:`make_validation_suite`).

    Files are ordered by name, never by directory enumeration order: the
    suite's order decides the sweep's output order, which must not depend
    on the filesystem.
    """
    if directory is not None:
        files = sorted(Path(directory).glob("*.npz"), key=lambda f: f.name)
        if files:
            return [load_recording(f) for f in files]
    return make_validation_suite()


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
