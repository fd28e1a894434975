"""The benchmark's traffic generator, frozen here so that a change to the
program cannot move it.

``make_recording`` and ``LENS_CONFIGS`` are copies of the port's
``data/synthetic.py`` (itself the JAX package's generator, drawing the same
numbers in the same order): a scintillating star field, 1-4 RSOs on
linear tracks and uniform shot noise on a 640x480 event camera, each event
labelled. ``chunk_bounds`` is the chunking of ``data/evas.py:iter_chunks``:
fixed spans of event time anchored at the first event. The cell builders
turn a workload file's parameters and ``--seed`` into the arrays the
program is handed: a list of recordings (the archive) or one lap of 20 ms
chunks per sensor (the fleet), replayed lap after lap.
"""
from __future__ import annotations

import dataclasses

import numpy as np

SENSOR_WIDTH = 640
SENSOR_HEIGHT = 480

LENS_CONFIGS = {
    "standard": dict(scale=1.0, n_stars=36),
    "telephoto": dict(scale=2.2, n_stars=14),
    "wide": dict(scale=0.55, n_stars=60),
}


@dataclasses.dataclass
class Events:
    """A time-sorted event stream: x, y, p int32 and t int64 microseconds."""

    x: np.ndarray
    y: np.ndarray
    t: np.ndarray
    p: np.ndarray
    duration_us: int

    def __len__(self) -> int:
        return len(self.t)


def _poisson_times(rng: np.random.Generator, rate_hz: float, duration_us: int) -> np.ndarray:
    n = rng.poisson(rate_hz * duration_us * 1e-6)
    return np.sort(rng.uniform(0, duration_us, size=n)).astype(np.int64)


def make_recording(
    seed,
    duration_s: float = 2.0,
    n_rsos: int = 2,
    lens: str = "standard",
    noise_rate_hz: float = 3_500.0,
    star_rate_hz: tuple[float, float] = (15.0, 60.0),
    rso_rate_hz: tuple[float, float] = (380.0, 700.0),
    rso_speed_px_s: tuple[float, float] = (40.0, 150.0),
    psf_sigma: float = 0.8,
    width: int = SENSOR_WIDTH,
    height: int = SENSOR_HEIGHT,
) -> Events:
    """One recording: the generator's numbers, without the labels."""
    rng = np.random.default_rng(seed)
    cfg = LENS_CONFIGS[lens]
    scale = cfg["scale"]
    n_stars = cfg["n_stars"]
    duration_us = int(duration_s * 1e6)
    xs, ys, ts, ps = [], [], [], []

    t_noise = _poisson_times(rng, noise_rate_hz, duration_us)
    n = len(t_noise)
    xs.append(rng.integers(0, width, n))
    ys.append(rng.integers(0, height, n))
    ts.append(t_noise)
    ps.append(rng.integers(0, 2, n))

    star_x = rng.uniform(30, width - 30, n_stars)
    star_y = rng.uniform(30, height - 30, n_stars)
    drift = rng.normal(0.0, 0.6, (n_stars, 2)) * scale
    for s in range(n_stars):
        rate = rng.uniform(*star_rate_hz)
        t_s = _poisson_times(rng, rate, duration_us)
        n = len(t_s)
        if n == 0:
            continue
        tt = t_s * 1e-6
        xs.append(star_x[s] + drift[s, 0] * tt + rng.normal(0, psf_sigma, n))
        ys.append(star_y[s] + drift[s, 1] * tt + rng.normal(0, psf_sigma, n))
        ts.append(t_s)
        ps.append(rng.integers(0, 2, n))

    for _ in range(n_rsos):
        speed = rng.uniform(*rso_speed_px_s) * scale
        angle = rng.uniform(0, 2 * np.pi)
        vx, vy = speed * np.cos(angle), speed * np.sin(angle)
        x0 = rng.uniform(0.25 * width, 0.75 * width) - vx * duration_s / 2
        y0 = rng.uniform(0.25 * height, 0.75 * height) - vy * duration_s / 2
        rate = rng.uniform(*rso_rate_hz)
        t_r = _poisson_times(rng, rate, duration_us)
        n = len(t_r)
        tt = t_r * 1e-6
        px = x0 + vx * tt + rng.normal(0, psf_sigma, n)
        py = y0 + vy * tt + rng.normal(0, psf_sigma, n)
        inside = (px >= 0) & (px < width) & (py >= 0) & (py < height)
        xs.append(px[inside])
        ys.append(py[inside])
        ts.append(t_r[inside])
        ps.append(rng.integers(0, 2, int(inside.sum())))

    x = np.clip(np.concatenate(xs), 0, width - 1).astype(np.int32)
    y = np.clip(np.concatenate(ys), 0, height - 1).astype(np.int32)
    t = np.concatenate(ts).astype(np.int64)
    p = np.concatenate(ps).astype(np.int32)
    order = np.argsort(t, kind="stable")
    return Events(x[order], y[order], t[order], p[order], duration_us)


def chunk_bounds(t: np.ndarray, chunk_us: int) -> list[tuple[int, int]]:
    """``(lo, hi)`` index spans of fixed ``chunk_us`` spans of event time,
    anchored at the first event; an empty span is kept (a live client's
    heartbeat), so chunk index x ``chunk_us`` tracks wall time."""
    if chunk_us < 1:
        raise ValueError(f"chunk_us must be >= 1, got {chunk_us}")
    if len(t) == 0:
        return []
    out = []
    w0, t_end = int(t[0]), int(t[-1])
    while w0 <= t_end:
        lo = int(np.searchsorted(t, w0, side="left"))
        hi = int(np.searchsorted(t, w0 + chunk_us, side="left"))
        out.append((lo, hi))
        w0 += chunk_us
    return out


def entropy(seed: int) -> int:
    """``--seed`` as a seed sequence's entropy: any whole number, however
    large, negative ones folded onto their own values."""
    return int(seed) % 2**128


def stream_seeds(seed: int, n: int) -> list[np.random.SeedSequence]:
    """``n`` independent seed sequences drawn from ``--seed``."""
    return np.random.SeedSequence(entropy(seed)).spawn(n)


def _pick(values, i: int):
    return values[i % len(values)]


def recordings(traffic: dict, seed: int) -> list[Events]:
    """The archive's recordings: ``count`` of ``duration_s`` each; the
    lens types in turn, and for each full turn of lenses the next RSO
    count, as the paper's validation suite draws them."""
    lenses, rsos = traffic["lenses"], traffic["n_rsos"]
    return [
        make_recording(
            ss, duration_s=traffic["duration_s"], lens=_pick(lenses, i),
            n_rsos=_pick(rsos, i // len(lenses)), noise_rate_hz=traffic["noise_rate_hz"],
        )
        for i, ss in enumerate(stream_seeds(seed, traffic["count"]))
    ]


@dataclasses.dataclass
class Lap:
    """One sensor's lap: its events and the index span of each chunk."""

    events: Events
    spans: list[tuple[int, int]]
    lap_us: int


def laps(traffic: dict, n_sensors: int, seed: int) -> list[Lap]:
    """One lap of ``lap_s`` a sensor, cut into ``chunk_us`` chunks."""
    lenses, rsos = traffic["lenses"], traffic["n_rsos"]
    out = []
    for s, ss in enumerate(stream_seeds(seed, n_sensors)):
        ev = make_recording(
            ss, duration_s=traffic["lap_s"], lens=_pick(lenses, s),
            n_rsos=_pick(rsos, s // len(lenses)), noise_rate_hz=traffic["noise_rate_hz"],
        )
        # Every event lies in [0, lap), so lap k's events, shifted by k
        # laps, all follow lap k - 1's.
        out.append(Lap(ev, chunk_bounds(ev.t, traffic["chunk_us"]), ev.duration_us))
    return out


def lap_chunk(lap: Lap, k: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Chunk ``k`` of the endless replay: lap ``k // n`` shifted by that
    many laps' length, so the stream stays time-sorted across laps."""
    n = len(lap.spans)
    lo, hi = lap.spans[k % n]
    ev = lap.events
    return ev.x[lo:hi], ev.y[lo:hi], ev.t[lo:hi] + (k // n) * lap.lap_us, ev.p[lo:hi]


def chunk_len(lap: Lap, k: int) -> int:
    lo, hi = lap.spans[k % len(lap.spans)]
    return hi - lo


def replayed_stream(lap: Lap, n_chunks: int) -> Events:
    """The first ``n_chunks`` chunks of the replay, concatenated."""
    parts = [lap_chunk(lap, k) for k in range(n_chunks)]
    cat = lambda i, dt: np.concatenate([p[i] for p in parts]).astype(dt) if parts else np.zeros(0, dt)  # noqa: E731
    return Events(cat(0, np.int32), cat(1, np.int32), cat(2, np.int64), cat(3, np.int32), 0)
