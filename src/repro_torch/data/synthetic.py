"""Synthetic EVAS-like night-sky event recordings with ground truth.

The port's own copy of the part of ``repro.data.synthetic`` the detection
chain needs: the same numpy code, so the same seed gives the same arrays.
A static star field scintillates at a low rate and drifts slowly, 1-3
RSOs cross the field on linear trajectories producing dense streaks, and
uniform shot noise fills the sensor. Every event carries a ground-truth
kind (0 noise / 1 star / 2 RSO) and object id.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.events import SENSOR_HEIGHT, SENSOR_WIDTH

KIND_NOISE, KIND_STAR, KIND_RSO = 0, 1, 2

# Lens configurations: focal scale multiplies apparent velocities and
# divides the star density (narrower field of view sees fewer stars).
LENS_CONFIGS = {
    "standard": dict(scale=1.0, n_stars=36),
    "telephoto": dict(scale=2.2, n_stars=14),
    "wide": dict(scale=0.55, n_stars=60),
}


@dataclasses.dataclass
class Recording:
    """Time-sorted event stream with per-event ground truth.

    ``rso_tracks`` rows are ``[x0, y0, vx_px_per_s, vy_px_per_s]``
    ((R, 4)), optionally with ``[ax, ay]`` accelerations ((R, 6)).
    """

    x: np.ndarray  # (N,) int32
    y: np.ndarray  # (N,) int32
    t: np.ndarray  # (N,) int64 microseconds
    p: np.ndarray  # (N,) int32 polarity
    kind: np.ndarray  # (N,) int32 in {0 noise, 1 star, 2 rso}
    obj: np.ndarray  # (N,) int32 object index (-1 for noise)
    rso_tracks: np.ndarray  # (R, 4) or (R, 6) trajectory table
    duration_us: int
    name: str = "synthetic"

    def __len__(self) -> int:
        return len(self.t)

    def rso_position(self, rso: int, t_us: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """RSO ``rso``'s position (float64 px) at times ``t_us``."""
        tr = np.asarray(self.rso_tracks[rso], np.float64)
        x0, y0, vx, vy = tr[:4]
        ax, ay = (tr[4], tr[5]) if tr.shape[0] >= 6 else (0.0, 0.0)
        ts = np.asarray(t_us, np.float64) * 1e-6
        return (
            x0 + vx * ts + 0.5 * ax * ts * ts,
            y0 + vy * ts + 0.5 * ay * ts * ts,
        )


def _poisson_times(rng: np.random.Generator, rate_hz: float, duration_us: int) -> np.ndarray:
    n = rng.poisson(rate_hz * duration_us * 1e-6)
    return np.sort(rng.uniform(0, duration_us, size=n)).astype(np.int64)


def make_recording(
    seed: int = 0,
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
    name: str | None = None,
) -> Recording:
    """Generate one labeled recording (bit-identical to the reference's
    ``make_recording`` for the same arguments)."""
    rng = np.random.default_rng(seed)
    cfg = LENS_CONFIGS[lens]
    scale = cfg["scale"]
    n_stars = cfg["n_stars"]
    duration_us = int(duration_s * 1e6)

    xs, ys, ts, ps, kinds, objs = [], [], [], [], [], []

    # --- background shot noise -------------------------------------------
    t_noise = _poisson_times(rng, noise_rate_hz, duration_us)
    n = len(t_noise)
    xs.append(rng.integers(0, width, n))
    ys.append(rng.integers(0, height, n))
    ts.append(t_noise)
    ps.append(rng.integers(0, 2, n))
    kinds.append(np.full(n, KIND_NOISE))
    objs.append(np.full(n, -1))

    # --- star field -------------------------------------------------------
    star_x = rng.uniform(30, width - 30, n_stars)
    star_y = rng.uniform(30, height - 30, n_stars)
    # Apparent sidereal drift, px/s (scaled by lens focal length).
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
        kinds.append(np.full(n, KIND_STAR))
        objs.append(np.full(n, s))

    # --- RSOs --------------------------------------------------------------
    tracks = np.zeros((n_rsos, 4), np.float64)
    for r in range(n_rsos):
        speed = rng.uniform(*rso_speed_px_s) * scale  # px/s apparent
        angle = rng.uniform(0, 2 * np.pi)
        vx, vy = speed * np.cos(angle), speed * np.sin(angle)
        # Start so the trajectory stays mostly inside the ROI.
        x0 = rng.uniform(0.25 * width, 0.75 * width) - vx * duration_s / 2
        y0 = rng.uniform(0.25 * height, 0.75 * height) - vy * duration_s / 2
        tracks[r] = (x0, y0, vx, vy)
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
        kinds.append(np.full(int(inside.sum()), KIND_RSO))
        objs.append(np.full(int(inside.sum()), r))

    x = np.clip(np.concatenate(xs), 0, width - 1).astype(np.int32)
    y = np.clip(np.concatenate(ys), 0, height - 1).astype(np.int32)
    t = np.concatenate(ts).astype(np.int64)
    p = np.concatenate(ps).astype(np.int32)
    kind = np.concatenate(kinds).astype(np.int32)
    obj = np.concatenate(objs).astype(np.int32)
    order = np.argsort(t, kind="stable")
    return Recording(
        x[order], y[order], t[order], p[order], kind[order], obj[order],
        rso_tracks=tracks,
        duration_us=duration_us,
        name=name or f"synthetic-{lens}-seed{seed}",
    )


def make_validation_suite(
    n_recordings: int = 6, duration_s: float = 2.0, seed0: int = 100
) -> list[Recording]:
    """Six recordings x three lens types, the paper's Sec. V-A suite: the
    reference's seeds, lenses, names and arrays."""
    suite = []
    for i in range(n_recordings):
        for li, lens in enumerate(LENS_CONFIGS):
            suite.append(
                make_recording(
                    seed=seed0 + 17 * i + 251 * li,
                    duration_s=duration_s,
                    n_rsos=1 + (i % 3),
                    lens=lens,
                    name=f"rec{i}-{lens}",
                )
            )
    return suite
