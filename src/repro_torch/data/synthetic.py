"""Synthetic EVAS-like night-sky event recordings with ground truth.

The port's own copy of ``repro.data.synthetic``: the same numpy code,
drawing the same random numbers in the same order, so the same seed gives
the same arrays. A static star field scintillates at a low rate and
drifts slowly, 1-3 RSOs cross the field on linear trajectories producing
dense streaks, and uniform shot noise fills the sensor. The scenario
layer (:class:`Scenario`, :data:`SCENARIO_FAMILIES`) composes stressors
into the same kind of recording: GEO slow-movers, tumbling and ballistic
RSOs, hot-pixel columns, noise bursts and pointing jitter. Every event
carries a ground-truth kind (0 noise / 1 star / 2 RSO) and object id.
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


# ---------------------------------------------------------------------------
# Scenario layer: composable sky scenarios beyond the three lens configs.
#
# The paper validates on three lens configurations of the same regime
# (linear crossers + static stars + uniform shot noise). Real SSA
# scenes are messier — Afshar et al. (1911.08730) and Ussa et al.
# (2007.11404) both stress heterogeneous scene statistics — so the
# scenario layer composes orthogonal stressors into labeled recordings:
# GEO slow-movers, tumbling RSOs (periodic brightness), ballistic
# (curved) crossings, hot-pixel columns, temporally localized noise
# bursts, and platform pointing jitter. Every event still carries
# (kind, obj) ground truth, and trajectory tables extend to (R, 6)
# [x0, y0, vx, vy, ax, ay] so the evaluators gate curved paths exactly.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RSOSpec:
    """One resident space object: kinematics + photometric behaviour.

    ``speed_px_s`` / ``accel_px_s2`` / ``rate_hz`` are (lo, hi) ranges
    sampled per recording. ``tumble_hz > 0`` modulates the event rate
    sinusoidally (a tumbling body's periodic glint): instantaneous rate
    = peak * ((1 - depth) + depth * (1 + sin) / 2), so ``depth=1`` goes
    fully dark at the trough.
    """

    speed_px_s: tuple[float, float] = (40.0, 150.0)
    accel_px_s2: tuple[float, float] = (0.0, 0.0)
    rate_hz: tuple[float, float] = (380.0, 700.0)
    tumble_hz: float = 0.0
    tumble_depth: float = 0.9


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Composable recording spec: any mix of stressors in one sky.

    Fields compose freely — e.g. tumbling RSOs *plus* hot columns
    *plus* jitter is a valid scenario; :data:`SCENARIO_FAMILIES` holds
    the canonical single-stressor presets.
    """

    name: str
    rsos: tuple[RSOSpec, ...] = ()
    lens: str = "standard"
    noise_rate_hz: float = 3_500.0
    star_rate_hz: tuple[float, float] = (15.0, 60.0)
    # Hot-pixel columns: stuck sensor columns carrying clusters of
    # persistently firing pixels (exercises the conditioning stage).
    hot_columns: int = 0
    hot_pixels_per_column: int = 24
    hot_pixel_rate_hz: float = 800.0
    # Noise bursts: short intervals of elevated background rate.
    n_bursts: int = 0
    burst_rate_hz: float = 60_000.0
    burst_ms: float = 30.0
    # Platform pointing jitter: sinusoidal whole-frame wobble.
    jitter_px: float = 0.0
    jitter_hz: float = 4.0
    duration_s: float = 2.0


SCENARIO_FAMILIES: dict[str, Scenario] = {
    # The paper's regime: fast linear crossers (baseline family).
    "crossing": Scenario(name="crossing", rsos=(RSOSpec(), RSOSpec())),
    # Near-stationary GEO objects: drift speeds comparable to the star
    # field's sidereal motion — separability must come from density, not
    # streak length.
    "geo_slow": Scenario(
        name="geo_slow",
        rsos=(
            RSOSpec(speed_px_s=(0.5, 3.0), rate_hz=(420.0, 650.0)),
            RSOSpec(speed_px_s=(1.0, 5.0), rate_hz=(420.0, 650.0)),
        ),
    ),
    # Tumbling bodies: the event rate collapses periodically, so windows
    # near the glint trough look like sub-threshold star clusters.
    "tumbling": Scenario(
        name="tumbling",
        rsos=(
            RSOSpec(tumble_hz=5.0, rate_hz=(500.0, 800.0)),
            RSOSpec(tumble_hz=2.5, tumble_depth=1.0, rate_hz=(500.0, 800.0)),
        ),
    ),
    # Curved / ballistic crossings: constant-acceleration trajectories
    # ((R, 6) ground-truth rows) that a linear gate would lose.
    "ballistic": Scenario(
        name="ballistic",
        rsos=(
            RSOSpec(speed_px_s=(30.0, 90.0), accel_px_s2=(40.0, 120.0)),
            RSOSpec(speed_px_s=(40.0, 110.0), accel_px_s2=(30.0, 90.0)),
        ),
    ),
    # Defective sensor columns full of persistently firing pixels.
    "hot_columns": Scenario(
        name="hot_columns", rsos=(RSOSpec(),), hot_columns=3
    ),
    # Temporally localized background storms (e.g. stray light).
    "noise_burst": Scenario(
        name="noise_burst", rsos=(RSOSpec(),), n_bursts=5
    ),
    # Platform wobble: every apparent position oscillates a few px.
    "jitter": Scenario(
        name="jitter", rsos=(RSOSpec(), RSOSpec()), jitter_px=2.5,
        jitter_hz=6.0,
    ),
}


def _tumble_thin(
    rng: np.random.Generator, t_us: np.ndarray, spec: RSOSpec
) -> np.ndarray:
    """Thin Poisson arrivals to a sinusoidally modulated rate (keep mask)."""
    if spec.tumble_hz <= 0.0 or len(t_us) == 0:
        return np.ones(len(t_us), bool)
    phase = rng.uniform(0, 2 * np.pi)
    ts = t_us * 1e-6
    m = (1.0 - spec.tumble_depth) + spec.tumble_depth * 0.5 * (
        1.0 + np.sin(2 * np.pi * spec.tumble_hz * ts + phase)
    )
    return rng.uniform(size=len(t_us)) < m


def make_scenario(
    scenario: Scenario,
    seed: int = 0,
    psf_sigma: float = 0.8,
    width: int = SENSOR_WIDTH,
    height: int = SENSOR_HEIGHT,
    name: str | None = None,
) -> Recording:
    """Generate one labeled recording from a composable scenario spec."""
    rng = np.random.default_rng(seed)
    cfg = LENS_CONFIGS[scenario.lens]
    scale = cfg["scale"]
    n_stars = cfg["n_stars"]
    duration_s = scenario.duration_s
    duration_us = int(duration_s * 1e6)

    xs, ys, ts, ps, kinds, objs = [], [], [], [], [], []

    def add(x, y, t, kind, obj):
        n = len(t)
        xs.append(np.asarray(x, np.float64))
        ys.append(np.asarray(y, np.float64))
        ts.append(np.asarray(t, np.int64))
        ps.append(rng.integers(0, 2, n))
        kinds.append(np.full(n, kind))
        objs.append(np.full(n, obj))

    # --- background shot noise -------------------------------------------
    t_noise = _poisson_times(rng, scenario.noise_rate_hz, duration_us)
    n = len(t_noise)
    add(rng.integers(0, width, n), rng.integers(0, height, n), t_noise,
        KIND_NOISE, -1)

    # --- noise bursts -----------------------------------------------------
    for _ in range(scenario.n_bursts):
        b_us = int(scenario.burst_ms * 1e3)
        t0 = int(rng.uniform(0, max(duration_us - b_us, 1)))
        t_b = _poisson_times(rng, scenario.burst_rate_hz, b_us) + t0
        n = len(t_b)
        add(rng.integers(0, width, n), rng.integers(0, height, n), t_b,
            KIND_NOISE, -1)

    # --- hot-pixel columns ------------------------------------------------
    for _ in range(scenario.hot_columns):
        col = int(rng.integers(0, width))
        rows = rng.choice(height, size=scenario.hot_pixels_per_column,
                          replace=False)
        for r in rows:
            t_h = _poisson_times(rng, scenario.hot_pixel_rate_hz, duration_us)
            add(np.full(len(t_h), col), np.full(len(t_h), r), t_h,
                KIND_NOISE, -1)

    # --- star field -------------------------------------------------------
    star_x = rng.uniform(30, width - 30, n_stars)
    star_y = rng.uniform(30, height - 30, n_stars)
    drift = rng.normal(0.0, 0.6, (n_stars, 2)) * scale
    for s in range(n_stars):
        rate = rng.uniform(*scenario.star_rate_hz)
        t_s = _poisson_times(rng, rate, duration_us)
        n = len(t_s)
        if n == 0:
            continue
        tt = t_s * 1e-6
        add(
            star_x[s] + drift[s, 0] * tt + rng.normal(0, psf_sigma, n),
            star_y[s] + drift[s, 1] * tt + rng.normal(0, psf_sigma, n),
            t_s, KIND_STAR, s,
        )

    # --- RSOs -------------------------------------------------------------
    n_rsos = len(scenario.rsos)
    tracks = np.zeros((n_rsos, 6), np.float64)
    for r, spec in enumerate(scenario.rsos):
        speed = rng.uniform(*spec.speed_px_s) * scale
        angle = rng.uniform(0, 2 * np.pi)
        vx, vy = speed * np.cos(angle), speed * np.sin(angle)
        a_mag = rng.uniform(*spec.accel_px_s2) * scale
        a_angle = rng.uniform(0, 2 * np.pi)
        ax, ay = a_mag * np.cos(a_angle), a_mag * np.sin(a_angle)
        # Center the trajectory's midpoint so it stays mostly in view.
        half = duration_s / 2
        x0 = rng.uniform(0.25 * width, 0.75 * width) - vx * half - 0.5 * ax * half * half
        y0 = rng.uniform(0.25 * height, 0.75 * height) - vy * half - 0.5 * ay * half * half
        tracks[r] = (x0, y0, vx, vy, ax, ay)
        rate = rng.uniform(*spec.rate_hz)
        t_r = _poisson_times(rng, rate, duration_us)
        t_r = t_r[_tumble_thin(rng, t_r, spec)]
        n = len(t_r)
        tt = t_r * 1e-6
        px = x0 + vx * tt + 0.5 * ax * tt * tt + rng.normal(0, psf_sigma, n)
        py = y0 + vy * tt + 0.5 * ay * tt * tt + rng.normal(0, psf_sigma, n)
        inside = (px >= 0) & (px < width) & (py >= 0) & (py < height)
        add(px[inside], py[inside], t_r[inside], KIND_RSO, r)

    x = np.concatenate(xs)
    y = np.concatenate(ys)
    t = np.concatenate(ts).astype(np.int64)
    p = np.concatenate(ps).astype(np.int32)
    kind = np.concatenate(kinds).astype(np.int32)
    obj = np.concatenate(objs).astype(np.int32)

    # --- pointing jitter (applies to the whole frame) ---------------------
    if scenario.jitter_px > 0.0:
        phx, phy = rng.uniform(0, 2 * np.pi, 2)
        w = 2 * np.pi * scenario.jitter_hz
        tt = t * 1e-6
        x = x + scenario.jitter_px * np.sin(w * tt + phx)
        y = y + scenario.jitter_px * np.sin(w * tt + phy)

    x = np.clip(x, 0, width - 1).astype(np.int32)
    y = np.clip(y, 0, height - 1).astype(np.int32)
    order = np.argsort(t, kind="stable")
    return Recording(
        x[order], y[order], t[order], p[order], kind[order], obj[order],
        rso_tracks=tracks,
        duration_us=duration_us,
        name=name or f"{scenario.name}-seed{seed}",
    )


def make_scenario_suite(
    families: tuple[str, ...] | None = None,
    seed0: int = 0,
    duration_s: float | None = None,
    n_per_family: int = 1,
) -> list[Recording]:
    """One labeled recording per scenario family (x ``n_per_family``).

    The stress-test counterpart of :func:`make_validation_suite`:
    feeds the same evaluators (``threshold_sweep``,
    ``collect_candidates*``) but sweeps scene *statistics* instead of
    lens configs.
    """
    names = tuple(SCENARIO_FAMILIES) if families is None else families
    suite = []
    for i in range(n_per_family):
        for fi, fam in enumerate(names):
            sc = SCENARIO_FAMILIES[fam]
            if duration_s is not None:
                sc = dataclasses.replace(sc, duration_s=duration_s)
            suite.append(
                make_scenario(
                    sc, seed=seed0 + 31 * i + 7 * fi,
                    name=f"{fam}-{i}",
                )
            )
    return suite


def make_fleet_recordings(
    n_sensors: int,
    scenario: Scenario | None = None,
    seed0: int = 0,
    duration_s: float | None = None,
    jitter_px: float = 1.5,
    jitter_hz: float = 6.0,
) -> list[Recording]:
    """Per-sensor recordings for a fleet: scenario-diverse by default
    (cycling the family presets), each sensor with independent pointing
    jitter (own amplitude phase/seed) — no two sensors see the same
    platform wobble, which is exactly what the fleet engine's per-sensor
    carries must keep isolated.
    """
    names = tuple(SCENARIO_FAMILIES)
    recs = []
    for s in range(n_sensors):
        sc = SCENARIO_FAMILIES[names[s % len(names)]] if scenario is None else scenario
        sc = dataclasses.replace(
            sc,
            jitter_px=max(sc.jitter_px, jitter_px),
            jitter_hz=jitter_hz,
            **({"duration_s": duration_s} if duration_s is not None else {}),
        )
        recs.append(
            make_scenario(sc, seed=seed0 + 101 * s, name=f"sensor{s}-{sc.name}")
        )
    return recs
