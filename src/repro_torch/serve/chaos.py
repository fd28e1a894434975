"""Deterministic chaos-injection harness for the detection service.

The port of ``repro.serve.chaos``. Real event-camera SSA deployments
(Afshar et al., arXiv:1911.08730) must keep observing through sensor
dropouts, hot-pixel bursts, and corrupted links. This module drives a
fault-tolerant :class:`~repro_torch.serve.service.DetectionService` on
its device through a *seeded* schedule of every fault in the taxonomy
and checks the two invariants the fault layer promises (DESIGN.md
Sec. 13):

* **No crash**: no injected fault ever raises out of ``feed``/``pump``
  — faulty sessions are quarantined, evicted, shed, or retried, each
  leaving a structured :class:`~repro_torch.serve.sessions.SessionError`.
* **Bit-identical degraded mode**: the outputs of every *healthy*
  session — windows, clusters, metrics, tracks, final tracker state —
  are bit-identical to a fault-free reference run of the same feeds on
  the same device. Faults on one sensor never perturb another, and
  degraded rounds (restored chunks re-fed later, i.e. re-chunked) are
  covered by the streaming engine's re-chunking invariance.

Everything is deterministic from ``ChaosConfig.seed``: the fault
schedule, every injected payload (``numpy.random.default_rng``, the
reference's draws), and the fake clock (no wall time, no real sleeps),
so a chaos failure replays exactly, and the same seed gives the
reference's schedule and payloads.

    report = ChaosHarness(ChaosConfig(seed=7), device="cuda").run()
    assert report.bit_identical and not report.escaped_errors
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.core.pipeline.config import PipelineConfig
from repro_torch.serve.batcher import AdmissionConfig
from repro_torch.serve.faults import FaultConfig
from repro_torch.serve.service import DetectionService
from repro_torch.serve.sessions import LIVE, SessionError

# The fault taxonomy. Each entry is injected on *faulty* sensors only;
# healthy sensors feed clean chunks every round.
FAULT_TAXONOMY = (
    "non_monotone",    # timestamps shuffled inside a chunk -> quarantine
    "duplicate",       # previous chunk re-sent (stream regresses) -> quarantine
    "dropped",         # a chunk silently lost in transit (gap; survivable)
    "oob_coords",      # off-sensor but int32-safe coordinates (masked; survivable)
    "garbage_coords",  # int32-unsafe integer garbage -> quarantine
    "stall",           # sensor goes silent -> heartbeat eviction
    "burst",           # overload flood past the queue budget -> shed
    "churn",           # detach + immediate re-attach (slot recycle)
    "step_exception",  # simulated device-step failure -> retry / degraded round
)


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Seeded chaos schedule over a sensor fleet.

    The first ``n_faulty`` sensors are the fault targets; the remaining
    ``n_sensors - n_faulty`` stay healthy and are the bit-identity
    comparison set. Faults fire on a deterministic schedule that cycles
    through ``faults`` (every entry at least once when the round budget
    allows) and then keeps injecting at random from the same seed.
    """

    n_sensors: int = 6
    n_faulty: int = 2
    n_rounds: int = 48
    seed: int = 0
    faults: tuple[str, ...] = FAULT_TAXONOMY
    chunk_events: int = 100  # per-round clean chunk size
    burst_events: int = 1500  # overload chunk size (>> queue budget share)
    round_dt_s: float = 0.02  # fake-clock advance per round (live cadence)
    queue_budget_events: int = 800  # per-session ingest bound
    shed_policy: str = "drop_oldest"
    heartbeat_rounds: int = 4  # silence threshold, in rounds
    stall_rounds: int = 6  # how long a stalled sensor stays silent
    max_step_retries: int = 2
    tiers: tuple[int, ...] = (4, 8, 16)

    def __post_init__(self):
        if not 0 < self.n_faulty < self.n_sensors:
            raise ValueError(
                f"need 0 < n_faulty < n_sensors, got {self.n_faulty} of "
                f"{self.n_sensors}"
            )
        unknown = set(self.faults) - set(FAULT_TAXONOMY)
        if unknown:
            raise ValueError(f"unknown faults {sorted(unknown)}")
        if self.stall_rounds <= self.heartbeat_rounds + 1:
            raise ValueError(
                "stall_rounds must exceed heartbeat_rounds + 1 so a stalled "
                "sensor is reliably evicted before it could resume"
            )
        if self.chunk_events > self.queue_budget_events:
            raise ValueError(
                "chunk_events must fit the queue budget or healthy feeds "
                "would shed (breaking the bit-identity comparison)"
            )


@dataclasses.dataclass
class ChaosReport:
    """Outcome of one chaos run; every field is deterministic per seed."""

    rounds: int
    fired: dict  # fault kind -> injection count (every kind >= 1)
    quarantines: int
    evictions: int
    degraded_rounds: int
    step_retries: int
    demotions: int
    healthy_windows: int  # windows served to healthy sessions
    shed: dict  # {"offered": int, "accepted": int, "shed": int, "exact": bool}
    errors: list[SessionError]  # structured records, service-wide order
    escaped_errors: list[str]  # exceptions that escaped feed/pump (must be [])
    bit_identical: bool  # healthy outputs == fault-free reference
    mismatches: list[str]  # per-leaf mismatch descriptions when not
    round_times_ms: list[float]  # wall time per faulted round (bench input)


class _FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self) -> float:
        return self.now


class _Stream:
    """Deterministic per-sensor event stream: strictly increasing
    timestamps (100 us apart), rng coordinates. Both chaos runs consume
    a healthy stream with the same seed and the same slice sizes, so
    the fed chunks are identical arrays."""

    def __init__(self, seed: int, dt_us: int = 100):
        self._rng = np.random.default_rng(seed)
        self._pos = 0
        self.dt_us = dt_us

    def next(self, n: int):
        x = self._rng.integers(40, 560, n).astype(np.int64)
        y = self._rng.integers(40, 400, n).astype(np.int64)
        p = self._rng.integers(0, 2, n).astype(np.int64)
        t = (np.arange(n, dtype=np.int64) + self._pos + 1) * self.dt_us
        self._pos += n
        return x, y, t, p


class _FlakyFleet:
    """Transparent fleet wrapper whose ``feed`` / ``feed_async`` raise
    the next ``fail_next`` times — the chaos stand-in for a device-step
    failure at the dispatch boundary (before any fleet mutation, which
    is where a failed kernel launch surfaces; the service's retry loop
    wraps ``feed_async``)."""

    def __init__(self, fleet):
        self._fleet = fleet
        self.fail_next = 0
        self.raised = 0

    def __getattr__(self, name):
        return getattr(self._fleet, name)

    def _maybe_fail(self):
        if self.fail_next > 0:
            self.fail_next -= 1
            self.raised += 1
            raise RuntimeError("chaos: injected device-step failure")

    def feed(self, *args, **kwargs):
        self._maybe_fail()
        return self._fleet.feed(*args, **kwargs)

    def feed_async(self, *args, **kwargs):
        self._maybe_fail()
        return self._fleet.feed_async(*args, **kwargs)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _result_arrays(res) -> list[np.ndarray]:
    """A ScanResult's comparable surfaces as host arrays, leading dim =
    windows (so concatenation over parts is chunking-invariant), in the
    reference's leaf order: cluster fields, metrics by sorted name, track
    fields."""
    out = [np.asarray(res.t_start_us)]
    if res.num_windows:
        out.extend(_host(a) for a in res.clusters)
        out.extend(_host(res.metrics[k]) for k in sorted(res.metrics))
        if res.tracks is not None:
            out.extend(_host(a) for a in res.tracks)
    return out


def concat_outputs(parts) -> list[np.ndarray]:
    """Concatenate one session's per-step results into window-indexed
    surfaces, plus the final tracker state of the last (detach) part."""
    cols = [_result_arrays(r) for r in parts if r.num_windows]
    out = [np.concatenate(c) for c in zip(*cols)] if cols else []
    for r in reversed(parts):
        if r.final_tracks is not None:
            out.extend(_host(a) for a in r.final_tracks)
            break
    return out


def compare_outputs(got, want, label: str) -> list[str]:
    """Bitwise comparison of two concat_outputs lists."""
    bad = []
    if len(got) != len(want):
        return [f"{label}: {len(got)} surfaces vs {len(want)}"]
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape:
            bad.append(f"{label}[{i}]: shape {g.shape} vs {w.shape}")
        elif not np.array_equal(g, w):
            bad.append(
                f"{label}[{i}]: {int((g != w).sum())}/{g.size} elements differ"
            )
    return bad


class ChaosHarness:
    """Run the seeded fault schedule against a fault-tolerant service,
    then a fault-free reference over the same healthy feeds, and diff.

    ``config`` here is the chaos schedule; ``pipeline`` the detection
    pipeline config shared by both runs; ``device`` where both services
    run (the card unless the caller asks for the CPU).
    """

    def __init__(
        self,
        config: ChaosConfig = ChaosConfig(),
        pipeline: PipelineConfig = PipelineConfig(),
        device: str | torch.device = DEFAULT_DEVICE,
    ):
        self.config = config
        self.pipeline = pipeline
        self.device = device

    # -- schedule ------------------------------------------------------

    def schedule(self) -> list[tuple[int, int, str]]:
        """The deterministic fault schedule: (round, faulty_sensor, kind).

        A guarantee pass spreads every configured kind over the run —
        each fires at least once — then extra (sensor, kind) pairs are
        drawn at random from the same seed. Stalled sensors carry a busy
        horizon so they are evicted and re-attached before their next
        fault."""
        cfg = self.config
        rng = np.random.default_rng(cfg.seed)
        kinds = list(cfg.faults)
        first = 3  # duplicates need history; give every sensor some
        last = cfg.n_rounds - 3
        busy = [0] * cfg.n_faulty  # per-sensor stall horizon
        out: list[tuple[int, int, str]] = []

        def place(r: int, f: int, kind: str) -> None:
            out.append((r, f, kind))
            if kind == "stall":
                busy[f] = r + cfg.stall_rounds + 2

        span = max(1, last - first)
        for i, kind in enumerate(kinds):  # guarantee pass
            r = first + (i * span) // len(kinds)
            free = [f for f in range(cfg.n_faulty) if r >= busy[f]]
            if not free:
                r = min(busy)
                free = [f for f in range(cfg.n_faulty) if r >= busy[f]]
            place(min(r, last), free[i % len(free)], kind)
        r = first  # extra random injections
        while True:
            r += int(rng.integers(2, 6))
            if r >= last:
                break
            f = int(rng.integers(cfg.n_faulty))
            if r >= busy[f]:
                place(r, f, str(rng.choice(kinds)))
        out.sort(key=lambda e: e[0])
        return out

    # -- runs ----------------------------------------------------------

    def run(self) -> ChaosReport:
        cfg = self.config
        faulted = self._run_faulted()
        reference = self._run_reference()
        mismatches: list[str] = []
        for k, hid in enumerate(sorted(faulted["healthy_parts"])):
            got = concat_outputs(faulted["healthy_parts"][hid])
            want = concat_outputs(reference[k])
            mismatches.extend(compare_outputs(got, want, f"healthy[{k}]"))
        svc = faulted["svc"]
        stats = [s.stats for s in faulted["all_sessions"]]
        offered = sum(s.offered_events for s in stats)
        accepted = sum(s.events for s in stats)
        shed = sum(s.shed_events for s in stats)
        return ChaosReport(
            rounds=cfg.n_rounds,
            fired=faulted["fired"],
            quarantines=svc.quarantines,
            evictions=svc.evictions,
            degraded_rounds=svc.degraded_rounds,
            step_retries=svc.step_retries,
            demotions=svc.demotions,
            healthy_windows=sum(
                r.num_windows
                for parts in faulted["healthy_parts"].values()
                for r in parts
            ),
            shed={
                "offered": offered,
                "accepted": accepted,
                "shed": shed,
                "exact": offered == accepted + shed,
            },
            errors=list(svc.errors),
            escaped_errors=faulted["escaped"],
            bit_identical=not mismatches,
            mismatches=mismatches,
            round_times_ms=faulted["round_times_ms"],
        )

    def _fault_config(self) -> FaultConfig:
        cfg = self.config
        return FaultConfig(
            on_validation_error="quarantine",
            queue_budget_events=cfg.queue_budget_events,
            shed_policy=cfg.shed_policy,
            heartbeat_timeout_s=(cfg.heartbeat_rounds - 0.5) * cfg.round_dt_s,
            demote_tiers=True,
            max_step_retries=cfg.max_step_retries,
            retry_backoff_s=0.001,  # fake sleep: advances the fake clock
            degrade_on_step_failure=True,
        )

    def _service(self, clock, faults: FaultConfig) -> DetectionService:
        cfg = self.config

        def fake_sleep(s: float) -> None:
            clock.now += s

        return DetectionService(
            self.pipeline,
            tiers=cfg.tiers,
            admission=AdmissionConfig(
                max_delay_s=cfg.round_dt_s,
                max_items=cfg.chunk_events * cfg.n_sensors,
            ),
            faults=faults,
            clock=clock,
            sleep=fake_sleep,
            device=self.device,
        )

    def _run_faulted(self) -> dict:
        cfg = self.config
        clock = _FakeClock()
        svc = self._service(clock, self._fault_config())
        flaky = _FlakyFleet(svc._fleet)
        svc._fleet = flaky
        schedule = {}
        for r, f, kind in self.schedule():
            schedule.setdefault(r, []).append((f, kind))
        rng = np.random.default_rng(cfg.seed + 1)  # payload corruption rng
        streams: dict[int, _Stream] = {}
        next_stream_seed = [0]

        def fresh_stream(sensor: int) -> _Stream:
            # Healthy sensors must consume the SAME seed sequence as the
            # reference run; faulty re-attaches draw private seeds.
            if sensor >= cfg.n_faulty:
                seed = cfg.seed * 1000 + sensor
            else:
                seed = cfg.seed * 1000 + 500 + next_stream_seed[0]
                next_stream_seed[0] += 1
            return _Stream(seed)

        sids = {}
        all_sessions = []
        for sensor in range(cfg.n_sensors):
            sids[sensor] = svc.attach(f"sensor-{sensor}")
            all_sessions.append(svc.session(sids[sensor]))
            streams[sensor] = fresh_stream(sensor)
        healthy_sids = {sids[s] for s in range(cfg.n_faulty, cfg.n_sensors)}
        healthy_parts: dict[int, list] = {h: [] for h in healthy_sids}
        last_chunk: dict[int, tuple] = {}
        stalled_until = [0] * cfg.n_faulty
        fired: dict[str, int] = {k: 0 for k in cfg.faults}
        step_exc_count = [0]
        escaped: list[str] = []
        round_times_ms: list[float] = []

        def collect(served):
            for fd in served:
                if fd.sid in healthy_sids:
                    healthy_parts[fd.sid].append(fd.result)

        def guard(fn, *args):
            try:
                collect(fn(*args))
            except Exception as e:  # noqa: BLE001 — the no-crash invariant
                escaped.append(f"{type(e).__name__}: {e}")

        def reattach(sensor: int) -> int:
            """A faulty sensor's live sid: re-attached first when a fault
            closed its session (quarantine, heartbeat eviction)."""
            if svc.session(sids[sensor]).state != LIVE:
                sids[sensor] = svc.attach(f"sensor-{sensor}-r{rnd}")
                all_sessions.append(svc.session(sids[sensor]))
                streams[sensor] = fresh_stream(sensor)
                last_chunk.pop(sensor, None)
            return sids[sensor]

        def inject(sensor: int, kind: str) -> None:
            """One fault on one faulty sensor. Never touches healthy state."""
            sid = sids[sensor]
            stream = streams[sensor]
            if kind == "stall":
                stalled_until[sensor] = rnd + cfg.stall_rounds
                fired[kind] += 1
                return
            if kind == "step_exception":
                # Alternate: heal-within-retries, then a degraded round.
                step_exc_count[0] += 1
                flaky.fail_next = (
                    1 if step_exc_count[0] % 2 else cfg.max_step_retries + 1
                )
                fired[kind] += 1
                return
            if kind == "churn":
                if svc.session(sid).state == LIVE:
                    try:
                        svc.detach(sid)
                    except RuntimeError:  # degraded detach: session stays
                        fired[kind] += 1  # live, chunks restored — retryable
                        return
                sids[sensor] = svc.attach(f"sensor-{sensor}-churned")
                all_sessions.append(svc.session(sids[sensor]))
                streams[sensor] = fresh_stream(sensor)
                last_chunk.pop(sensor, None)
                fired[kind] += 1
                return
            if kind == "dropped":
                stream.next(cfg.chunk_events)  # lost in transit
                fired[kind] += 1
                return
            # The guarantee pass can put a feeding fault inside a stall
            # placed after it, where the sensor's session is already
            # evicted: re-attach it first, as the round loop would, so
            # the fault reaches a live session instead of raising out of
            # ``feed`` (the reference feeds the closed session and
            # records an escaped error; ROADMAP §3).
            sid = reattach(sensor)
            stream = streams[sensor]
            if kind == "burst":
                chunk = stream.next(cfg.burst_events)
                guard(svc.feed, sid, *chunk)
                fired[kind] += 1
                return
            if kind == "duplicate":
                chunk = last_chunk.get(sensor)
                if chunk is None:  # no history yet: synthesize a regression
                    chunk = stream.next(cfg.chunk_events)
                    guard(svc.feed, sid, *chunk)
                guard(svc.feed, sid, *chunk)
                fired[kind] += 1
                return
            x, y, t, p = stream.next(cfg.chunk_events)
            if kind == "non_monotone":
                t = t[::-1].copy()
            elif kind == "oob_coords":
                x = x + 5000  # off-sensor, int32-safe: masked, survivable
                y = y + 5000
            elif kind == "garbage_coords":
                x = x + (np.int64(1) << 31)  # int32-unsafe garbage
            guard(svc.feed, sid, x, y, t, p)
            fired[kind] += 1

        for rnd in range(cfg.n_rounds):
            t0 = time.perf_counter()
            clock.now += cfg.round_dt_s
            for sensor, kind in schedule.get(rnd, ()):
                inject(sensor, kind)
            for sensor in range(cfg.n_sensors):
                faulty = sensor < cfg.n_faulty
                if faulty and rnd < stalled_until[sensor]:
                    continue  # silent: heartbeat eviction territory
                sid = sids[sensor]
                if svc.session(sid).state != LIVE:
                    if faulty:  # re-attach after quarantine/eviction
                        sid = reattach(sensor)
                    else:  # a healthy session left LIVE = isolation broken
                        escaped.append(
                            f"healthy sensor {sensor} left live state: "
                            f"{svc.session(sid).state}"
                        )
                        continue
                chunk = streams[sensor].next(cfg.chunk_events)
                if faulty:
                    last_chunk[sensor] = chunk
                guard(svc.feed, sid, *chunk)
            guard(svc.pump, True)
            round_times_ms.append((time.perf_counter() - t0) * 1e3)

        for h in sorted(healthy_sids):
            try:
                healthy_parts[h].append(svc.detach(h))
            except Exception as e:  # noqa: BLE001
                escaped.append(f"detach({h}): {type(e).__name__}: {e}")
        return {
            "svc": svc,
            "healthy_parts": healthy_parts,
            "all_sessions": all_sessions,
            "fired": fired,
            "escaped": escaped,
            "round_times_ms": round_times_ms,
        }

    def _run_reference(self) -> list[list]:
        """Fault-free run of the healthy feeds only (strict FaultConfig,
        same cadence, same stream seeds) — the bit-identity baseline."""
        cfg = self.config
        clock = _FakeClock()
        svc = self._service(clock, FaultConfig())
        sensors = list(range(cfg.n_faulty, cfg.n_sensors))
        sids = [svc.attach(f"ref-{s}") for s in sensors]
        streams = [_Stream(cfg.seed * 1000 + s) for s in sensors]
        parts: list[list] = [[] for _ in sensors]
        by_sid = {sid: i for i, sid in enumerate(sids)}

        def collect(served):
            for fd in served:
                parts[by_sid[fd.sid]].append(fd.result)

        for _ in range(cfg.n_rounds):
            clock.now += cfg.round_dt_s
            for i, sid in enumerate(sids):
                collect(svc.feed(sid, *streams[i].next(cfg.chunk_events)))
            collect(svc.pump(force=True))
        for i, sid in enumerate(sids):
            parts[i].append(svc.detach(sid))
        return parts
