"""Multi-shard chaos harness for the constellation layer.

The port of ``repro.serve.chaos_shards``. Extends the single-service
chaos harness (:mod:`repro_torch.serve.chaos`, DESIGN.md Sec. 13) to
shard-level faults on a
:class:`~repro_torch.serve.constellation.ConstellationService` whose
shards share one device (the card unless the caller asks for the CPU):
on top of the
full per-sensor taxonomy, sessions are migrated between shards
mid-stream (explicitly and via forced rebalances), and whole shards
stall — every fleet round on them fails — until the constellation's
rescue path re-migrates their sessions to the surviving shards. The two
invariants under test (DESIGN.md Sec. 15):

* **No crash, no loss**: no injected fault escapes ``feed``/``pump``,
  and a whole-shard stall moves its sessions — healthy ones included —
  rather than losing them (a degraded round restores its chunks to the
  session queues, and the queues travel with the carry export).
* **Bit-identity against dedicated pipelines**: every healthy session's
  concatenated outputs are bit-identical to a dedicated
  :class:`~repro_torch.core.pipeline.stream.StreamingPipeline` on the
  same device, fed the same
  chunks — a *stronger* reference than the single-service harness's
  fault-free service twin, since it crosses the fleet, service, AND
  constellation layers in one comparison.

Deterministic from ``ShardChaosConfig.seed`` exactly like the
single-service harness: fake clock, seeded schedule, seeded payloads.

    report = ShardChaosHarness(ShardChaosConfig(seed=7), device="cuda").run()
    assert report.bit_identical and not report.escaped_errors
    assert report.rescues >= 1 and report.lost_sessions == 0
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.core.pipeline.config import PipelineConfig
from repro_torch.core.pipeline.stream import StreamingPipeline
from repro_torch.serve.batcher import AdmissionConfig
from repro_torch.serve.chaos import (
    FAULT_TAXONOMY,
    _FakeClock,
    _FlakyFleet,
    _Stream,
    compare_outputs,
    concat_outputs,
)
from repro_torch.serve.constellation import ConstellationService
from repro_torch.serve.faults import FaultConfig
from repro_torch.serve.sessions import LIVE, SessionError

# Shard-level faults layered on the per-sensor taxonomy. ``migrate``
# moves a random live session (healthy ones included — the point) to
# another shard; ``rebalance`` forces a planner sweep; ``shard_stall``
# makes every fleet round on one shard fail until the rescue path
# evacuates it.
SHARD_FAULT_TAXONOMY = FAULT_TAXONOMY + ("migrate", "rebalance", "shard_stall")


@dataclasses.dataclass(frozen=True)
class ShardChaosConfig:
    """Seeded chaos schedule over a sharded constellation.

    Sensors ``0 .. n_faulty-1`` are the per-sensor fault targets; the
    rest stay healthy and form the bit-identity comparison set (healthy
    sessions still migrate and ride shard stalls — those must be
    invisible in their outputs).
    """

    n_shards: int = 2
    n_sensors: int = 6
    n_faulty: int = 2
    n_rounds: int = 48
    seed: int = 0
    faults: tuple[str, ...] = SHARD_FAULT_TAXONOMY
    chunk_events: int = 100
    burst_events: int = 1500
    round_dt_s: float = 0.02
    queue_budget_events: int = 800
    shed_policy: str = "drop_oldest"
    heartbeat_rounds: int = 4
    stall_rounds: int = 6  # per-sensor stall length (heartbeat eviction)
    shard_stall_rounds: int = 5  # whole-shard stall length (repair horizon)
    rescue_after_degraded_rounds: int = 2
    max_step_retries: int = 1
    tiers: tuple[int, ...] = (2, 4, 8, 16)
    exchange: str = "int8_ef"

    def __post_init__(self):
        if self.n_shards < 2:
            raise ValueError("shard chaos needs >= 2 shards to migrate between")
        if not 0 < self.n_faulty < self.n_sensors:
            raise ValueError(
                f"need 0 < n_faulty < n_sensors, got {self.n_faulty} of "
                f"{self.n_sensors}"
            )
        unknown = set(self.faults) - set(SHARD_FAULT_TAXONOMY)
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
        if self.shard_stall_rounds <= self.rescue_after_degraded_rounds:
            raise ValueError(
                "shard_stall_rounds must exceed rescue_after_degraded_rounds "
                "so the rescue reliably fires before the shard heals"
            )


@dataclasses.dataclass
class ShardChaosReport:
    """Outcome of one shard-chaos run; deterministic per seed."""

    rounds: int
    fired: dict  # fault kind -> injection count (every kind >= 1)
    migrations: int  # sessions moved between shards (all causes)
    rebalances: int
    rescues: int  # whole-shard rescues performed
    lost_sessions: int  # healthy sessions not live at the end (must be 0)
    quarantines: int
    evictions: int
    degraded_rounds: int
    healthy_windows: int
    errors: list[SessionError]
    escaped_errors: list[str]  # exceptions escaping feed/pump (must be [])
    bit_identical: bool  # healthy outputs == dedicated pipeline runs
    mismatches: list[str]
    round_times_ms: list[float]
    exchange: dict  # CrossShardExchange.stats snapshot


class ShardChaosHarness:
    """Seeded shard-level fault schedule against a constellation, diffed
    healthy-session-by-healthy-session against dedicated
    :class:`StreamingPipeline` runs of the identical chunk streams, every
    shard and every dedicated pipeline on ``device``."""

    def __init__(
        self,
        config: ShardChaosConfig = ShardChaosConfig(),
        pipeline: PipelineConfig = PipelineConfig(),
        device: str | torch.device = DEFAULT_DEVICE,
    ):
        self.config = config
        self.pipeline = pipeline
        self.device = device

    # -- schedule ------------------------------------------------------

    def schedule(self) -> list[tuple[int, int, str]]:
        """Deterministic (round, faulty_sensor, kind) schedule: one
        guarantee pass spreading every kind over the run, then random
        extras from the same seed. Shard-level kinds ignore the sensor
        column. Stalled sensors and stalled shards carry busy horizons
        so overlapping stalls cannot mask each other."""
        cfg = self.config
        rng = np.random.default_rng(cfg.seed)
        kinds = list(cfg.faults)
        first, last = 3, cfg.n_rounds - 4
        busy = [0] * cfg.n_faulty
        shard_busy = [0]  # global: one shard stall at a time
        out: list[tuple[int, int, str]] = []

        def place(r: int, f: int, kind: str) -> None:
            out.append((r, f, kind))
            if kind == "stall":
                busy[f] = r + cfg.stall_rounds + 2
            elif kind == "shard_stall":
                shard_busy[0] = r + cfg.shard_stall_rounds + 2

        span = max(1, last - first)
        for i, kind in enumerate(kinds):  # guarantee pass
            r = first + (i * span) // len(kinds)
            if kind == "shard_stall":
                r = max(r, shard_busy[0])
            free = [f for f in range(cfg.n_faulty) if r >= busy[f]]
            if not free:
                r = min(busy)
                free = [f for f in range(cfg.n_faulty) if r >= busy[f]]
            place(min(r, last), free[i % len(free)], kind)
        r = first
        while True:  # extra random injections
            r += int(rng.integers(2, 6))
            if r >= last:
                break
            f = int(rng.integers(cfg.n_faulty))
            kind = str(rng.choice(kinds))
            if kind == "shard_stall" and r < shard_busy[0]:
                continue
            if r >= busy[f]:
                place(r, f, kind)
        out.sort(key=lambda e: e[0])
        return out

    # -- runs ----------------------------------------------------------

    def run(self) -> ShardChaosReport:
        cfg = self.config
        faulted = self._run_faulted()
        mismatches: list[str] = []
        for k, sensor in enumerate(sorted(faulted["healthy_chunks"])):
            got = concat_outputs(faulted["healthy_parts"][sensor])
            want = concat_outputs(
                self._run_dedicated(faulted["healthy_chunks"][sensor])
            )
            mismatches.extend(compare_outputs(got, want, f"healthy[{k}]"))
        cs = faulted["cs"]
        return ShardChaosReport(
            rounds=cfg.n_rounds,
            fired=faulted["fired"],
            migrations=cs.migrations,
            rebalances=cs.rebalances,
            rescues=cs.rescues,
            lost_sessions=faulted["lost_sessions"],
            quarantines=sum(s.service.quarantines for s in cs._shards),
            evictions=sum(s.service.evictions for s in cs._shards),
            degraded_rounds=sum(s.service.degraded_rounds for s in cs._shards),
            healthy_windows=sum(
                r.num_windows
                for parts in faulted["healthy_parts"].values()
                for r in parts
            ),
            errors=[e for s in cs._shards for e in s.service.errors],
            escaped_errors=faulted["escaped"],
            bit_identical=not mismatches,
            mismatches=mismatches,
            round_times_ms=faulted["round_times_ms"],
            exchange=cs.exchange.stats,
        )

    def _constellation(self, clock) -> ConstellationService:
        cfg = self.config

        def fake_sleep(s: float) -> None:
            clock.now += s

        return ConstellationService(
            self.pipeline,
            n_shards=cfg.n_shards,
            tiers=cfg.tiers,
            admission=AdmissionConfig(
                max_delay_s=cfg.round_dt_s,
                max_items=cfg.chunk_events * cfg.n_sensors,
            ),
            faults=FaultConfig(
                on_validation_error="quarantine",
                queue_budget_events=cfg.queue_budget_events,
                shed_policy=cfg.shed_policy,
                heartbeat_timeout_s=(cfg.heartbeat_rounds - 0.5)
                * cfg.round_dt_s,
                demote_tiers=True,
                max_step_retries=cfg.max_step_retries,
                retry_backoff_s=0.001,
                degrade_on_step_failure=True,
            ),
            clock=clock,
            sleep=fake_sleep,
            exchange=cfg.exchange,
            rescue_after_degraded_rounds=cfg.rescue_after_degraded_rounds,
            devices=[self.device],
        )

    def _run_dedicated(self, chunks: list) -> list:
        """One healthy sensor's chunk stream through a dedicated
        single-sensor StreamingPipeline — the bit-identity reference."""
        pipe = StreamingPipeline(self.pipeline, device=self.device)
        parts = [pipe.feed(*chunk) for chunk in chunks]
        parts.append(pipe.flush())
        return parts

    def _run_faulted(self) -> dict:
        cfg = self.config
        clock = _FakeClock()
        cs = self._constellation(clock)
        # Every shard's fleet gets the flaky wrapper so both per-sensor
        # step faults and whole-shard stalls inject at the same boundary.
        flaky: list[_FlakyFleet] = []
        for sh in cs._shards:
            wrapper = _FlakyFleet(sh.service._fleet)
            sh.service._fleet = wrapper
            flaky.append(wrapper)
        schedule: dict[int, list] = {}
        for r, f, kind in self.schedule():
            schedule.setdefault(r, []).append((f, kind))
        rng = np.random.default_rng(cfg.seed + 1)
        streams: dict[int, _Stream] = {}
        next_stream_seed = [0]

        def fresh_stream(sensor: int) -> _Stream:
            if sensor >= cfg.n_faulty:  # healthy: shared seed sequence
                seed = cfg.seed * 1000 + sensor
            else:  # faulty re-attaches draw private seeds
                seed = cfg.seed * 1000 + 500 + next_stream_seed[0]
                next_stream_seed[0] += 1
            return _Stream(seed)

        gids: dict[int, int] = {}
        for sensor in range(cfg.n_sensors):
            gids[sensor] = cs.attach(f"sensor-{sensor}")
            streams[sensor] = fresh_stream(sensor)
        healthy = list(range(cfg.n_faulty, cfg.n_sensors))
        healthy_parts: dict[int, list] = {s: [] for s in healthy}
        healthy_chunks: dict[int, list] = {s: [] for s in healthy}
        healthy_gids = {gids[s]: s for s in healthy}
        last_chunk: dict[int, tuple] = {}
        stalled_until = [0] * cfg.n_faulty
        stalled_shard: list[tuple[int, int] | None] = [None]  # (shard, heal_round)
        fired: dict[str, int] = {k: 0 for k in cfg.faults}
        step_exc_count = [0]
        escaped: list[str] = []
        round_times_ms: list[float] = []

        def collect(served):
            for fd in served:
                sensor = healthy_gids.get(fd.gid)
                if sensor is not None:
                    healthy_parts[sensor].append(fd.result)

        def guard(fn, *args):
            try:
                collect(fn(*args))
            except Exception as e:  # noqa: BLE001 — the no-crash invariant
                escaped.append(f"{type(e).__name__}: {e}")

        def reattach(sensor: int) -> int:
            """A faulty sensor's live gid: re-attached first when a fault
            closed its session (quarantine, heartbeat eviction)."""
            if cs.session(gids[sensor]).state != LIVE:
                gids[sensor] = cs.attach(f"sensor-{sensor}-r{rnd}")
                streams[sensor] = fresh_stream(sensor)
                last_chunk.pop(sensor, None)
            return gids[sensor]

        def inject(sensor: int, kind: str) -> None:
            gid = gids[sensor]
            stream = streams[sensor]
            if kind == "shard_stall":
                up = [s.index for s in cs._shards if not s.down]
                # The busiest up shard: a stall that holds no sessions
                # hostage would exercise nothing.
                target = max(up, key=lambda i: (cs._shards[i].load, -i))
                flaky[target].fail_next = 10**9  # every dispatch fails
                stalled_shard[0] = (target, rnd + cfg.shard_stall_rounds)
                fired[kind] += 1
                return
            if kind == "migrate":
                live = sorted(cs._routes)
                if live:
                    g = int(live[rng.integers(len(live))])
                    src = cs.shard_of(g)
                    up = [
                        s.index
                        for s in cs._shards
                        if not s.down and s.index != src
                    ]
                    if up:
                        guard_migrate(g, int(up[rng.integers(len(up))]))
                fired[kind] += 1
                return
            if kind == "rebalance":
                try:
                    cs.rebalance()
                except Exception as e:  # noqa: BLE001
                    escaped.append(f"rebalance: {type(e).__name__}: {e}")
                fired[kind] += 1
                return
            if kind == "stall":
                stalled_until[sensor] = rnd + cfg.stall_rounds
                fired[kind] += 1
                return
            if kind == "step_exception":
                # Alternate heal-within-retries / degraded on the
                # sensor's own shard.
                step_exc_count[0] += 1
                shard_i = cs.shard_of(gid)
                flaky[shard_i].fail_next = (
                    1 if step_exc_count[0] % 2 else cfg.max_step_retries + 1
                )
                fired[kind] += 1
                return
            if kind == "churn":
                if cs.session(gid).state == LIVE:
                    try:
                        cs.detach(gid)
                    except RuntimeError:  # degraded detach: retryable
                        fired[kind] += 1
                        return
                gids[sensor] = cs.attach(f"sensor-{sensor}-churned")
                streams[sensor] = fresh_stream(sensor)
                last_chunk.pop(sensor, None)
                fired[kind] += 1
                return
            if kind == "dropped":
                stream.next(cfg.chunk_events)
                fired[kind] += 1
                return
            # A feeding fault inside a later-placed stall meets an evicted
            # session: re-attach first, as in repro_torch.serve.chaos.
            gid = reattach(sensor)
            stream = streams[sensor]
            if kind == "burst":
                chunk = stream.next(cfg.burst_events)
                guard(cs.feed, gid, *chunk)
                fired[kind] += 1
                return
            if kind == "duplicate":
                chunk = last_chunk.get(sensor)
                if chunk is None:
                    chunk = stream.next(cfg.chunk_events)
                    guard(cs.feed, gid, *chunk)
                guard(cs.feed, gid, *chunk)
                fired[kind] += 1
                return
            x, y, t, p = stream.next(cfg.chunk_events)
            if kind == "non_monotone":
                t = t[::-1].copy()
            elif kind == "oob_coords":
                x = x + 5000
                y = y + 5000
            elif kind == "garbage_coords":
                x = x + (np.int64(1) << 31)
            guard(cs.feed, gid, x, y, t, p)
            fired[kind] += 1

        def guard_migrate(g: int, dst: int) -> None:
            try:
                cs.migrate(g, dst)
            except Exception as e:  # noqa: BLE001
                escaped.append(f"migrate: {type(e).__name__}: {e}")

        for rnd in range(cfg.n_rounds):
            t0 = time.perf_counter()
            clock.now += cfg.round_dt_s
            # Heal a stalled shard once its repair horizon passes.
            if stalled_shard[0] is not None and rnd >= stalled_shard[0][1]:
                shard_i = stalled_shard[0][0]
                flaky[shard_i].fail_next = 0
                if cs._shards[shard_i].down:
                    cs.revive_shard(shard_i)
                stalled_shard[0] = None
            for sensor, kind in schedule.get(rnd, ()):
                inject(sensor, kind)
            for sensor in range(cfg.n_sensors):
                faulty = sensor < cfg.n_faulty
                if faulty and rnd < stalled_until[sensor]:
                    continue
                gid = gids[sensor]
                if cs.session(gid).state != LIVE:
                    if faulty:
                        gid = reattach(sensor)
                    else:  # healthy session closed by a fault = isolation broken
                        escaped.append(
                            f"healthy sensor {sensor} left live state: "
                            f"{cs.session(gid).state}"
                        )
                        continue
                chunk = streams[sensor].next(cfg.chunk_events)
                if faulty:
                    last_chunk[sensor] = chunk
                else:
                    healthy_chunks[sensor].append(chunk)
                guard(cs.feed, gid, *chunk)
            guard(cs.pump, True)
            round_times_ms.append((time.perf_counter() - t0) * 1e3)

        # A stall still pending at the end: heal so the detach flush runs.
        if stalled_shard[0] is not None:
            flaky[stalled_shard[0][0]].fail_next = 0
        lost = 0
        for sensor in healthy:
            gid = gids[sensor]
            try:
                if cs.session(gid).state != LIVE:
                    lost += 1
                    continue
                healthy_parts[sensor].append(cs.detach(gid))
            except Exception as e:  # noqa: BLE001
                escaped.append(f"detach({sensor}): {type(e).__name__}: {e}")
                lost += 1
        return {
            "cs": cs,
            "healthy_parts": healthy_parts,
            "healthy_chunks": healthy_chunks,
            "fired": fired,
            "escaped": escaped,
            "lost_sessions": lost,
            "round_times_ms": round_times_ms,
        }
