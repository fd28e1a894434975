"""The port's admission, session and liveness primitives against the JAX
package's, on the reference's cases (``tests/test_serve_batcher.py``).

The same scripts of operations, with a ``FakeClock``, run through both
packages' ``DualThresholdAdmitter`` (and ``drain``), ``SensorSession``
(accept under both shed policies, take, restore, export and requeue),
``HeartbeatMonitor``, ``StragglerTracker`` and ``SessionHealth``; every
observable (readiness, popped items, weights, ages, counters, errors)
must be equal. These are host objects: there is nothing to round, so
every value compares exactly.
"""
import dataclasses

import numpy as np
import pytest

from repro.distributed import fault_tolerance as JFT
from repro.serve import batcher as JB
from repro.serve import faults as JF
from repro.serve import sessions as JS
from repro_torch.distributed import fault_tolerance as TFT
from repro_torch.serve import batcher as TB
from repro_torch.serve import faults as TF
from repro_torch.serve import sessions as TS


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self) -> float:
        return self.now


def _admitter(pkg, max_delay_s, max_items):
    clock = FakeClock()
    return pkg.DualThresholdAdmitter(pkg.AdmissionConfig(max_delay_s, max_items), clock), clock


def _run_script(pkg, cfg, script):
    """Run ``(op, *args)`` steps; return every observable after each."""
    adm, clock = _admitter(pkg, *cfg)
    seen = []
    for op, *args in script:
        try:
            if op == "tick":
                clock.now += args[0]
                out = None
            elif op == "drain":
                out = pkg.drain(adm, force=args[0])
            else:
                out = getattr(adm, op)(*args)
        except ValueError as e:
            out = ("ValueError", str(e))
        seen.append((op, out, adm.ready(), adm.items, adm.pending_weight,
                     adm.oldest_age_s(), len(adm)))
    return seen


# The reference's cases, as scripts: (config, steps).
CASES = {
    "empty": ((0.02, 4), [("ready",), ("pop",), ("pop_all",)]),
    "time threshold": ((0.02, 100), [("submit", "a"), ("tick", 0.015), ("submit", "b"),
                                     ("tick", 0.005), ("pop_all",)]),
    "size counts weight": ((10.0, 250), [("submit", "c1", 200), ("submit", "c2", 50)]),
    "prefix pop": ((10.0, 4), [("submit", "a", 2), ("submit", "b", 2), ("submit", "c", 1),
                               ("pop",)]),
    "overweight head": ((10.0, 4), [("submit", "huge", 100), ("submit", "next", 1), ("pop",)]),
    "drain": ((0.02, 100), [("submit", "a"), ("drain", False), ("drain", True), ("submit", "b"),
                            ("tick", 1.0), ("drain", False)]),
    "negative weight": ((0.02, 250), [("submit", "a", -1), ("restate", "a", -1)]),
    "discard": ((0.02, 100), [("submit", "a", 30), ("submit", "b", 10), ("submit", "a", 20),
                              ("discard", "a"), ("tick", 1.0), ("discard", "missing")]),
    "restate": ((10.0, 100), [("submit", "a", 30), ("submit", "b", 10), ("submit", "a", 20),
                              ("restate", "a", 12)]),
    "restate keeps arrival": ((0.02, 10_000), [("submit", "a", 50), ("tick", 0.010),
                                               ("restate", "a", 30), ("tick", 0.011)]),
    "restate zero": ((0.02, 100), [("submit", "a", 5), ("restate", "a", 0), ("tick", 1.0),
                                   ("restate", "b", 7)]),
    "restate order": ((10.0, 3), [("submit", "a", 1), ("tick", 0.01), ("submit", "b", 1),
                                  ("tick", 0.01), ("submit", "c", 1), ("restate", "b", 1),
                                  ("pop",)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_admitter_cases_match_reference(case):
    cfg, script = CASES[case]
    assert _run_script(TB, cfg, script) == _run_script(JB, cfg, script)


def _random_script(seed: int, n: int = 60):
    rng = np.random.default_rng(seed)
    items = ["s0", "s1", "s2", "s3"]
    script = []
    for _ in range(n):
        r = int(rng.integers(0, 8))
        item = items[int(rng.integers(len(items)))]
        if r < 3:
            script.append(("submit", item, int(rng.integers(0, 150))))
        elif r == 3:
            script.append(("tick", float(rng.integers(0, 15)) * 1e-3))
        elif r == 4:
            script.append(("pop",))
        elif r == 5:
            script.append(("discard", item))
        elif r == 6:
            script.append(("restate", item, int(rng.integers(0, 150))))
        else:
            script.append(("drain", bool(rng.integers(0, 2))))
    return script


@pytest.mark.parametrize("seed", range(6))
def test_admitter_random_scripts_match_reference(seed):
    script = _random_script(seed)
    assert _run_script(TB, (0.02, 250), script) == _run_script(JB, (0.02, 250), script)


def test_admission_config_validation():
    for pkg in (TB, JB):
        with pytest.raises(ValueError, match="max_items"):
            pkg.AdmissionConfig(0.02, 0)
        with pytest.raises(ValueError, match="max_delay_s"):
            pkg.AdmissionConfig(-1.0, 8)
    assert dataclasses.asdict(TB.AdmissionConfig()) == dataclasses.asdict(JB.AdmissionConfig())


# ---------------------------------------------------------------------------
# Sensor sessions.
# ---------------------------------------------------------------------------

def _chunk(rng, t0, n):
    return (rng.integers(0, 640, n), rng.integers(0, 480, n),
            t0 + np.sort(rng.integers(0, 5_000, n)), rng.integers(0, 2, n))


def _session_trace(pkg, policy, budget, seed):
    """A seeded accept / take / restore / export / requeue script through
    one session; returns every observable after each step."""
    rng = np.random.default_rng(seed)
    clock = FakeClock()
    sess = pkg.SensorSession(sid=3, slot=1, name="cam", clock=clock, queue_budget=budget,
                             shed_policy=policy)
    seen, t0, taken = [], 0, None
    for step in range(40):
        clock.now += 0.003
        r = int(rng.integers(0, 10))
        if r < 6:
            n = int(rng.integers(0, 90))
            c = _chunk(rng, t0, n)
            if r == 5 and n > 1:  # a regressing chunk: refused, session unharmed
                c = (c[0], c[1], c[2][::-1].copy(), c[3])
            try:
                out = sess.accept(*c)
                t0 = int(c[2][-1]) + 1 if n else t0
            except ValueError as e:
                out = str(e)
        elif r < 8:
            taken = sess.take()
            out = None if taken[0] is None else [a.tolist() for a in taken[0]] + [taken[1]]
        elif r == 8 and taken is not None and taken[0] is not None:
            sess.restore(*taken)
            taken, out = None, "restored"
        else:
            q = sess.export_queue()
            for c, arr in q:
                sess.requeue(c, arr)
            out = [(len(c[2]), arr) for c, arr in q]
        seen.append((step, out, sess.queued_events, sess.last_t, dataclasses.asdict(sess.stats)))
    sess.record_step(4, 1.5)
    sess.record_step(0, None)
    seen.append((dataclasses.asdict(sess.stats), sess.drop_queue(), sess.queued_events,
                 [dataclasses.asdict(sess.record_error("validation", "bad"))]))
    return seen


@pytest.mark.parametrize("policy,budget", [("reject", None), ("reject", 120), ("drop_oldest", 120)])
@pytest.mark.parametrize("seed", [0, 1])
def test_sensor_session_matches_reference(policy, budget, seed):
    assert _session_trace(TS, policy, budget, seed) == _session_trace(JS, policy, budget, seed)


def test_session_refuses_garbage_and_closed_states():
    for pkg in (TS, JS):
        sess = pkg.SensorSession(sid=0, slot=0, name="s", clock=FakeClock())
        z = np.zeros(3, np.int64)
        for bad in ((z + pkg.COORD_LIMIT, z, z, z), (z, z - pkg.COORD_LIMIT, z, z),
                    (z, z, z, z + pkg.COORD_LIMIT)):
            with pytest.raises(ValueError, match="corrupt"):
                sess.accept(*bad)
        sess.state = pkg.DETACHED
        with pytest.raises(RuntimeError, match="detached"):
            sess.accept(z, z, z, z)
        with pytest.raises(ValueError, match="shed_policy"):
            pkg.SensorSession(sid=0, slot=0, name="s", clock=FakeClock(), shed_policy="newest")
        with pytest.raises(ValueError, match="queue_budget"):
            pkg.SensorSession(sid=0, slot=0, name="s", clock=FakeClock(), queue_budget=0)
    assert (TS.COORD_LIMIT, TS.MAX_LATENCY_SAMPLES, TS.SHED_POLICIES) == \
        (JS.COORD_LIMIT, JS.MAX_LATENCY_SAMPLES, JS.SHED_POLICIES)


# ---------------------------------------------------------------------------
# Liveness and stragglers.
# ---------------------------------------------------------------------------

def _monitor_trace(pkg):
    clock = FakeClock()
    mon = pkg.HeartbeatMonitor(("a", "b"), timeout_s=0.05, clock=clock)
    seen = []
    steps = [("register", "c"), ("tick", 0.03), ("beat", "a"), ("tick", 0.03), ("beat", "zz"),
             ("register", "a"), ("forget", "b"), ("forget", "b"), ("tick", 0.06), ("beat", "c")]
    for op, arg in steps:
        try:
            if op == "tick":
                clock.now += arg
                out = None
            else:
                out = getattr(mon, op)(arg)
        except (KeyError, ValueError) as e:
            out = type(e).__name__
        seen.append((op, out, mon.nodes, mon.failed_nodes(), mon.healthy_nodes(),
                     "a" in mon, [mon.last_beat_s(n) for n in mon.nodes]))
    return seen


def test_heartbeat_monitor_matches_reference():
    assert _monitor_trace(TFT) == _monitor_trace(JFT)


@pytest.mark.parametrize("factor,alpha", [(2.0, 0.2), (4.0, 1.0)])
def test_straggler_tracker_matches_reference(factor, alpha):
    """Seeded step times for five nodes, node 3 about ten times slower."""
    rng = np.random.default_rng(int(factor))
    nodes = rng.integers(0, 5, 40)
    times = rng.uniform(1.0, 20.0, len(nodes)) * np.where(nodes == 3, 10.0, 1.0)
    traces = []
    for pkg in (TFT, JFT):
        tr = pkg.StragglerTracker(factor=factor, alpha=alpha)
        trace = [(tr.fleet_median(), tr.stragglers())]
        for n, t in zip(nodes.tolist(), times.tolist()):
            tr.record(n, t)
            trace.append((tr.ema(n), tr.fleet_median(), tr.stragglers()))
        tr.forget(3)
        tr.forget(99)
        trace.append((tr.fleet_median(), tr.stragglers(), tr.ema(3)))
        traces.append(trace)
    assert traces[0] == traces[1]
    assert any(3 in st for _, _, st in traces[0][1:-1])


def test_session_health_and_fault_config_match_reference():
    for kw in ({"on_validation_error": "panic"}, {"shed_policy": "newest"},
               {"queue_budget_events": 0}, {"heartbeat_timeout_s": 0.0},
               {"max_step_retries": -1}, {"retry_backoff_s": -0.1}, {"straggler_factor": 1.0}):
        for pkg in (TF, JF):
            with pytest.raises(ValueError):
                pkg.FaultConfig(**kw)
    assert dataclasses.asdict(TF.FaultConfig()) == dataclasses.asdict(JF.FaultConfig())
    traces = []
    for pkg in (TF, JF):
        clock = FakeClock()
        h = pkg.SessionHealth(pkg.FaultConfig(heartbeat_timeout_s=0.05, straggler_factor=2.0,
                                              straggler_alpha=1.0), clock)
        trace = []
        for sid in range(3):
            h.register(sid)
        for step in range(6):
            clock.now += 0.02
            h.beat(step % 2)
            h.note_latency(step % 3, 5.0 if step % 3 else 50.0)
            trace.append((h.expired(), h.stragglers()))
        h.forget(2)
        h.forget(7)
        trace.append((h.expired(), h.stragglers()))
        off = pkg.SessionHealth(pkg.FaultConfig(), clock)
        off.register(0)
        off.beat(0)
        trace.append(off.expired())
        traces.append(trace)
    assert traces[0] == traces[1]
