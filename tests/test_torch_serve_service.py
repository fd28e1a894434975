"""The port's ``DetectionService`` on the CPU, against the JAX package's.

The reference's corpora (``tests/test_serve_service.py``,
``tests/test_serve_async.py``): the recordings of ``_service_recordings``
and evenly spaced synthetic streams, fed through both packages' services
with a ``FakeClock`` under the same schedule. Against the JAX service:
a random churn schedule (attach, feed, idle, pump, detach, tier
promotion and demotion); quarantine, heartbeat eviction and demotion;
both shed policies; step retry and degraded rounds under a flaky fleet;
a quarantine at depth 2 with rounds in flight; and a session exported
from one package's service and adopted by the other's, both ways. Every
session's outputs compare with ``tests/test_torch_pipeline.py``'s
tolerances (integers exact, metrics rtol = atol = 1e-5, tracker floats
rtol 1e-6, atol 1e-4), and the counters and per-session accounting
exactly. Within the port: every session equals a dedicated
``StreamingPipeline`` of the same chunks to the bit, on the default, the
float kernel and the fixed megakernel configs; depth 2 and 3 equal depth
1 with slot recycling and promotion while rounds are in flight; the
admission, validation, accounting and lifecycle cases of the reference.
The reference's compile-count tests have no counterpart: PyTorch
compiles nothing.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.core import pipeline as JP
from repro.core import tracking as JT
from repro.core.pipeline import fleet as JF
from repro.serve import AdmissionConfig as JAdmissionConfig
from repro.serve import DetectionService as JDetectionService
from repro.serve import FaultConfig as JFaultConfig
from repro.serve import service as JS
from repro.serve import sessions as JSess
from repro_torch.core import pipeline as TP
from repro_torch.core.events import BatcherConfig
from repro_torch.data.evas import iter_chunks
from repro_torch.data.synthetic import make_recording
from repro_torch.serve import (
    AdmissionConfig,
    DetectionService,
    FaultConfig,
    session_export_from_numpy,
    session_export_to_numpy,
)
from repro_torch.serve.sessions import MAX_LATENCY_SAMPLES, SessionStats

torch.set_num_threads(1)

CONFIG = TP.PipelineConfig()
KERNEL_CFG = TP.PipelineConfig(use_kernels=True, metrics_impl="kernel")
FIXED_CFG = TP.PipelineConfig(numerics="fixed", metrics_impl="megakernel")
EXACT_METRICS = ("event_count", "edge_density")
LAZY = dict(max_delay_s=1e9, max_items=1 << 30)  # admission never fires


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self) -> float:
        return self.now


@functools.lru_cache(maxsize=None)
def _service_recordings(n: int = 4, duration_s: float = 0.25):
    return tuple(make_recording(seed=40 + s, duration_s=duration_s, n_rsos=1 + s % 2) for s in range(n))


def _spaced_stream(seed: int, n: int, dt_us: int = 100):
    """Evenly spaced synthetic events (the reference's ``_spaced_stream``)."""
    rng = np.random.default_rng(seed)
    return (
        rng.integers(40, 560, n).astype(np.int64),
        rng.integers(40, 400, n).astype(np.int64),
        (np.arange(n, dtype=np.int64) + 1) * dt_us,
        rng.integers(0, 2, n).astype(np.int64),
    )


def _sl(chunk, a, b):
    return tuple(c[a:b] for c in chunk)


# ---------------------------------------------------------------------------
# Outputs as numpy, compared exactly or to the reference's tolerances.
# ---------------------------------------------------------------------------

def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _surfaces(parts) -> dict:
    """One session's results over its lifetime, concatenated, as numpy;
    the tracker state of its last part, and the window count."""
    live = [p for p in parts if p.num_windows]
    out = {"windows": sum(p.num_windows for p in parts)}
    if live:
        cat = lambda get: np.concatenate([_np(get(p)) for p in live])  # noqa: E731
        out["t_start_us"] = cat(lambda p: p.t_start_us)
        for f in live[0].clusters._fields:
            out[f"clusters.{f}"] = cat(lambda p: getattr(p.clusters, f))
        for k in live[0].metrics:
            out[f"metrics.{k}"] = cat(lambda p: p.metrics[k])
        if live[0].tracks is not None:
            for f in live[0].tracks._fields:
                out[f"tracks.{f}"] = cat(lambda p: getattr(p.tracks, f))
    last = parts[-1].final_tracks if parts else None
    if last is not None:
        for f in last._fields:
            out[f"final.{f}"] = _np(getattr(last, f))
    return out


def _assert_same(got: dict, want: dict, exact: bool = True, what: str = ""):
    """Exact, or (port against reference) integers exact, metrics rtol =
    atol = 1e-5 and tracker floats rtol 1e-6, atol 1e-4."""
    assert got.keys() == want.keys(), (what, sorted(got), sorted(want))
    for k, a in got.items():
        b = want[k]
        if k == "windows":
            assert a == b, (what, k, a, b)
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (what, k, a.shape, b.shape)
        name = k.split(".", 1)[-1]
        if exact or not np.issubdtype(a.dtype, np.floating) or k.startswith("clusters.") \
                or name in EXACT_METRICS:
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {k}")
        elif k.startswith("metrics."):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-4, err_msg=f"{what} {k}")


def _collect(served, parts):
    for fd in served:
        parts.setdefault(fd.sid, []).append(fd.result)


def _stream_parts(chunks, config=CONFIG, final=True):
    """A dedicated port stream fed the same chunks (and flushed)."""
    sp = TP.StreamingPipeline(config, device="cpu")
    parts = [sp.feed(*c) for c in chunks]
    if final:
        parts.append(sp.flush())
    return parts


def _both(**kw):
    """The same service in each package: (port, reference), each with its
    own fake clock."""
    jkw = dict(kw)
    if "admission" in kw:
        jkw["admission"] = JAdmissionConfig(**dataclasses.asdict(kw["admission"]))
    if "faults" in kw:
        jkw["faults"] = JFaultConfig(**dataclasses.asdict(kw["faults"]))
    jkw["config"] = JP.PipelineConfig()
    t = DetectionService(CONFIG, clock=FakeClock(), device="cpu", **kw)
    j = JDetectionService(clock=FakeClock(), **{k: v for k, v in jkw.items()})
    return t, j


def _stats(svc, sid) -> dict:
    return dataclasses.asdict(svc.session(sid).stats)


def _counters(svc) -> dict:
    return {k: getattr(svc, k) for k in (
        "capacity", "n_sessions", "promotions", "demotions", "quarantines", "evictions",
        "degraded_rounds", "step_retries", "deferred_rounds")}


# ---------------------------------------------------------------------------
# Against the JAX package.
# ---------------------------------------------------------------------------

def _churn_schedule(seed: int, n_ops: int = 30):
    """A seeded attach / feed / pump / detach schedule (the reference's
    random-churn test); decisions draw only on the rng."""
    rng = np.random.default_rng(seed)
    recs = _service_recordings()
    ops, live, spawned = [], {}, 0
    for _ in range(n_ops):
        r = int(rng.integers(0, 10))
        if r < 3 and len(live) < 4:
            live[spawned] = [int(rng.integers(len(recs))), 0]
            ops.append(("attach", spawned))
            spawned += 1
        elif r < 8 and live:
            key = int(rng.choice(sorted(live)))
            rec_ix, pos = live[key]
            cut = min(pos + int(rng.integers(1, 1200)), len(recs[rec_ix]))
            if cut > pos:
                ops.append(("feed", key, rec_ix, pos, cut))
                live[key][1] = cut
        elif r < 9:
            ops.append(("pump",))
        elif live:
            key = int(rng.choice(sorted(live)))
            ops.append(("detach", key))
            del live[key]
    ops.extend(("detach", k) for k in sorted(live))
    return ops


def _run_schedule(svc, ops, dt: float = 0.004):
    recs = _service_recordings()
    sids, parts = {}, {}
    for op in ops:
        svc.clock.now += dt
        if op[0] == "attach":
            sids[op[1]] = svc.attach()
            parts[sids[op[1]]] = []
        elif op[0] == "feed":
            _, key, rec_ix, a, b = op
            r = recs[rec_ix]
            _collect(svc.feed(sids[key], r.x[a:b], r.y[a:b], r.t[a:b], r.p[a:b]), parts)
        elif op[0] == "pump":
            _collect(svc.pump(force=True), parts)
        else:
            parts[sids[op[1]]].append(svc.detach(sids[op[1]]))
    return sids, parts


@pytest.mark.parametrize("seed", [3, 11])
def test_random_churn_matches_reference_service(seed):
    """Churn with slot recycling and the 2 -> 4 promotion: every session's
    outputs, its accounting and the service's counters equal the JAX
    service's."""
    ops = _churn_schedule(seed)
    adm = AdmissionConfig(max_delay_s=0.02, max_items=600)
    t, j = _both(tiers=(2, 4), admission=adm)
    t_sids, t_parts = _run_schedule(t, ops)
    j_sids, j_parts = _run_schedule(j, ops)
    assert t_sids == j_sids
    assert _counters(t) == _counters(j)
    for sid in t_sids.values():
        _assert_same(_surfaces(t_parts[sid]), _surfaces(j_parts[sid]), exact=False, what=f"session {sid}")
        assert _stats(t, sid) == _stats(j, sid)
        assert t.session(sid).state == j.session(sid).state == "detached"


def test_quarantine_eviction_and_demotion_match_reference():
    """A garbage chunk quarantines one session; two silent ones are
    evicted (queue and trailing window flushed into ``tail_result``), and
    emptying the pool's upper half demotes it 4 -> 2; the survivor streams
    on. States, error records, counters and every output equal the JAX
    service's."""
    faults = FaultConfig(on_validation_error="quarantine", heartbeat_timeout_s=0.05)
    t, j = _both(tiers=(2, 4), admission=AdmissionConfig(**LAZY), faults=faults)
    streams = [_spaced_stream(60 + i, 500) for i in range(4)]
    parts = {}
    for svc in (t, j):
        p = parts[svc] = {}
        a, b, c, d = (svc.attach(f"s{i}") for i in range(4))
        assert svc.capacity == 4 and svc.promotions == 1
        for sid in (a, b, c, d):
            svc.feed(sid, *_sl(streams[sid], 0, 120))
        svc.clock.now += 0.03
        garbage = _sl(streams[b], 120, 220)
        svc.feed(b, garbage[0] + (np.int64(1) << 31), *garbage[1:])  # quarantined
        svc.feed(a, *_sl(streams[a], 120, 260))
        _collect(svc.pump(force=True), p)
        svc.clock.now += 0.03  # c and d 60 ms silent: evicted by a's feed
        _collect(svc.feed(a, *_sl(streams[a], 260, 400)), p)
        assert svc.capacity == 2 and svc.demotions == 1
        _collect(svc.feed(a, *_sl(streams[a], 400, 500)), p)
        p[a].append(svc.detach(a))
        assert [svc.session(s).state for s in (a, b, c, d)] == \
            ["detached", "quarantined", "evicted", "evicted"]
    assert _counters(t) == _counters(j)
    assert (t.evictions, t.quarantines) == (2, 1)
    assert [(e.kind, e.sid, e.time_s, e.message) for e in t.errors] == \
        [(e.kind, e.sid, e.time_s, e.message) for e in j.errors]
    _assert_same(_surfaces(parts[t][0]), _surfaces(parts[j][0]), exact=False, what="survivor")
    for sid in (2, 3):
        _assert_same(_surfaces([t.session(sid).tail_result]), _surfaces([j.session(sid).tail_result]),
                     exact=False, what=f"eviction tail {sid}")
    for sid in range(4):
        assert _stats(t, sid) == _stats(j, sid), sid


@pytest.mark.parametrize("policy", ["reject", "drop_oldest"])
def test_shed_policies_match_reference(policy):
    """Queue budgets of 100 events under both shed policies: the shed
    accounting (offered == events + shed), the admitter's weight and the
    outputs equal the JAX service's."""
    faults = FaultConfig(queue_budget_events=100, shed_policy=policy)
    t, j = _both(tiers=(2,), admission=AdmissionConfig(**LAZY), faults=faults)
    x = _spaced_stream(25, 600)
    res = []
    for svc in (t, j):
        parts = {}
        sid = svc.attach()
        for a, b in ((0, 80), (80, 160), (160, 310), (310, 330)):
            svc.feed(sid, *_sl(x, a, b))
        assert svc._admit.pending_weight == svc.session(sid).queued_events
        _collect(svc.pump(force=True), parts)
        svc.feed(sid, *_sl(x, 330, 420))
        parts.setdefault(sid, []).append(svc.detach(sid))
        st = svc.session(sid).stats
        assert st.offered_events == st.events + st.shed_events
        res.append(parts[sid])
    assert _stats(t, 0) == _stats(j, 0)
    assert t.session(0).stats.shed_events > 0
    _assert_same(_surfaces(res[0]), _surfaces(res[1]), exact=False, what=policy)


class _FlakyFleet:
    """Fleet wrapper whose dispatch raises the next ``fail`` times (the
    reference's ``tests/test_serve_service.py:_FlakyFleet``)."""

    def __init__(self, fleet, fail: int):
        self._fleet = fleet
        self.fail = fail

    def __getattr__(self, name):
        return getattr(self._fleet, name)

    def _maybe_fail(self):
        if self.fail > 0:
            self.fail -= 1
            raise RuntimeError(f"boom {self.fail}")

    def feed(self, *args, **kwargs):
        self._maybe_fail()
        return self._fleet.feed(*args, **kwargs)

    def feed_async(self, *args, **kwargs):
        self._maybe_fail()
        return self._fleet.feed_async(*args, **kwargs)


def test_retry_and_degrade_match_reference():
    """One transient failure heals by retry; then every attempt fails and
    the round degrades with its chunks restored; the healed fleet re-feeds
    them. Counters, backoff sleeps, error records and outputs equal the
    JAX service's, and the outputs a never-faulted run's."""
    faults = FaultConfig(max_step_retries=2, retry_backoff_s=0.01, degrade_on_step_failure=True)
    chunk = _spaced_stream(29, 500)
    res = []
    for pkg in ("port", "reference"):
        sleeps = []
        svc = (DetectionService(CONFIG, tiers=(2,), faults=faults, clock=FakeClock(),
                                sleep=sleeps.append, device="cpu")
               if pkg == "port" else
               JDetectionService(JP.PipelineConfig(), tiers=(2,),
                                 faults=JFaultConfig(**dataclasses.asdict(faults)),
                                 clock=FakeClock(), sleep=sleeps.append))
        parts = {}
        sid = svc.attach()
        fleet = svc._fleet
        svc.feed(sid, *_sl(chunk, 0, 200))
        svc._fleet = _FlakyFleet(fleet, fail=1)
        _collect(svc.pump(force=True), parts)
        assert svc.step_retries == 1 and svc.degraded_rounds == 0
        svc.feed(sid, *_sl(chunk, 200, 400))
        svc._fleet.fail = 3
        assert svc.pump(force=True) == []
        assert svc.degraded_rounds == 1 and svc.session(sid).queued_events == 200
        _collect(svc.pump(force=True), parts)
        svc.feed(sid, *_sl(chunk, 400, 500))
        parts[sid].append(svc.detach(sid))
        res.append((parts[sid], sleeps, svc))
    (tp, ts, t), (jp, js, j) = res
    assert ts == js == [0.01, 0.01, 0.02]
    assert _counters(t) == _counters(j)
    assert [(e.kind, e.message) for e in t.session(0).errors] == \
        [(e.kind, e.message) for e in j.session(0).errors]
    assert _stats(t, 0) == _stats(j, 0)
    _assert_same(_surfaces(tp), _surfaces(jp), exact=False, what="retry/degrade")
    clean = _stream_parts([_sl(chunk, 0, 200), _sl(chunk, 200, 400), _sl(chunk, 400, 500)])
    _assert_same(_surfaces(tp), _surfaces(clean), what="against a never-faulted stream")


def test_strict_step_failure_reraises_the_last_error_as_reference():
    """Under the strict default the last attempt's error propagates (not
    the first), in both packages."""
    for svc in (DetectionService(CONFIG, tiers=(2,), faults=FaultConfig(max_step_retries=1),
                                 clock=FakeClock(), device="cpu"),
                JDetectionService(JP.PipelineConfig(), tiers=(2,),
                                  faults=JFaultConfig(max_step_retries=1), clock=FakeClock())):
        sid = svc.attach()
        svc.feed(sid, *_spaced_stream(30, 100))
        svc._fleet = _FlakyFleet(svc._fleet, fail=2)
        with pytest.raises(RuntimeError, match="boom 0"):
            svc.pump(force=True)
        assert svc.step_retries == 1


def test_quarantine_in_flight_at_depth_two_matches_reference():
    """Depth 2 with a quarantine while rounds are in flight: results are
    read only after later rounds were dispatched, and the healthy
    session's outputs equal the JAX service's at depth 2 and the port's
    at depth 1."""
    rec = _service_recordings()[0]
    bad_stream = _spaced_stream(60, 2000)

    def run(svc):
        healthy, bad = svc.attach("healthy"), svc.attach("bad")
        served, pos = [], 0
        for r in range(8):
            svc.clock.now += 0.01
            lo, hi = pos, min(pos + 300, len(rec.t))
            served += svc.feed(healthy, rec.x[lo:hi], rec.y[lo:hi], rec.t[lo:hi], rec.p[lo:hi])
            pos = hi
            bx, by, bt, bp = (a[r * 200:(r + 1) * 200] for a in bad_stream)
            if r == 4:
                if svc.max_inflight_rounds > 1:
                    assert svc.inflight_rounds >= 1  # the fault lands mid-flight
                served += svc.feed(bad, bx, by, bt[::-1].copy(), bp)
                assert svc.session(bad).state == "quarantined"
            elif svc.session(bad).state == "live":
                served += svc.feed(bad, bx, by, bt, bp)
        tail = svc.detach(healthy)
        svc.drain()
        parts = {}
        _collect(served, parts)  # materialized only now, after every dispatch
        return parts[healthy] + [tail], svc

    faults = FaultConfig(on_validation_error="quarantine")
    adm = AdmissionConfig(max_delay_s=1e9, max_items=250)
    t2, j2 = _both(tiers=(2,), admission=adm, faults=faults, max_inflight_rounds=2)
    t1 = DetectionService(CONFIG, tiers=(2,), admission=adm, faults=faults, clock=FakeClock(),
                          device="cpu")
    (got, t2), (want, j2), (sync, t1) = run(t2), run(j2), run(t1)
    _assert_same(_surfaces(got), _surfaces(want), exact=False, what="depth 2 vs reference")
    _assert_same(_surfaces(got), _surfaces(sync), what="depth 2 vs depth 1")
    # Deferral follows the device's timing (a JAX round may still be
    # running on the CPU), so it is left out; nothing else does.
    drop = lambda c: {k: v for k, v in c.items() if k != "deferred_rounds"}  # noqa: E731
    assert drop(_counters(t2)) == drop(_counters(j2))


def _reference_export(d: dict):
    """A reference ``SessionExport`` from the port's numpy form."""
    c = d["carry"]
    carry = JF.SlotCarry(
        cursor=JF.SensorCursor(pending=c["pending"], events_consumed=c["events_consumed"],
                               next_tag=c["next_tag"], last_t=c["last_t"]),
        atlas=c["atlas"], tracks=JT.TrackState(**c["tracks"]),
    )
    return JS.SessionExport(
        name=d["name"], carry=carry, queue=list(d["queue"]), last_t=d["last_t"],
        stats=JSess.SessionStats(**d["stats"]), errors=[JSess.SessionError(**e) for e in d["errors"]],
    )


def _numpy_export(e) -> dict:
    """The port's numpy form of a reference ``SessionExport``."""
    c = e.carry
    return dict(
        name=e.name,
        carry=dict(pending=c.cursor.pending, events_consumed=c.cursor.events_consumed,
                   next_tag=c.cursor.next_tag, last_t=c.cursor.last_t, atlas=np.asarray(c.atlas),
                   tracks={f: np.asarray(getattr(c.tracks, f)) for f in c.tracks._fields}),
        queue=[(tuple(np.asarray(a) for a in ch), arr) for ch, arr in e.queue],
        last_t=e.last_t, stats=dataclasses.asdict(e.stats),
        errors=[dataclasses.asdict(x) for x in e.errors],
    )


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_session_migrates_across_packages(direction):
    """A session exported mid-stream, with chunks still queued, from one
    package's service and adopted by the other's (a different slot, a
    neighbour streaming beside it) resumes: its concatenated outputs equal
    a never-migrated run, and its accounting survives the hop."""
    rec = _service_recordings()[1]
    other = _spaced_stream(70, 3000)
    chunks = list(iter_chunks(rec))
    cut = len(chunks) // 2
    t, j = _both(tiers=(2,), admission=AdmissionConfig(**LAZY))
    src, dst = (j, t) if direction == "reference_to_port" else (t, j)
    parts = {}
    sid = src.attach("mover")
    for i, c in enumerate(chunks[:cut]):
        src.feed(sid, *c)
        if i % 3 == 1:
            _collect(src.pump(force=True), parts)
    assert src.session(sid).queued_events > 0  # the export carries a queue
    before = list(parts.get(sid, []))
    exp = src.export_session(sid)
    # A twin session in the other package, driven alike, exports the same
    # carry: the atlas (written by the atlas event core) exactly.
    t2, j2 = _both(tiers=(2,), admission=AdmissionConfig(**LAZY))
    twin = t2 if src is j else j2
    tsid = twin.attach("mover")
    for i, c in enumerate(chunks[:cut]):
        twin.feed(tsid, *c)
        if i % 3 == 1:
            twin.pump(force=True)
    twin_exp = twin.export_session(tsid)
    assert twin_exp.carry.cursor.next_tag == exp.carry.cursor.next_tag > 0
    np.testing.assert_array_equal(np.asarray(twin_exp.carry.atlas), np.asarray(exp.carry.atlas))
    assert np.count_nonzero(np.asarray(exp.carry.atlas)) > 0
    if direction == "reference_to_port":
        exp = session_export_from_numpy(_numpy_export(exp))
    else:
        exp = _reference_export(session_export_to_numpy(exp))
    neighbour = dst.attach("neighbour")
    dst.feed(neighbour, *_sl(other, 0, 700))
    new = dst.adopt_session(exp)
    assert dst.session(new).slot == 1 and src.session(sid).state == "migrated"
    after = {}
    for i, c in enumerate(chunks[cut:]):
        dst.feed(new, *c)
        if i % 2:
            _collect(dst.pump(force=True), after)
    after.setdefault(new, []).append(dst.detach(new))
    got = before + after[new]
    never = _stream_parts(chunks)
    _assert_same(_surfaces(got), _surfaces(never), exact=False, what=direction)
    st = dst.session(new).stats
    assert st.events == len(rec) and st.offered_events == len(rec)
    assert st.windows == _surfaces(never)["windows"]


# ---------------------------------------------------------------------------
# Within the port: every session equals its dedicated stream.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("config", [CONFIG, KERNEL_CFG, FIXED_CFG], ids=["default", "kernel", "fixed"])
def test_sessions_equal_dedicated_streams(config):
    """Three sessions (forcing the 2 -> 4 promotion), one detached and its
    slot recycled mid-run, fed live-cadence chunks: each equals a
    dedicated stream of the same chunks to the bit."""
    recs = _service_recordings()
    svc = DetectionService(config, tiers=(2, 4), clock=FakeClock(), device="cpu")
    chunk_lists = [list(iter_chunks(r)) for r in recs]
    sids = [svc.attach(f"s{i}") for i in range(3)]
    assert svc.capacity == 4 and svc.promotions == 1
    feeds = {sid: (i, 0) for i, sid in enumerate(sids)}
    parts, fed = {}, {}
    for j in range(max(map(len, chunk_lists))):
        if j == 6:  # one leaves, a fourth takes its slot
            slot = svc.session(sids[1]).slot
            parts.setdefault(sids[1], []).append(svc.detach(sids[1]))
            del feeds[sids[1]]
            new = svc.attach("s3")
            assert svc.session(new).slot == slot
            feeds[new] = (3, j)
        for sid, (i, j0) in feeds.items():
            if j - j0 < len(chunk_lists[i]):
                c = chunk_lists[i][j - j0]
                fed.setdefault(sid, []).append(c)
                _collect(svc.feed(sid, *c), parts)
        _collect(svc.pump(force=True), parts)
    for sid in list(feeds):
        parts.setdefault(sid, []).append(svc.detach(sid))
    for sid, chunks in fed.items():
        _assert_same(_surfaces(parts[sid]), _surfaces(_stream_parts(chunks, config)), what=f"session {sid}")


def _drive(depth: int, seed: int):
    """The reference's depth schedule (``tests/test_serve_async.py``):
    churn and random chunking from a seeded rng, results read only after
    the service is drained."""
    rng = np.random.default_rng(seed)
    recs = _service_recordings()
    svc = DetectionService(CONFIG, tiers=(2, 4), admission=AdmissionConfig(0.02, 600),
                           clock=FakeClock(), max_inflight_rounds=depth, device="cpu")
    live, served, tails, keys, spawned = {}, [], {}, {}, 0
    for _ in range(40):
        svc.clock.now += 0.01
        if live and rng.random() < 0.15:
            sid = list(live)[int(rng.integers(len(live)))]
            tails[sid] = svc.detach(sid)
            del live[sid]
        if len(live) < 4 and rng.random() < 0.5:
            sid = svc.attach()
            live[sid] = [spawned % len(recs), 0]
            keys[sid] = spawned
            spawned += 1
        for sid, st in live.items():
            rec = recs[st[0]]
            lo, hi = st[1], min(st[1] + int(rng.integers(0, 400)), len(rec.t))
            if hi > lo:
                served += svc.feed(sid, rec.x[lo:hi], rec.y[lo:hi], rec.t[lo:hi], rec.p[lo:hi])
                st[1] = hi
        served += svc.pump(force=rng.random() < 0.3)
    for sid in list(live):
        tails[sid] = svc.detach(sid)
    svc.drain()
    assert svc.inflight_rounds == 0
    parts = {}
    _collect(served, parts)
    return {keys[sid]: _surfaces(parts.get(sid, []) + [tails[sid]]) for sid in keys}


@pytest.mark.parametrize("seed", [0, 7])
def test_depth_two_and_three_equal_depth_one(seed):
    """The reference's seeded churn at depth 1, 2 and 3, results read only
    after the drain: session by session equal to the bit."""
    ref = _drive(1, seed)
    for depth in (2, 3):
        got = _drive(depth, seed)
        assert got.keys() == ref.keys()
        for key in ref:
            _assert_same(got[key], ref[key], what=f"depth {depth} session {key}")


def test_promotion_and_recycling_while_a_round_is_in_flight():
    """At depth 2, a slot is recycled (``reset_slots``) and the pool is
    promoted (``grow``) while dispatched rounds are unretired; results
    read afterwards equal dedicated streams."""
    svc = DetectionService(CONFIG, tiers=(2, 4), admission=AdmissionConfig(1e9, 250),
                           clock=FakeClock(), max_inflight_rounds=2, device="cpu")
    data = [_spaced_stream(80 + i, 1500) for i in range(4)]
    a, b = svc.attach(), svc.attach()
    served, fed = [], {a: [], b: []}
    for r in range(3):
        for sid, d in ((a, data[0]), (b, data[1])):
            c = _sl(d, 250 * r, 250 * (r + 1))
            fed[sid].append(c)
            served += svc.feed(sid, *c)
    assert svc.inflight_rounds >= 1
    tail_b = svc.detach(b)  # flush + reset_slots with a round in flight
    assert svc.inflight_rounds >= 1
    c_sid = svc.attach()  # recycles b's slot
    assert svc.session(c_sid).slot == 1
    d_sid = svc.attach()  # promotes 2 -> 4 with rounds in flight
    assert svc.capacity == 4 and svc.promotions == 1
    fed[c_sid], fed[d_sid] = [], []
    for r in range(3, 6):
        for sid, d in ((a, data[0]), (c_sid, data[2]), (d_sid, data[3])):
            c = _sl(d, 250 * r, 250 * (r + 1))
            fed[sid].append(c)
            served += svc.feed(sid, *c)
    tails = {b: tail_b}
    for sid in (a, c_sid, d_sid):
        tails[sid] = svc.detach(sid)
    svc.drain()
    parts = {}
    _collect(served, parts)
    for sid, chunks in fed.items():
        _assert_same(_surfaces(parts.get(sid, []) + [tails[sid]]), _surfaces(_stream_parts(chunks)),
                     what=f"session {sid}")


def test_export_adopt_within_the_port_with_rounds_in_flight():
    """Exported at depth 2 with a round in flight, through the numpy
    form, adopted by a service at depth 1 (promoting it): equal to a
    never-migrated stream. A carry of another config is refused
    atomically."""
    x = _spaced_stream(90, 2000)
    src = DetectionService(CONFIG, tiers=(2,), admission=AdmissionConfig(1e9, 250),
                           clock=FakeClock(), max_inflight_rounds=2, device="cpu")
    dst = DetectionService(CONFIG, tiers=(1, 2), clock=FakeClock(), device="cpu")
    sid = src.attach()
    served = []
    chunks = [_sl(x, i * 130, (i + 1) * 130) for i in range(15)]
    for c in chunks[:7]:
        served += src.feed(sid, *c)
    assert src.inflight_rounds >= 1
    exp = session_export_from_numpy(session_export_to_numpy(src.export_session(sid)))
    other = DetectionService(TP.PipelineConfig(batcher=BatcherConfig(capacity=1024)), tiers=(2,),
                             clock=FakeClock(), device="cpu")
    with pytest.raises(ValueError, match="atlas shape"):
        other.adopt_session(exp)
    assert other.n_sessions == 0 and other._free == [0, 1]
    dst.attach("first")
    new = dst.adopt_session(exp)
    assert dst.capacity == 2 and dst.promotions == 1
    for c in chunks[7:]:
        served += dst.feed(new, *c)
        served += dst.pump(force=True)
    src.drain()
    parts = {}
    _collect(served, parts)
    got = parts.get(sid, []) + parts.get(new, []) + [dst.detach(new)]
    _assert_same(_surfaces(got), _surfaces(_stream_parts(chunks)), what="migrated")


# ---------------------------------------------------------------------------
# Admission, validation, accounting and lifecycle (the reference's cases).
# ---------------------------------------------------------------------------

def test_admission_micro_batches_sessions():
    clock = FakeClock()
    svc = DetectionService(CONFIG, tiers=(2,), admission=AdmissionConfig(0.02, 300),
                           clock=clock, device="cpu")
    s0, s1 = svc.attach(), svc.attach()
    d0, d1 = _spaced_stream(1, 400), _spaced_stream(2, 400)
    assert svc.feed(s0, *_sl(d0, 0, 150)) == []
    clock.now += 0.010
    assert svc.feed(s1, *_sl(d1, 0, 100)) == []
    clock.now += 0.011
    served = svc.feed(s0, *_sl(d0, 150, 151))
    assert {fd.sid for fd in served} == {s0, s1}
    assert svc.session(s0).stats.steps == svc.session(s1).stats.steps == 1


def test_feed_rejects_bad_chunk_atomically():
    rec = _service_recordings()[0]
    svc = DetectionService(CONFIG, tiers=(2,), clock=FakeClock(), device="cpu")
    sid = svc.attach()
    with pytest.raises(ValueError, match=f"session {sid}"):
        svc.feed(sid, rec.x[:20], rec.y[:20], rec.t[:20][::-1].copy(), rec.p[:20])
    assert svc.backlog(sid) == 0 and svc.session(sid).stats.feeds == 0
    with pytest.raises(ValueError, match="corrupt x"):
        svc.feed(sid, rec.x[:5].astype(np.int64) - (1 << 31), rec.y[:5], rec.t[:5], rec.p[:5])
    parts = {}
    chunks = list(iter_chunks(rec))
    for c in chunks:
        _collect(svc.feed(sid, *c), parts)
        _collect(svc.pump(force=True), parts)
    parts[sid].append(svc.detach(sid))
    _assert_same(_surfaces(parts[sid]), _surfaces(_stream_parts(chunks)))


def test_monotone_enforced_across_session_feeds():
    svc = DetectionService(CONFIG, tiers=(2,), clock=FakeClock(), device="cpu")
    sid = svc.attach()
    x = _spaced_stream(3, 200)
    svc.feed(sid, *_sl(x, 0, 100))
    with pytest.raises(ValueError, match="monotonically non-decreasing"):
        svc.feed(sid, *_sl(x, 0, 10))


def test_latency_and_backlog_accounting():
    clock = FakeClock()
    svc = DetectionService(CONFIG, tiers=(2,), admission=AdmissionConfig(**LAZY), clock=clock,
                           device="cpu")
    sid = svc.attach("cam")
    x = _spaced_stream(4, 300)
    svc.feed(sid, *_sl(x, 0, 50))
    assert svc.backlog(sid) == 50
    clock.now += 0.005
    served = svc.pump(force=True)
    assert len(served) == 1 and served[0].latency_ms == pytest.approx(5.0)
    assert served[0].result.num_windows == 0 and svc.backlog(sid) == 50
    st = svc.session(sid).stats
    assert (st.feeds, st.events, st.steps) == (1, 50, 1)
    assert st.latency_percentile(50) == pytest.approx(5.0)
    svc.detach(sid)
    assert svc.backlog(sid) == 0
    sid2 = svc.attach()
    assert svc.feed(sid2, *[np.zeros(0, np.int64)] * 4) == []
    assert svc.session(sid2).stats.feeds == 0 and svc.pump(force=True) == []


def test_constructor_validation():
    for tiers in ((4, 2), (), (2, 2)):
        with pytest.raises(ValueError, match="tiers"):
            DetectionService(CONFIG, tiers=tiers, device="cpu")
    with pytest.raises(ValueError, match="max_inflight_rounds"):
        DetectionService(CONFIG, max_inflight_rounds=0, device="cpu")
    with pytest.raises(ValueError, match="wire"):
        DetectionService(CONFIG, wire="packed", device="cpu")


def test_detach_discards_stale_admission_entries():
    clock = FakeClock()
    svc = DetectionService(CONFIG, tiers=(2,), admission=AdmissionConfig(0.02, 10_000),
                           clock=clock, device="cpu")
    a = svc.attach()
    svc.feed(a, *_spaced_stream(10, 100))
    clock.now += 0.005
    svc.detach(a)
    clock.now += 0.05
    b = svc.attach()
    assert svc.feed(b, *_spaced_stream(11, 50)) == []
    assert svc.session(b).stats.steps == 0


def test_slot_recycling_promotion_and_lifecycle():
    svc = DetectionService(CONFIG, tiers=(2, 4), clock=FakeClock(), device="cpu")
    a, b = svc.attach("a"), svc.attach("b")
    assert svc.capacity == 2 and svc.promotions == 0
    c = svc.attach("c")
    assert svc.capacity == 4 and svc.promotions == 1
    slot_b = svc.session(b).slot
    svc.detach(b)
    with pytest.raises(RuntimeError, match="detached"):
        svc.detach(b)
    with pytest.raises(RuntimeError, match="detached"):
        svc.feed(b, *_spaced_stream(0, 10))
    with pytest.raises(KeyError, match="unknown session"):
        svc.feed(12345, *_spaced_stream(0, 10))
    d = svc.attach("d")
    assert svc.session(d).slot == slot_b and svc.n_sessions == 3
    assert svc.detached_sessions == [b]
    with pytest.raises(RuntimeError, match="detach first"):
        svc.forget(a)
    svc.forget(b)
    svc.forget(b)  # unknown sids: a no-op
    with pytest.raises(KeyError):
        svc.session(b)
    for sid in (a, c, d):
        svc.detach(sid)
    assert svc.n_sessions == 0 and svc.detached_sessions == [a, c, d]


def test_latency_samples_are_bounded():
    stats = SessionStats()
    for i in range(MAX_LATENCY_SAMPLES + 100):
        stats.record_latency(float(i))
    assert len(stats.latency_ms) == MAX_LATENCY_SAMPLES and stats.latency_ms[0] == 100.0
    assert stats.latency_percentile(100) == float(MAX_LATENCY_SAMPLES + 99)


def test_fault_config_validation():
    for kw in ({"on_validation_error": "panic"}, {"shed_policy": "newest"},
               {"queue_budget_events": 0}, {"heartbeat_timeout_s": 0.0},
               {"max_step_retries": -1}, {"retry_backoff_s": -0.1}, {"straggler_factor": 1.0}):
        with pytest.raises(ValueError):
            FaultConfig(**kw)


def test_degraded_detach_is_retryable():
    svc = DetectionService(CONFIG, tiers=(2,), faults=FaultConfig(max_step_retries=0,
                           degrade_on_step_failure=True), clock=FakeClock(), device="cpu")
    sid = svc.attach()
    svc.feed(sid, *_spaced_stream(31, 100))
    svc._fleet = _FlakyFleet(svc._fleet, fail=1)
    with pytest.raises(RuntimeError, match="retry the detach"):
        svc.detach(sid)
    assert svc.session(sid).state == "live" and svc.session(sid).queued_events == 100
    assert svc.detach(sid) is not None and svc.session(sid).state == "detached"


def test_straggler_flagging_filters_to_live_sessions():
    svc = DetectionService(CONFIG, tiers=(4,), faults=FaultConfig(straggler_factor=2.0,
                           straggler_alpha=1.0), clock=FakeClock(), device="cpu")
    a, b, c = svc.attach(), svc.attach(), svc.attach()
    for _ in range(3):
        for sid, ms in ((a, 5.0), (b, 5.0), (c, 50.0)):
            svc._health.note_latency(sid, ms)
    assert svc.stragglers() == [c]
    svc.detach(c)
    assert svc.stragglers() == []


def test_deferred_round_accounting_exact(monkeypatch):
    svc = DetectionService(CONFIG, tiers=(2,), admission=AdmissionConfig(1e9, 100),
                           clock=FakeClock(), max_inflight_rounds=2, device="cpu")
    sid = svc.attach()
    x = _spaced_stream(55, 1000)
    feed = lambda i: svc.feed(sid, *_sl(x, i * 100, (i + 1) * 100))  # noqa: E731
    feed(0)
    feed(1)
    assert svc.inflight_rounds == 2 and svc.deferred_rounds == 0
    monkeypatch.setattr(TP.PendingRound, "ready", lambda self: False)
    feed(2)
    feed(3)
    sess = svc.session(sid)
    assert svc.deferred_rounds == sess.stats.deferred_rounds == 2
    assert sess.queued_events == 200 and svc.inflight_rounds == 2
    monkeypatch.undo()
    svc.pump()
    assert svc.deferred_rounds == 2 and sess.queued_events == 0
    svc.drain()
    st = sess.stats
    assert st.offered_events == st.events + st.shed_events == 400 and st.steps == 3


def test_force_pump_applies_backpressure_not_deferral(monkeypatch):
    svc = DetectionService(CONFIG, tiers=(2,), admission=AdmissionConfig(1e9, 100),
                           clock=FakeClock(), max_inflight_rounds=2, device="cpu")
    sid = svc.attach()
    x = _spaced_stream(56, 600)
    for i in range(2):
        svc.feed(sid, *_sl(x, i * 100, (i + 1) * 100))
    assert svc.inflight_rounds == 2
    monkeypatch.setattr(TP.PendingRound, "ready", lambda self: False)
    svc.feed(sid, *_sl(x, 200, 300))
    svc.pump(force=True)
    assert svc.session(sid).queued_events == 0 and svc.deferred_rounds == 1
    monkeypatch.undo()
    svc.drain()


def test_served_feed_is_lazy():
    svc = DetectionService(CONFIG, tiers=(2,), admission=AdmissionConfig(1e9, 250),
                           clock=FakeClock(), max_inflight_rounds=2, device="cpu")
    sid = svc.attach()
    (fd,) = svc.feed(sid, *_spaced_stream(57, 250))
    assert fd._result is None and fd.num_windows == 1 and fd._result is None
    res = fd.result
    assert fd.result is res and res.num_windows == 1
    svc.drain()
