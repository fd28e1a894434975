"""The port's atlas event core against the JAX reference, on the CPU.

The float event route (``metrics_impl="event"``, the default, with and
without ``use_kernels``) writes the persistent window-tagged atlas. Its
every exported form is held to the reference's **exactly**: the stream's
state after every feed (dense and ragged wire), the same across forced
tag rollovers (``_tag_limit = 4``, as ``tests/test_streaming.py`` forces
them), a 4-sensor fleet's ``export_slot``, a service's
``SessionExport``, and a JAX stream's carry adopted by the port and fed
on. The atlas and every output are invariant to how the feed is split
and to ``scan_chunk``; the capacity-4096 stride windows give a 481x4096
atlas equal to the reference core's; ``run_many_scan`` equals
per-recording scans with one atlas a recording. Outputs against the
reference use ``tests/test_torch_pipeline.py``'s tolerances (integers
exact, metrics rtol = atol = 1e-5, tracker floats rtol 1e-6, atol 1e-4).

The frame route (``metrics_impl="frame"``) runs through the scan and the
loop driver against the JAX frame route on the quickstart recording, and
equals the port's event route bit for bit.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.core import events as JE
from repro.core import pipeline as JP
from repro.core import tracking as JT
from repro.serve import DetectionService as JDetectionService
from repro_torch.core import pipeline as TP
from repro_torch.core.events import pad_windows
from repro_torch.core.grid_clustering import Clusters
from repro_torch.core.tracking import TrackState, init_tracks
from repro_torch.data.evas import iter_chunks
from repro_torch.data.synthetic import make_recording
from repro_torch.serve import DetectionService

torch.set_num_threads(1)

CONFIGS = {"default": {}, "kernels": dict(use_kernels=True)}
EXACT_METRICS = ("event_count", "edge_density")


def _cfgs(kw):
    jcfg = JP.PipelineConfig(**kw)
    return jcfg, TP.config_from_dict(dataclasses.asdict(jcfg))


@functools.lru_cache(maxsize=None)
def _recording(seed: int = 3, duration_s: float = 0.35, n_rsos: int = 2, **kw):
    return make_recording(seed=seed, duration_s=duration_s, n_rsos=n_rsos, **kw)


def _cuts(rec, n=5):
    """``n`` event-count slices covering the recording."""
    c = np.linspace(0, len(rec), n + 1).astype(int)
    return [slice(a, b) for a, b in zip(c[:-1], c[1:])]


def _assert_atlas(port_atlas, ref_atlas, what):
    a, b = port_atlas.cpu().numpy(), np.asarray(ref_atlas)
    assert a.dtype == b.dtype == np.int32 and a.shape == b.shape, what
    diff = np.argwhere(a != b)
    assert len(diff) == 0, f"{what}: {len(diff)} pixels differ, first {diff[:3].tolist()}"


def _close_to_reference(got_parts, want_parts):
    """Port results against reference results, concatenated."""
    cat_t = lambda get: torch.cat([get(p).cpu() for p in got_parts]).numpy()  # noqa: E731
    cat_j = lambda get: np.concatenate([np.asarray(get(p)) for p in want_parts])  # noqa: E731
    assert sum(p.num_windows for p in got_parts) == sum(p.num_windows for p in want_parts)
    for f in Clusters._fields:
        np.testing.assert_array_equal(cat_t(lambda p: getattr(p.clusters, f)),
                                      cat_j(lambda p: getattr(p.clusters, f)), err_msg=f)
    for m in ("shannon_entropy", "renyi_entropy", "differential_entropy", "local_contrast",
              *EXACT_METRICS):
        got, want = cat_t(lambda p: p.metrics[m]), cat_j(lambda p: p.metrics[m])
        if m in EXACT_METRICS:
            np.testing.assert_array_equal(got, want, err_msg=m)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=m)
    if got_parts[0].tracks is None:
        return
    for f in ("hits", "misses", "age", "active"):
        np.testing.assert_array_equal(cat_t(lambda p: getattr(p.tracks, f)),
                                      cat_j(lambda p: getattr(p.tracks, f)), err_msg=f)
    for f in ("x", "y", "vx", "vy", "entropy"):
        np.testing.assert_allclose(cat_t(lambda p: getattr(p.tracks, f)),
                                   cat_j(lambda p: getattr(p.tracks, f)), rtol=1e-6, atol=1e-4,
                                   err_msg=f)


def _equal_results(a, b, what):
    """Two port results equal to the bit on every output."""
    for f in Clusters._fields:
        assert torch.equal(getattr(a.clusters, f), getattr(b.clusters, f)), (what, f)
    for k in a.metrics:
        assert torch.equal(a.metrics[k], b.metrics[k]), (what, k)
    if a.tracks is not None:
        for f in TrackState._fields:
            assert torch.equal(getattr(a.tracks, f), getattr(b.tracks, f)), (what, f)


def _feed(sp, rec, sl):
    return sp.feed(rec.x[sl], rec.y[sl], rec.t[sl], rec.p[sl])


# ---------------------------------------------------------------------------
# The stream's atlas after every feed.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wire", ["dense", "ragged"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_stream_atlas_equals_reference_after_every_feed(name, wire):
    rec = _recording()
    jcfg, tcfg = _cfgs(CONFIGS[name])
    jsp = JP.StreamingPipeline(jcfg)
    tsp = TP.StreamingPipeline(tcfg, wire=wire, device="cpu")
    got, want = [], []
    for i, sl in enumerate(_cuts(rec)):
        got.append(_feed(tsp, rec, sl))
        want.append(_feed(jsp, rec, sl))
        assert tsp.state.next_tag == jsp.state.next_tag
        _assert_atlas(tsp.state.atlas, jsp.state.atlas, f"after feed {i}")
    got.append(tsp.flush())
    want.append(jsp.flush())
    _assert_atlas(tsp.state.atlas, jsp.state.atlas, "after flush")
    assert int((tsp.state.atlas != 0).sum()) > 100  # the atlas was written
    _close_to_reference(got, want)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_stream_atlas_across_forced_rollover(name):
    """``_tag_limit = 4``: the atlas is re-zeroed every few windows in both
    packages; after every 20 ms feed the atlases are equal, and the
    stream still equals its scan."""
    rec = _recording()
    jcfg, tcfg = _cfgs(CONFIGS[name])
    jsp = JP.StreamingPipeline(jcfg)
    tsp = TP.StreamingPipeline(tcfg, wire="ragged", device="cpu")
    jsp._tag_limit = tsp._tag_limit = 4
    parts, rolled = [], 0
    for i, chunk in enumerate(iter_chunks(rec, 20_000)):
        before = tsp.state.next_tag
        parts.append(tsp.feed(*chunk))
        jsp.feed(*chunk)
        rolled += tsp.state.next_tag < before
        assert tsp.state.next_tag == jsp.state.next_tag <= 4
        _assert_atlas(tsp.state.atlas, jsp.state.atlas, f"after feed {i}")
    parts.append(tsp.flush())
    jsp.flush()
    _assert_atlas(tsp.state.atlas, jsp.state.atlas, "after flush")
    assert rolled >= 3
    scan = TP.run_recording_scan(rec, tcfg, device="cpu")
    for f in Clusters._fields:
        assert torch.equal(torch.cat([getattr(p.clusters, f) for p in parts]), getattr(scan.clusters, f))
    for k in scan.metrics:
        assert torch.equal(torch.cat([p.metrics[k] for p in parts]), scan.metrics[k]), k


def test_reference_stream_carry_adopted_and_fed_on():
    """A JAX stream fed halfway, its carry adopted by the port (atlas
    included), both fed on in 20 ms chunks through a forced rollover: the
    atlases equal after every feed, the outputs to the stated bounds."""
    rec = _recording()
    jcfg, tcfg = _cfgs({})
    half = len(rec) // 2
    jsp = JP.StreamingPipeline(jcfg)
    _feed(jsp, rec, slice(0, half))
    st = jsp.state
    carry = dict(
        pending=st.pending, events_consumed=st.events_consumed, next_tag=st.next_tag,
        last_t=st.last_t, atlas=np.asarray(st.atlas),
        tracks={f: np.asarray(getattr(st.tracks, f)) for f in st.tracks._fields},
    )
    assert np.count_nonzero(carry["atlas"]) > 0
    tsp = TP.StreamingPipeline(tcfg, state=TP.stream_state_from_numpy(carry, "cpu"), device="cpu")
    jsp._tag_limit = tsp._tag_limit = st.next_tag + 6  # one rollover after the hop
    got, want = [], []
    chunks = [c for c in iter_chunks(rec, 20_000) if len(c[2]) and c[2][0] >= rec.t[half]]
    rolled = 0
    for i, chunk in enumerate(chunks):
        before = tsp.state.next_tag
        got.append(tsp.feed(*chunk))
        want.append(jsp.feed(*chunk))
        rolled += tsp.state.next_tag < before
        _assert_atlas(tsp.state.atlas, jsp.state.atlas, f"after feed {i}")
    got.append(tsp.flush())
    want.append(jsp.flush())
    _assert_atlas(tsp.state.atlas, jsp.state.atlas, "after flush")
    assert rolled >= 1
    _close_to_reference(got, want)


# ---------------------------------------------------------------------------
# Fleet and service carries.
# ---------------------------------------------------------------------------

def _fleet_rounds(recs, chunk_us=20_000):
    """Per-round chunk lists, sensor s idle in every (s + 2)-th round so
    the sensors' tags drift apart."""
    per = [list(iter_chunks(r, chunk_us)) for r in recs]
    n = max(len(c) for c in per)
    return [[(c[i] if i < len(c) and i % (s + 2) else None) if i else (c[0] if c else None)
             for s, c in enumerate(per)] for i in range(n)]


@pytest.mark.parametrize("tag_limit", [None, 4], ids=["epoch", "rollover"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_fleet_export_slot_atlas_equals_reference(name, tag_limit):
    recs = [_recording(seed=20 + s, duration_s=0.2, n_rsos=1 + s % 2) for s in range(4)]
    jcfg, tcfg = _cfgs(CONFIGS[name])
    jf = JP.FleetPipeline(jcfg, n_sensors=4)
    tf = TP.FleetPipeline(tcfg, n_sensors=4, device="cpu")
    if tag_limit:
        jf._tag_limit = tf._tag_limit = tag_limit
    rounds = _fleet_rounds(recs)
    for i, chunks in enumerate(rounds):
        tf.feed(chunks)
        jf.feed(chunks)
        if i % 3 == 2 or i == len(rounds) - 1:
            for s in range(4):
                a, b = tf.export_slot(s), jf.export_slot(s)
                assert a.cursor.next_tag == b.cursor.next_tag
                _assert_atlas(torch.from_numpy(a.atlas), b.atlas, f"round {i} slot {s}")
    tf.flush()
    jf.flush()
    tags = [tf.export_slot(s).cursor.next_tag for s in range(4)]
    for s in range(4):
        _assert_atlas(torch.from_numpy(tf.export_slot(s).atlas), jf.export_slot(s).atlas, f"flush slot {s}")
    assert len(set(tags)) > 1 or tag_limit


def test_service_session_export_atlas_equals_reference():
    """Two sessions of each package's ``DetectionService``, fed and pumped
    alike; each ``SessionExport`` carries the same atlas and cursor."""
    recs = [_recording(seed=40 + s, duration_s=0.25, n_rsos=1 + s % 2) for s in range(2)]
    jcfg, tcfg = _cfgs({})
    t = DetectionService(tcfg, tiers=(2,), device="cpu")
    j = JDetectionService(jcfg, tiers=(2,))
    sids = [(t.attach(f"s{s}"), j.attach(f"s{s}")) for s in range(2)]
    chunks = [list(iter_chunks(r, 20_000)) for r in recs]
    for i in range(max(len(c) for c in chunks)):
        for s, (ts, js) in enumerate(sids):
            if i < len(chunks[s]):
                t.feed(ts, *chunks[s][i])
                j.feed(js, *chunks[s][i])
        if i % 2:
            t.pump(force=True)
            j.pump(force=True)
    t.drain()
    j.drain()
    for ts, js in sids:
        a, b = t.export_session(ts), j.export_session(js)
        assert a.carry.cursor.next_tag == b.carry.cursor.next_tag > 0
        assert a.carry.cursor.events_consumed == b.carry.cursor.events_consumed
        _assert_atlas(torch.from_numpy(a.carry.atlas), b.carry.atlas, a.name)


# ---------------------------------------------------------------------------
# Invariance: feed splits, scan_chunk, recordings stacked.
# ---------------------------------------------------------------------------

def _core_out(cfg, windows, tag0=0):
    """One core call over all of ``windows`` from a fresh carry; its last
    output is the atlas."""
    return TP.make_core(cfg)(windows.batch, init_tracks(cfg.tracker, "cpu"),
                             TP.make_atlas(cfg, windows.capacity, "cpu"), tag0)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_atlas_invariant_to_feed_split_and_scan_chunk(name):
    """One core call over the whole recording, streams split two ways and
    every ``scan_chunk`` in (1, 3, 16, 64) give the same atlas and the
    same results, to the bit."""
    rec = _recording()
    _, tcfg = _cfgs(CONFIGS[name])
    win = pad_windows(rec.x, rec.y, rec.t, rec.p, tcfg.batcher, "cpu")
    whole = _core_out(tcfg, win)[-1]
    assert int((whole != 0).sum()) > 100
    for cuts in (_cuts(rec, 3), _cuts(rec, 11)):
        sp = TP.StreamingPipeline(tcfg, device="cpu")
        for sl in cuts:
            _feed(sp, rec, sl)
        sp.flush()
        assert torch.equal(sp.state.atlas, whole)
    base = TP.run_recording_scan(rec, tcfg, device="cpu")
    for chunk in (1, 3, 16, 64):
        cfg = dataclasses.replace(tcfg, scan_chunk=chunk)
        _equal_results(TP.run_recording_scan(rec, cfg, device="cpu"), base, f"scan_chunk={chunk}")
        assert torch.equal(_core_out(cfg, win)[-1], whole)


def test_atlas_split_across_core_calls_with_offset_tags():
    """Two core calls, the second from the first's atlas and tags, equal
    one call over all windows (the reference's split invariance)."""
    rec = _recording()
    _, tcfg = _cfgs({})
    win = pad_windows(rec.x, rec.y, rec.t, rec.p, tcfg.batcher, "cpu")
    core = TP.make_core(tcfg)
    st0 = init_tracks(tcfg.tracker, "cpu")
    atlas0 = TP.make_atlas(tcfg, device="cpu")
    *_, whole = core(win.batch, st0, atlas0, 0)
    h = win.num_windows // 3
    first = type(win.batch)(*(a[:h] for a in win.batch))
    second = type(win.batch)(*(a[h:] for a in win.batch))
    st1, *_, mid = core(first, st0, atlas0, 0)
    *_, end = core(second, st1, mid, h)
    assert torch.equal(end, whole) and torch.equal(atlas0, torch.zeros_like(atlas0))


def test_stride_windows_capacity_4096_atlas_equals_reference():
    """The scale recording's shape of stride windows, cut to 0.5 s: 100 ms
    windows of about 2,000 events at capacity 4096, a 481x4096 atlas
    written by the sort route, equal to the reference core's."""
    rec = _recording(seed=11, duration_s=0.5, n_rsos=2, noise_rate_hz=20_000)
    jcfg, tcfg = _cfgs(dict(batcher=JE.BatcherConfig(capacity=4096)))
    jw = JE.pad_windows(rec.x, rec.y, rec.t, rec.p, jcfg.batcher, policy="stride", window_us=100_000)
    tw = pad_windows(rec.x, rec.y, rec.t, rec.p, tcfg.batcher, "cpu", policy="stride", window_us=100_000)
    assert tw.capacity == 4096 and int(tw.batch.valid.sum(-1).max()) > 1024
    jout = JP.make_stream_fn(jcfg)(jw.batch, JT.init_tracks(jcfg.tracker), JP.make_atlas(jcfg, 4096), 7)
    final, clusters, mets, states, atlas = _core_out(tcfg, tw, tag0=7)
    assert tuple(atlas.shape) == (481, 4096)
    _assert_atlas(atlas, jout[4], "stride windows")
    for f in Clusters._fields:
        np.testing.assert_array_equal(getattr(clusters, f).numpy(), np.asarray(getattr(jout[1], f)), err_msg=f)
    for m in EXACT_METRICS:
        np.testing.assert_array_equal(mets[m].numpy(), np.asarray(jout[2][m]), err_msg=m)


def test_run_many_scan_has_one_atlas_per_recording():
    """``run_many_scan`` equals per-recording scans; the stacked core
    writes one atlas a recording, each equal to the reference core's for
    that recording alone."""
    recs = [_recording(seed=30 + s, duration_s=0.15 + 0.05 * s, n_rsos=1 + s % 2) for s in range(3)]
    jcfg, tcfg = _cfgs({})
    many = TP.run_many_scan(recs, tcfg, device="cpu")
    for r, rec in enumerate(recs):
        _equal_results(many[r], TP.run_recording_scan(rec, tcfg, device="cpu"), f"recording {r}")
    wins = [pad_windows(r.x, r.y, r.t, r.p, tcfg.batcher, "cpu") for r in recs]
    w_max = max(w.num_windows for w in wins)
    pad = lambda a: torch.cat([a, a.new_zeros((w_max - a.shape[0],) + a.shape[1:])])  # noqa: E731
    stacked = type(wins[0].batch)(*(torch.stack([pad(getattr(w.batch, f)) for w in wins])
                                    for f in wins[0].batch._fields))
    fresh = init_tracks(tcfg.tracker, "cpu")
    state = TrackState(*(a.new_zeros((3,) + tuple(a.shape)) for a in fresh))
    atlas = torch.zeros((3,) + TP.atlas_shape(tcfg), dtype=torch.int32)
    *_, out = TP.make_core(tcfg)(stacked, state, atlas, 0)
    for r, rec in enumerate(recs):
        jw = JE.pad_windows(rec.x, rec.y, rec.t, rec.p, jcfg.batcher)
        jout = JP.make_stream_fn(jcfg)(jw.batch, JT.init_tracks(jcfg.tracker), JP.make_atlas(jcfg), 0)
        _assert_atlas(out[r], jout[4], f"recording {r}")
        assert torch.equal(out[r], _core_out(tcfg, wins[r])[-1])


def test_core_refuses_a_mismatched_atlas():
    rec = _recording()
    _, tcfg = _cfgs({})
    win = pad_windows(rec.x, rec.y, rec.t, rec.p, tcfg.batcher, "cpu")
    with pytest.raises(ValueError, match="atlas shape"):
        TP.make_core(tcfg)(win.batch, init_tracks(tcfg.tracker, "cpu"),
                           torch.zeros((1,) + TP.atlas_shape(tcfg), dtype=torch.int32), 0)


# ---------------------------------------------------------------------------
# The frame route through the scan and the loop driver.
# ---------------------------------------------------------------------------

QUICKSTART = dict(seed=7, duration_s=2.0, n_rsos=2)


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
def test_scan_frame_route_against_reference_and_event_route(use_kernels):
    rec = _recording(**QUICKSTART)
    jcfg, tcfg = _cfgs(dict(metrics_impl="frame", use_kernels=use_kernels))
    got = TP.run_recording_scan(rec, tcfg, device="cpu")
    want = JP.run_recording_scan(rec, jcfg)
    assert got.num_windows == 100
    _close_to_reference([got], [want])
    event = TP.run_recording_scan(rec, dataclasses.replace(tcfg, metrics_impl="event"), device="cpu")
    _equal_results(got, event, "frame vs event")
    for f in TrackState._fields:
        assert torch.equal(getattr(got.final_tracks, f), getattr(event.final_tracks, f)), f


def test_loop_driver_frame_route_against_reference():
    rec = _recording(seed=7, duration_s=0.6, n_rsos=2)
    jcfg, tcfg = _cfgs(dict(metrics_impl="frame"))
    got = TP.run_recording(rec, tcfg, device="cpu")
    want = JP.run_recording(rec, jcfg)
    event = TP.run_recording(rec, dataclasses.replace(tcfg, metrics_impl="event"), device="cpu")
    scan = TP.run_recording_scan(rec, tcfg, device="cpu").window_results()
    assert len(got) == len(want) == len(event) == len(scan) > 20
    for w, (g, j, e, s) in enumerate(zip(got, want, event, scan)):
        for f in Clusters._fields:
            np.testing.assert_array_equal(getattr(g.clusters, f).numpy(), np.asarray(getattr(j.clusters, f)))
        for k in g.metrics:
            np.testing.assert_array_equal(g.metrics[k], e.metrics[k], err_msg=f"window {w} {k}")
            np.testing.assert_array_equal(g.metrics[k], s.metrics[k], err_msg=f"window {w} {k}")
            if k in EXACT_METRICS:
                np.testing.assert_array_equal(g.metrics[k], np.asarray(j.metrics[k]), err_msg=k)
            else:
                np.testing.assert_allclose(g.metrics[k], np.asarray(j.metrics[k]), rtol=1e-5, atol=1e-5)
        for f in ("hits", "misses", "age", "active"):
            np.testing.assert_array_equal(getattr(g.tracks, f).numpy(), np.asarray(getattr(j.tracks, f)))


@pytest.mark.parametrize("driver", ["stream", "fleet", "service"])
def test_frame_route_through_the_live_drivers(driver):
    """``metrics_impl="frame"`` through the stream, the fleet and the
    service equals the frame scan to the bit (the atlas untouched, as on
    the reference's straight route)."""
    rec = _recording()
    _, tcfg = _cfgs(dict(metrics_impl="frame"))
    scan = TP.run_recording_scan(rec, tcfg, device="cpu")
    chunks = list(iter_chunks(rec, 20_000))
    if driver == "stream":
        sp = TP.StreamingPipeline(tcfg, wire="ragged", device="cpu")
        parts = [sp.feed(*c) for c in chunks] + [sp.flush()]
        assert int(sp.state.atlas.abs().sum()) == 0
    elif driver == "fleet":
        fp = TP.FleetPipeline(tcfg, n_sensors=2, device="cpu")
        parts = [fp.feed([c, None]).sensor(0) for c in chunks] + [fp.flush().sensor(0)]
    else:
        svc = DetectionService(tcfg, tiers=(2,), device="cpu")
        sid = svc.attach("frame")
        parts = []
        for c in chunks:
            parts += [s.result for s in svc.feed(sid, *c) if s.sid == sid]
            parts += [s.result for s in svc.pump(force=True) if s.sid == sid]
        parts.append(svc.detach(sid))
    parts = [p for p in parts if p.num_windows]
    for f in Clusters._fields:
        assert torch.equal(torch.cat([getattr(p.clusters, f).cpu() for p in parts]),
                           getattr(scan.clusters, f)), f
    for k in scan.metrics:
        assert torch.equal(torch.cat([p.metrics[k].cpu() for p in parts]), scan.metrics[k]), k


def test_tag0_tensor_matches_int_tags():
    """An ``(S,)`` tag tensor writes each sensor's atlas slice as the int
    tag does for that sensor alone."""
    recs = [_recording(seed=50 + s, duration_s=0.15) for s in range(2)]
    _, tcfg = _cfgs({})
    wins = [pad_windows(r.x, r.y, r.t, r.p, tcfg.batcher, "cpu") for r in recs]
    w = min(x.num_windows for x in wins)
    stacked = type(wins[0].batch)(*(torch.stack([getattr(x.batch, f)[:w] for x in wins])
                                    for f in wins[0].batch._fields))
    core = TP.make_core(tcfg)
    fresh = init_tracks(tcfg.tracker, "cpu")
    state = TrackState(*(a.new_zeros((2,) + tuple(a.shape)) for a in fresh))
    tags = torch.tensor([5, 123], dtype=torch.int32)
    *_, out = core(stacked, state, torch.zeros((2,) + TP.atlas_shape(tcfg), dtype=torch.int32), tags)
    for s in range(2):
        one = type(wins[0].batch)(*(a[s] for a in stacked))
        *_, want = core(one, fresh, TP.make_atlas(tcfg, device="cpu"), int(tags[s]))
        assert torch.equal(out[s], want), s
