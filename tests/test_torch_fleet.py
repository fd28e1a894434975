"""The port's fleet driver, on the CPU.

Four sensors of 0.3 s (the reference's ``_fleet_recordings``) under
interleavings with idle sensors, on both wires: per-sensor fleet outputs
equal independent port streams and the port's scan exactly. The slot
pool (``grow``, ``shrink``, ``reset_slots``, ``flush_slots``, the
``final`` mask, atomic rejection, export and import) as
``tests/test_fleet.py`` and ``tests/test_carry_migration.py`` pin it.
Against the JAX package: a slot exported from the JAX fleet mid-stream
resumes in the port's fleet with the reference's outputs and, at the
end, the reference's atlas exactly, and the port's
fleet under the kernel config matches the reference's
``run_recording_scan`` under that config (tolerances of
``tests/test_torch_pipeline.py``).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.core import pipeline as JP
from repro_torch.core import pipeline as TP
from repro_torch.core.events import BatcherConfig
from repro_torch.data.evas import iter_chunks
from repro_torch.data.synthetic import make_recording
from test_torch_stream import _close_to_reference, assert_stream_equals_scan

torch.set_num_threads(1)

CONFIG = TP.PipelineConfig()
WIRES = ["dense", "ragged"]


@functools.lru_cache(maxsize=None)
def _fleet_recordings(n: int = 4, duration_s: float = 0.3):
    return tuple(
        make_recording(seed=20 + s, duration_s=duration_s, n_rsos=1 + s % 2) for s in range(n)
    )


@functools.lru_cache(maxsize=None)
def _scan(s: int, with_tracking: bool = True):
    return TP.run_recording_scan(_fleet_recordings()[s], CONFIG, with_tracking, device="cpu")


def _fleet(n, wire="ragged", config=CONFIG, **kw):
    return TP.FleetPipeline(config, n_sensors=n, wire=wire, device="cpu", **kw)


def _chunk(rec, a, b):
    return rec.x[a:b], rec.y[a:b], rec.t[a:b], rec.p[a:b]


def _interleave(fp, recs, cuts_per_sensor, idle=()):
    """Feed every sensor its recording split at per-sensor cut indices,
    round-robin; ``idle`` (feed, sensor) pairs are fed ``None`` that round.
    Ends with a flush. Returns per-sensor lists of results."""
    s_count = len(recs)
    n_feeds = max(len(c) for c in cuts_per_sensor) + 1
    prev = [0] * s_count
    parts = [[] for _ in range(s_count)]
    for i in range(n_feeds):
        chunks = []
        for s, rec in enumerate(recs):
            if (i, s) in idle and i < n_feeds - 1:
                chunks.append(None)
                continue
            cuts = cuts_per_sensor[s]
            cut = len(rec) if i >= len(cuts) or i == n_feeds - 1 else min(max(cuts[i], prev[s]), len(rec))
            chunks.append(_chunk(rec, prev[s], cut))
            prev[s] = cut
        out = fp.feed(chunks)
        for s in range(s_count):
            parts[s].append(out.sensor(s))
    tail = fp.flush()
    for s in range(s_count):
        parts[s].append(tail.sensor(s))
    return parts


@pytest.mark.parametrize("wire", WIRES)
def test_fleet_single_feed_equals_scan_per_sensor(wire):
    recs = _fleet_recordings()
    parts = _interleave(_fleet(len(recs), wire), recs, [[] for _ in recs])
    for s in range(len(recs)):
        assert_stream_equals_scan(parts[s], _scan(s))


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("seed", [0, 1])
def test_fleet_random_interleaving_equals_independent_streams(wire, seed):
    recs = _fleet_recordings()
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 10_000_000, 12)
    cuts = [sorted(c % (len(recs[s]) + 1) for j, c in enumerate(raw) if j % 4 == s)
            for s in range(len(recs))]
    idle = {(int(raw[0] % 3), int(raw[1] % 4)), (int(raw[-1] % 3), int(raw[-2] % 4))}
    parts = _interleave(_fleet(len(recs), wire), recs, cuts, idle=idle)
    n_feeds = len(parts[0]) - 1
    for s, rec in enumerate(recs):
        # The same chunks, fed to a dedicated stream: equal feed by feed.
        sp, prev = TP.StreamingPipeline(CONFIG, wire=wire, device="cpu"), 0
        for i in range(n_feeds):
            if (i, s) in idle and i < n_feeds - 1:
                want = sp.feed_chunk(None)
            else:
                c = cuts[s]
                cut = len(rec) if i >= len(c) or i == n_feeds - 1 else min(max(c[i], prev), len(rec))
                want = sp.feed(*_chunk(rec, prev, cut))
                prev = cut
            assert_stream_equals_scan([parts[s][i]], want)
        assert_stream_equals_scan([parts[s][-1]], sp.flush())
        assert_stream_equals_scan(parts[s], _scan(s))


def test_fleet_sensor_mid_tag_rollover_keeps_identity():
    recs = _fleet_recordings()
    fp = _fleet(len(recs))
    fp._tag_limit = 4  # force per-sensor atlas re-zeroing every few windows
    cuts = [list(range(0, len(r), max(len(r) // 6, 1))) for r in recs]
    parts = _interleave(fp, recs, cuts)
    assert any(c.next_tag <= 4 for c in fp.state.cursors)
    for s in range(len(recs)):
        assert_stream_equals_scan(parts[s], _scan(s))


def test_fleet_without_tracking():
    recs = _fleet_recordings()[:2]
    fp = TP.FleetPipeline(CONFIG, n_sensors=2, with_tracking=False, device="cpu")
    parts = _interleave(fp, recs, [[len(r) // 2] for r in recs])
    for s in range(2):
        assert_stream_equals_scan(parts[s], _scan(s, with_tracking=False), with_tracking=False)


def test_fleet_feed_rejects_bad_chunk_atomically():
    r0, r1 = _fleet_recordings()[:2]
    fp = _fleet(2)
    bad_t = r1.t[:10][::-1].copy()
    with pytest.raises(ValueError, match="sensor 1"):
        fp.feed([_chunk(r0, 0, 10), (r1.x[:10], r1.y[:10], bad_t, r1.p[:10])])
    assert all(c.pending_count == 0 for c in fp.state.cursors)
    parts = _interleave(fp, (r0, r1), [[len(r) // 2] for r in (r0, r1)])
    for s in range(2):
        assert_stream_equals_scan(parts[s], _scan(s))


def test_fleet_feed_rejects_regressing_feed_boundary():
    recs = _fleet_recordings()[:2]
    fp = _fleet(2)
    fp.feed([_chunk(r, 0, len(r) // 2) for r in recs])
    with pytest.raises(ValueError, match="monotonically non-decreasing"):
        fp.feed([_chunk(recs[0], 0, 5), None])


def test_fleet_feed_validation():
    fp = _fleet(3)
    with pytest.raises(ValueError, match="3 per-sensor chunks"):
        fp.feed([None, None])
    with pytest.raises(ValueError, match="final mask"):
        _fleet(2).feed([None, None], final=np.zeros(3, bool))
    with pytest.raises(ValueError, match="2 sensors"):
        TP.FleetPipeline(CONFIG, n_sensors=3, state=_fleet(2).state, device="cpu")
    with pytest.raises(ValueError, match="unknown wire mode"):
        TP.FleetPipeline(CONFIG, wire="csr", device="cpu")
    with pytest.raises(TypeError, match="mesh of devices"):
        TP.FleetPipeline(CONFIG, n_sensors=4, mesh=object(), device="cpu")


def test_fleet_empty_feed_closes_nothing():
    recs = _fleet_recordings()[:2]
    fp = _fleet(2)
    out = fp.feed([None, None])
    assert out.total_windows == 0 and out.ready()
    assert all(out.sensor(s).num_windows == 0 for s in range(2))
    out = fp.feed([_chunk(r, 0, 3) for r in recs])
    assert out.total_windows == 0
    assert [c.pending_count for c in fp.state.cursors] == [3, 3]


def test_tier_capacity_schedule():
    assert TP.DEFAULT_TIERS == JP.fleet.DEFAULT_TIERS
    for n in range(1, 140):
        assert TP.tier_capacity(n) == JP.tier_capacity(n)
    assert [TP.tier_capacity(n, (4, 8, 16)) for n in (1, 4, 5, 8, 9, 16, 17, 33)] == \
        [4, 4, 8, 8, 16, 16, 32, 64]
    with pytest.raises(ValueError, match="at least one"):
        TP.tier_capacity(0)


def test_fleet_grow_preserves_live_sensor_identity():
    recs = _fleet_recordings()
    fp = _fleet(2)
    half = [len(r) // 2 for r in recs[:2]]
    first = fp.feed([_chunk(r, 0, h) for r, h in zip(recs, half)])
    parts = {s: [first.sensor(s)] for s in range(2)}
    fp.grow(4)
    assert fp.n_sensors == 4 and fp.state.atlas.shape[0] == 4
    second = fp.feed([_chunk(recs[0], half[0], None), _chunk(recs[1], half[1], None),
                      _chunk(recs[2], 0, None), _chunk(recs[3], 0, None)])
    tail = fp.flush()
    for s in range(4):
        parts[s] = parts.get(s, []) + [second.sensor(s), tail.sensor(s)]
        assert_stream_equals_scan(parts[s], _scan(s))


def test_fleet_grow_and_shrink_validation():
    fp = _fleet(4)
    with pytest.raises(ValueError, match="shrink"):
        fp.grow(2)
    with pytest.raises(ValueError, match="at least one"):
        fp.shrink(0)
    with pytest.raises(ValueError, match="use grow"):
        fp.shrink(8)
    with pytest.raises(ValueError, match=r"occupied slots \[3\]"):
        fp.shrink(2, occupied=(0, 3))
    fp.grow(4)
    fp.shrink(4)  # both no-ops at the current size
    fp.shrink(2, occupied=(0, 1))
    assert fp.n_sensors == 2 and len(fp.state.cursors) == 2
    fp.grow(4)
    assert fp.n_sensors == 4 and fp.state.tracks.x.shape == (4, 16)


def _feed_whole(fp, slot, rec):
    half = len(rec) // 2
    parts = []
    for lo, hi in ((0, half), (half, len(rec))):
        chunks = [None] * fp.n_sensors
        chunks[slot] = _chunk(rec, lo, hi)
        parts.append(fp.feed(chunks).sensor(slot))
    parts.append(fp.flush_slots([slot]).sensor(slot))
    return parts


def test_fleet_reset_slots_recycles_bit_identically():
    recs = _fleet_recordings()
    fp = _fleet(2)
    parts_a = _feed_whole(fp, 0, recs[0])
    held = parts_a[-1].final_tracks.x.clone()
    assert_stream_equals_scan(parts_a, _scan(0))
    fp.reset_slots([0])
    assert fp.state.cursors[0].next_tag == 0
    assert torch.equal(parts_a[-1].final_tracks.x, held)  # a result is never zeroed
    assert_stream_equals_scan(_feed_whole(fp, 0, recs[1]), _scan(1))


def test_fleet_flush_slots_leaves_other_remainders_pending():
    recs = _fleet_recordings()[:2]
    fp = _fleet(2)
    half = [len(r) // 2 for r in recs]
    first = fp.feed([_chunk(r, 0, h) for r, h in zip(recs, half)])
    pending_1 = fp.state.cursors[1].pending_count
    assert pending_1 > 0
    tail0 = fp.flush_slots([0])
    assert tail0.n_windows.tolist() == [1, 0]
    assert fp.state.cursors[0].pending_count == 0
    assert fp.state.cursors[1].pending_count == pending_1
    second = fp.feed([None, _chunk(recs[1], half[1], None)])
    tail1 = fp.flush_slots([1])
    assert_stream_equals_scan([first.sensor(1), second.sensor(1), tail1.sensor(1)], _scan(1))


def test_fleet_shrink_preserves_surviving_slots():
    recs = _fleet_recordings()[:2]
    fp = _fleet(4)
    half = [len(r) // 2 for r in recs]
    first = fp.feed([_chunk(recs[0], 0, half[0]), _chunk(recs[1], 0, half[1]), None, None])
    fp.shrink(2, occupied=(0, 1))
    second = fp.feed([_chunk(r, h, None) for r, h in zip(recs, half)])
    tail = fp.flush()
    for s in range(2):
        assert_stream_equals_scan([first.sensor(s), second.sensor(s), tail.sensor(s)], _scan(s))


def test_fleet_ragged_spill_equals_dense():
    config = dataclasses.replace(CONFIG, batcher=BatcherConfig(time_threshold_us=200_000))
    rng = np.random.default_rng(5)
    n = 400
    stream = (rng.integers(0, 640, n), rng.integers(0, 480, n),
              np.sort(rng.integers(0, 2_000_000, n)), rng.integers(0, 2, n))
    cuts = [(0, 120), (120, 260), (260, n)]
    res = {}
    for wire in WIRES:
        fp = _fleet(2, wire, config)
        res[wire] = [fp.feed([tuple(a[lo:hi] for a in stream), None]) for lo, hi in cuts] + [fp.flush()]
        stats = fp.wire_stats
    assert stats.spilled > 0
    for got, want in zip(res["ragged"], res["dense"]):
        assert_stream_equals_scan([got.sensor(0)], want.sensor(0))


@pytest.mark.parametrize("wire", WIRES)
def test_fleet_feed_async_equals_feed(wire):
    recs = _fleet_recordings()[:3]
    per = [list(iter_chunks(r, 20_000)) for r in recs]
    rounds = [[c[i] if i < len(c) else None for c in per] for i in range(max(map(len, per)))]
    sync_fp, async_fp = _fleet(3, wire), _fleet(3, wire, staging_depth=2)
    sync = [sync_fp.feed(r) for r in rounds] + [sync_fp.flush()]
    pend = [async_fp.feed_async(r) for r in rounds] + [async_fp.feed_async([None] * 3, final=True)]
    assert all(p.ready() for p in pend)  # CPU rounds complete before returning
    for p, q in zip(pend, sync):
        np.testing.assert_array_equal(p.n_windows, q.n_windows)
        for s in range(3):
            assert_stream_equals_scan([p.wait().sensor(s)], q.sensor(s))
    for s in range(3):
        assert_stream_equals_scan([q.sensor(s) for q in sync], _scan(s))
    assert sync_fp.wire_stats == async_fp.wire_stats


@pytest.mark.parametrize("seed", [0, 1])
def test_fleet_export_import_mid_stream(seed):
    """A stream hopped mid-stream from a 2-slot pool into a 4-slot pool,
    through the numpy form, equals a dedicated stream."""
    rng = np.random.default_rng(seed)
    chunks = []
    for i in range(6):
        t = (np.arange(90, dtype=np.int64) + 90 * i + 1) * 40
        chunks.append((rng.integers(0, 600, 90), rng.integers(0, 440, 90), t, rng.integers(0, 2, 90)))
    a, b = _fleet(2), _fleet(4)
    parts = []
    for c in chunks[:3]:
        parts.append(a.feed([None, c]).sensor(1))
    carry = TP.slot_carry_from_numpy(TP.slot_carry_to_numpy(a.export_slot(1)))
    a.reset_slots([1])
    b.import_slot(3, carry)
    for c in chunks[3:]:
        parts.append(b.feed([None, None, None, c]).sensor(3))
    parts.append(b.flush_slots([3]).sensor(3))
    ref = TP.StreamingPipeline(CONFIG, device="cpu")
    want = [ref.feed(*c) for c in chunks] + [ref.flush()]
    for f in want[0].clusters._fields:
        got_cat = torch.cat([getattr(p.clusters, f) for p in parts])
        assert torch.equal(got_cat, torch.cat([getattr(p.clusters, f) for p in want])), f
    for f in want[0].tracks._fields:
        assert torch.equal(torch.cat([getattr(p.tracks, f) for p in parts]),
                           torch.cat([getattr(p.tracks, f) for p in want])), f


def test_fleet_import_refuses_mismatched_carry():
    other = TP.PipelineConfig(batcher=BatcherConfig(time_threshold_us=2_000, size_threshold=40,
                                                    capacity=4096))
    a, b = _fleet(2), _fleet(2, config=other)
    carry = a.export_slot(0)
    before = [t.clone() for t in (b.state.atlas, *b.state.tracks)]
    with pytest.raises(ValueError, match="atlas shape"):
        b.import_slot(0, carry)
    for g, w in zip((b.state.atlas, *b.state.tracks), before):
        assert torch.equal(g, w)
    with pytest.raises(IndexError, match="out of range"):
        a.import_slot(7, carry)
    with pytest.raises(IndexError, match="out of range"):
        a.export_slot(7)


# ---------------------------------------------------------------------------
# Against the JAX package.
# ---------------------------------------------------------------------------

def test_reference_slot_carry_resumes_in_the_port_fleet():
    """``export_slot`` from the JAX fleet mid-stream, converted with
    ``slot_carry_from_numpy`` and imported into the port's fleet: both
    fleets fed on give the same outputs (integers exact, floats to the
    stated tolerances)."""
    rec = _fleet_recordings()[1]
    per = list(iter_chunks(rec, 20_000))
    ja = JP.FleetPipeline(JP.PipelineConfig(), n_sensors=2, uniform_fast_path=False)
    for c in per[:5]:
        ja.feed([None, c])
    jc = ja.export_slot(1)
    d = dict(pending=jc.cursor.pending, events_consumed=jc.cursor.events_consumed,
             next_tag=jc.cursor.next_tag, last_t=jc.cursor.last_t, atlas=jc.atlas,
             tracks={f: np.asarray(getattr(jc.tracks, f)) for f in jc.tracks._fields})
    tb = _fleet(4)
    tb.import_slot(2, TP.slot_carry_from_numpy(d))
    assert tb.state.cursors[2].pending_count == jc.pending_count
    got, want = [], []
    for c in per[5:]:
        got.append(tb.feed([None, None, c, None]).sensor(2))
        want.append(ja.feed([None, c]).sensor(1))
    got.append(tb.flush_slots([2]).sensor(2))
    want.append(ja.flush_slots([1]).sensor(1))
    _close_to_reference(got, want)
    back = TP.slot_carry_to_numpy(tb.export_slot(2))
    jb = ja.export_slot(1)
    assert (back["events_consumed"], back["next_tag"], back["last_t"]) == (
        jb.cursor.events_consumed, jb.cursor.next_tag, jb.cursor.last_t)
    np.testing.assert_array_equal(back["atlas"], np.asarray(jb.atlas))  # the atlas event core
    assert np.count_nonzero(back["atlas"]) > 0


def test_fleet_kernel_config_matches_reference_scan():
    """The port's fleet under ``use_kernels=True, metrics_impl="kernel"``
    (its wire decoded by ``ops.event_unpack``'s CPU route) against the
    reference's per-sensor ``run_recording_scan`` under that config."""
    recs = _fleet_recordings()[:2]
    jcfg = JP.PipelineConfig(use_kernels=True, metrics_impl="kernel")
    tcfg = TP.config_from_dict(dataclasses.asdict(jcfg))
    parts = _interleave(_fleet(2, "ragged", tcfg), recs, [[len(r) // 3, 2 * len(r) // 3] for r in recs])
    for s, rec in enumerate(recs):
        _close_to_reference(parts[s], [JP.run_recording_scan(rec, jcfg)])
