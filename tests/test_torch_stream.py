"""The port's streaming driver, on the CPU.

``StreamingPipeline`` (dense and ragged wire) over the reference's
chunkings (``tests/test_streaming.py``: random cuts, a cut one event past
every window start, tag-epoch rollover, a feed beyond one epoch refused
without wedging, unsorted and regressing chunks refused) equals the
port's own ``run_recording_scan`` exactly, on every output. Against the
JAX package: one stream under the kernel config (``use_kernels=True,
metrics_impl="kernel"``; the JAX side runs its Pallas kernels in
interpret mode) with ``tests/test_torch_pipeline.py``'s tolerances
(integers exact, metrics rtol = atol = 1e-5, tracker floats rtol 1e-6,
atol 1e-4), and a JAX stream's carry resumed in the port (its final
atlas equal to the reference's exactly). The batched
``tracker_step`` equals the single-sensor one bit for bit.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.core import pipeline as JP
from repro_torch.core import pipeline as TP
from repro_torch.core.events import BatcherConfig
from repro_torch.core.grid_clustering import Clusters
from repro_torch.core.tracking import TrackState, TrackerConfig, init_tracks, tracker_step
from repro_torch.data.synthetic import Recording, make_recording

torch.set_num_threads(1)

KERNEL_CFG = dict(use_kernels=True, metrics_impl="kernel")
WIRES = ["dense", "ragged"]


@functools.lru_cache(maxsize=None)
def _recording(seed: int = 3, duration_s: float = 0.35, n_rsos: int = 2):
    return make_recording(seed=seed, duration_s=duration_s, n_rsos=n_rsos)


@functools.lru_cache(maxsize=None)
def _scan(config=TP.PipelineConfig(), with_tracking=True, **rec):
    return TP.run_recording_scan(_recording(**rec), config, with_tracking, device="cpu")


def _feed_chunks(sp, rec, cuts):
    """Feed a recording split at the given event indices; flush at the end."""
    parts, prev = [], 0
    for c in sorted(cuts) + [len(rec)]:
        c = min(max(c, prev), len(rec))
        parts.append(sp.feed(rec.x[prev:c], rec.y[prev:c], rec.t[prev:c], rec.p[prev:c]))
        prev = c
    parts.append(sp.flush())
    return parts


def assert_stream_equals_scan(parts, scan, with_tracking=True):
    """Concatenated stream outputs equal the scan's, to the bit."""
    assert sum(p.num_windows for p in parts) == scan.num_windows
    np.testing.assert_array_equal(np.concatenate([p.t_start_us for p in parts]), scan.t_start_us)
    for f in ("starts", "stops", "overflow"):
        np.testing.assert_array_equal(
            np.concatenate([getattr(p.windows, f) for p in parts]), getattr(scan.windows, f), err_msg=f)
    cat = lambda get: torch.cat([get(p).cpu() for p in parts])  # noqa: E731
    for f in scan.clusters._fields:
        assert torch.equal(cat(lambda p: getattr(p.clusters, f)), getattr(scan.clusters, f).cpu()), f
    for k in scan.metrics:
        assert torch.equal(cat(lambda p: p.metrics[k]), scan.metrics[k].cpu()), k
    if not with_tracking:
        assert all(p.tracks is None and p.final_tracks is None for p in parts)
        return
    for f in scan.tracks._fields:
        assert torch.equal(cat(lambda p: getattr(p.tracks, f)), getattr(scan.tracks, f).cpu()), f
        assert torch.equal(getattr(parts[-1].final_tracks, f).cpu(), getattr(scan.final_tracks, f).cpu()), f


def _stream(wire="dense", config=TP.PipelineConfig(), **kw):
    return TP.StreamingPipeline(config, wire=wire, device="cpu", **kw)


@pytest.mark.parametrize("wire", WIRES)
def test_single_feed_plus_flush_equals_scan(wire):
    assert_stream_equals_scan(_feed_chunks(_stream(wire), _recording(), []), _scan())


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chunked_feed_bit_identical_to_scan(wire, seed):
    rec = _recording()
    rng = np.random.default_rng(seed)
    cuts = list(rng.integers(0, len(rec) + 1, rng.integers(1, 7)))
    assert_stream_equals_scan(_feed_chunks(_stream(wire), rec, cuts), _scan())


@pytest.mark.parametrize("wire", WIRES)
def test_chunk_splitting_every_window_boundary_neighbourhood(wire):
    cuts = [int(s) + 1 for s in _scan().windows.starts[1:]]
    assert_stream_equals_scan(_feed_chunks(_stream(wire), _recording(), cuts), _scan())


@pytest.mark.parametrize(
    "cfg",
    [dict(), KERNEL_CFG, dict(numerics="fixed"), dict(numerics="fixed", metrics_impl="megakernel")],
    ids=["event", "kernel", "fixed staged", "fixed megakernel"],
)
def test_stream_matches_scan_across_routes(cfg):
    config = TP.PipelineConfig(**cfg)
    rec = _recording(seed=6, duration_s=0.25, n_rsos=1)
    scan = TP.run_recording_scan(rec, config, device="cpu")
    parts = _feed_chunks(_stream("ragged", config), rec, [len(rec) // 3, 2 * len(rec) // 3])
    assert_stream_equals_scan(parts, scan)


def test_stream_without_tracking():
    sp = TP.StreamingPipeline(TP.PipelineConfig(), with_tracking=False, device="cpu")
    parts = _feed_chunks(sp, _recording(), [len(_recording()) // 2])
    assert_stream_equals_scan(parts, _scan(with_tracking=False), with_tracking=False)


def test_feed_that_closes_no_window_returns_empty_result():
    rec = _recording()
    sp = _stream()
    res = sp.feed(rec.x[:3], rec.y[:3], rec.t[:3], rec.p[:3])
    assert res.num_windows == 0 and res.clusters.count.shape == (0, 32)
    assert res.tracks.x.shape == (0, 16) and sp.backlog == 3
    rest = sp.feed(rec.x[3:], rec.y[3:], rec.t[3:], rec.p[3:])
    assert_stream_equals_scan([res, rest, sp.flush()], _scan())


@pytest.mark.parametrize("wire", WIRES)
def test_tag_epoch_rollover_keeps_identity(wire):
    rec = _recording()
    sp = _stream(wire)
    sp._tag_limit = 4  # force atlas re-zeroing every few windows
    parts = _feed_chunks(sp, rec, list(range(0, len(rec), len(rec) // 5)))
    assert sp.state.next_tag <= 4
    assert_stream_equals_scan(parts, _scan())


def test_feed_larger_than_tag_epoch_refuses_without_wedging():
    rec = _recording()
    sp = _stream()
    sp._tag_limit = 2
    with pytest.raises(ValueError, match="tag epoch"):
        sp.feed(rec.x, rec.y, rec.t, rec.p)
    assert sp.state.pending_count == 0  # chunk rejected, not buffered
    parts = _feed_chunks(sp, rec, list(range(0, len(rec), len(rec) // 10)))
    assert_stream_equals_scan(parts, _scan())


def test_tag_limit_equals_reference():
    for cap in (1, 32, 256, 4096):
        cfg = dict(batcher=BatcherConfig(capacity=cap))
        assert TP.tag_limit(TP.PipelineConfig(**cfg)) == JP.stream.tag_limit(
            JP.PipelineConfig(batcher=JP.config.BatcherConfig(capacity=cap)))


def test_stream_state_resumes_in_new_pipeline():
    rec = _recording()
    half = len(rec) // 2
    sp1 = _stream("ragged")
    first = sp1.feed(rec.x[:half], rec.y[:half], rec.t[:half], rec.p[:half])
    saved = TP.stream_state_to_numpy(sp1.state)
    sp2 = _stream("ragged", state=TP.stream_state_from_numpy(saved, "cpu"))
    rest = sp2.feed(rec.x[half:], rec.y[half:], rec.t[half:], rec.p[half:])
    assert_stream_equals_scan([first, rest, sp2.flush()], _scan())


def test_feed_rejects_unsorted_chunk():
    rec = _recording()
    sp = _stream()
    with pytest.raises(ValueError, match="not non-decreasing"):
        sp.feed(rec.x[:20], rec.y[:20], rec.t[:20][::-1].copy(), rec.p[:20])
    assert sp.state.pending_count == 0
    assert_stream_equals_scan(_feed_chunks(sp, rec, [len(rec) // 2]), _scan())


def test_feed_rejects_timestamps_regressing_across_feeds():
    rec = _recording()
    sp = _stream()
    half = len(rec) // 2
    sp.feed(rec.x[:half], rec.y[:half], rec.t[:half], rec.p[:half])
    with pytest.raises(ValueError, match="monotonically non-decreasing"):
        sp.feed(rec.x[:10], rec.y[:10], rec.t[:10], rec.p[:10])
    rest = sp.feed(rec.x[half:], rec.y[half:], rec.t[half:], rec.p[half:])
    assert rest.num_windows > 0
    with pytest.raises(ValueError, match="monotonically non-decreasing"):
        sp.feed(rec.x[:1], rec.y[:1], rec.t[:1], rec.p[:1])


def test_feed_accepts_equal_boundary_timestamps_and_idle_chunks():
    t = np.array([0, 0, 5, 5], np.int64)
    z = np.zeros(4, np.int32)
    sp = _stream()
    sp.feed(z, z, t, z)
    sp.feed_chunk((z, z, np.full(4, 5, np.int64), z))
    sp.feed_chunk(None)
    assert sp.backlog == 8


@pytest.mark.parametrize("wire", WIRES)
def test_capacity_below_size_threshold_truncates_like_scan(wire):
    config = TP.PipelineConfig(batcher=BatcherConfig(size_threshold=8, capacity=4))
    n = 64
    t = np.arange(n, dtype=np.int64)
    z = np.zeros(n, np.int32)
    sp = _stream(wire, config)
    res = sp.feed(z, z, t, z)
    np.testing.assert_array_equal(res.windows.overflow, np.full(res.num_windows, 4))
    rec = Recording(x=z, y=z, t=t, p=z, kind=z, obj=z, rso_tracks=np.zeros((0, 4)),
                    duration_us=int(t[-1]), name="trunc")
    assert_stream_equals_scan([res, sp.flush()], TP.run_recording_scan(rec, config, device="cpu"))


def test_ragged_spill_path_equals_dense():
    """Sparse events under a 200 ms time threshold give deltas past the
    16-bit lane: the spill lane carries them, outputs stay identical."""
    config = TP.PipelineConfig(batcher=BatcherConfig(time_threshold_us=200_000))
    rng = np.random.default_rng(5)
    n = 400
    x, y = rng.integers(0, 640, n), rng.integers(0, 480, n)
    t, p = np.sort(rng.integers(0, 2_000_000, n)), rng.integers(0, 2, n)
    out = {}
    for wire in WIRES:
        sp = _stream(wire, config)
        out[wire] = [sp.feed(x[a:b], y[a:b], t[a:b], p[a:b]) for a, b in ((0, 120), (120, 260), (260, n))]
        out[wire].append(sp.flush())
        stats = sp.wire_stats
    assert stats.spilled > 0 and stats.compression > 1.0
    rec = Recording(x=x, y=y, t=t, p=p, kind=x * 0, obj=x * 0, rso_tracks=np.zeros((0, 4)),
                    duration_us=int(t[-1]), name="sparse")
    scan = TP.run_recording_scan(rec, config, device="cpu")
    for wire in WIRES:
        assert_stream_equals_scan(out[wire], scan)


def test_wire_mode_validated():
    with pytest.raises(ValueError, match="unknown wire mode"):
        TP.StreamingPipeline(TP.PipelineConfig(), wire="packed", device="cpu")


# ---------------------------------------------------------------------------
# Against the JAX package.
# ---------------------------------------------------------------------------

def _close_to_reference(got_parts, want_parts):
    """Port parts against reference parts: integers exact, metrics rtol =
    atol = 1e-5, tracker floats rtol 1e-6, atol 1e-4."""
    cat_t = lambda get: torch.cat([get(p).cpu() for p in got_parts]).numpy()  # noqa: E731
    cat_j = lambda get: np.concatenate([np.asarray(get(p)) for p in want_parts])  # noqa: E731
    assert sum(p.num_windows for p in got_parts) == sum(p.num_windows for p in want_parts)
    for f in Clusters._fields:
        np.testing.assert_array_equal(cat_t(lambda p: getattr(p.clusters, f)),
                                      cat_j(lambda p: getattr(p.clusters, f)), err_msg=f)
    for m in ("event_count", "edge_density"):
        np.testing.assert_array_equal(cat_t(lambda p: p.metrics[m]), cat_j(lambda p: p.metrics[m]), err_msg=m)
    for m in ("shannon_entropy", "renyi_entropy", "differential_entropy", "local_contrast"):
        np.testing.assert_allclose(cat_t(lambda p: p.metrics[m]), cat_j(lambda p: p.metrics[m]),
                                   rtol=1e-5, atol=1e-5, err_msg=m)
    for f in ("hits", "misses", "age", "active"):
        np.testing.assert_array_equal(cat_t(lambda p: getattr(p.tracks, f)),
                                      cat_j(lambda p: getattr(p.tracks, f)), err_msg=f)
    for f in ("x", "y", "vx", "vy", "entropy"):
        np.testing.assert_allclose(cat_t(lambda p: getattr(p.tracks, f)),
                                   cat_j(lambda p: getattr(p.tracks, f)), rtol=1e-6, atol=1e-4, err_msg=f)


def test_stream_kernel_config_matches_reference_stream():
    rec = _recording(seed=3, duration_s=0.3)
    jcfg = JP.PipelineConfig(**KERNEL_CFG)
    tcfg = TP.config_from_dict(dataclasses.asdict(jcfg))
    cuts = [len(rec) // 2]
    want = _feed_chunks(JP.StreamingPipeline(jcfg, wire="ragged"), rec, cuts)
    got = _feed_chunks(TP.StreamingPipeline(tcfg, wire="ragged", device="cpu"), rec, cuts)
    _close_to_reference(got, want)


def test_reference_stream_state_resumes_in_the_port():
    """A stream fed halfway in the JAX package, its carry converted with
    ``stream_state_from_numpy``, finishes in the port like it finishes in
    the reference."""
    rec = _recording()
    half = len(rec) // 2
    jsp = JP.StreamingPipeline(JP.PipelineConfig())
    jsp.feed(rec.x[:half], rec.y[:half], rec.t[:half], rec.p[:half])
    st = jsp.state
    carry = dict(
        pending=st.pending, events_consumed=st.events_consumed, next_tag=st.next_tag,
        last_t=st.last_t, atlas=np.asarray(st.atlas),
        tracks={f: np.asarray(getattr(st.tracks, f)) for f in st.tracks._fields},
    )
    tsp = _stream("ragged", state=TP.stream_state_from_numpy(carry, "cpu"))
    assert tsp.backlog == jsp.backlog and tsp.state.next_tag == st.next_tag
    rest = slice(half, None)
    got = [tsp.feed(rec.x[rest], rec.y[rest], rec.t[rest], rec.p[rest]), tsp.flush()]
    want = [jsp.feed(rec.x[rest], rec.y[rest], rec.t[rest], rec.p[rest]), jsp.flush()]
    _close_to_reference(got, want)
    back = TP.stream_state_to_numpy(tsp.state)
    assert back["events_consumed"] == jsp.state.events_consumed == len(rec)
    assert back["next_tag"] == jsp.state.next_tag and back["last_t"] == jsp.state.last_t
    np.testing.assert_array_equal(back["atlas"], np.asarray(jsp.state.atlas))  # the atlas event core
    assert np.count_nonzero(back["atlas"]) > 0


# ---------------------------------------------------------------------------
# The batched tracker.
# ---------------------------------------------------------------------------

def _random_tracker_inputs(rng, s, t=16, k=32):
    state = TrackState(
        x=torch.from_numpy(rng.uniform(0, 640, (s, t)).astype(np.float32)),
        y=torch.from_numpy(rng.uniform(0, 480, (s, t)).astype(np.float32)),
        vx=torch.from_numpy(rng.normal(0, 3, (s, t)).astype(np.float32)),
        vy=torch.from_numpy(rng.normal(0, 3, (s, t)).astype(np.float32)),
        hits=torch.from_numpy(rng.integers(0, 6, (s, t)).astype(np.int32)),
        misses=torch.from_numpy(rng.integers(0, 3, (s, t)).astype(np.int32)),
        age=torch.from_numpy(rng.integers(0, 9, (s, t)).astype(np.int32)),
        active=torch.from_numpy(rng.random((s, t)) < 0.5),
        entropy=torch.from_numpy(rng.uniform(0, 5, (s, t)).astype(np.float32)),
    )
    # Detections near some tracks, so matches, spawns and duplicates occur.
    near = state.x[:, :1] + torch.from_numpy(rng.normal(0, 10, (s, k)).astype(np.float32))
    cl = Clusters(
        centroid_x=torch.where(torch.from_numpy(rng.random((s, k)) < 0.5), near,
                               torch.from_numpy(rng.uniform(0, 640, (s, k)).astype(np.float32))),
        centroid_y=torch.from_numpy(rng.uniform(0, 480, (s, k)).astype(np.float32)),
        centroid_t=torch.zeros((s, k)),
        count=torch.from_numpy(rng.integers(1, 50, (s, k)).astype(np.int32)),
        cell_x=torch.zeros((s, k), dtype=torch.int32),
        cell_y=torch.zeros((s, k), dtype=torch.int32),
        valid=torch.from_numpy(rng.random((s, k)) < 0.6),
    )
    return state, cl, torch.from_numpy(rng.uniform(0, 5, (s, k)).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batched_tracker_step_equals_single_sensor(seed):
    rng = np.random.default_rng(seed)
    state, cl, ent = _random_tracker_inputs(rng, 6)
    cfg = TrackerConfig()
    for _ in range(4):
        new, assign = tracker_step(state, cl, ent, cfg)
        for s in range(6):
            one, a1 = tracker_step(TrackState(*(a[s] for a in state)),
                                   Clusters(*(a[s] for a in cl)), ent[s], cfg)
            assert torch.equal(assign[s], a1)
            for f, got, want in zip(TrackState._fields, new, one):
                assert torch.equal(got[s], want), f
        state = new


def test_batched_tracker_over_real_windows_equals_scan():
    """Two recordings' scans stacked as a 2-sensor fleet: the batched
    loop gives each sensor's scan tracks to the bit."""
    a = _scan()
    b = TP.run_recording_scan(_recording(seed=8), TP.PipelineConfig(), device="cpu")
    w = min(a.num_windows, b.num_windows)
    cl = Clusters(*(torch.stack([u[:w], v[:w]]) for u, v in zip(a.clusters, b.clusters)))
    ent = torch.stack([a.metrics["shannon_entropy"][:w], b.metrics["shannon_entropy"][:w]])
    z = init_tracks(device="cpu")
    state = TrackState(*(torch.stack([f, f]) for f in z))
    for i in range(w):
        state, _ = tracker_step(state, Clusters(*(c[:, i] for c in cl)), ent[:, i])
        for s, r in enumerate((a, b)):
            for f in TrackState._fields:
                assert torch.equal(getattr(state, f)[s], getattr(r.tracks, f)[i]), (i, s, f)
