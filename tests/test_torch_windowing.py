"""The rest of windowing and the loop driver, against the JAX reference on
the CPU: ``make_empty_batch``, ``batch_from_arrays``,
``dual_threshold_batches``, ``window_batches`` and ``pad_windows(policy=
"stride")`` give the reference's arrays to the bit;
``persistent_event_filter_hist`` is the histogram oracle of the
event-space filter; ``run_recording`` (one window core call per window)
equals ``run_recording_scan`` window for window on every route, as in the
reference's ``tests/test_pipeline_scan.py`` and
``tests/test_pipeline_e2e.py``, and equals the reference's
``run_recording`` (integers exactly, metrics to rtol = atol = 1e-5,
tracker floats to rtol = 1e-6, atol = 1e-4); ``run_many_scan`` equals a
scan per recording. The kernel route at ``BatcherConfig(capacity=4096)``,
past the CUDA kernels' small path, is held to the reference on
dual-threshold and 100 ms stride windows."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import events as JE
from repro.core import pipeline as JP
from repro.data.synthetic import make_recording, make_validation_suite
from repro_torch.core import events as TE
from repro_torch.core import pipeline as TP
from repro_torch.kernels import ref
from repro_torch.data.synthetic import Recording

torch.set_num_threads(1)

KERNEL_CFG = dict(use_kernels=True, metrics_impl="kernel")
FIXED_CFG = dict(numerics="fixed", metrics_impl="megakernel")
EXACT_METRICS = ("event_count", "edge_density")
TRACK_RTOL, TRACK_ATOL = 1e-6, 1e-4


@pytest.fixture(scope="module")
def recording():
    return make_recording(seed=3, duration_s=0.4, n_rsos=2)


@pytest.fixture(scope="module")
def suite():
    return make_validation_suite(n_recordings=1, duration_s=0.4)


def _empty_recording() -> Recording:
    z = np.zeros(0, np.int32)
    return Recording(x=z, y=z, t=np.zeros(0, np.int64), p=z, kind=z, obj=z,
                     rso_tracks=np.zeros((0, 4)), duration_us=0, name="empty")


def _tcfg(jcfg):
    return TP.config_from_dict(dataclasses.asdict(jcfg))


def _assert_batch_equal(tb, jb, what):
    for f in JE.EventBatch._fields:
        a, b = getattr(tb, f), np.asarray(getattr(jb, f))
        assert a.dtype == (torch.bool if f == "valid" else torch.int32), (what, f)
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f"{what}: {f}")


# ---------------------------------------------------------------------------
# Windowing, array for array.
# ---------------------------------------------------------------------------

def test_make_empty_batch_and_batch_from_arrays_match_reference(recording):
    _assert_batch_equal(TE.make_empty_batch(64, device="cpu"), JE.make_empty_batch(64), "empty")
    r = recording
    for n, cap in ((250, 256), (300, 256), (0, 16), (5, 5)):
        t = r.t[:n] - (r.t[0] if n else 0)
        _assert_batch_equal(TE.batch_from_arrays(r.x[:n], r.y[:n], t, r.p[:n], cap, device="cpu"),
                            JE.batch_from_arrays(r.x[:n], r.y[:n], t, r.p[:n], cap), (n, cap))


@pytest.mark.parametrize("cfg", [dict(), dict(size_threshold=40, capacity=32),
                                 dict(time_threshold_us=5_000)], ids=str)
def test_dual_threshold_batches_match_reference(recording, cfg):
    r = recording
    tb = list(TE.dual_threshold_batches(r.x, r.y, r.t, r.p, TE.BatcherConfig(**cfg), device="cpu"))
    jb = list(JE.dual_threshold_batches(r.x, r.y, r.t, r.p, JE.BatcherConfig(**cfg)))
    assert len(tb) == len(jb) > 0
    for w, ((a, sa), (b, sb)) in enumerate(zip(tb, jb)):
        assert sa == sb
        _assert_batch_equal(a, b, f"window {w}")


@pytest.mark.parametrize("window_us,cap", [(20_000, 256), (100_000, 512), (7_000, 16)])
def test_window_batches_and_stride_pad_windows_match_reference(recording, window_us, cap):
    r = recording
    tb = list(TE.window_batches(r.x, r.y, r.t, r.p, window_us, cap, device="cpu"))
    jb = list(JE.window_batches(r.x, r.y, r.t, r.p, window_us, cap))
    assert len(tb) == len(jb) > 0
    for w, ((a, sa), (b, sb)) in enumerate(zip(tb, jb)):
        assert sa == sb
        _assert_batch_equal(a, b, f"window {w}")
    cfg = dict(capacity=cap)
    tw = TE.pad_windows(r.x, r.y, r.t, r.p, TE.BatcherConfig(**cfg), "cpu", policy="stride",
                        window_us=window_us)
    jw = JE.pad_windows(r.x, r.y, r.t, r.p, JE.BatcherConfig(**cfg), policy="stride",
                        window_us=window_us)
    _assert_batch_equal(tw.batch, jw.batch, "stride planes")
    for f in ("t_start_us", "starts", "stops", "overflow"):
        np.testing.assert_array_equal(getattr(tw, f), getattr(jw, f), err_msg=f)
    for w, (a, _) in enumerate(tb):  # the stacked rows are the iterator's windows
        _assert_batch_equal(TE.EventBatch(*(p[w] for p in tw.batch)),
                            JE.EventBatch(*(a_.numpy() for a_ in a)), f"row {w}")


def test_stride_policy_defaults_to_the_time_threshold(recording):
    r = recording
    cfg = TE.BatcherConfig(time_threshold_us=30_000, capacity=512)
    a = TE.pad_windows(r.x, r.y, r.t, r.p, cfg, "cpu", policy="stride")
    b = TE.pad_windows(r.x, r.y, r.t, r.p, cfg, "cpu", policy="stride", window_us=30_000)
    np.testing.assert_array_equal(a.t_start_us, b.t_start_us)
    assert torch.equal(a.batch.x, b.batch.x)


def test_pad_windows_stride_truncates_at_capacity():
    # 100 events in one 20 ms stride window but capacity 16: one row of 16,
    # the other 84 counted as overflow.
    n = 100
    t = np.arange(n, dtype=np.int64) * 100
    z = np.zeros(n, np.int32)
    w = TE.pad_windows(z, z, t, z, TE.BatcherConfig(capacity=16), "cpu", policy="stride")
    assert w.num_windows == 1
    assert int(w.batch.valid.sum()) == 16 and int(w.overflow[0]) == 84


def test_pad_windows_empty_stream_and_unknown_policy():
    z = np.zeros(0, np.int32)
    for policy in ("dual", "stride"):
        w = TE.pad_windows(z, z, np.zeros(0, np.int64), z, TE.BatcherConfig(), "cpu", policy=policy)
        assert w.num_windows == 0 and w.batch.x.shape == (0, TE.DEFAULT_CAPACITY)
    z = np.zeros(1, np.int32)
    with pytest.raises(ValueError):
        TE.pad_windows(z, z, np.zeros(1, np.int64), z, device="cpu", policy="nope")


def test_persistent_event_filter_hist_matches_reference_and_event_space(recording):
    """The histogram oracle equals the reference's oracle and the port's
    event-space filter (pairwise below 1,024 events, sort-based above)."""
    r = recording
    for cap, max_rep in ((256, 8), (256, 2), (2048, 3)):
        batches = list(TE.window_batches(r.x, r.y, r.t, r.p, 100_000, cap, device="cpu"))
        for b, _ in batches:
            hot = b._replace(x=torch.where(torch.arange(cap) % 7 == 0, 300, b.x),
                             y=torch.where(torch.arange(cap) % 7 == 0, 200, b.y))
            got = TE.persistent_event_filter_hist(hot, max_rep)
            jb = JE.EventBatch(*(a.numpy() for a in hot))
            want = JE.persistent_event_filter_hist(jb, max_rep)
            np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
            assert torch.equal(got.valid, TE.persistent_event_filter(hot, max_rep).valid)
            assert bool((hot.valid & ~got.valid).any()), "the hot pixel is filtered"
        stacked = TE.EventBatch(*(torch.stack(f) for f in zip(*(b for b, _ in batches))))
        assert torch.equal(TE.persistent_event_filter_hist(stacked, max_rep).valid,
                           TE.persistent_event_filter(stacked, max_rep).valid)


# ---------------------------------------------------------------------------
# The loop driver.
# ---------------------------------------------------------------------------

def _assert_loop_equals_scan(rec, cfg, with_tracking=True):
    loop = TP.run_recording(rec, cfg, with_tracking=with_tracking, device="cpu")
    scan = TP.run_recording_scan(rec, cfg, with_tracking=with_tracking, device="cpu")
    assert scan.num_windows == len(loop) > 0
    for w, (a, b) in enumerate(zip(loop, scan.window_results())):
        assert a.t_start_us == b.t_start_us
        for f in a.clusters._fields:
            assert torch.equal(getattr(a.clusters, f), getattr(b.clusters, f)), (w, f)
        assert a.metrics.keys() == b.metrics.keys()
        for k in a.metrics:
            np.testing.assert_array_equal(a.metrics[k], b.metrics[k], err_msg=f"{w} {k}")
        if with_tracking:
            for f in a.tracks._fields:
                assert torch.equal(getattr(a.tracks, f), getattr(b.tracks, f)), (w, f)
        else:
            assert a.tracks is None and b.tracks is None
    if with_tracking:
        for f in scan.final_tracks._fields:
            assert torch.equal(getattr(loop[-1].tracks, f), getattr(scan.final_tracks, f)), f
    return loop


@pytest.mark.parametrize("cfg", [dict(), KERNEL_CFG, dict(use_kernels=True), FIXED_CFG,
                                 dict(numerics="fixed", metrics_impl="staged")], ids=str)
def test_loop_equals_scan(suite, cfg):
    for rec in suite[:1] if cfg else suite:
        _assert_loop_equals_scan(rec, TP.PipelineConfig(**cfg))


def test_loop_without_tracking_equals_scan(recording):
    _assert_loop_equals_scan(recording, TP.PipelineConfig(**KERNEL_CFG), with_tracking=False)


def test_loop_empty_recording():
    assert TP.run_recording(_empty_recording(), TP.PipelineConfig(), device="cpu") == []
    scan = TP.run_recording_scan(_empty_recording(), TP.PipelineConfig(), device="cpu")
    assert scan.window_results() == []


def test_process_window_is_memoized_and_one_window_at_a_time(recording):
    cfg = TP.PipelineConfig(**KERNEL_CFG)
    assert TP.make_process_window(cfg) is TP.make_process_window(cfg)
    assert TP._tracker_fn(cfg.tracker) is TP._tracker_fn(cfg.tracker)
    b = TE.batch_from_arrays(recording.x[:250], recording.y[:250],
                             recording.t[:250] - recording.t[0], recording.p[:250], device="cpu")
    for c in (cfg, TP.PipelineConfig(**FIXED_CFG)):
        clusters, mets = TP.make_process_window(c)(b)
        assert clusters.count.shape == (32,) and all(v.shape == (32,) for v in mets.values())


def test_kernel_path_equals_plain_path(recording):
    """The reference's ``test_kernel_path_equals_jnp_path``: on one device
    the port's two histogram routes agree to the bit."""
    n = min(len(recording), 250)
    b = TE.batch_from_arrays(recording.x[:n], recording.y[:n], recording.t[:n], recording.p[:n],
                             device="cpu")
    c1, m1 = TP.make_process_window(TP.PipelineConfig(use_kernels=False))(b)
    c2, m2 = TP.make_process_window(TP.PipelineConfig(use_kernels=True))(b)
    for f in c1._fields:
        assert torch.equal(getattr(c1, f), getattr(c2, f)), f
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k


def test_run_recording_produces_windows_and_tracks(recording):
    results = TP.run_recording(recording, TP.PipelineConfig(), device="cpu")
    assert len(results) >= 15
    assert all(r.tracks is not None for r in results)
    assert sum(int(r.clusters.num_valid()) for r in results) > 10


@pytest.mark.parametrize("cfg", [KERNEL_CFG, FIXED_CFG], ids=str)
def test_run_recording_matches_reference(cfg):
    """The loop driver on the quickstart recording against the
    reference's: every integer exactly, metrics to 1e-5 (event_count and
    edge_density exactly; the others come from log2 and sqrt in each
    framework's own implementation, on both datapaths), tracker floats to
    the stated bound."""
    rec = make_recording(seed=7, duration_s=2.0, n_rsos=2)
    jcfg = JP.PipelineConfig(**cfg)
    jl = JP.run_recording(rec, jcfg)
    tl = TP.run_recording(rec, _tcfg(jcfg), device="cpu")
    assert len(tl) == len(jl) == 100
    for w, (a, b) in enumerate(zip(tl, jl)):
        assert a.t_start_us == b.t_start_us
        for f in a.clusters._fields:
            np.testing.assert_array_equal(getattr(a.clusters, f).numpy(),
                                          np.asarray(getattr(b.clusters, f)), err_msg=f"{w} {f}")
        for k in a.metrics:
            if k in EXACT_METRICS:
                np.testing.assert_array_equal(a.metrics[k], np.asarray(b.metrics[k]), err_msg=k)
            else:
                np.testing.assert_allclose(a.metrics[k], np.asarray(b.metrics[k]), rtol=1e-5,
                                           atol=1e-5, err_msg=k)
        for f in ("hits", "misses", "age", "active"):
            np.testing.assert_array_equal(getattr(a.tracks, f).numpy(),
                                          np.asarray(getattr(b.tracks, f)), err_msg=f"{w} {f}")
        for f in ("x", "y", "vx", "vy", "entropy"):
            np.testing.assert_allclose(getattr(a.tracks, f).numpy(), np.asarray(getattr(b.tracks, f)),
                                       rtol=TRACK_RTOL, atol=TRACK_ATOL, err_msg=f"{w} {f}")


# ---------------------------------------------------------------------------
# run_many_scan.
# ---------------------------------------------------------------------------

def test_run_many_scan_matches_per_recording():
    # Different lengths, so the padded tail and the per-recording final
    # state are exercised; one recording without windows at all.
    recs = [make_recording(seed=1, duration_s=0.6, n_rsos=2),
            make_recording(seed=2, duration_s=0.3, n_rsos=1), _empty_recording()]
    cfg = TP.PipelineConfig(**KERNEL_CFG)
    singles = [TP.run_recording_scan(r, cfg, device="cpu") for r in recs]
    assert singles[0].num_windows != singles[1].num_windows
    many = TP.run_many_scan(recs, cfg, device="cpu")
    assert len(many) == len(recs)
    for res, single in zip(many, singles):
        assert res.num_windows == single.num_windows
        np.testing.assert_array_equal(res.t_start_us, single.t_start_us)
        for f in res.clusters._fields:
            assert torch.equal(getattr(res.clusters, f), getattr(single.clusters, f)), f
        for k in res.metrics:
            assert torch.equal(res.metrics[k], single.metrics[k]), k
        for f in res.tracks._fields:
            assert torch.equal(getattr(res.tracks, f), getattr(single.tracks, f)), f
            assert torch.equal(getattr(res.final_tracks, f), getattr(single.final_tracks, f)), f
    untracked = TP.run_many_scan(recs, cfg, with_tracking=False, device="cpu")
    assert all(r.tracks is None and r.final_tracks is None for r in untracked)
    assert torch.equal(untracked[0].clusters.count, singles[0].clusters.count)


def test_run_many_scan_matches_reference_and_empty_list():
    recs = [make_recording(seed=1, duration_s=0.4, n_rsos=2),
            make_recording(seed=2, duration_s=0.2, n_rsos=1)]
    jcfg = JP.PipelineConfig(**KERNEL_CFG)
    for a, b in zip(TP.run_many_scan(recs, _tcfg(jcfg), device="cpu"), JP.run_many_scan(recs, jcfg)):
        for f in ("count", "cell_x", "cell_y", "valid", "centroid_x", "centroid_y", "centroid_t"):
            np.testing.assert_array_equal(getattr(a.clusters, f).numpy(),
                                          np.asarray(getattr(b.clusters, f)), err_msg=f)
        for f in ("hits", "misses", "age", "active"):
            np.testing.assert_array_equal(getattr(a.final_tracks, f).numpy(),
                                          np.asarray(getattr(b.final_tracks, f)), err_msg=f)
    assert TP.run_many_scan([], TP.PipelineConfig(), device="cpu") == []


# ---------------------------------------------------------------------------
# The kernel route past the CUDA kernels' small path (E > 1024).
# ---------------------------------------------------------------------------

def _assert_scan_matches_reference(tr, jr, what):
    """Integers exactly; centroid_t within ``ref.centroid_t_bound`` of the
    slot, sized by count x the window's largest t (exact below 2^24);
    metrics to 1e-5, event_count and edge_density exactly."""
    assert tr.num_windows == jr.num_windows > 0
    np.testing.assert_array_equal(tr.t_start_us, jr.t_start_us)
    for f in ("count", "cell_x", "cell_y", "valid", "centroid_x", "centroid_y"):
        np.testing.assert_array_equal(getattr(tr.clusters, f).numpy(),
                                      np.asarray(getattr(jr.clusters, f)), err_msg=f"{what} {f}")
    b = tr.windows.batch
    t_max = torch.where(b.valid, b.t.abs(), 0).amax(-1).to(torch.int64)
    bound = ref.centroid_t_bound(tr.clusters.count, tr.clusters.count.to(torch.int64) * t_max[:, None])
    diff = (tr.clusters.centroid_t.double() - torch.as_tensor(np.array(jr.clusters.centroid_t))).abs()
    assert bool((diff <= bound).all()), what
    for m, v in tr.metrics.items():
        want = np.asarray(jr.metrics[m])
        if m in EXACT_METRICS:
            np.testing.assert_array_equal(v.numpy(), want, err_msg=f"{what} {m}")
        else:
            np.testing.assert_allclose(v.numpy(), want, rtol=1e-5, atol=1e-5, err_msg=f"{what} {m}")


def test_kernel_route_at_capacity_4096_matches_reference():
    """``use_kernels=True, metrics_impl="kernel"`` at ``BatcherConfig(
    capacity=4096)``, the reference's own large config: dual-threshold
    windows (up to 250 events in 4,096 slots, tracked), and 100 ms stride
    windows of about 2,300 events on a dense sky (centroid_t held to its
    bound, though no cell of this sky passes 2^24: the hand-built case is
    in ``test_torch_kernels.py``). On the CPU the wrappers run the plain versions; on the
    card the same config runs the kernels' large path
    (``test_torch_cuda.py``, ``chip_smoke.py`` phase 4)."""
    rec = make_recording(seed=11, duration_s=0.3, n_rsos=4, noise_rate_hz=20_000)
    jcfg = JP.PipelineConfig(batcher=JE.BatcherConfig(capacity=4096), **KERNEL_CFG)
    tcfg = _tcfg(jcfg)
    tr = TP.run_recording_scan(rec, tcfg, device="cpu")
    jr = JP.run_recording_scan(rec, jcfg)
    _assert_scan_matches_reference(tr, jr, "dual")
    for f in ("hits", "misses", "age", "active"):
        np.testing.assert_array_equal(getattr(tr.tracks, f).numpy(), np.asarray(getattr(jr.tracks, f)))
    tw = TE.pad_windows(rec.x, rec.y, rec.t, rec.p, tcfg.batcher, "cpu", policy="stride",
                        window_us=100_000)
    jw = JE.pad_windows(rec.x, rec.y, rec.t, rec.p, jcfg.batcher, policy="stride", window_us=100_000)
    assert int(tw.batch.valid.sum(-1).min()) > 1024
    tr = TP.run_recording_scan(rec, tcfg, with_tracking=False, windows=tw, device="cpu")
    jr = JP.run_recording_scan(rec, jcfg, with_tracking=False, windows=jw)
    _assert_scan_matches_reference(tr, jr, "stride")
