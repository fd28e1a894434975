"""The accuracy sweep (the paper's Fig. 10b) and candidate collection,
against the JAX reference on the CPU. Scores are exact: the port's
``threshold_sweep`` over the reference's five-recording corpus
(``tests/test_detection_accuracy.py``) equals the reference's tp/fp/fn/tn
at every threshold, with the scan and the fleet driver, on the default
route, the float kernel route (here the kernels' plain versions) and the
fixed megakernel route. ``collect_candidates`` (device matcher),
``collect_candidates_numpy`` (float64 oracle), ``collect_candidates_loop``
(the loop driver's windows), ``collect_candidates_many`` and
``collect_candidates_fleet`` agree exactly, as in the reference's
``tests/test_detection_candidates.py``, and each equals the reference's
collection; ``tests/test_evaluate_edges.py``'s degenerate scores and
merges carry over."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import pipeline as JP
from repro.data.synthetic import make_recording
from repro_torch.core import pipeline as TP
from repro_torch.core.pipeline import Candidates, DetectionScore
from repro_torch.core.tracking import confirmed
from repro_torch.data import synthetic as TS

torch.set_num_threads(1)

KERNEL_CFG = dict(use_kernels=True, metrics_impl="kernel")
FIXED_CFG = dict(numerics="fixed", metrics_impl="megakernel")
THRESHOLDS = (2, 3, 4, 5, 6, 8, 10)
# The reference's score on the five recordings below at min_events = 5.
SWEEP5 = (435, 24, 25, 1784)


def _accuracy_suite(make=make_recording):
    """``tests/test_detection_accuracy.py``'s five recordings."""
    return [make(seed=s, duration_s=1.0, n_rsos=1 + (s % 3)) for s in (1, 2, 3)] + [
        make(seed=11, duration_s=1.0, n_rsos=1, lens="telephoto"),
        make(seed=21, duration_s=1.0, n_rsos=2, lens="wide")]


@pytest.fixture(scope="module")
def recording():
    return make_recording(seed=5, duration_s=0.4, n_rsos=2)


@pytest.fixture(scope="module")
def reference_sweep():
    return {name: JP.threshold_sweep(_accuracy_suite(), THRESHOLDS, JP.PipelineConfig(**cfg))
            for name, cfg in (("default", {}), ("fixed", FIXED_CFG))}


def _empty_recording() -> TS.Recording:
    z = np.zeros(0, np.int32)
    return TS.Recording(x=z, y=z, t=np.zeros(0, np.int64), p=z, kind=z, obj=z,
                        rso_tracks=np.zeros((0, 4)), duration_us=0, name="empty")


def _tcfg(jcfg):
    return TP.config_from_dict(dataclasses.asdict(jcfg))


def _scores(sweep):
    return {t: (s.tp, s.fp, s.fn, s.tn) for t, s in sweep.items()}


def _assert_candidates_equal(a, b, what=""):
    np.testing.assert_array_equal(a.counts, b.counts, err_msg=f"{what} counts")
    np.testing.assert_array_equal(a.is_rso, b.is_rso, err_msg=f"{what} is_rso")
    np.testing.assert_array_equal(a.object_best, b.object_best, err_msg=f"{what} object_best")


# ---------------------------------------------------------------------------
# The sweep, score for score.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("driver", ["scan", "fleet"])
@pytest.mark.parametrize("name,cfg", [("default", {}), ("float kernel", KERNEL_CFG),
                                      ("fixed", FIXED_CFG)])
def test_sweep_equals_reference(reference_sweep, driver, name, cfg):
    """Every threshold's tp/fp/fn/tn equals the reference's sweep (the
    float kernel route is held to the reference's default float route:
    the reference's own tests show its routes score alike)."""
    want = reference_sweep["fixed" if name == "fixed" else "default"]
    got = TP.threshold_sweep(_accuracy_suite(TS.make_recording), THRESHOLDS, TP.PipelineConfig(**cfg),
                             driver=driver, device="cpu")
    assert _scores(got) == _scores(want)
    assert (got[5].tp, got[5].fp, got[5].fn, got[5].tn) == SWEEP5


def test_sweep_curve_as_the_paper_claims():
    """The reference's accuracy assertions, on the port: at least 0.95 at
    min_events = 5, the peak at 4-6, both flanks worse, precision
    non-decreasing up to 6."""
    sweep = TP.threshold_sweep(_accuracy_suite(TS.make_recording), THRESHOLDS,
                               TP.PipelineConfig(**KERNEL_CFG), device="cpu")
    accs = {t: s.accuracy for t, s in sweep.items()}
    assert accs[5] >= 0.95, accs
    best = max(accs, key=accs.get)
    assert best in (4, 5, 6) and accs[2] < accs[best] - 0.05 and accs[10] < accs[best], accs
    precs = [sweep[t].precision for t in (2, 3, 4, 5, 6)]
    assert all(b >= a - 1e-9 for a, b in zip(precs, precs[1:])), precs


def test_sweep_runs_one_core_call(monkeypatch):
    """The scan driver collects the whole suite through one core call (the
    reference's vmapped single dispatch): a per-recording scan would call
    the core once per recording."""
    from repro_torch.core.pipeline import scan as S

    calls = []
    make_core = S.make_core

    def counting(config, with_tracking=True):
        core = make_core(config, with_tracking)

        def wrapped(*a, **k):
            calls.append(a[0].x.shape)
            return core(*a, **k)
        return wrapped

    monkeypatch.setattr(S, "make_core", counting)
    recs = [TS.make_recording(seed=s, duration_s=0.3, n_rsos=1) for s in (1, 2, 3)]
    sweep = TP.threshold_sweep(recs, thresholds=(5,), device="cpu")
    assert sweep[5].tp + sweep[5].fn > 0
    assert len(calls) == 1 and calls[0][0] == 3, calls


def test_sweep_rejects_unknown_driver_and_fleet_mesh():
    recs = [TS.make_recording(seed=1, duration_s=0.1)]
    with pytest.raises(ValueError):
        TP.threshold_sweep(recs, driver="nope", device="cpu")
    with pytest.raises(TypeError, match="mesh of devices"):
        TP.collect_candidates_fleet(recs, mesh=object(), device="cpu")


# ---------------------------------------------------------------------------
# Candidate collection: device = numpy = loop = many = fleet = reference.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [{}, KERNEL_CFG, FIXED_CFG], ids=str)
def test_device_numpy_and_loop_agree(recording, cfg):
    c = TP.PipelineConfig(**cfg)
    dev = TP.collect_candidates(recording, c, device="cpu")
    _assert_candidates_equal(dev, TP.collect_candidates_numpy(recording, c, device="cpu"), "numpy")
    _assert_candidates_equal(dev, TP.collect_candidates_loop(recording, c, device="cpu"), "loop")
    _assert_candidates_equal(dev, JP.collect_candidates(recording, JP.PipelineConfig(**cfg)), "ref")


def test_device_matches_numpy_oracle_on_suite():
    cfg = TP.PipelineConfig(**KERNEL_CFG)
    for rec in TS.make_validation_suite(n_recordings=1, duration_s=0.4):
        _assert_candidates_equal(TP.collect_candidates(rec, cfg, device="cpu"),
                                 TP.collect_candidates_numpy(rec, cfg, device="cpu"), rec.name)


@pytest.mark.parametrize("max_samples", [0, 7, 40])
def test_loop_matches_device_with_max_samples(recording, max_samples):
    cfg = TP.PipelineConfig()
    a = TP.collect_candidates(recording, cfg, max_samples=max_samples, device="cpu")
    b = TP.collect_candidates_loop(recording, cfg, max_samples=max_samples, device="cpu")
    full = TP.collect_candidates(recording, cfg, device="cpu")
    assert len(a.counts) == min(max_samples, len(full.counts))
    _assert_candidates_equal(a, b)


@pytest.mark.parametrize("driver", ["many", "fleet"])
def test_batched_collection_matches_single(driver):
    recs = [TS.make_recording(seed=1, duration_s=0.5, n_rsos=2),
            TS.make_recording(seed=2, duration_s=0.3, n_rsos=1),  # fewer windows and RSOs
            TS.make_recording(seed=4, duration_s=0.3, n_rsos=0)]  # no RSO at all
    cfg = TP.PipelineConfig(**KERNEL_CFG)
    fn = TP.collect_candidates_many if driver == "many" else TP.collect_candidates_fleet
    for ms in (None, 9):
        batched = fn(recs, cfg, max_samples=ms, device="cpu")
        assert len(batched) == len(recs)
        for m, rec in zip(batched, recs):
            _assert_candidates_equal(m, TP.collect_candidates(rec, cfg, max_samples=ms, device="cpu"),
                                     f"{driver} {ms}")
    jm = JP.collect_candidates_many(recs, JP.PipelineConfig(**KERNEL_CFG))
    for m, j in zip(fn(recs, cfg, device="cpu"), jm):
        _assert_candidates_equal(m, j, "reference")


def test_batched_collection_empty_inputs():
    cfg = TP.PipelineConfig()
    assert TP.collect_candidates_many([], cfg, device="cpu") == []
    assert TP.collect_candidates_fleet([], cfg, device="cpu") == []
    for fn in (TP.collect_candidates_many, TP.collect_candidates_fleet):
        (cand,) = fn([_empty_recording()], cfg, device="cpu")
        assert cand.counts.shape == cand.is_rso.shape == cand.object_best.shape == (0,)


def test_threshold_sweep_matches_numpy_oracle_scores():
    cfg = TP.PipelineConfig()
    recs = TS.make_validation_suite(n_recordings=1, duration_s=0.4)
    sweep = TP.threshold_sweep(recs, thresholds=(2, 4, 5, 8), config=cfg, device="cpu")
    oracle = TP.merge_candidates([TP.collect_candidates_numpy(r, cfg, device="cpu") for r in recs])
    for thr, score in sweep.items():
        want = TP.score_threshold(oracle, thr)
        assert (score.tp, score.fp, score.fn, score.tn) == (want.tp, want.fp, want.fn, want.tn), thr


def test_validation_suite_matches_reference():
    from repro.data.synthetic import make_validation_suite as j_suite

    for kw in (dict(), dict(n_recordings=2, duration_s=0.3, seed0=7)):
        ours, theirs = TS.make_validation_suite(**kw), j_suite(**kw)
        assert [r.name for r in ours] == [r.name for r in theirs]
        assert len(ours) == 3 * kw.get("n_recordings", 6)
        for a, b in zip(ours, theirs):
            assert a.duration_us == b.duration_us
            for f in ("x", "y", "t", "p", "kind", "obj", "rso_tracks"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f"{a.name} {f}")


# ---------------------------------------------------------------------------
# Edges (tests/test_detection_candidates.py, tests/test_evaluate_edges.py).
# ---------------------------------------------------------------------------

def test_empty_recording_yields_empty_candidates():
    cand = TP.collect_candidates(_empty_recording(), TP.PipelineConfig(), device="cpu")
    assert cand.counts.shape == cand.is_rso.shape == cand.object_best.shape == (0,)
    s = TP.score_threshold(cand, 5)
    assert (s.tp, s.fp, s.fn, s.tn) == (0, 0, 0, 0)
    assert s.accuracy == s.precision == s.recall == 0.0


def test_zero_rso_recording_has_no_fn_inflation():
    rec = TS.make_recording(seed=4, duration_s=0.3, n_rsos=0)
    assert rec.rso_tracks.shape == (0, 4)
    cand = TP.collect_candidates(rec, TP.PipelineConfig(), device="cpu")
    assert len(cand.counts) > 0 and not cand.is_rso.any()
    assert cand.object_best.shape == (0,)
    assert all(TP.score_threshold(cand, thr).fn == 0 for thr in (2, 5, 10))
    assert TP.score_threshold(cand, 5).tp == 0


def test_max_samples_truncation_cap(recording):
    full = TP.collect_candidates(recording, TP.PipelineConfig(), device="cpu")
    cap = len(full.counts) // 2
    cut = TP.collect_candidates(recording, TP.PipelineConfig(), max_samples=cap, device="cpu")
    assert len(cut.counts) == cap
    np.testing.assert_array_equal(cut.counts, full.counts[:cap])
    np.testing.assert_array_equal(cut.is_rso, full.is_rso[:cap])


def test_merge_candidates_empty_single_and_in_order(recording):
    merged = TP.merge_candidates([])
    assert merged.counts.shape == (0,) and merged.counts.dtype == np.int32
    assert merged.is_rso.shape == (0,) and merged.is_rso.dtype == np.bool_
    assert merged.object_best.shape == (0,)
    assert TP.score_threshold(merged, 5).accuracy == 0.0
    cand = Candidates(np.array([3, 7, 12], np.int32), np.array([False, True, True]),
                      np.array([7, 12], np.int32))
    _assert_candidates_equal(TP.merge_candidates([cand]), cand)
    s = TP.score_threshold(cand, 5)
    assert (s.tp, s.fp, s.fn, s.tn) == (2, 0, 0, 1)
    a = Candidates(np.array([1], np.int32), np.array([True]), np.array([1], np.int32))
    b = Candidates(np.array([9, 2], np.int32), np.array([False, True]), np.array([], np.int32))
    m = TP.merge_candidates([a, b])
    np.testing.assert_array_equal(m.counts, [1, 9, 2])
    np.testing.assert_array_equal(m.is_rso, [True, False, True])
    np.testing.assert_array_equal(m.object_best, [1])
    real = TP.collect_candidates(recording, TP.PipelineConfig(), device="cpu")
    s1, s2 = TP.score_threshold(real, 5), TP.score_threshold(TP.merge_candidates([real, real]), 5)
    assert (s2.tp, s2.fp, s2.fn, s2.tn) == (2 * s1.tp, 2 * s1.fp, 2 * s1.fn, 2 * s1.tn)


@pytest.mark.parametrize("score,acc,prec,rec", [
    ((0, 0, 0, 0), 0.0, 0.0, 0.0), ((0, 0, 7, 3), 0.3, 0.0, 0.0), ((0, 4, 0, 6), 0.6, 0.0, 0.0),
    ((5, 0, 0, 5), 1.0, 1.0, 1.0), ((1, 1, 1, 1), 0.5, 0.5, 0.5)])
def test_detection_score_edges(score, acc, prec, rec):
    s = DetectionScore(*score)
    assert (s.accuracy, s.precision, s.recall) == pytest.approx((acc, prec, rec))


def test_score_threshold_known_values():
    cand = Candidates(np.array([1, 4, 5, 9], np.int32), np.array([False, True, True, False]),
                      np.array([4, 9], np.int32))
    s = TP.score_threshold(cand, 5)
    assert (s.tp, s.fp, s.fn, s.tn) == (1, 1, 1, 1) and s.accuracy == pytest.approx(0.5)


# ---------------------------------------------------------------------------
# Tracking through the loop driver (tests/test_detection_accuracy.py).
# ---------------------------------------------------------------------------

def test_tracking_confirms_rsos_not_noise():
    rec = TS.make_recording(seed=9, duration_s=1.0, n_rsos=2)
    cfg = TP.PipelineConfig(**KERNEL_CFG)
    results = TP.run_recording(rec, cfg, device="cpu")
    n_conf = int(confirmed(results[-1].tracks, cfg.tracker).sum())
    assert 1 <= n_conf <= 4
    from repro.core.tracking import confirmed as j_confirmed

    jres = JP.run_recording(make_recording(seed=9, duration_s=1.0, n_rsos=2), JP.PipelineConfig())
    assert n_conf == int(np.asarray(j_confirmed(jres[-1].tracks, JP.PipelineConfig().tracker)).sum())


def test_single_recording_detection():
    rec = TS.make_recording(seed=5, duration_s=0.6, n_rsos=2)
    score = TP.evaluate_detection(rec, TP.PipelineConfig(**KERNEL_CFG), device="cpu")
    assert score.accuracy > 0.9 and score.tp > 10
