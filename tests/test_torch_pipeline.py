"""The port's main path end to end against the JAX reference, on the CPU:
``run_recording_scan`` + ``evaluate_detection`` under the kernel config
(``use_kernels=True``, ``metrics_impl="kernel"``; the JAX side runs its
Pallas kernels in interpret mode). Windows, clusters (centroids
included), track hits/misses/age/active and the DetectionScore compare
exactly; metrics to rtol = atol = 1e-5; tracker floats to rtol = 1e-6,
atol = 1e-4."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import pipeline as JP
from repro.core.tracking import confirmed as j_confirmed
from repro.data.synthetic import make_recording
from repro_torch.core import pipeline as TP
from repro_torch.core.events import EventBatch
from repro_torch.core.tracking import confirmed as t_confirmed
from repro_torch.data import synthetic as TS

torch.set_num_threads(1)

KERNEL_CFG = dict(use_kernels=True, metrics_impl="kernel")
EXACT_METRICS = ("event_count", "edge_density")


def _compare(rec, jcfg):
    tcfg = TP.config_from_dict(dataclasses.asdict(jcfg))
    jr = JP.run_recording_scan(rec, jcfg)
    tr = TP.run_recording_scan(rec, tcfg, device="cpu")
    assert tr.num_windows == jr.num_windows
    np.testing.assert_array_equal(tr.t_start_us, jr.t_start_us)
    for f in tr.clusters._fields:
        np.testing.assert_array_equal(
            getattr(tr.clusters, f).numpy(), np.asarray(getattr(jr.clusters, f)), err_msg=f
        )
    for m, v in tr.metrics.items():
        if m in EXACT_METRICS:
            np.testing.assert_array_equal(v.numpy(), np.asarray(jr.metrics[m]), err_msg=m)
        else:
            np.testing.assert_allclose(v.numpy(), np.asarray(jr.metrics[m]), rtol=1e-5, atol=1e-5, err_msg=m)
    for f in ("hits", "misses", "age", "active"):
        np.testing.assert_array_equal(getattr(tr.tracks, f).numpy(), np.asarray(getattr(jr.tracks, f)), err_msg=f)
    for f in ("x", "y", "vx", "vy", "entropy"):
        np.testing.assert_allclose(
            getattr(tr.tracks, f).numpy(), np.asarray(getattr(jr.tracks, f)), rtol=1e-6, atol=1e-4, err_msg=f
        )
    js = JP.evaluate_detection(rec, jcfg)
    ts = TP.evaluate_detection(rec, tcfg, device="cpu")
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    return tr, ts, tcfg


def test_quickstart_matches_reference():
    rec = make_recording(seed=7, duration_s=2.0, n_rsos=2)
    tr, ts, tcfg = _compare(rec, JP.PipelineConfig(**KERNEL_CFG))
    summary = (tr.num_windows, int(tr.clusters.valid.sum()),
               int(t_confirmed(tr.final_tracks, tcfg.tracker).sum()))
    assert summary == (100, 203, 2)
    assert (ts.tp, ts.fp, ts.fn, ts.tn) == (199, 4, 5, 562)


@pytest.mark.parametrize(
    "seed,kw,cfg",
    [(3, dict(duration_s=0.5, n_rsos=1), KERNEL_CFG),
     (19, dict(duration_s=0.5, n_rsos=3, lens="wide", noise_rate_hz=8_000),
      dict(KERNEL_CFG, hot_pixel_max=4))],
)
def test_short_recordings_match_reference(seed, kw, cfg):
    rec = make_recording(seed=seed, **kw)
    tr, _, tcfg = _compare(rec, JP.PipelineConfig(**cfg))
    jr = JP.run_recording_scan(rec, JP.PipelineConfig(**cfg))
    assert int(t_confirmed(tr.final_tracks, tcfg.tracker).sum()) == int(
        np.asarray(j_confirmed(jr.final_tracks, JP.PipelineConfig().tracker)).sum()
    )


def test_event_route_equals_kernel_route():
    # Like the reference, the two metric routes agree; on one device the
    # port's routes agree to the bit.
    rec = TS.make_recording(seed=7, duration_s=0.6)
    a = TP.run_recording_scan(rec, TP.PipelineConfig(), device="cpu")
    b = TP.run_recording_scan(rec, TP.PipelineConfig(**KERNEL_CFG), device="cpu")
    for m in a.metrics:
        assert torch.equal(a.metrics[m], b.metrics[m]), m
    for f in a.clusters._fields:
        assert torch.equal(getattr(a.clusters, f), getattr(b.clusters, f)), f


def test_merge_neighbors_route_runs_and_matches_reference():
    rec = make_recording(seed=2, duration_s=0.3)
    jcfg = JP.PipelineConfig(merge_neighbors=True, **KERNEL_CFG)
    jr = JP.run_recording_scan(rec, jcfg)
    tr = TP.run_recording_scan(rec, TP.config_from_dict(dataclasses.asdict(jcfg)), device="cpu")
    for f in ("count", "cell_x", "cell_y", "valid"):
        np.testing.assert_array_equal(getattr(tr.clusters, f).numpy(), np.asarray(getattr(jr.clusters, f)))


def test_config_from_dict_roundtrip():
    jcfg = JP.PipelineConfig(hot_pixel_max=9, **KERNEL_CFG)
    tcfg = TP.config_from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert TP.config_from_dict(dataclasses.asdict(tcfg)) == tcfg
    assert dataclasses.asdict(TP.PipelineConfig()) == dataclasses.asdict(JP.PipelineConfig())


@pytest.mark.parametrize(
    "kw,err",
    [(dict(numerics="fixed", metrics_impl="frame"), ValueError),
     (dict(numerics="fp8"), ValueError),
     (dict(numerics="fixed", use_kernels=True), ValueError),
     (dict(metrics_impl="nope"), ValueError)],
)
def test_routes_not_ported_raise(kw, err):
    rec = TS.make_recording(seed=1, duration_s=0.1)
    with pytest.raises(err):
        TP.run_recording_scan(rec, TP.PipelineConfig(**kw), device="cpu")


def test_empty_recording():
    rec = TS.make_recording(seed=1, duration_s=0.1)
    empty = dataclasses.replace(rec, **{f: getattr(rec, f)[:0] for f in ("x", "y", "t", "p", "kind", "obj")})
    r = TP.run_recording_scan(empty, TP.PipelineConfig(**KERNEL_CFG), device="cpu")
    assert r.num_windows == 0 and r.clusters.count.shape == (0, 32)
    assert r.tracks.hits.shape == (0, 16) and not bool(r.final_tracks.active.any())
    s = TP.evaluate_detection(empty, TP.PipelineConfig(**KERNEL_CFG), device="cpu")
    assert (s.tp, s.fp, s.fn, s.tn) == (0, 0, 0, 0)


def test_precomputed_windows_reused():
    rec = TS.make_recording(seed=4, duration_s=0.3)
    cfg = TP.PipelineConfig(**KERNEL_CFG)
    from repro_torch.core.events import pad_windows

    win = pad_windows(rec.x, rec.y, rec.t, rec.p, cfg.batcher, device="cpu")
    a = TP.run_recording_scan(rec, cfg, windows=win, device="cpu")
    b = TP.run_recording_scan(rec, cfg, device="cpu")
    assert isinstance(a.windows.batch, EventBatch)
    for f in a.clusters._fields:
        assert torch.equal(getattr(a.clusters, f), getattr(b.clusters, f))
