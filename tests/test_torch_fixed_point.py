"""The port's fixed-point datapath (``numerics="fixed"``) against the JAX
reference, on the CPU.

Inputs are built with numpy from pinned seeds (no hypothesis draws) and
handed to both packages. Every integer compares exactly: the primitives,
the cluster fields, the surfaces, the patches, the normalizer,
``event_count`` and ``edge_density``. The other four metrics come from
log2/sqrt in each framework's own implementation and compare to rtol =
atol = 1e-5; tracker floats to rtol = 1e-6, atol = 1e-4 (the float
path's tolerances). The megakernel's plain version is held against the
JAX megakernel in interpret mode; the CUDA kernel itself is held against
the plain version in ``test_torch_cuda.py``.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import events as JE
from repro.core import fixed_point as JFX
from repro.core import pipeline as JP
from repro.core.pipeline.window_core import _condition as j_condition
from repro.data.synthetic import make_recording
from repro.kernels import ops as jops
from repro_torch.core import fixed_point as TFX
from repro_torch.core import pipeline as TP
from repro_torch.core.pipeline.window_core import _condition as t_condition
from repro_torch.core.tracking import confirmed as t_confirmed
from repro_torch.data.adversarial import clustered_window, named_windows, stacked_batch
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

RTOL = ATOL = 1e-5
TRACK_RTOL, TRACK_ATOL = 1e-6, 1e-4
EXACT_METRICS = ("event_count", "edge_density")
J_FIXED = JP.PipelineConfig(numerics="fixed")
J_MEGA = JP.PipelineConfig(numerics="fixed", metrics_impl="megakernel")
ROUTES = ("staged", "megakernel")
SEEDS = (0, 1, 2, 3, 4, 2048)
NAMES = sorted(named_windows())


def _tcfg(jcfg):
    return TP.config_from_dict(dataclasses.asdict(jcfg))


def _window(name):
    return clustered_window(int(name[5:])) if name.startswith("seed=") else named_windows()[name]


def _jbatch(windows):
    x, y, t, v = (np.stack(a) for a in zip(*windows))
    return JE.EventBatch(*(jnp.asarray(a, jnp.int32) for a in (x, y, t, np.zeros_like(x))), jnp.asarray(v))


def _eq(got, want, what):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=what)


def _metrics_close(got, want):
    for m, v in got.items():
        if m in EXACT_METRICS:
            _eq(v.numpy(), want[m], m)
        else:
            np.testing.assert_allclose(v.numpy(), np.asarray(want[m]), rtol=RTOL, atol=ATOL, err_msg=m)


# ---------------------------------------------------------------------------
# Primitives.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_round_div_half_even_matches_reference(seed):
    rng = np.random.default_rng(seed)
    num = rng.integers(0, 2**26, 4096)
    den = rng.integers(1, 1025, 4096)
    num[:64] = den[:64] * rng.integers(0, 1000, 64) + den[:64] // 2  # near ties
    got = TFX.round_div_half_even(torch.as_tensor(num, dtype=torch.int32), torch.as_tensor(den, dtype=torch.int32))
    want = JFX.round_div_half_even(jnp.asarray(num, jnp.int32), jnp.asarray(den, jnp.int32))
    _eq(got.numpy(), want, "round_div_half_even")
    _eq(got.numpy(), np.round(num / den).astype(np.int64), "float64 round")


def test_round_div_half_even_ties_to_even():
    num = torch.tensor([1, 3, 5, 7, 501, 0, 2, 6], dtype=torch.int32)
    den = torch.tensor([2, 2, 2, 2, 2, 5, 4, 4], dtype=torch.int32)
    assert TFX.round_div_half_even(num, den).tolist() == [0, 2, 2, 4, 250, 0, 0, 2]


@pytest.mark.parametrize("seed", range(4))
def test_isqrt_matches_reference(seed):
    v = np.random.default_rng(seed).integers(0, 2**26, 4096)
    v[:8] = [0, 1, 2, 3, 4, 255, 256, 2**26 - 1]
    sq = np.arange(0, 8192, dtype=np.int64) ** 2
    v = np.concatenate([v, sq, sq[1:] - 1])
    got = TFX.isqrt(torch.as_tensor(v, dtype=torch.int32)).numpy()
    _eq(got, [math.isqrt(int(u)) for u in v], "math.isqrt")
    _eq(got, JFX.isqrt(jnp.asarray(v, jnp.int32)), "reference isqrt")


def test_dequantized_clusters_match_reference():
    rng = np.random.default_rng(5)
    cq = rng.integers(-256, 2**24, (3, 4, 32)).astype(np.int32)
    valid = rng.random((4, 32)) < 0.7
    ints = [rng.integers(0, 50, (4, 32)).astype(np.int32) for _ in range(5)]
    tfc = TFX.FixedClusters(*(torch.as_tensor(a) for a in (*cq, *ints)), torch.as_tensor(valid))
    jfc = JFX.FixedClusters(*(jnp.asarray(a) for a in (*cq, *ints)), jnp.asarray(valid))
    got, want = tfc.to_clusters(), jfc.to_clusters()
    for f in got._fields:
        _eq(getattr(got, f).numpy(), getattr(want, f), f)


# ---------------------------------------------------------------------------
# The staged stage against the reference's, window by window.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [f"seed={s}" for s in SEEDS] + NAMES)
def test_staged_stage_matches_reference(name):
    win = _window(name)
    tb, jb = stacked_batch([win]), _jbatch([win])
    one = jax.tree_util.tree_map(lambda a: a[0], jb)
    jfc, jm = jax.jit(lambda b: JFX.fixed_window_stage(J_FIXED, b))(one)
    tfc, tm = TFX.fixed_window_stage(_tcfg(J_FIXED), tb)
    for f in tfc._fields:
        _eq(getattr(tfc, f)[0].numpy(), getattr(jfc, f), f)
    _metrics_close({m: v[0] for m, v in tm.items()}, jm)

    # The integer surfaces behind the metrics, patches and normalizer included.
    jcond = j_condition(J_FIXED, one)
    js = jax.jit(lambda b, x0, y0: JFX.fixed_metric_surfaces(b, x0, y0, 640, 480))(jcond, jfc.x0, jfc.y0)
    ts = TFX.fixed_metric_surfaces(t_condition(_tcfg(J_FIXED), tb), tfc.x0, tfc.y0, 640, 480)
    assert set(ts) == set(js)
    for k, v in ts.items():
        assert v.dtype == torch.int32, k
        _eq(v[0].numpy(), js[k], k)
    jcm = jax.jit(lambda b, fc: JFX.fixed_cluster_metrics(b, fc, 640, 480))(jcond, jfc)
    tcm = TFX.fixed_cluster_metrics(t_condition(_tcfg(J_FIXED), tb), tfc, 640, 480)
    _metrics_close({m: v[0] for m, v in tcm.items()}, jcm)


@pytest.mark.parametrize("cell_size", [16, 12])
def test_cell_stats_and_clusters_match_reference(cell_size):
    wins = [clustered_window(s, n=120) for s in SEEDS] + list(named_windows().values())
    jcfg = dataclasses.replace(J_FIXED, grid=dataclasses.replace(J_FIXED.grid, cell_size=cell_size, min_events=3))
    tcfg = _tcfg(jcfg)
    tb = t_condition(tcfg, stacked_batch(wins))
    tst = TFX.cell_stats_fixed(tb, tcfg.grid)
    tfc = TFX.clusters_fixed_from_stats(*tst, tcfg.grid)
    jb = _jbatch(wins)
    for r in range(len(wins)):
        one = j_condition(jcfg, jax.tree_util.tree_map(lambda a: a[r], jb))
        jst = JFX.cell_stats_fixed(one, jcfg.grid)
        for a, b, f in zip(tst, jst, ("count", "sum_x", "sum_y", "sum_t")):
            assert a.dtype == torch.int32
            _eq(a[r].numpy(), b, f"{f} window {r}")
        jfc = JFX.clusters_fixed_from_stats(*jst, jcfg.grid)
        for f in tfc._fields:
            _eq(getattr(tfc, f)[r].numpy(), getattr(jfc, f), f"{f} window {r}")


def test_sobel_int_matches_reference():
    patch = np.random.default_rng(9).integers(0, 9, (3, 48, 48)).astype(np.int32)
    tx, ty = TFX.sobel_int(torch.as_tensor(patch))
    for r in range(3):
        jx, jy = JFX.sobel_int(jnp.asarray(patch[r]))
        _eq(tx[r].numpy(), jx, "gx")
        _eq(ty[r].numpy(), jy, "gy")


def test_epilogue_matches_reference_jitted():
    # Held against the jitted reference, as the main path runs it; see the
    # epilogue's docstring for why every division by n is a product.
    rng = np.random.default_rng(13)
    n = 4096
    hist = rng.integers(0, 60, (n, 32)).astype(np.int32)
    hist[:, 0] += 1500
    s1 = rng.integers(1, 300, n).astype(np.int32)
    args = (hist, s1, (s1 * rng.integers(1, 20, n)).astype(np.int32),
            rng.integers(0, 3000, n).astype(np.int32), rng.integers(0, 200_000, n).astype(np.int32),
            rng.integers(0, 2304, n).astype(np.int32), rng.integers(0, 300, n).astype(np.int32),
            rng.random(n) < 0.8, rng.integers(1, 12, n).astype(np.int32))
    want = jax.jit(jax.vmap(lambda *a: JFX.fixed_metric_epilogue(*a, n=2304)))(*(jnp.asarray(a) for a in args))
    got = TFX.fixed_metric_epilogue(*(torch.as_tensor(a) for a in args), n=2304)
    _metrics_close(got, want)
    # True division would not be exact: it differs by one ulp somewhere.
    divided = torch.where(torch.as_tensor(args[7]), torch.as_tensor(args[5]).float() / torch.tensor(2304.0), 0.0)
    assert not np.array_equal(divided.numpy(), np.asarray(want["edge_density"]))


def test_sobel_ties_explain_the_reference_flaky_test():
    # Seed 2048, slot 0: max g2 is 32 and 63 pixels tie with 16 * g2 ==
    # max g2. The fixed path's strict compare leaves them out (74 edges);
    # the float path's ``+ 1e-12`` counts them (137), beyond the reference
    # test's 8-pixel tolerance. The port follows the fixed path.
    b = stacked_batch([clustered_window(2048)])
    cfg = _tcfg(J_FIXED)
    fc, mets = TFX.fixed_window_stage(cfg, b)
    s = TFX.fixed_metric_surfaces(t_condition(cfg, b), fc.x0, fc.y0, 640, 480)
    gx, gy = TFX.sobel_int(s["patches"][0, 0])
    g2 = gx * gx + gy * gy
    mx = int(g2.max())
    assert (mx, int((16 * g2 == mx).sum()), int((16 * g2 > mx).sum())) == (32, 63, 74)
    assert int(s["edges"][0, 0]) == 74
    assert float(mets["edge_density"][0, 0]) == float(np.float32(74) * (np.float32(1) / np.float32(2304)))
    jm = jax.jit(lambda b: JFX.fixed_window_stage(J_FIXED, b))(
        jax.tree_util.tree_map(lambda a: a[0], _jbatch([clustered_window(2048)])))[1]
    assert float(np.asarray(jm["edge_density"])[0]) == float(mets["edge_density"][0, 0])


# ---------------------------------------------------------------------------
# The megakernel's plain version against the JAX megakernel (interpret).
# ---------------------------------------------------------------------------

def test_plain_megakernel_matches_reference_megakernel():
    wins = [clustered_window(s) for s in (0, 1, 2048)] + [named_windows()[k] for k in NAMES]
    jfc, jm = jax.jit(lambda s: jops.window_pipeline_call(s, J_MEGA))(_jbatch(wins))
    tfc, tm, surf = ops.window_pipeline(stacked_batch(wins), _tcfg(J_MEGA))
    for f in tfc._fields:
        _eq(getattr(tfc, f).numpy(), getattr(jfc, f), f)
    _metrics_close(tm, jm)
    assert set(surf) == {"hist", "norm_i", *TFX.SURF_FIELDS}


def test_megakernel_wrapper_on_cpu_is_the_staged_path():
    wins = [clustered_window(s, n=300, capacity=384) for s in SEEDS]
    b = stacked_batch(wins)
    cfg = _tcfg(J_MEGA)
    before = ops.LAUNCHES["window_pipeline"]
    fc, mets, surf = ops.window_pipeline(b, cfg)
    assert ops.LAUNCHES["window_pipeline"] == before  # the plain version launches nothing
    rfc, rmets, rsurf = ref.window_pipeline_ref(b, cfg)
    sfc, smets = TFX.fixed_window_stage(cfg, b)
    for f in fc._fields:
        assert torch.equal(getattr(fc, f), getattr(rfc, f)) and torch.equal(getattr(fc, f), getattr(sfc, f)), f
    for m in mets:
        assert torch.equal(mets[m], rmets[m]) and torch.equal(mets[m], smets[m]), m
    for k in surf:
        assert torch.equal(surf[k], rsurf[k]), k


@pytest.mark.parametrize("e,k", [(1025, 32), (256, 129)])
def test_megakernel_wrapper_rejects_what_the_reference_rejects(e, k):
    cfg = _tcfg(J_MEGA)
    cfg = dataclasses.replace(cfg, grid=dataclasses.replace(cfg.grid, max_clusters=k))
    b = stacked_batch([clustered_window(0, n=10, capacity=e)])
    with pytest.raises(ValueError):
        ops.window_pipeline(b, cfg)


# ---------------------------------------------------------------------------
# Config routing and the whole-recording driver.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "kw", [dict(merge_neighbors=True), dict(use_kernels=True),
           dict(metrics_impl="frame"), dict(metrics_impl="kernel")],
    ids=lambda kw: next(iter(kw)) + "=" + str(next(iter(kw.values()))),
)
def test_fixed_config_rejects_what_the_reference_rejects(kw):
    jcfg = dataclasses.replace(J_FIXED, **kw)
    with pytest.raises(ValueError):
        JFX.make_fixed_process_window(jcfg)
    rec = make_recording(seed=1, duration_s=0.05)
    with pytest.raises(ValueError):
        TP.run_recording_scan(rec, _tcfg(jcfg), device="cpu")


@pytest.mark.parametrize("route", ROUTES)
def test_scan_matches_reference(route):
    rec = make_recording(seed=3, duration_s=0.3)
    jr = JP.run_recording_scan(rec, J_FIXED)
    tr = TP.run_recording_scan(rec, _tcfg(dataclasses.replace(J_FIXED, metrics_impl=route)), device="cpu")
    assert tr.num_windows == jr.num_windows > 0
    for f in tr.clusters._fields:
        _eq(getattr(tr.clusters, f).numpy(), getattr(jr.clusters, f), f)
    _metrics_close(tr.metrics, jr.metrics)
    for f in ("hits", "misses", "age", "active"):
        _eq(getattr(tr.tracks, f).numpy(), getattr(jr.tracks, f), f)
    for f in ("x", "y", "vx", "vy", "entropy"):
        np.testing.assert_allclose(getattr(tr.tracks, f).numpy(), np.asarray(getattr(jr.tracks, f)),
                                   rtol=TRACK_RTOL, atol=TRACK_ATOL, err_msg=f)


def test_routes_agree_to_the_bit():
    rec = make_recording(seed=5, duration_s=0.4)
    a, b = (TP.run_recording_scan(rec, TP.PipelineConfig(numerics="fixed", metrics_impl=r), device="cpu")
            for r in ROUTES)
    for f in a.clusters._fields:
        assert torch.equal(getattr(a.clusters, f), getattr(b.clusters, f)), f
    for m in a.metrics:
        assert torch.equal(a.metrics[m], b.metrics[m]), m
    for f in a.tracks._fields:
        assert torch.equal(getattr(a.tracks, f), getattr(b.tracks, f)), f


@pytest.mark.parametrize("route", ROUTES)
def test_quickstart_scores(route):
    rec = make_recording(seed=7, duration_s=2.0, n_rsos=2)
    cfg = TP.PipelineConfig(numerics="fixed", metrics_impl=route)
    r = TP.run_recording_scan(rec, cfg, device="cpu")
    s = TP.evaluate_detection(rec, cfg, device="cpu")
    assert (r.num_windows, int(r.clusters.valid.sum()), int(t_confirmed(r.final_tracks, cfg.tracker).sum())) == (
        100, 203, 2)
    assert (s.tp, s.fp, s.fn, s.tn) == (199, 4, 5, 562)


@pytest.mark.parametrize("route", ROUTES)
def test_empty_recording(route):
    rec = make_recording(seed=1, duration_s=0.1)
    empty = dataclasses.replace(rec, **{f: getattr(rec, f)[:0] for f in ("x", "y", "t", "p", "kind", "obj")})
    cfg = TP.PipelineConfig(numerics="fixed", metrics_impl=route)
    r = TP.run_recording_scan(empty, cfg, device="cpu")
    assert r.num_windows == 0 and r.clusters.count.shape == (0, 32)
    assert not bool(r.final_tracks.active.any())
    s = TP.evaluate_detection(empty, cfg, device="cpu")
    assert (s.tp, s.fp, s.fn, s.tn) == (0, 0, 0, 0)
