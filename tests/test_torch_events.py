"""The port's windowing, conditioning and synthetic data against the JAX
reference: the same numpy inputs through both packages, compared exactly
(windows, masks, coincidence counts and leaders are all integers)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import events as JE
from repro.data import synthetic as JS
from repro_torch.core import events as TE
from repro_torch.data import synthetic as TS

torch.set_num_threads(1)


def _tt(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _jbatch(x, y, v):
    z = np.zeros_like(x)
    return JE.EventBatch(*(jnp.asarray(a, jnp.int32) for a in (x, y, z, z)), jnp.asarray(v))


def _tbatch(x, y, v):
    z = np.zeros_like(x)
    return TE.EventBatch(*(_tt(a, torch.int32) for a in (x, y, z, z)), _tt(v, torch.bool))


@pytest.mark.parametrize(
    "seed,kw",
    [(7, dict(duration_s=0.5, n_rsos=2)),
     (3, dict(duration_s=0.4, n_rsos=0, lens="wide")),
     (11, dict(duration_s=0.3, n_rsos=3, lens="telephoto", noise_rate_hz=20_000))],
)
def test_make_recording_identical(seed, kw):
    a, b = JS.make_recording(seed=seed, **kw), TS.make_recording(seed=seed, **kw)
    for f in ("x", "y", "t", "p", "kind", "obj", "rso_tracks"):
        ja, tb = getattr(a, f), getattr(b, f)
        assert ja.dtype == tb.dtype, f
        np.testing.assert_array_equal(ja, tb, err_msg=f)
    assert (a.duration_us, a.name) == (b.duration_us, b.name)


@pytest.mark.parametrize(
    "cfg",
    [dict(), dict(size_threshold=7, time_threshold_us=900, capacity=8),
     dict(size_threshold=40, capacity=32)],
)
def test_pad_windows_identical(cfg):
    rec = JS.make_recording(seed=5, duration_s=0.3)
    jw = JE.pad_windows(rec.x, rec.y, rec.t, rec.p, JE.BatcherConfig(**cfg))
    tw = TE.pad_windows(rec.x, rec.y, rec.t, rec.p, TE.BatcherConfig(**cfg), device="cpu")
    assert tw.num_windows == jw.num_windows and tw.capacity == jw.capacity
    for f in JE.EventBatch._fields:
        np.testing.assert_array_equal(
            getattr(tw.batch, f).numpy(), np.asarray(getattr(jw.batch, f)), err_msg=f
        )
    for f in ("t_start_us", "starts", "stops", "overflow"):
        np.testing.assert_array_equal(getattr(tw, f), getattr(jw, f), err_msg=f)


def test_dual_threshold_bounds_identical():
    rng = np.random.default_rng(0)
    t = np.cumsum(rng.integers(0, 400, 2000))
    for cfg in (dict(), dict(size_threshold=13, time_threshold_us=1_000), dict(time_threshold_us=0)):
        assert TE.dual_threshold_bounds(t, TE.BatcherConfig(**cfg)) == JE.dual_threshold_bounds(
            t, JE.BatcherConfig(**cfg)
        )
        assert TE.dual_threshold_closed_bounds(
            t[:777], TE.BatcherConfig(**cfg)
        ) == JE.dual_threshold_closed_bounds(t[:777], JE.BatcherConfig(**cfg))


def test_pack_words_roundtrip_identical():
    rng = np.random.default_rng(1)
    x = rng.integers(-70_000, 70_000, 500)
    y = rng.integers(-70_000, 70_000, 500)
    jw = np.asarray(JE.pack_words(jnp.asarray(x, jnp.int32), jnp.asarray(y, jnp.int32)))
    tw = TE.pack_words(_tt(x, torch.int32), _tt(y, torch.int32)).numpy()
    np.testing.assert_array_equal(tw, jw.astype(np.int64))
    jx, jy = JE.unpack_words(jnp.asarray(jw))
    tx, ty = TE.unpack_words(_tt(tw))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


def _hot_windows(w, e, seed):
    """Windows with hot pixels (one pixel repeated up to 20 times), random
    validity and some out-of-ROI / out-of-sensor coordinates."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-5, 650, (w, e))
    y = rng.integers(-5, 490, (w, e))
    for r in range(w):
        hot = rng.integers(0, e, rng.integers(1, 21))
        x[r, hot], y[r, hot] = 300 + r, 200
        few = rng.integers(0, e, 5)
        x[r, few], y[r, few] = 10, 10 + r
    v = rng.random((w, e)) < 0.85
    return x, y, v


def test_roi_filter_identical():
    x, y, v = _hot_windows(4, 64, 2)
    for roi in (JE.DEFAULT_ROI, (0, 0, 640, 480), (100, 50, 101, 51)):
        j = JE.roi_filter(_jbatch(x, y, v), roi)
        t = TE.roi_filter(_tbatch(x, y, v), roi)
        np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))


@pytest.mark.parametrize("e,max_repeats", [(64, 8), (256, 12), (1100, 8)])
def test_persistent_event_filter_identical(e, max_repeats):
    # E = 1100 takes the sort route in both packages (E > 1024).
    x, y, v = _hot_windows(2, e, 3)
    j = jax.jit(JE.persistent_event_filter, static_argnums=1)(_jbatch(x, y, v), max_repeats)
    t = TE.persistent_event_filter(_tbatch(x, y, v), max_repeats)
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))


@pytest.mark.parametrize("e", [48, 256, 1100])
def test_coincidence_counts_identical(e):
    # E <= 1024: the pairwise route (the reference's CPU branch); E = 1100:
    # the sort route. Counts of unweighted events are route-specific and
    # compared too, with coordinates past 16 bits to pin the key masking.
    x, y, v = _hot_windows(3, e, 4)
    x[:, :3] = [70_000, 70_000 - 65_536, -1]
    y[:, :3] = [5, 5, 0]
    tc, tl = TE.coincidence_counts(_tt(x, torch.int32), _tt(y, torch.int32), _tt(v, torch.bool))
    for r in range(x.shape[0]):
        jc, jl = JE.coincidence_counts(
            jnp.asarray(x[r], jnp.int32), jnp.asarray(y[r], jnp.int32), jnp.asarray(v[r])
        )
        np.testing.assert_array_equal(tc[r].numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tl[r].numpy(), np.asarray(jl))
    # Leaders: exactly one per occupied pixel, the lowest-index weighted event.
    key = TE.pack_words(_tt(x[0]), _tt(y[0])).numpy()
    lead = tl[0].numpy()
    for k in np.unique(key[v[0]]):
        idx = np.flatnonzero((key == k) & v[0])
        assert lead[idx].tolist() == [True] + [False] * (len(idx) - 1)
