"""The port's alpha-beta tracker against the JAX reference: assignments,
hits, misses, age and active flags exactly; positions, velocities and the
entropy EMA to rtol = 1e-6, atol = 1e-4 (float32 arithmetic that a
compiler may contract differently)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import grid_clustering as JG
from repro.core import tracking as JT
from repro_torch.core import grid_clustering as TG
from repro_torch.core import tracking as TT

torch.set_num_threads(1)

K = 32
INT_FIELDS = ("hits", "misses", "age", "active")
FLOAT_FIELDS = ("x", "y", "vx", "vy", "entropy")


def _clusters(points, k=K):
    """(K,) cluster slots as numpy: the given (x, y) points valid, rest empty."""
    cx = np.full(k, -1.0, np.float32)
    cy = np.full(k, -1.0, np.float32)
    valid = np.zeros(k, bool)
    for i, (px, py) in enumerate(points):
        cx[i], cy[i], valid[i] = px, py, True
    count = np.where(valid, 9, 0).astype(np.int32)
    cell = np.where(valid, 1, -1).astype(np.int32)
    return dict(centroid_x=cx, centroid_y=cy, centroid_t=np.where(valid, 5.0, -1.0).astype(np.float32),
                count=count, cell_x=cell, cell_y=cell, valid=valid)


def _jcl(d):
    return JG.Clusters(**{f: jnp.asarray(d[f]) for f in JG.Clusters._fields})


def _tcl(d):
    return TG.Clusters(**{f: torch.as_tensor(d[f]) for f in TG.Clusters._fields})


def _assert_state(ts, js, where=""):
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), err_msg=f + where)
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(
            getattr(ts, f).numpy(), np.asarray(getattr(js, f)), rtol=1e-6, atol=1e-4, err_msg=f + where
        )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_assign_ties_identical(seed):
    rng = np.random.default_rng(seed)
    cost = rng.integers(0, 6, (16, K)).astype(np.float32) * 5.0  # many exact ties
    cost[rng.random(cost.shape) < 0.3] = np.inf
    cost[3] = np.inf  # an inactive track
    for gate in (0.0, 10.0, 24.0):
        got = TT._greedy_assign(torch.as_tensor(cost), gate)
        exp = JT._greedy_assign(jnp.asarray(cost), gate)
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


def test_duplicate_track_from_reference_scatter():
    # Reference fault (repro/core/tracking.py:116-118): unmatched tracks clip
    # their -1 assignment to detection 0 and the last scatter write wins, so
    # detection 0, already matched by track 0, is also marked free and
    # spawns a duplicate track. The port reproduces the reference.
    seq = [_clusters([(100.0, 100.0), (300.0, 300.0)]), _clusters([(100.0, 100.0)])]
    cfg = JT.TrackerConfig()
    step = jax.jit(JT.tracker_step)
    js, ts = JT.init_tracks(cfg), TT.init_tracks(TT.TrackerConfig(), device="cpu")
    for d in seq:
        ent = np.linspace(1.0, 2.0, K).astype(np.float32)
        js, ja = step(js, _jcl(d), jnp.asarray(ent))
        ts, ta = TT.tracker_step(ts, _tcl(d), torch.as_tensor(ent), TT.TrackerConfig())
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        _assert_state(ts, js)
    assert ta.tolist()[:2] == [0, -1]
    assert ts.active.tolist()[:3] == [True, True, True]
    assert float(ts.x[2]) == 100.0 and int(ts.hits[2]) == 1  # the duplicate
    assert int(ts.hits[0]) == 2


def _moving_sequence(n_windows, seed):
    """Three objects moving a few px per window plus random clutter."""
    rng = np.random.default_rng(seed)
    start = rng.uniform(50, 400, (3, 2))
    vel = rng.uniform(-6, 6, (3, 2))
    seq = []
    for w in range(n_windows):
        pts = [tuple(start[i] + vel[i] * w + rng.normal(0, 1.0, 2)) for i in range(3) if rng.random() < 0.85]
        pts += [tuple(rng.uniform(0, 600, 2)) for _ in range(rng.integers(0, 5))]
        rng.shuffle(pts)
        seq.append(_clusters([(np.float32(a), np.float32(b)) for a, b in pts]))
    ents = rng.uniform(0, 3, (n_windows, K)).astype(np.float32)
    return seq, ents


def _stack(seq):
    return {f: np.stack([d[f] for d in seq]) for f in seq[0]}


@pytest.mark.parametrize("seed", [3, 4])
def test_track_recording_identical(seed):
    seq, ents = _moving_sequence(40, seed)
    st = _stack(seq)
    jfinal, jstates = JT.track_recording(_jcl(st), jnp.asarray(ents))
    tfinal, tstates = TT.track_recording(_tcl(st), torch.as_tensor(ents))
    _assert_state(tfinal, jfinal)
    _assert_state(tstates, jstates)
    assert int(TT.confirmed(tfinal).sum()) == int(JT.confirmed(jfinal).sum())


def test_mid_stream_start_from_reference_state():
    seq, ents = _moving_sequence(30, 5)
    st = _stack(seq)
    jfinal, _ = JT.track_recording(_jcl(st), jnp.asarray(ents))
    head = {f: a[:12] for f, a in st.items()}
    tail = {f: a[12:] for f, a in st.items()}
    jmid, _ = JT.track_recording(_jcl(head), jnp.asarray(ents[:12]))
    tmid = TT.tracks_from_numpy(
        {f: np.asarray(v) for f, v in jmid._asdict().items()}, device="cpu"
    )
    _assert_state(tmid, jmid)
    tfinal, _ = TT.track_recording(_tcl(tail), torch.as_tensor(ents[12:]), init=tmid)
    _assert_state(tfinal, jfinal)
    back = TT.tracks_to_numpy(tfinal)
    again = TT.tracks_from_numpy(back, device="cpu")
    for f in TT.TrackState._fields:
        assert torch.equal(getattr(again, f), getattr(tfinal, f)), f
        assert back[f].dtype == np.asarray(getattr(jfinal, f)).dtype, f


def test_tracker_step_eager_reference_agrees():
    # The reference's tracker outside jit (op by op): the last-write-wins
    # scatter order holds there too, so the port agrees with it.
    seq, ents = _moving_sequence(4, 6)
    st = _stack(seq)
    js = JT.init_tracks()
    for w in range(4):
        js, _ = JT.tracker_step(js, _jcl(seq[w]), jnp.asarray(ents[w]))
    tfinal, _ = TT.track_recording(_tcl(st), torch.as_tensor(ents))
    _assert_state(tfinal, js)
