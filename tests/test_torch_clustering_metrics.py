"""The port's clustering and metric stages against the JAX reference.
Integer fields (cells, counts, validity, origins) and the centroids
(exact integer sums, IEEE division) compare exactly; merged centroids
(float32 weighted sums) to 1e-6 relative; the entropies and contrast to
rtol = atol = 1e-5 (order-dependent float32 reductions and log2)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import events as JE
from repro.core import grid_clustering as JG
from repro.core import metrics as JM
from repro_torch.core import events as TE
from repro_torch.core import grid_clustering as TG
from repro_torch.core import metrics as TM

torch.set_num_threads(1)

RTOL = ATOL = 1e-5
EXACT_METRICS = ("event_count", "edge_density")


def _events(w, e, seed, clumps=True):
    rng = np.random.default_rng(seed)
    x = rng.integers(-20, 660, (w, e))
    y = rng.integers(-20, 500, (w, e))
    if clumps:
        for r in range(w):
            for c in range(4):
                n = rng.integers(5, 40)
                cx, cy = rng.integers(0, 640), rng.integers(0, 480)
                x[r, c * 40:c * 40 + n] = np.clip(cx + rng.integers(-6, 7, n), 0, 639)
                y[r, c * 40:c * 40 + n] = np.clip(cy + rng.integers(-6, 7, n), 0, 479)
    t = rng.integers(0, 20_000, (w, e))
    v = rng.random((w, e)) < 0.9
    return x, y, t, v


def _both(x, y, t, v):
    z = np.zeros_like(x)
    jb = JE.EventBatch(*(jnp.asarray(a, jnp.int32) for a in (x, y, t, z)), jnp.asarray(v))
    tb = TE.EventBatch(*(torch.as_tensor(a, dtype=torch.int32) for a in (x, y, t, z)), torch.as_tensor(v))
    return jb, tb


def _assert_clusters(tc, jc, exact_centroids=True):
    for f in TG.Clusters._fields:
        a, b = getattr(tc, f).numpy(), np.asarray(getattr(jc, f))
        assert a.dtype == b.dtype, f
        if f.startswith("centroid") and not exact_centroids:
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


def test_top_k_ties_keep_lowest_index_first():
    vals, idx = TG._top_k_cells(torch.tensor([3, 3, 1, 3]), 2)
    assert idx.tolist() == [0, 1] and vals.tolist() == [3, 3]
    rng = np.random.default_rng(0)
    count = rng.integers(0, 4, (6, 1200)).astype(np.int32)  # ties everywhere
    tv, ti = TG._top_k_cells(torch.as_tensor(count), 32)
    jv, ji = jax.lax.top_k(jnp.asarray(count), 32)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for r in range(count.shape[0]):
        jv, ji = JG._top_k_cells(jnp.asarray(count[r]), 32)  # the CPU argmax passes
        np.testing.assert_array_equal(ti[r].numpy(), np.asarray(ji))


@pytest.mark.parametrize("cell_size", [16, 12, 32, 7])
def test_quantize_identical(cell_size):
    rng = np.random.default_rng(cell_size)
    x, y = rng.integers(-100, 700, 400), rng.integers(-100, 500, 400)
    jx, jy = JG.quantize(jnp.asarray(x, jnp.int32), jnp.asarray(y, jnp.int32), cell_size)
    tx, ty = TG.quantize(torch.as_tensor(x, dtype=torch.int32), torch.as_tensor(y, dtype=torch.int32), cell_size)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


@pytest.mark.parametrize("cfg", [dict(), dict(cell_size=12, min_events=3), dict(max_clusters=8, min_events=1)])
def test_cell_histogram_and_clusters_identical(cfg):
    x, y, t, v = _events(3, 256, 1)
    jb, tb = _both(x, y, t, v)
    g_j, g_t = JG.GridConfig(**cfg), TG.GridConfig(**cfg)
    th = TG.cell_histogram(tb, g_t)
    tc = TG.clusters_from_histogram(*th, g_t)
    ref = jax.jit(lambda b: (JG.cell_histogram(b, g_j), JG.form_clusters(b, g_j)))
    for r in range(x.shape[0]):
        jh, jc = ref(JE.EventBatch(*(a[r] for a in jb)))
        for a, b in zip(th, jh):
            np.testing.assert_array_equal(a[r].numpy(), np.asarray(b))
        _assert_clusters(TG.Clusters(*(a[r] for a in tc)), jc)


def test_merge_adjacent_matches():
    x, y, t, v = _events(3, 256, 2)
    jb, tb = _both(x, y, t, v)
    g_j, g_t = JG.GridConfig(min_events=2), TG.GridConfig(min_events=2)
    tm = TG.merge_adjacent(TG.form_clusters(tb, g_t), g_t)
    ref = jax.jit(lambda b: JG.merge_adjacent(JG.form_clusters(b, g_j), g_j))
    for r in range(x.shape[0]):
        jm = ref(JE.EventBatch(*(a[r] for a in jb)))
        _assert_clusters(TG.Clusters(*(a[r] for a in tm)), jm, exact_centroids=False)


def test_window_origin_rounds_half_to_even():
    cx = np.array([24.5, 25.5, 26.5, 0.5, -1.0, 615.5, 616.5, 639.0, 100.49999], np.float32)
    cy = np.array([24.5, 25.5, 455.5, 456.5, 479.0, 0.0, 1.5, 2.5, 3.5], np.float32)
    jx, jy = JM.window_origin(jnp.asarray(cx), jnp.asarray(cy), 640, 480)
    tx, ty = TM.window_origin(torch.as_tensor(cx), torch.as_tensor(cy), 640, 480)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    assert tx[:3].tolist() == [0, 2, 2]  # 24.5 -> 24, 25.5 -> 26, 26.5 -> 26


def test_exact_cluster_metrics_matches():
    rng = np.random.default_rng(3)
    patches = np.zeros((6, 48, 48), np.float32)
    for i in range(6):
        idx = rng.integers(0, 48, (rng.integers(1, 200), 2))
        np.add.at(patches[i], (idx[:, 0], idx[:, 1]), 1.0)
    patches[5] = 0.0  # an empty patch
    hist = rng.integers(0, 50, (6, 32)).astype(np.float32)
    norm = np.array([1, 2, 5, 9, 30, 1], np.float32)
    count = rng.integers(0, 100, 6).astype(np.int32)
    valid = np.array([1, 1, 1, 0, 1, 1], bool)
    got = TM._exact_cluster_metrics(*(torch.as_tensor(a) for a in (patches, hist, norm, count, valid)))
    exp = jax.jit(jax.vmap(JM._exact_cluster_metrics))(
        *(jnp.asarray(a) for a in (patches, hist, norm, count, valid))
    )
    for m in TM.METRIC_NAMES:
        if m in EXACT_METRICS:
            np.testing.assert_array_equal(got[m].numpy(), np.asarray(exp[m]), err_msg=m)
        else:
            np.testing.assert_allclose(got[m].numpy(), np.asarray(exp[m]), rtol=RTOL, atol=ATOL, err_msg=m)


def test_cluster_metrics_events_matches():
    x, y, t, v = _events(4, 256, 5)
    x[3], y[3] = 320, 240  # one saturated pixel
    jb, tb = _both(x, y, t, v)
    g_j, g_t = JG.GridConfig(min_events=2), TG.GridConfig(min_events=2)
    tcl = TG.form_clusters(tb, g_t)
    got = TM.cluster_metrics_events(tb, tcl)
    patches = TM.cluster_count_patches(tb, tcl)
    ref = jax.jit(lambda b: (
        JM.cluster_metrics_events(b, JG.form_clusters(b, g_j)),
        JM.cluster_count_patches(b, JG.form_clusters(b, g_j)),
    ))
    for r in range(x.shape[0]):
        exp, jpatches = ref(JE.EventBatch(*(a[r] for a in jb)))
        np.testing.assert_array_equal(patches[r].numpy(), np.asarray(jpatches))
        for m in TM.METRIC_NAMES:
            a, b = got[m][r].numpy(), np.asarray(exp[m])
            if m in EXACT_METRICS:
                np.testing.assert_array_equal(a, b, err_msg=m)
            else:
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=m)
