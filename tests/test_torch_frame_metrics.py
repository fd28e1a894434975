"""The port's frame oracle against the JAX reference, on the CPU.

The corpora of ``tests/test_core_metrics.py`` and
``tests/test_event_metrics.py`` (clumped random windows at several seeds,
events hugging the sensor's corners so the patches clamp, a window with
no valid event, a window after the hot-pixel filter, off-sensor
coordinates), each as the same numpy arrays through both packages with
the reference's clusters. Exact against the reference:
``accumulate_image``, ``reconstruct_frame``, ``extract_window``,
``_histogram_counts`` and ``metric_matrix``. Within the port's stated
``rtol = atol = 1e-5`` (order-dependent float32 reductions and ``log2``):
the per-patch metric functions, the legacy ``cluster_metrics``,
``cluster_metrics_frame`` and ``correlation_matrix``. The reference is
called jitted, as its pipeline calls it: the port computes the
reciprocal product XLA makes of a division by the constant pixel count,
so the edge density is exact too.

The float statistics of a patch (``differential_entropy`` and
``local_contrast``: ``jnp.var`` / ``jnp.std`` of 2,304 float32 values)
are where the reference's own float32 summation can stray: on a patch of
the edge-clamped corpus its variance is 2e-5 off the float64 value of the
same formula, while the port's is within 1e-8. There the port is held to
the float64 value within the bound and must lie nearer to it than the
reference does; everywhere else to the reference within the bound.

Inside the port, ``cluster_metrics_frame`` equals
``cluster_metrics_events`` bit for bit, across metric blocks too.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import events as JE
from repro.core import metrics as JM
from repro.core.grid_clustering import GridConfig as JGridConfig
from repro.core.grid_clustering import grid_cluster as j_grid_cluster
from repro_torch.core import metrics as TM
from repro_torch.core.events import EventBatch
from repro_torch.core.grid_clustering import Clusters

torch.set_num_threads(1)

RTOL = ATOL = 1e-5
PATCH_FNS = ("shannon_entropy", "renyi_entropy", "gradient_magnitude",
             "differential_entropy", "local_contrast", "edge_density")


def _clumped(seed, n=200, capacity=256):
    """``tests/test_event_metrics.py``'s random window: four hot spots,
    repeated pixels, random validity holes."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(30, 600, (4, 2))
    pick = rng.integers(0, 4, n)
    x = np.clip(centers[pick, 0] + rng.integers(-20, 21, n), 0, 639)
    y = np.clip(centers[pick, 1] + rng.integers(-20, 21, n), 0, 479)
    valid = np.zeros(capacity, bool)
    valid[:n] = True
    valid &= rng.random(capacity) > 0.1
    return _pad(x, y, capacity), valid


def _pad(x, y, capacity):
    out = np.zeros((2, capacity), np.int32)
    out[0, :len(x)], out[1, :len(y)] = x, y
    return out


def _edge_clamped():
    pts = []
    for cx, cy in [(1, 1), (638, 1), (1, 478), (638, 477)]:
        pts += [(cx + dx, cy) for dx in (-1, 0, 1)] * 2
    pts = np.array(pts)
    valid = np.zeros(256, bool)
    valid[:len(pts)] = True
    return _pad(pts[:, 0], pts[:, 1], 256), valid


def _off_sensor(seed=4):
    """Clumps with a fifth of the events pushed off the sensor (negative,
    at the width and height, far past them)."""
    xy, valid = _clumped(seed)
    rng = np.random.default_rng(seed + 100)
    off = rng.random(256) < 0.2
    bad = rng.choice([-1, -30, 640, 700, 65_600], 256)
    xy[0] = np.where(off & (rng.random(256) < 0.5), bad, xy[0])
    xy[1] = np.where(off & (rng.random(256) >= 0.5), rng.choice([-1, 480, 999], 256), xy[1])
    return xy, valid


def _corpus():
    out = {f"random {s}": _clumped(s) for s in (0, 1, 2, 3)}
    out["edge clamped"] = _edge_clamped()
    xy, valid = _clumped(5)
    out["zero valid"] = (xy, np.zeros_like(valid))
    xy, valid = _clumped(6)
    jb = JE.EventBatch(jnp.asarray(xy[0]), jnp.asarray(xy[1]), jnp.zeros(256, jnp.int32),
                       jnp.zeros(256, jnp.int32), jnp.asarray(valid))
    out["after hot filter"] = (xy, np.asarray(JE.persistent_event_filter(jb, max_repeats=2).valid))
    out["off sensor"] = _off_sensor()
    return out


CORPUS = _corpus()


def _both(xy, valid):
    """The window as a reference ``(E,)`` batch and a port ``(1, E)`` one."""
    z = np.zeros_like(xy[0])
    jb = JE.EventBatch(*(jnp.asarray(a) for a in (xy[0], xy[1], z, z)), jnp.asarray(valid))
    tb = EventBatch(*(torch.from_numpy(a.copy())[None] for a in (xy[0], xy[1], z, z)),
                    torch.from_numpy(valid.copy())[None])
    return jb, tb


def _clusters(jb, min_events=2):
    """The reference's clusters, and the same as port tensors with a
    leading window axis."""
    jc = j_grid_cluster(jb, JGridConfig(min_events=min_events))
    tc = Clusters(*(torch.from_numpy(np.array(a))[None] for a in jc))
    return jc, tc


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL, err_msg=what)


def _f64_truth(fn: str, patches: np.ndarray, want: np.ndarray) -> np.ndarray:
    """The reference's formula for ``fn`` over ``(..., 48, 48)`` patches
    evaluated in float64 from its own float32 inputs (the patch, or its
    float32 gradient magnitude, which the port matches bit for bit);
    ``want`` for the functions with no float64 model here."""
    p = np.asarray(patches, np.float32)
    if fn == "local_contrast":
        return p.astype(np.float64).std(axis=(-2, -1))
    if fn == "differential_entropy":
        flat = p.reshape(-1, *p.shape[-2:])
        g = np.stack([np.asarray(JM.gradient_magnitude(jnp.asarray(q))) for q in flat])
        var = np.maximum(g.astype(np.float64).var(axis=(-2, -1)), 1e-12)
        return (0.5 * np.log2(2 * np.pi * np.e * var)).reshape(p.shape[:-2])
    return np.asarray(want, np.float64)


def _close_or_nearer(got, want, truth, what):
    """Each value within the bound of the reference's, or, where the
    reference strays, within the bound of ``truth`` and nearer to it than
    the reference's."""
    got, want, truth = (np.asarray(a, np.float64) for a in (got, want, truth))
    bound = lambda a, b: np.abs(a - b) <= ATOL + RTOL * np.abs(b)  # noqa: E731
    ok = bound(got, want) | (bound(got, truth) & (np.abs(got - truth) <= np.abs(want - truth)))
    assert ok.all(), (what, got[~ok], want[~ok], truth[~ok])


@pytest.mark.parametrize("name", list(CORPUS))
def test_accumulate_and_reconstruct_exact(name):
    jb, tb = _both(*CORPUS[name])
    np.testing.assert_array_equal(TM.accumulate_image(tb)[0].numpy(), np.asarray(JM.accumulate_image(jb)))
    np.testing.assert_array_equal(TM.reconstruct_frame(tb)[0].numpy(), np.asarray(JM.reconstruct_frame(jb)))


def test_accumulate_masks_off_sensor_events():
    """The reference's case: x = width must not wrap onto the next row."""
    xy = _pad(np.array([640, 10, -1]), np.array([10, 470, 5]), 4)
    _, tb = _both(xy, np.array([True, True, True, False]))
    img = TM.accumulate_image(tb)[0]
    assert float(img.sum()) == 1.0 and float(img[470, 10]) == 1.0 and float(img[11, 0]) == 0.0


@pytest.mark.parametrize("name", list(CORPUS))
def test_extract_window_exact(name):
    jb, tb = _both(*CORPUS[name])
    jc, tc = _clusters(jb)
    jf, tf = JM.reconstruct_frame(jb), TM.reconstruct_frame(tb)
    got = TM.extract_window(tf, tc.centroid_x, tc.centroid_y)  # (1, K, 48, 48)
    for k in range(jc.count.shape[0]):
        want = JM.extract_window(jf, jc.centroid_x[k], jc.centroid_y[k])
        np.testing.assert_array_equal(got[0, k].numpy(), np.asarray(want), err_msg=f"slot {k}")


def test_extract_window_clamps_and_takes_scalars():
    rng = np.random.default_rng(3)
    frame = rng.random((480, 640)).astype(np.float32)
    tf = torch.from_numpy(frame)
    for cx, cy in [(2, 470), (639.5, 0.5), (320.5, 240.5), (321.5, 23.49), (-40.0, 900.0)]:
        want = np.asarray(JM.extract_window(jnp.asarray(frame), jnp.asarray(cx), jnp.asarray(cy)))
        got = TM.extract_window(tf, cx, cy)
        assert got.shape == (48, 48)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str((cx, cy)))
    np.testing.assert_array_equal(TM.extract_window(tf, 2, 470).numpy(), frame[432:480, 0:48])


def _patches():
    """Patches for the per-patch functions: uniform noise, a vertical edge,
    a flat patch, the reference's even spread over the bins, and the
    clusters' patches of two real frames."""
    rng = np.random.default_rng(3)
    edge = np.zeros((48, 48), np.float32)
    edge[:, 24:] = 1.0
    spread = np.linspace(0, 0.999, 48 * 48).reshape(48, 48).astype(np.float32)
    out = [rng.random((48, 48)).astype(np.float32), edge, np.zeros((48, 48), np.float32), spread]
    for name in ("random 0", "edge clamped"):
        jb, _ = _both(*CORPUS[name])
        jc, _ = _clusters(jb)
        jf = JM.reconstruct_frame(jb)
        for k in np.flatnonzero(np.asarray(jc.valid))[:4]:
            out.append(np.asarray(JM.extract_window(jf, jc.centroid_x[k], jc.centroid_y[k])))
    return np.stack(out)


def test_histogram_counts_exact():
    patches = _patches()
    got = TM._histogram_counts(torch.from_numpy(patches))
    for i, p in enumerate(patches):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(JM._histogram_counts(jnp.asarray(p))))


@pytest.mark.parametrize("fn", PATCH_FNS)
def test_per_patch_functions_within_bound(fn):
    patches = _patches()
    got = getattr(TM, fn)(torch.from_numpy(patches)).numpy()
    want = np.stack([np.asarray(jax.jit(getattr(JM, fn))(jnp.asarray(p))) for p in patches])
    assert got.shape == want.shape
    _close_or_nearer(got, want, _f64_truth(fn, patches, want), fn)


@pytest.mark.parametrize("name", list(CORPUS))
def test_cluster_metrics_frame_against_reference(name):
    jb, tb = _both(*CORPUS[name])
    jc, tc = _clusters(jb)
    want = jax.jit(JM.cluster_metrics_frame)(jb, jc)
    got = TM.cluster_metrics_frame(tb, tc)
    assert set(got) == set(TM.METRIC_NAMES)
    for k in TM.METRIC_NAMES:
        if k in ("event_count", "edge_density"):  # exact integers / exact reciprocal product
            np.testing.assert_array_equal(got[k][0].numpy(), np.asarray(want[k]), err_msg=k)
        else:
            _close(got[k][0], want[k], k)


@pytest.mark.parametrize("name", list(CORPUS))
def test_legacy_cluster_metrics_against_reference(name):
    jb, tb = _both(*CORPUS[name])
    jc, tc = _clusters(jb)
    frame = JM.reconstruct_frame(jb)
    want = jax.jit(JM.cluster_metrics)(frame, jc)
    got = TM.cluster_metrics(TM.reconstruct_frame(tb), tc)
    patches = np.stack([np.asarray(JM.extract_window(frame, x, y))
                        for x, y in zip(jc.centroid_x, jc.centroid_y)])
    valid = np.asarray(jc.valid)
    for k in TM.METRIC_NAMES:
        truth = np.where(valid, _f64_truth(k, patches, want[k]), 0.0)
        _close_or_nearer(got[k][0], want[k], truth, k)
    valid = tc.valid[0]
    assert (got["event_count"][0][~valid] == 0).all()


@pytest.mark.parametrize("name", list(CORPUS))
def test_frame_route_equals_event_route_bit_for_bit(name):
    _, tb = _both(*CORPUS[name])
    jb, _ = _both(*CORPUS[name])
    _, tc = _clusters(jb)
    a = TM.cluster_metrics_frame(tb, tc)
    b = TM.cluster_metrics_events(tb, tc)
    for k in TM.METRIC_NAMES:
        assert torch.equal(a[k], b[k]), k
    if name == "zero valid":
        assert all(float(v.abs().max()) == 0.0 for v in a.values())


@pytest.mark.parametrize("block", [2, 3, 64])
def test_frame_route_equals_event_route_across_blocks(block, monkeypatch):
    """Seven windows of the corpus stacked: each block of ``block``
    windows gets its own image, and the result equals the event route's
    to the bit and the reference's per window within the bound."""
    monkeypatch.setattr(TM, "_METRIC_BLOCK", block)
    names = list(CORPUS)[:7]
    jbs = [_both(*CORPUS[n])[0] for n in names]
    tbs = [_both(*CORPUS[n])[1] for n in names]
    tb = EventBatch(*(torch.cat(f) for f in zip(*tbs)))
    jcs = [_clusters(b)[0] for b in jbs]
    tc = Clusters(*(torch.cat(f) for f in zip(*(_clusters(b)[1] for b in jbs))))
    a = TM.cluster_metrics_frame(tb, tc)
    b = TM.cluster_metrics_events(tb, tc)
    for k in TM.METRIC_NAMES:
        assert torch.equal(a[k], b[k]), k
    ref = jax.jit(JM.cluster_metrics_frame)
    for w, (jb, jc) in enumerate(zip(jbs, jcs)):
        want = ref(jb, jc)
        for k in TM.METRIC_NAMES:
            _close(a[k][w], want[k], f"window {w} {k}")


def test_metric_matrix_exact_and_correlation_within_bound():
    names = list(CORPUS)[:4]
    jm, tm = [], []
    for n in names:
        jb, tb = _both(*CORPUS[n])
        jc, tc = _clusters(jb)
        jmets = jax.jit(JM.cluster_metrics_frame)(jb, jc)
        jm.append(np.asarray(JM.metric_matrix(jmets)))
        tmat = TM.metric_matrix({k: torch.from_numpy(np.array(v)) for k, v in jmets.items()})
        np.testing.assert_array_equal(tmat.numpy(), jm[-1])
        tm.append(TM.metric_matrix(TM.cluster_metrics_frame(tb, tc))[0])
    samples = np.concatenate(jm)
    samples = samples[samples[:, -1] > 0]  # valid clusters
    got = TM.correlation_matrix(torch.from_numpy(samples)).numpy()
    want = np.asarray(JM.correlation_matrix(jnp.asarray(samples)))
    assert got.shape == (6, 6)
    _close(got, want, "correlation")
    # The port's own samples (their metrics within the bound) through the
    # port's correlation, against the reference's samples through its own.
    ours = torch.cat(tm)
    ours = ours[ours[:, -1] > 0]
    _close(TM.correlation_matrix(ours), want, "correlation of the port's samples")


def test_correlation_matrix_properties():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(200, 6)).astype(np.float32)
    x[:, 1] = x[:, 0] * 2 + 0.01 * rng.normal(size=200)
    c = TM.correlation_matrix(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.diag(c), 1.0, atol=1e-4)
    np.testing.assert_allclose(c, c.T, atol=1e-5)
    assert c[0, 1] > 0.95
    _close(c, JM.correlation_matrix(jnp.asarray(x)), "correlation")


@pytest.mark.parametrize("name", ["random 0", "random 1", "edge clamped", "off sensor"])
def test_window_entropy_plain_version_on_frame_oracle_patches(name):
    """``window_entropy``'s plain version (its CUDA kernel's CPU route) on
    the reconstructed frame at the clusters' rounded centres gives the
    frame oracle's Shannon and Renyi entropy and ``local_contrast`` of the
    same patches, within the bound (its slice truncates an integer centre,
    so the centre is rounded first, as ``extract_window`` rounds)."""
    from repro_torch.kernels import ops

    jb, tb = _both(*CORPUS[name])
    _, tc = _clusters(jb)
    frame = TM.reconstruct_frame(tb)[0]
    sel = tc.valid[0]
    assert bool(sel.any())
    cx, cy = tc.centroid_x[0][sel], tc.centroid_y[0][sel]
    got = ops.window_entropy(frame, torch.round(cx).to(torch.int32), torch.round(cy).to(torch.int32))
    mets = TM.cluster_metrics_frame(tb, tc)
    _close(got[0], mets["shannon_entropy"][0][sel], "shannon")
    _close(got[1], mets["renyi_entropy"][0][sel], "renyi")
    _close(got[2], TM.local_contrast(TM.extract_window(frame, cx, cy)), "contrast")
