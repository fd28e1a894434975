"""The paper's Table I algorithms in the port against the JAX package's:
grid clustering (``grid_cluster``, ``quantize_packed``), k-means and
DBSCAN (``core/baselines.py``), on the CPU.

Corpora: the separated blobs of ``tests/test_core_clustering.py:180-221``
and the uniform batches of ``benchmarks/table1_algorithms.py`` (n = 64 to
1024, padded past n so the masks matter). DBSCAN on integer pixel
coordinates is exact (squared distances below 640^2 + 480^2 < 2^24):
``labels``, ``n_clusters`` and ``core_mask`` equal the reference's, and
``dbscan_centroids`` counts too. k-means: on the blobs ``assignment`` and
``counts`` are equal and ``centroids`` within rtol 1e-6; on the uniform
batches, where a near-tie of float distances may be broken another way
by the other package's arithmetic, the centroids are held within rtol
1e-5 and at least 99% of the assignments equal. Grid clustering sums
integers below 2^24 and is equal field for field; ``quantize_packed``
equals the reference's and the ``grid_quantize_packed`` kernel's plain
version to the bit.
"""
import numpy as np
import pytest
import torch

from repro.core import baselines as JB
from repro.core import events as JE
from repro.core import grid_clustering as JG
from repro_torch.core import baselines as TB
from repro_torch.core import events as TE
from repro_torch.core import grid_clustering as TG
from repro_torch.kernels import ops

torch.set_num_threads(1)


def _three_blobs(rng, n_per=20):
    blobs = [(100, 100), (300, 200), (500, 400)]
    pts = np.concatenate([rng.normal(0, 2, (n_per, 2)) + np.array(c) for c in blobs])
    return pts.astype(int), blobs


def _batches(xy, capacity):
    xy = np.asarray(xy)
    n = len(xy)
    args = (xy[:, 0], xy[:, 1], np.arange(n), np.zeros(n, np.int32), capacity)
    return JE.batch_from_arrays(*args), TE.batch_from_arrays(*args, device="cpu")


def _uniform(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, 640, n), rng.integers(0, 480, n)], -1)


def _blob_corpus():
    """The reference's corpus: its module rng (seed 7) draws the blobs."""
    rng = np.random.default_rng(7)
    pts, blobs = _three_blobs(rng)
    noise = np.array([[50, 400], [600, 50]])
    return pts, blobs, np.concatenate([pts, noise])


def _eq(a, b, what=""):
    np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy(), err_msg=what)


def assert_dbscan_equal(j, t):
    _eq(j.labels, t.labels, "labels")
    _eq(j.core_mask, t.core_mask, "core_mask")
    assert int(j.n_clusters) == int(t.n_clusters)
    assert t.labels.dtype == torch.int32 and t.n_clusters.dtype == torch.int32


@pytest.mark.parametrize("k,iters,capacity", [(3, 20, 256), (3, 16, 60), (8, 16, 128)])
def test_kmeans_equals_reference_on_blobs(k, iters, capacity):
    pts, blobs, _ = _blob_corpus()
    jb, tb = _batches(pts, capacity)
    j, t = JB.kmeans(jb, k=k, iters=iters), TB.kmeans(tb, k=k, iters=iters)
    _eq(j.assignment, t.assignment, "assignment")
    _eq(j.counts, t.counts, "counts")
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids), rtol=1e-6)
    assert (t.assignment[len(pts):] == -1).all() and int(t.counts.sum()) == len(pts)
    if k == 3:
        cents = t.centroids.numpy()
        for bx, by in blobs:
            assert np.hypot(cents[:, 0] - bx, cents[:, 1] - by).min() < 10


@pytest.mark.parametrize("n", [64, 256, 1024])
@pytest.mark.parametrize("seed", [0, 1])
def test_kmeans_within_tolerance_on_uniform_batches(n, seed):
    jb, tb = _batches(_uniform(n, seed), n + 37)
    j, t = JB.kmeans(jb, k=8, iters=16), TB.kmeans(tb, k=8, iters=16)
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids), rtol=1e-5)
    assert (t.assignment.numpy() == np.asarray(j.assignment)).mean() >= 0.99
    assert int(t.counts.sum()) == n


def test_dbscan_equals_reference_on_blobs_and_noise():
    pts, blobs, allpts = _blob_corpus()
    jb, tb = _batches(allpts, 128)
    j, t = JB.dbscan(jb, eps=8.0, min_pts=5), TB.dbscan(tb, eps=8.0, min_pts=5)
    assert_dbscan_equal(j, t)
    assert int(t.n_clusters) == 3 and (t.labels[len(pts):len(allpts)] == -1).all()
    jc, tc = JB.dbscan_centroids(jb, j), TB.dbscan_centroids(tb, t)
    _eq(jc[1], tc[1], "counts")
    np.testing.assert_allclose(tc[0].numpy(), np.asarray(jc[0]), rtol=1e-6)
    for bx, by in blobs:
        assert np.hypot(tc[0][:, 0].numpy() - bx, tc[0][:, 1].numpy() - by).min() < 6


@pytest.mark.parametrize("eps,min_pts", [(8.0, 5), (20.0, 3), (5.5, 2)])
@pytest.mark.parametrize("n", [64, 128, 256, 512])
def test_dbscan_equals_reference_on_table1_batches(n, eps, min_pts):
    jb, tb = _batches(_uniform(n, n), n + 19)
    j, t = JB.dbscan(jb, eps=eps, min_pts=min_pts), TB.dbscan(tb, eps=eps, min_pts=min_pts)
    assert_dbscan_equal(j, t)
    jc, tc = JB.dbscan_centroids(jb, j, 8), TB.dbscan_centroids(tb, t, 8)
    _eq(jc[1], tc[1], "counts")
    np.testing.assert_allclose(tc[0].numpy(), np.asarray(jc[0]), rtol=1e-6)


def test_dbscan_chain_needs_every_diffusion_step():
    """A path of core points 4 px apart: the smallest label must travel
    the whole chain, which the ``2 * n.bit_length()`` steps with pointer
    jumping carry; the one-cluster answer equals the reference's."""
    xy = np.stack([np.arange(0, 600, 4), np.full(150, 240)], -1)
    jb, tb = _batches(xy, 160)
    j, t = JB.dbscan(jb, eps=4.0, min_pts=3), TB.dbscan(tb, eps=4.0, min_pts=3)
    assert_dbscan_equal(j, t)
    assert int(t.n_clusters) == 1


@pytest.mark.parametrize("source", ["blobs", "uniform"])
@pytest.mark.parametrize("cell_size", [16, 12])
def test_grid_cluster_equals_reference(source, cell_size):
    xy = _blob_corpus()[2] if source == "blobs" else _uniform(1024, 3)
    jb, tb = _batches(xy, 1024 + 64)
    jcfg, tcfg = JG.GridConfig(cell_size=cell_size, min_events=3), TG.GridConfig(cell_size=cell_size,
                                                                                min_events=3)
    j, t = JG.grid_cluster(jb, jcfg), TG.grid_cluster(tb, tcfg)
    for f in t._fields:
        _eq(getattr(j, f), getattr(t, f), f)
    assert int(t.num_valid()) > 0


@pytest.mark.parametrize("cell_size", [16, 12, 1])
def test_quantize_packed_equals_reference_and_the_kernel_plain_version(cell_size):
    rng = np.random.default_rng(cell_size)
    x = np.concatenate([rng.integers(0, 1 << 16, 4000), [0, 65535, 639, 640]])
    y = np.concatenate([rng.integers(0, 1 << 16, 4000), [65535, 0, 479, 480]])
    words_j = JE.pack_words(x, y)
    words_t = TE.pack_words(torch.as_tensor(x), torch.as_tensor(y))
    _eq(np.asarray(words_j).astype(np.int64), words_t, "words")
    got = TG.quantize_packed(words_t, cell_size)
    _eq(np.asarray(JG.quantize_packed(words_j, cell_size)).astype(np.int64), got, "cells")
    plain = ops.grid_quantize_packed(words_t.to(torch.int32), cell_size)  # the CPU route
    assert torch.equal(plain.to(torch.int64) & 0xFFFFFFFF, got)
