"""The large path of the metrics kernel (``csrc/patch_metrics.cu``,
``patch_metrics_kernel_large``: any E, any K), modelled in numpy step by
step and held to the JAX package and to the port's plain version.

The kernel runs only on a card; its algorithm is checked here:

* each CTA indexes a window's w events (valid, in the sensor) by sensor
  row: a count a row, a scan, each event's x at its row's cursor;
* norm from the counts within each row: a row of at most 32 events by
  counting each event's later repeats, a longer one by counters over x;
* per slot, the 48x48 count patch from the events of its 48 rows only,
  each occupied pixel's bin (its count is its events' c) and moments;
* the Sobel only at pixels with an occupied pixel in their 3x3
  neighbourhood (the candidates), g2 in float32 steps; every other
  pixel's e2 = 1e-12 and sqrt(e2) enter the sums as one product each; the
  candidates, in row then column order, are cut into 32 runs of
  ceil(n / 32), a lane sums the non-zero terms of its run in that order,
  the lanes are summed by xor shuffles, then the products are added.

The patch, the normalizer, the histogram counts and the moments must
equal the JAX package's ``cluster_count_patches``, ``event_normalizer``
and ``event_histogram_counts`` exactly; the six metrics in the model's
float32 order must equal ``cluster_metrics_events`` and the port's plain
stage with event_count and edge_density exact, the rest within rtol =
atol = 1e-5 (the float sums run in another order, and log2). Cases: E =
1,025 and 4,096 (``large_windows``: a hot pixel of 40 repeats, a dense
cell, rows past 32 events) at K = 32 and 160 with every slot valid and
four on the sensor's corners (patches clipped at the edge), and the first
stride windows of the scale recording (100 ms at capacity 4,096, 32 of 32
slots valid)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import metrics as JM
from repro_torch.core import metrics as TM
from repro_torch.core.grid_clustering import Clusters
from repro_torch.kernels import ref
from test_torch_kernels import (
    ATOL, EXACT, F32, RTOL, SHORT_ROW, _jbatch, _k3_rows, _k3_rows_norm, _warp_sum,
)

torch.set_num_threads(1)

WIN, BINS, PIX = 48, 32, 48 * 48
SCALE = dict(seed=11, duration_s=60, n_rsos=4, noise_rate_hz=20_000)  # chip_smoke.SCALE
STRIDE_US, STRIDE_CAPACITY, STRIDE_WINDOWS = 100_000, 4096, 3


def _lane_sums(values, cand, nz):
    """The kernel's float32 sum of one term over a slot's candidate pixels
    (``cand``, the dilated occupancy, in row then column order): lane l
    takes the l-th of 32 runs of ceil(n / 32) candidates and adds the
    non-zero ones (``nz``) of its run in order from 0, then the 32 lanes
    are summed by xor shuffles."""
    idx = np.flatnonzero(cand)
    run = -(-len(idx) // 32)
    lanes = np.zeros(32, F32)
    for lane in range(32):
        mine = idx[lane * run:(lane + 1) * run]
        vals = values.flat[mine[nz.flat[mine]]].astype(F32)
        if len(vals):
            lanes[lane] = np.add.accumulate(vals, dtype=F32)[-1]
    return _warp_sum(lanes)


def _slot(rows, nrm, x0, y0, count, height=480):
    """Steps 4-5 for one valid slot. Returns (patch, histogram counts,
    (s1, s2), the six metrics in METRIC_NAMES order)."""
    p = np.zeros((WIN + 2, WIN + 2), np.int64)
    for r in range(WIN):
        yy = y0 + r
        if 0 <= yy < height:
            rx = rows[yy].astype(np.int64) - x0
            np.add.at(p[r + 1], rx[(rx >= 0) & (rx < WIN)] + 1, 1)
    mid = p[1:-1, 1:-1]
    occ = mid > 0
    c = mid[occ]
    s1, s2 = int(c.sum()), int((c * c).sum())
    bins = np.clip((c.astype(F32) / nrm * F32(BINS)).astype(np.int64), 0, BINS - 1)
    hist = np.bincount(bins, minlength=BINS)
    hist[0] += PIX - int(occ.sum())

    ul, up, ur = p[:-2, :-2], p[:-2, 1:-1], p[:-2, 2:]
    left, right = p[1:-1, :-2], p[1:-1, 2:]
    dl, down, dr = p[2:, :-2], p[2:, 1:-1], p[2:, 2:]
    gx = (ur - ul) + 2 * (right - left) + (dr - dl)
    gy = (dl - ul) + 2 * (down - up) + (dr - ur)
    nz = (gx | gy) != 0
    dilated = np.zeros_like(occ)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            dilated[max(dy, 0):WIN + min(dy, 0), max(dx, 0):WIN + min(dx, 0)] |= \
                occ[max(-dy, 0):WIN + min(-dy, 0), max(-dx, 0):WIN + min(-dx, 0)]
    assert not (nz & ~dilated).any(), "a gradient off the candidate pixels"
    fx, fy = gx.astype(F32), gy.astype(F32)
    e2 = (fx * fx + fy * fy) / (nrm * nrm) + F32(1e-12)
    g = np.sqrt(e2)
    s_g = _lane_sums(g, dilated, nz)
    s_e2 = _lane_sums(e2, dilated, nz)
    n_zero = PIX - int(nz.sum())
    mx = max(e2[nz].max(initial=-np.inf), F32(1e-12) if n_zero else -np.inf)
    a = F32(0.25) * max(np.sqrt(F32(mx)), F32(1e-3))
    edges = int((e2[nz] > a * a).sum())
    g_tot = F32(F32(n_zero) * np.sqrt(F32(1e-12))) + s_g
    e2_tot = F32(F32(n_zero) * F32(1e-12)) + s_e2
    inv_n = F32(1) / F32(PIX)
    pb = hist.astype(F32) / max(_warp_sum(hist.astype(F32)), F32(1))  # one bin a lane
    shannon = _warp_sum(np.where(pb > 0, pb * np.log2(np.maximum(pb, F32(1e-12))), F32(0)))
    collide = _warp_sum(pb * pb)
    mean = F32(s1) * inv_n
    contrast = np.sqrt(max(F32(s2) * inv_n - mean * mean, F32(0))) / nrm
    m1 = g_tot * inv_n
    var_g = max(e2_tot * inv_n - m1 * m1, F32(1e-12))
    mets = (-shannon, -np.log2(max(collide, F32(1e-12))),
            F32(0.5) * np.log2(F32(17.079468445347132) * var_g), contrast,
            F32(edges) * inv_n, F32(count))
    return mid, hist, (s1, s2), mets


def _stride_windows():
    """The scale recording's first stride windows, conditioned and
    clustered as the scan's window core does (``chip_smoke.stride_blocks``)."""
    from repro_torch.core.events import BatcherConfig, EventBatch, pad_windows
    from repro_torch.core.pipeline import PipelineConfig
    from repro_torch.core.pipeline import config as C
    from repro_torch.core.pipeline.window_core import _cluster, _condition
    from repro_torch.data.synthetic import make_recording

    cfg = dataclasses.replace(PipelineConfig(use_kernels=True, metrics_impl="kernel"),
                              batcher=BatcherConfig(capacity=STRIDE_CAPACITY))
    rec = make_recording(**SCALE)
    win = pad_windows(rec.x, rec.y, rec.t, rec.p, cfg.batcher, "cpu", policy="stride",
                      window_us=STRIDE_US)
    b = _condition(cfg, EventBatch(*(a[:STRIDE_WINDOWS] for a in win.batch)))
    return b, _cluster(cfg, C._histogram_fn(cfg), b)


def _case(name, k):
    from repro_torch.data.adversarial import full_slot_clusters, large_windows, stacked_batch

    if name == "stride":
        return _stride_windows()
    b = stacked_batch(large_windows(int(name), n_windows=2))
    return b, full_slot_clusters(b, k)


@pytest.mark.parametrize("name,k", [("1025", 32), ("1025", 160), ("4096", 32), ("4096", 160),
                                    ("stride", 32)])
def test_large_path_algorithm_matches_reference_and_plain(name, k):
    b, cl = _case(name, k)
    x, y, t, v = (a.numpy() for a in (b.x, b.y, b.t, b.valid))
    assert cl.valid.shape[1] == k and bool(cl.valid.all()), "every slot valid"
    assert x.shape[1] > 1024 or k > 128, "past the small path"
    x0, y0 = (a.numpy() for a in TM.window_origin(cl.centroid_x, cl.centroid_y, 640, 480))
    if name != "stride":
        assert (x0 == 0).any() and (y0 == 480 - WIN).any(), "patches clipped at the edge"

    jfields = [jnp.asarray(getattr(cl, f).numpy()) for f in Clusters._fields]
    jb = [_jbatch(x[r], y[r], t[r], v[r]) for r in range(x.shape[0])]
    jbatch = jax.tree.map(lambda *a: jnp.stack(a), *jb)

    def reference(bb, *fields):
        from repro.core.grid_clustering import Clusters as JC
        c = JC(*fields)
        cc, lead, w, norm = JM.event_normalizer(bb, 640, 480)
        jx0, jy0 = JM.window_origin(c.centroid_x, c.centroid_y, 640, 480)
        hist, mom = JM.event_histogram_counts(bb, cc, lead, w, norm, jx0, jy0)
        return (norm, JM.cluster_count_patches(bb, c, 640, 480), hist, mom,
                JM.cluster_metrics_events(bb, c, 640, 480))

    jnorm, jpatch, jhist, (js1, js2), jmets = jax.jit(jax.vmap(reference))(jbatch, *jfields)
    plain = ref.patch_metrics_stage_ref(b, cl, width=640, height=480)

    long_rows = 0
    for r in range(x.shape[0]):
        rows = _k3_rows(x[r], y[r], v[r])
        long_rows += sum(len(q) > SHORT_ROW for q in rows)
        nrm = _k3_rows_norm(rows)
        assert nrm == np.asarray(jnorm)[r], r
        for s in range(k):
            patch, hist, (s1, s2), got = _slot(rows, nrm, int(x0[r, s]), int(y0[r, s]),
                                               int(cl.count[r, s]))
            np.testing.assert_array_equal(patch, np.asarray(jpatch)[r, s], err_msg=f"patch {r} {s}")
            np.testing.assert_array_equal(hist, np.asarray(jhist)[r, s], err_msg=f"hist {r} {s}")
            assert (s1, s2) == (np.asarray(js1)[r, s], np.asarray(js2)[r, s]), (r, s)
            for m, a in zip(TM.METRIC_NAMES, got):
                for what, want in (("jax", np.asarray(jmets[m])[r, s]), ("plain", plain[m][r, s].item())):
                    if m in EXACT:
                        assert a == want, (what, m, r, s)
                    else:
                        np.testing.assert_allclose(a, want, rtol=RTOL, atol=ATOL,
                                                   err_msg=f"{what} {m} {r} {s}")
    if name != "stride":
        assert long_rows > 0, "the long-row branch of the normalizer"
