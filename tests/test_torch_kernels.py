"""The port's two stage kernels, cluster_accum and patch_metrics. Here on
the CPU the wrappers run the plain PyTorch versions, held against the JAX
package's Pallas kernels in interpret mode on adversarial windows:
cluster_accum exactly; for patch_metrics event_count and edge_density
exactly, the entropies and contrast to rtol = atol = 1e-5
(order-dependent float32 reductions and log2). Numpy models of the two
CUDA kernels' algorithms (the metrics kernel's sort and pixel runs, its
float32 reduction order; the clustering kernel's prefix top-K) are held
against the plain versions and the JAX package, and so are models of
their large paths (past E = 1024 or K = 128: the metrics kernel's row
index and normalizer, the whole of its steps in
``test_torch_patch_metrics_large.py``; the clustering kernel's 64-bit
keys). A window whose cell t sums pass 2^24 holds the float32 routes
(the plain version, the JAX package's scatter and its Pallas kernel) to
the stated bound of the exact, once-rounded sum the clustering kernel
computes. The adversarial windows and the CUDA kernels' own tests are in
``test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import events as JE
from repro.core import grid_clustering as JG
from repro.kernels import ops as jops
from repro_torch.core import metrics as TM
from repro_torch.core.grid_clustering import Clusters, GridConfig
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.kernels import _build, ops, ref
from test_torch_cuda import _slot_clusters, _tbatch, _windows

torch.set_num_threads(1)

RTOL = ATOL = 1e-5
EXACT = ("event_count", "edge_density")


def _jbatch(x, y, t, v):
    return JE.EventBatch(
        *(jnp.asarray(a, jnp.int32) for a in (x, y, t, np.zeros_like(x))), jnp.asarray(v)
    )


@pytest.mark.parametrize("cell_size,width,height", [(16, 640, 480), (12, 640, 480), (16, 600, 400)])
def test_cluster_accum_plain_matches_pallas(cell_size, width, height):
    x, y, t, v = _windows()
    g = GridConfig(cell_size=cell_size)
    kw = dict(cell_size=cell_size, grid_w=g.grid_w, grid_h=g.grid_h, width=width, height=height)
    got = ops.cluster_accum(*(torch.as_tensor(a) for a in (x, y, t, v)), **kw)
    for r in range(x.shape[0]):
        exp = jops.cluster_accum(
            jnp.asarray(x[r]), jnp.asarray(y[r]), jnp.asarray(t[r]), jnp.asarray(v[r]), **kw
        )
        for a, b, f in zip(got, exp, ("count", "sum_x", "sum_y", "sum_t")):
            assert a.dtype == (torch.int32 if f == "count" else torch.float32)
            np.testing.assert_array_equal(a[r].numpy(), np.asarray(b), err_msg=f"{f} window {r}")


def test_cluster_accum_batch_axis_equals_per_window():
    x, y, t, v = _windows()
    kw = dict(cell_size=16, grid_w=40, grid_h=30)
    whole = ref.cluster_accum_ref(*(torch.as_tensor(a) for a in (x, y, t, v)), **kw)
    for r in range(x.shape[0]):
        one = ref.cluster_accum_ref(*(torch.as_tensor(a[r]) for a in (x, y, t, v)), **kw)
        for a, b in zip(whole, one):
            assert torch.equal(a[r], b)


def test_patch_metrics_plain_matches_pallas():
    x, y, t, v = _windows()
    cl = _slot_clusters(x, y, t, v)
    got = ops.patch_metrics(_tbatch(x, y, t, v), cl)
    assert set(got) == set(TM.METRIC_NAMES)
    # Under jit, as the reference's pipeline and its own kernel tests run it.
    call = jax.jit(lambda b, c: jops.patch_metrics_call(b, c, width=640, height=480))
    for r in range(x.shape[0]):
        jb = _jbatch(x[r], y[r], t[r], v[r])
        jc = JG.Clusters(*(jnp.asarray(getattr(cl, f)[r].numpy()) for f in Clusters._fields))
        exp = call(jb, jc)
        for m in TM.METRIC_NAMES:
            a, b = got[m][r].numpy(), np.asarray(exp[m])
            if m in EXACT:
                np.testing.assert_array_equal(a, b, err_msg=f"{m} window {r}")
            else:
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=f"{m} window {r}")


def test_patch_metrics_plain_equals_event_route():
    # The kernel's dense moments and the event route's event moments are
    # the same exact integers, so on one device the two agree to the bit.
    x, y, t, v = _windows()
    cl = _slot_clusters(x, y, t, v)
    b = _tbatch(x, y, t, v)
    got = ops.patch_metrics(b, cl)
    exp = TM.cluster_metrics_events(b, cl)
    for m in TM.METRIC_NAMES:
        assert torch.equal(got[m], exp[m]), m


def test_cpu_route_launches_no_kernel():
    ops.reset_launches()
    x, y, t, v = _windows()
    ops.cluster_accum(*(torch.as_tensor(a) for a in (x, y, t, v)), cell_size=16, grid_w=40, grid_h=30)
    ops.patch_metrics(_tbatch(x, y, t, v), _slot_clusters(x, y, t, v))
    ops.window_pipeline(_tbatch(x, y, t, v), PipelineConfig(numerics="fixed", metrics_impl="megakernel"))
    assert ops.LAUNCHES == {"cluster_accum": 0, "patch_metrics": 0, "window_pipeline": 0,
                            "event_unpack": 0, "grid_quantize_packed": 0, "window_entropy": 0}


def test_wrappers_refuse_other_devices_and_float_t():
    x = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel route"):
        ops.cluster_accum(x, x, x, x.bool(), cell_size=16, grid_w=40, grid_h=30)
    c = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        ops.cluster_accum(c, c, c.float(), c.bool(), cell_size=16, grid_w=40, grid_h=30)


def test_build_is_lazy_and_keyed_by_sources():
    d = _build.build_dir()
    assert d.parent == _build.BUILD_ROOT and d == _build.build_dir()
    assert _build.BUILD_ROOT.parts[-2:] == ("build", "repro_torch")
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == set(_build.SOURCES)
    assert "-use_fast_math" not in _build.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


# ---------------------------------------------------------------------------
# The two stage kernels' algorithms (csrc/patch_metrics.cu and the stage
# entry of csrc/cluster_accum.cu), modelled in numpy. The kernels run only
# on a card; their logic is held here against the plain versions and the
# JAX package, window by window.
# ---------------------------------------------------------------------------

F32 = np.float32


def _stack(windows):
    return tuple(np.stack(a) for a in zip(*windows))


def _seeded(w, e, seed):
    """Random windows with clumps and out-of-sensor events."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-20, 660, (w, e))
    y = rng.integers(-20, 500, (w, e))
    for r in range(w):
        for c in range(4):
            n = rng.integers(5, 40)
            cx, cy = rng.integers(0, 640), rng.integers(0, 480)
            x[r, c * 40:c * 40 + n] = np.clip(cx + rng.integers(-3, 4, n), 0, 639)
            y[r, c * 40:c * 40 + n] = np.clip(cy + rng.integers(-3, 4, n), 0, 479)
    return x, y, rng.integers(0, 20_000, (w, e)), rng.random((w, e)) < 0.9


def _model_case(name):
    """Host ``(x, y, t, valid)`` ``(W, E)`` planes of a named case."""
    from repro_torch.data.adversarial import clustered_window, named_windows, run_and_tie_windows

    if name == "adversarial":
        return _windows()
    if name == "named":
        return _stack(list(named_windows().values()))
    if name == "runs and ties":
        return _stack(run_and_tie_windows())
    if name == "E=1024":
        return _stack([clustered_window(s, n=1000, capacity=1024) for s in range(2)])
    return _seeded(3, 256, 11)


MODEL_CASES = ("adversarial", "named", "runs and ties", "seeded", "E=1024")


def _k3_events_model(x, y, v, width=640, height=480):
    """The kernel's steps 2-3 per window: sort the w events' keys (pixel,
    index); each pixel run of length r gives its events c = r and its
    first event the lead; norm = max(1, max c); each leader's bin
    trunc(c / norm * 32) in float32. Returns (w, c, leader, norm, bin)."""
    n_win, e = x.shape
    ebits = max(e - 1, 0).bit_length()
    mask = (1 << ebits) - 1
    w = v & (x >= 0) & (x < width) & (y >= 0) & (y < height)
    c = np.zeros((n_win, e), np.int64)
    lead = np.zeros((n_win, e), bool)
    norm = np.ones(n_win, F32)
    bins = np.full((n_win, e), -1, np.int64)
    for r in range(n_win):
        keys = sorted(((int(y[r, i]) * width + int(x[r, i])) << ebits) | int(i)
                      for i in np.flatnonzero(w[r]))
        j = 0
        while j < len(keys):
            n = 1
            while j + n < len(keys) and keys[j + n] >> ebits == keys[j] >> ebits:
                n += 1
            for q in range(j, j + n):
                c[r, keys[q] & mask] = n
            lead[r, keys[j] & mask] = True
            j += n
        norm[r] = max(int(c[r].max(initial=0)), 1)
        for i in np.flatnonzero(lead[r]):
            bins[r, i] = min(max(int(F32(c[r, i]) / norm[r] * F32(32)), 0), 31)
    return w, c, lead, norm, bins


def _k3_origins(cx, cy, width=640, height=480):
    """Step 1's patch origins: rint (half to even) less 24, clipped."""
    clip = lambda a, hi: np.minimum(np.maximum(np.rint(a).astype(np.int64) - 24, 0), hi - 48)
    return clip(cx, width), clip(cy, height)


def _warp_sum(lanes):
    """A warp's float32 sum by xor shuffles over its last axis of 32."""
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., np.arange(32) ^ o]
    return lanes[..., 0]


def _block_sum(a):
    """The kernel's float32 sum of 2,304 per-pixel values: each of 256
    threads over its pixels p = tid + 256 j in j order, a warp's 32 by
    xor shuffles, then the 8 warps in order."""
    acc = np.zeros(256, F32)
    for row in a.reshape(9, 256):
        acc = acc + row
    tot = F32(0)
    for s in _warp_sum(acc.reshape(8, 32)):
        tot = F32(tot + s)
    return tot


def _k3_slot_model(xs, ys, w, lead, bins, nrm, x0, y0, count):
    """The kernel's steps 4-5 for one valid slot, in its float32 order."""
    patch = np.zeros((50, 50), np.int64)
    hist = np.zeros(32, np.int64)
    for i in np.flatnonzero(w):
        rx, ry = int(xs[i]) - x0, int(ys[i]) - y0
        if 0 <= rx < 48 and 0 <= ry < 48:
            patch[ry + 1, rx + 1] += 1
            if lead[i]:
                hist[bins[i]] += 1
    p = patch
    ul, up, ur = p[:-2, :-2], p[:-2, 1:-1], p[:-2, 2:]
    left, mid, right = p[1:-1, :-2], p[1:-1, 1:-1], p[1:-1, 2:]
    dl, down, dr = p[2:, :-2], p[2:, 1:-1], p[2:, 2:]
    gx = (ur - ul) + 2 * (right - left) + (dr - dl)
    gy = (dl - ul) + 2 * (down - up) + (dr - ur)
    g2 = gx * gx + gy * gy
    e2 = np.where(g2 == 0, F32(1e-12), g2.astype(F32) / (nrm * nrm) + F32(1e-12)).astype(F32)
    g = np.sqrt(e2)
    a = F32(0.25) * max(np.sqrt(e2.max()), F32(1e-3))
    edges = int((e2 > a * a).sum())
    inv_n = F32(1) / F32(2304)
    hist[0] += 2304 - hist.sum()
    pb = hist.astype(F32) / max(_warp_sum(hist.astype(F32)), F32(1))  # one bin a lane
    shannon = _warp_sum(np.where(pb > 0, pb * np.log2(np.maximum(pb, F32(1e-12))), F32(0)))
    collide = _warp_sum(pb * pb)
    mean = F32(mid.sum()) * inv_n
    contrast = np.sqrt(max(F32((mid * mid).sum()) * inv_n - mean * mean, F32(0))) / nrm
    m1 = _block_sum(g) * inv_n
    var_g = max(_block_sum(e2) * inv_n - m1 * m1, F32(1e-12))
    return (-shannon, -np.log2(max(collide, F32(1e-12))),
            F32(0.5) * np.log2(F32(17.079468445347132) * var_g), contrast,
            F32(edges) * inv_n, F32(count))


@pytest.mark.parametrize("case", MODEL_CASES)
def test_patch_metrics_algorithm_matches_reference_and_plain(case):
    """The metrics kernel's run-based normalizer, leaders and bins and its
    round-half-even origins, in numpy, equal the JAX package's
    ``event_normalizer`` and ``window_origin`` and the port's, exactly;
    its per-slot metrics, in the kernel's own float32 order, equal the
    port's plain stage (event_count and edge_density exactly, the rest to
    rtol = atol = 1e-5)."""
    from repro.core import metrics as JM
    from repro_torch.data.adversarial import edge_slot_clusters

    x, y, t, v = _model_case(case)
    b = _tbatch(x, y, t, v)
    cl = edge_slot_clusters(b)
    f = {k: a.clone() for k, a in cl._asdict().items()}
    for j, (px, py) in ((4, (100.5, 200.5)), (5, (101.5, 201.5))):  # ties to even
        f["centroid_x"][:, j], f["centroid_y"][:, j] = px, py
        f["count"][:, j], f["valid"][:, j] = 3, True
    cl = Clusters(**f)
    w, c, lead, norm, bins = _k3_events_model(x, y, v)
    x0, y0 = _k3_origins(cl.centroid_x.numpy(), cl.centroid_y.numpy())

    tc, tl, tw, tn = TM.event_normalizer(b, 640, 480)
    np.testing.assert_array_equal(tw.numpy(), w)
    np.testing.assert_array_equal(np.where(w, tc.numpy(), 0), c)
    np.testing.assert_array_equal(tl.numpy(), lead)
    np.testing.assert_array_equal(tn.numpy(), norm)
    tbin = torch.clamp((tc.float() / tn[:, None] * 32).int(), 0, 31).numpy()
    np.testing.assert_array_equal(np.where(lead, tbin, -1), bins)
    tx0, ty0 = TM.window_origin(cl.centroid_x, cl.centroid_y, 640, 480)
    np.testing.assert_array_equal(tx0.numpy(), x0)
    np.testing.assert_array_equal(ty0.numpy(), y0)
    jn = jax.jit(lambda jb: JM.event_normalizer(jb, 640, 480))
    jo = jax.jit(lambda a, b_: JM.window_origin(a, b_, 640, 480))
    for r in range(x.shape[0]):
        jc, jl, jw, jnorm = jn(_jbatch(x[r], y[r], t[r], v[r]))
        np.testing.assert_array_equal(np.asarray(jw), w[r])
        np.testing.assert_array_equal(np.where(w[r], np.asarray(jc), 0), c[r])
        np.testing.assert_array_equal(np.asarray(jl), lead[r])
        assert np.asarray(jnorm) == norm[r]
        jx0, jy0 = jo(jnp.asarray(cl.centroid_x[r].numpy()), jnp.asarray(cl.centroid_y[r].numpy()))
        np.testing.assert_array_equal(np.asarray(jx0), x0[r])
        np.testing.assert_array_equal(np.asarray(jy0), y0[r])

    exp = ref.patch_metrics_stage_ref(b, cl, width=640, height=480)
    valid = cl.valid.numpy()
    count = cl.count.numpy()
    for r in range(x.shape[0]):
        for s in range(valid.shape[1]):
            want = [exp[m][r, s].item() for m in TM.METRIC_NAMES]
            if not valid[r, s]:
                assert want == [0.0] * 6
                continue
            got = _k3_slot_model(x[r], y[r], w[r], lead[r], bins[r], norm[r],
                                 x0[r, s], y0[r, s], count[r, s])
            for m, a, e in zip(TM.METRIC_NAMES, got, want):
                if m in EXACT:
                    assert a == e, (m, r, s)
                else:
                    np.testing.assert_allclose(a, e, rtol=RTOL, atol=ATOL, err_msg=f"{m} {r} {s}")


def _k2_model(x, y, t, v, grid, key_shift=None):
    """The clustering kernel's stage entry per window: the cell table,
    then one sort of the counted cells' keys (E - count, cell), the count
    shifted by ``key_shift`` bits (the small path: the cell's bit length;
    the large path: 32); slots below min_events are constants, and with
    min_events <= 0 the slots after the counted cells take the cells with
    no event, lowest first. Returns the (W, K) cluster fields as numpy."""
    n_win, e = x.shape
    k, cs, gw = grid.max_clusters, grid.cell_size, grid.grid_w
    n_cells = gw * grid.grid_h
    cbits = (n_cells - 1).bit_length() if key_shift is None else key_shift
    out = {f: np.zeros((n_win, k), np.float32 if f.startswith("centroid") else
                       (bool if f == "valid" else np.int32)) for f in Clusters._fields}
    for r in range(n_win):
        w = v[r] & (x[r] >= 0) & (x[r] < grid.width) & (y[r] >= 0) & (y[r] < grid.height)
        cell = np.minimum(y[r][w] // cs * gw + x[r][w] // cs, n_cells - 1)
        table = [np.bincount(cell, weights=a, minlength=n_cells).astype(np.int64)
                 for a in (np.ones(len(cell)), x[r][w], y[r][w], t[r][w])]
        cnt = table[0]
        keys = sorted(((e - int(cnt[c])) << cbits) | int(c)
                      for c in np.flatnonzero(cnt >= max(grid.min_events, 1)))
        n_top = min(len(keys), k)
        n_valid = k if grid.min_events <= 0 else n_top
        empty = iter(np.flatnonzero(cnt == 0))
        for s in range(k):
            ok = s < n_valid
            c, n = -1, 0
            if s < n_top:
                c, n = keys[s] & ((1 << cbits) - 1), e - (keys[s] >> cbits)
            elif ok:
                c, n = int(next(empty)), 0
            den = F32(max(n, 1))
            for f, a in zip(("centroid_x", "centroid_y", "centroid_t"), table[1:]):
                out[f][r, s] = F32(a[c]) / den if ok else -1.0
            out["count"][r, s] = n if ok else 0
            out["cell_x"][r, s] = c % gw if ok else -1
            out["cell_y"][r, s] = c // gw if ok else -1
            out["valid"][r, s] = ok
    return out


K2_GRIDS = [dict(cell_size=cs, min_events=me) for cs in (16, 12) for me in (5, 1, 0)] + [
    dict(min_events=0, max_clusters=128), "clipped", "clipped, cell 12"]


@pytest.mark.parametrize("grid", K2_GRIDS, ids=str)
def test_cluster_accum_topk_algorithm_matches_reference(grid):
    """The clustering kernel's selection, in numpy, equals the JAX
    package's ``clusters_from_histogram(*cluster_accum_ref(...))`` and
    the port's stage entry on the CPU (the rows route, then
    ``clusters_from_histogram``) on every field, exactly."""
    from repro.kernels import ref as jref
    from repro_torch.data.adversarial import ClippedGrid

    if isinstance(grid, str):
        g = ClippedGrid() if grid == "clipped" else ClippedGrid(cell_size=12, cols=40, rows=30, min_events=1)
        jg = g  # the JAX function reads only max_clusters, min_events and grid_w
    else:
        g, jg = GridConfig(**grid), JG.GridConfig(**grid)
    kw = dict(cell_size=g.cell_size, grid_w=g.grid_w, grid_h=g.grid_h, width=g.width, height=g.height)
    jfn = jax.jit(jax.vmap(lambda *a: JG.clusters_from_histogram(*jref.cluster_accum_ref(*a, **kw), jg)))
    cases = [_model_case(n) for n in MODEL_CASES]
    by_e = {}
    for case in cases:  # one JAX compile per window length
        by_e.setdefault(case[0].shape[1], []).append(case)
    for group in by_e.values():
        x, y, t, v = (np.concatenate(a) for a in zip(*group))
        model = _k2_model(x, y, t, v, g)
        got = ops.cluster_accum_topk(*(torch.as_tensor(a) for a in (x, y, t, v)), g)
        want = jfn(*(jnp.asarray(a, jnp.int32) for a in (x, y, t)), jnp.asarray(v))
        for f in Clusters._fields:
            np.testing.assert_array_equal(model[f], getattr(got, f).numpy(), err_msg=f)
            np.testing.assert_array_equal(model[f], np.asarray(getattr(want, f)), err_msg=f"jax {f}")


@pytest.mark.parametrize("cell_size,min_events", [(16, 5), (12, 1), (16, 0)])
def test_cluster_accum_topk_cpu_route_is_rows_then_clusters(cell_size, min_events):
    """The stage entry on the CPU equals the rows route followed by
    ``clusters_from_histogram``, every field, and launches nothing."""
    from repro_torch.core.grid_clustering import clusters_from_histogram

    x, y, t, v = (torch.as_tensor(a) for a in _windows())
    g = GridConfig(cell_size=cell_size, min_events=min_events)
    ops.reset_launches()
    got = ops.cluster_accum_topk(x, y, t, v, g)
    rows = ops.cluster_accum(x, y, t, v, cell_size=cell_size, grid_w=g.grid_w, grid_h=g.grid_h,
                             width=g.width, height=g.height)
    want = clusters_from_histogram(*rows, g)
    for f in Clusters._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert sum(ops.LAUNCHES.values()) == 0


# ---------------------------------------------------------------------------
# Past the small path's E <= 1024 / K <= 128, and cell t sums past 2^24.
# ---------------------------------------------------------------------------

SHORT_ROW = 32  # the large path's kShortRow


def _k3_rows(x, y, v, width=640, height=480):
    """The metrics kernel's large path, step 2 for one window: the w
    events' x by sensor row (a list of ``height`` arrays), as its count,
    scan and scatter leave them (within a row in any order; the model
    keeps the events' order)."""
    w = v & (x >= 0) & (x < width) & (y >= 0) & (y < height)
    order = np.argsort(y[w], kind="stable")
    xs, ys = x[w][order], y[w][order]
    ends = np.cumsum(np.bincount(ys, minlength=height))
    return [xs[s:e] for s, e in zip(np.r_[0, ends[:-1]], ends)]


def _k3_rows_norm(rows):
    """The large path's step 3: max(1, the largest count of one pixel)
    from the rows, a row of at most 32 events by each event's later
    repeats, a longer one by counters over x (its two branches)."""
    cmax = 0
    for r in rows:
        if len(r) <= SHORT_ROW:
            for i in range(len(r)):
                cmax = max(cmax, 1 + int((r[i + 1:] == r[i]).sum()))
        elif len(r):
            cmax = max(cmax, int(np.bincount(r).max()))
    return F32(max(cmax, 1))


@pytest.mark.parametrize("e", [1025, 4096])
def test_patch_metrics_large_path_algorithm_matches_reference(e):
    """The large path's row index and normalizer, in numpy: the rows hold
    exactly the w events, each pixel's count within its row is the c of
    the small path's model and of the JAX package's ``event_normalizer``
    (and the port's), and the normalizer equals theirs, with rows past 32
    events (the warp branch) in the windows."""
    from repro.core import metrics as JM
    from repro_torch.data.adversarial import large_windows

    x, y, t, v = _stack(large_windows(e, n_windows=2))
    sw, sc, slead, snorm, _ = _k3_events_model(x, y, v)
    tc, tl, tw, tn = TM.event_normalizer(_tbatch(x, y, t, v), 640, 480)
    jn = jax.jit(lambda jb: JM.event_normalizer(jb, 640, 480))
    for r in range(x.shape[0]):
        rows = _k3_rows(x[r], y[r], v[r])
        assert sum(len(q) for q in rows) == int(sw[r].sum())
        assert max(len(q) for q in rows) > SHORT_ROW
        norm = _k3_rows_norm(rows)
        jc, jl, jw, jnorm = jn(_jbatch(x[r], y[r], t[r], v[r]))
        assert norm == snorm[r] == tn[r].item() == np.asarray(jnorm)
        pix = {(int(yy), int(xx)): 0 for yy, q in enumerate(rows) for xx in q}
        for yy, q in enumerate(rows):
            for xx in q:
                pix[yy, int(xx)] += 1
        for i in np.flatnonzero(slead[r]):
            want = pix[int(y[r, i]), int(x[r, i])]
            assert want == sc[r, i] == tc[r, i].item() == np.asarray(jc)[i], (r, i)
        assert len(pix) == int(slead[r].sum()) == int(np.asarray(jl).sum())


def _assert_centroid_t_within_bound(got_t, want, abs_t, grid, what):
    """``got_t`` against ``want.centroid_t`` to :func:`ref.centroid_t_bound`
    of each valid slot's cell; invalid slots identical."""
    cell = np.maximum(want["cell_y"] * grid.grid_w + want["cell_x"], 0)
    a = np.take_along_axis(abs_t, cell, -1)
    bound = ref.centroid_t_bound(torch.as_tensor(want["count"]), torch.as_tensor(a)).numpy()
    bound = np.where(want["valid"], bound, 0.0)
    diff = np.abs(np.asarray(got_t, np.float64) - np.asarray(want["centroid_t"], np.float64))
    assert (diff <= bound).all(), (what, float((diff - bound).max()))


@pytest.mark.parametrize("grid", [dict(), dict(min_events=1, max_clusters=160),
                                  dict(cell_size=12, min_events=0, max_clusters=160)], ids=str)
def test_cluster_accum_topk_large_path_matches_reference(grid):
    """The clustering kernel's large path (E = 4,096: 64-bit keys, count
    above and cell below, more than 1,024 counted cells; K up to 160), in
    numpy, equals the port's stage entry on the CPU and the JAX package's
    ``clusters_from_histogram(*cluster_accum_ref(...))`` on every integer
    field, centroid_x and centroid_y; centroid_t within
    ``centroid_t_bound`` where a cell's t sum passes 2^24 (the model sums
    exactly and rounds once, as the kernel does; the other two add in
    float32)."""
    from repro.kernels import ref as jref
    from repro_torch.data.adversarial import large_windows

    g, jg = GridConfig(**grid), JG.GridConfig(**grid)
    kw = dict(cell_size=g.cell_size, grid_w=g.grid_w, grid_h=g.grid_h, width=g.width, height=g.height)
    x, y, t, v = _stack(large_windows(4096))
    model = _k2_model(x, y, t, v, g, key_shift=32)
    got = ops.cluster_accum_topk(*(torch.as_tensor(a) for a in (x, y, t, v)), g)
    jfn = jax.jit(jax.vmap(lambda *a: JG.clusters_from_histogram(*jref.cluster_accum_ref(*a, **kw), jg)))
    want = jfn(*(jnp.asarray(a, jnp.int32) for a in (x, y, t)), jnp.asarray(v))
    abs_t = ref.abs_t_rows(*(torch.as_tensor(a) for a in (x, y, t, v)), **kw).numpy()
    assert (abs_t >= 2 ** 24).any()
    assert (model["count"] > 0).sum(-1).max() >= min(g.max_clusters, 160)
    for f in Clusters._fields:
        if f != "centroid_t":
            np.testing.assert_array_equal(model[f], getattr(got, f).numpy(), err_msg=f)
            np.testing.assert_array_equal(model[f], np.asarray(getattr(want, f)), err_msg=f"jax {f}")
    _assert_centroid_t_within_bound(got.centroid_t.numpy(), model, abs_t, g, "port")
    _assert_centroid_t_within_bound(np.asarray(want.centroid_t), model, abs_t, g, "jax")


def test_sum_t_past_two_to_the_24_within_stated_bound():
    """One window whose cells' t sums pass 2^24 (600 events near t =
    100,000 us; 168 at t = 100,000, just past; 167, just below). The
    clustering kernel sums t exactly in int64 and rounds once; the port's
    plain version, the JAX package's ``cell_histogram`` and its Pallas
    ``cluster_accum`` (interpret mode) add in float32. The stated bound:
    |sum_t - exact| <= (n + 1) 2^-24 sum|t| and, for centroid_t =
    sum_t / max(n, 1), (n + 3) 2^-24 sum|t| / n, n the cell's count, and
    both exact where sum|t| < 2^24. Count, sum_x, sum_y and every other
    cluster field are exact on every route."""
    from repro_torch.core.grid_clustering import clusters_from_histogram
    from repro_torch.data.adversarial import sum_t_window

    x, y, t, v = (a[None] for a in sum_t_window())
    g, jg = GridConfig(min_events=1), JG.GridConfig(min_events=1)
    kw = dict(cell_size=16, grid_w=g.grid_w, grid_h=g.grid_h, width=640, height=480)
    tt = [torch.as_tensor(a) for a in (x, y, t, v)]
    exact = ref.abs_t_rows(*tt, **kw)[0]  # every t >= 0: the exact sums
    assert int(exact.max()) > 2 ** 24 and int((exact >= 2 ** 24).sum()) == 2
    plain = ref.cluster_accum_ref(*tt, **kw)
    count = plain[0][0]
    jh = JG.cell_histogram(_jbatch(x[0], y[0], t[0], v[0]), jg)
    jp = jops.cluster_accum(*(jnp.asarray(a[0]) for a in (x, y, t, v)), **kw)
    k2 = exact.float()  # the kernel's sum_t: the exact sum rounded once
    bound = ref.sum_t_bound(count, exact).numpy()
    assert (bound[exact.numpy() < 2 ** 24] == 0).all()
    routes = {"port plain": [a[0].numpy() for a in plain], "jax cell_histogram": jh,
              "jax pallas": jp}
    for name, (c, sx, sy, st) in routes.items():
        np.testing.assert_array_equal(np.asarray(c), count.numpy(), err_msg=name)
        np.testing.assert_array_equal(np.asarray(sx), plain[1][0].numpy(), err_msg=name)
        np.testing.assert_array_equal(np.asarray(sy), plain[2][0].numpy(), err_msg=name)
        diff = np.abs(np.asarray(st, np.float64) - k2.double().numpy())
        assert (diff <= bound).all(), (name, float((diff - bound).max()))

    model = _k2_model(x, y, t, v, g)  # the kernel's fields, exact sums
    for name, cl in (
        ("port plain", ops.cluster_accum_topk(*tt, g)),
        ("jax cell_histogram", JG.clusters_from_histogram(*jh, jg)),
        ("jax pallas", clusters_from_histogram(*(torch.as_tensor(np.array(a))[None] for a in jp), g)),
    ):
        got = {f: np.asarray(getattr(cl, f)).reshape(1, -1) for f in Clusters._fields}
        for f in Clusters._fields:
            if f != "centroid_t":
                np.testing.assert_array_equal(got[f], model[f], err_msg=f"{name} {f}")
        _assert_centroid_t_within_bound(got["centroid_t"], model, exact.numpy()[None], g, name)
