"""The CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports neither JAX nor the JAX package, so it runs on a machine
with a card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Integers compare exactly: cluster_accum's rows, and every field of its
stage entry against ``clusters_from_histogram`` of the plain rows. The
patch_metrics kernel is the whole metrics stage, held against its plain
stage (normalizer, origins, per-slot metrics): event_count and
edge_density exactly, the entropies and contrast to rtol = atol = 1e-5
(order-dependent float32 reductions and log2). Both stage kernels take
any E and any K: past their small path (E <= 1024, K <= 128) they are
held to the same contract at E = 1025, 4096 and 20,000 and K = 160,
except that where a cell's t sum passes 2^24 cluster_accum's sum_t and
centroid_t (an exact int64 sum rounded once, against the plain version's
float32 adds) are held to the bound ``kernels/ref.py:sum_t_bound`` and
``centroid_t_bound`` state. On the float kernel
route each block makes one launch in its clustering and one in its
metrics stage, by the launch counters and under the profiler. The window_pipeline
kernel emits integers only and shares the float epilogue with its plain
version, so its fields, valid-slot surfaces and all six metrics compare
to the bit. The event_unpack and grid_quantize_packed kernels compare to
the bit; window_entropy to rtol 1e-5 (atol 1e-7 for exact zeros): its
float32 sums run in another order than the plain version's, and log2f is
not torch's log2. The fleet's asynchronous rounds equal its synchronous
ones, and both each sensor's scan, to the bit, and so does the fleet
sharded over a 4-entry mesh of the card equal the unsharded one; so does the stream over
the ragged wire equal its scan. The frame oracle equals the event route
on the card bit for bit; the atlas event core writes the CPU's atlas
across forced tag rollovers, and its atlas update synchronizes nothing
with the host; ``window_entropy`` on real reconstructed frames agrees
with the frame oracle's entropies and contrast. The LM models (the
attention families and the reduced MLA, MoE, RG-LRU and xLSTM ones) in
float32 equal the CPU's within rtol = atol = 1e-4, serve the CPU's tokens,
and make no host synchronization in a decode step; so do a train step of
each (loss, gradient norm, updated parameters) and the paged decode. The
op counter (``launch/op_analysis.py``) counts on the card what it counts on
the meta device, operator for operator. The adversarial inputs
come from ``repro_torch.data.adversarial``, as in ``chip_smoke.py``, and
are shared with ``test_torch_kernels.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import events as TE
from repro_torch.core import metrics as TM
from repro_torch.core.grid_clustering import Clusters, GridConfig
from repro_torch.data.adversarial import adversarial_windows, edge_slot_clusters
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

E = 256
RTOL = ATOL = 1e-5
EXACT = ("event_count", "edge_density")


def _windows():
    """(5, E) adversarial windows (see :mod:`repro_torch.data.adversarial`)."""
    return adversarial_windows(E)


def _tbatch(x, y, t, v):
    return TE.EventBatch(
        *(torch.as_tensor(a, dtype=torch.int32) for a in (x, y, t, np.zeros_like(x))),
        torch.as_tensor(v),
    )


def _slot_clusters(x, y, t, v):
    """Clusters at min_events=1 from each window, with four slots forced to
    the sensor's corners (valid, no events nearby) and two invalid slots."""
    return edge_slot_clusters(_tbatch(x, y, t, v))


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell_size", [16, 12])
def test_cluster_accum_kernel_matches_plain(cuda_dev, cell_size):
    x, y, t, v = (torch.as_tensor(a, device=cuda_dev) for a in _windows())
    g = GridConfig(cell_size=cell_size)
    kw = dict(cell_size=cell_size, grid_w=g.grid_w, grid_h=g.grid_h, width=640, height=480)
    before = ops.LAUNCHES["cluster_accum"]
    got = ops.cluster_accum(x, y, t, v, **kw)
    assert ops.LAUNCHES["cluster_accum"] == before + 1
    for a, b in zip(got, ref.cluster_accum_ref(x, y, t, v, **kw)):
        assert torch.equal(a, b)


def _metric_cases(dev):
    """(name, batch, clusters) cases for the metrics kernel: adversarial
    windows with corner and invalid slots, the six named windows, runs and
    ties, and E = 1024, each with clusters at min_events=1 plus the forced
    slots of ``edge_slot_clusters``."""
    from repro_torch.data.adversarial import (
        adversarial_batch, clustered_window, named_windows, run_and_tie_windows, stacked_batch,
    )

    batches = {
        "adversarial": adversarial_batch(dev),
        "named windows": stacked_batch(list(named_windows().values()), dev),
        "runs and ties": stacked_batch(run_and_tie_windows(), dev),
        "E=1024": stacked_batch([clustered_window(s, n=1000, capacity=1024) for s in range(2)], dev),
    }
    return [(name, b, edge_slot_clusters(b)) for name, b in batches.items()]


def _assert_metrics_close(got, exp, what):
    for m in TM.METRIC_NAMES:
        if m in EXACT:
            assert torch.equal(got[m], exp[m]), (what, m)
        else:
            torch.testing.assert_close(got[m], exp[m], rtol=RTOL, atol=ATOL, msg=f"{what}: {m}")


@pytest.mark.cuda
def test_patch_metrics_kernel_matches_plain(cuda_dev):
    """The metrics stage in one launch against its plain version
    (``event_normalizer`` + ``window_origin`` + ``patch_metrics_ref``)."""
    for name, b, cl in _metric_cases(cuda_dev):
        before = ops.LAUNCHES["patch_metrics"]
        got = ops.patch_metrics(b, cl)
        assert ops.LAUNCHES["patch_metrics"] == before + 1, name
        _assert_metrics_close(got, ref.patch_metrics_stage_ref(b, cl, width=640, height=480), name)


def _topk_grids():
    from repro_torch.data.adversarial import ClippedGrid

    grids = [GridConfig(cell_size=cs, min_events=me) for cs in (16, 12) for me in (5, 1, 0)]
    return grids + [GridConfig(min_events=0, max_clusters=128), GridConfig(cell_size=12, max_clusters=128),
                    ClippedGrid(), ClippedGrid(cell_size=12, cols=40, rows=30, min_events=1)]


@pytest.mark.cuda
def test_cluster_accum_topk_kernel_matches_plain(cuda_dev):
    """The clustering stage in one launch, every field identical to
    ``clusters_from_histogram(cluster_accum_ref(...))``, at cell sizes 16
    and 12, min_events 5, 1 and 0, K 32 and 128 and on a clipped grid."""
    batches = [b for _, b, _ in _metric_cases(cuda_dev)]
    for g in _topk_grids():
        for b in batches:
            before = ops.LAUNCHES["cluster_accum"]
            got = ops.cluster_accum_topk(b.x, b.y, b.t, b.valid, g)
            assert ops.LAUNCHES["cluster_accum"] == before + 1
            want = ref.cluster_accum_topk_ref(b.x, b.y, b.t, b.valid, g)
            for f in Clusters._fields:
                assert torch.equal(getattr(got, f), getattr(want, f)), (g, f)


@pytest.mark.cuda
def test_stage_kernels_refuse_what_they_do_not_take(cuda_dev):
    """No conversion on the card: another dtype raises TypeError, another
    layout or a K above n_cells ValueError; nothing is launched."""
    b = TE.EventBatch(*(a.to(cuda_dev) for a in _tbatch(*_windows())))
    cl = edge_slot_clusters(b)
    g = GridConfig()
    ops.reset_launches()
    with pytest.raises(TypeError):
        ops.cluster_accum_topk(b.x.long(), b.y, b.t, b.valid, g)
    with pytest.raises(ValueError):
        ops.cluster_accum_topk(b.x.t(), b.y.t(), b.t.t(), b.valid.t(), g)
    with pytest.raises(ValueError):
        ops.cluster_accum_topk(b.x, b.y, b.t, b.valid, GridConfig(max_clusters=g.n_cells + 1))
    with pytest.raises(TypeError):
        ops.patch_metrics(b, cl._replace(count=cl.count.long()))
    with pytest.raises(ValueError):
        ops.patch_metrics(b._replace(x=b.x.t().contiguous().t()), cl)
    assert sum(ops.LAUNCHES.values()) == 0


# E past the small path's 1,024 (one over it, the capacity of the stride
# windows, and 20,000, about five times that); K past its 128; cell 4
# puts K2's table past shared memory.
LARGE_E = (1025, 4096, 20_000)
LARGE_GRIDS = (GridConfig(), GridConfig(min_events=1, max_clusters=160),
               GridConfig(cell_size=12, min_events=0, max_clusters=160))


def _assert_clusters_within_bound(got, want, b, g, what):
    """Every field identical except centroid_t, held to ``centroid_t_bound``
    of the slot's cell (identical where the cell's t sum is below 2^24)."""
    for f in Clusters._fields:
        if f != "centroid_t":
            assert torch.equal(getattr(got, f), getattr(want, f)), (what, f)
    abs_t = ref.abs_t_rows(b.x, b.y, b.t, b.valid, cell_size=g.cell_size, grid_w=g.grid_w,
                           grid_h=g.grid_h, width=g.width, height=g.height)
    cell = (want.cell_y * g.grid_w + want.cell_x).clamp_min(0).long()
    bound = torch.where(want.valid, ref.centroid_t_bound(want.count, abs_t.gather(-1, cell)), 0.0)
    diff = (got.centroid_t.double() - want.centroid_t.double()).abs()
    assert bool((diff <= bound).all()), (what, float((diff - bound).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("e", LARGE_E)
def test_stage_kernels_take_any_size(cuda_dev, e):
    """Past the small path's E <= 1024 and K <= 128 both stage kernels
    equal their plain versions, as at the main path's sizes: every
    cluster field identical (centroid_t within its stated bound where a
    cell's t sum passes 2^24), event_count and edge_density identical, the
    other metrics within 1e-5; one launch each."""
    from repro_torch.data.adversarial import large_windows, stacked_batch

    b = stacked_batch(large_windows(e, n_windows=2 if e > 4096 else 3), cuda_dev)
    grids = LARGE_GRIDS + ((GridConfig(cell_size=4, min_events=1, max_clusters=160),) if e == 4096 else ())
    for g in grids:
        ops.reset_launches()
        got = ops.cluster_accum_topk(b.x, b.y, b.t, b.valid, g)
        assert ops.LAUNCHES["cluster_accum"] == 1
        want = ref.cluster_accum_topk_ref(b.x, b.y, b.t, b.valid, g)
        _assert_clusters_within_bound(got, want, b, g, (e, g))
        kw = dict(cell_size=g.cell_size, grid_w=g.grid_w, grid_h=g.grid_h, width=640, height=480)
        rows = ops.cluster_accum(b.x, b.y, b.t, b.valid, **kw)
        plain = ref.cluster_accum_ref(b.x, b.y, b.t, b.valid, **kw)
        for a, p in zip(rows[:3], plain[:3]):
            assert torch.equal(a, p), (e, g)
        bound = ref.sum_t_bound(plain[0], ref.abs_t_rows(b.x, b.y, b.t, b.valid, **kw))
        assert bool(((rows[3].double() - plain[3].double()).abs() <= bound).all()), (e, g)
    _assert_patch_metrics_any_slots(b, e)


def _assert_patch_metrics_any_slots(b, e, slots=None):
    """K3 at K = 32 and 160, with ``edge_slot_clusters`` and with every
    slot of every window valid (``full_slot_clusters``, the case whose
    slots the large path runs side by side), or with ``slots(b, k)``: one
    launch, against the plain version; on the large path the same to the
    bit at 1, 7 and 32 slots a CTA."""
    from repro_torch.data.adversarial import full_slot_clusters
    from repro_torch.kernels import patch_metrics as _pm

    if slots is None:
        slots = lambda b, k: (edge_slot_clusters(b, k), full_slot_clusters(b, k))  # noqa: E731
    for k in (32, 160):
        for cl in slots(b, k):
            ops.reset_launches()
            got = ops.patch_metrics(b, cl)
            assert ops.LAUNCHES["patch_metrics"] == 1
            _assert_metrics_close(got, ref.patch_metrics_stage_ref(b, cl, width=640, height=480), (e, k))
            if e > 1024 or k > 128:
                for group in (1, 7, 32):
                    other = _pm._launch(b, cl, 640, 480, group)
                    assert all(torch.equal(other[m], got[m]) for m in got), (e, k, group)


@pytest.mark.cuda
def test_patch_metrics_past_shared_memory(cuda_dev):
    """K3 at E = 70,000: past 65,535 events its patch tables are 32-bit and
    the row index and events lie in per-CTA device scratch."""
    from repro_torch.data.adversarial import large_windows, stacked_batch
    from repro_torch.kernels import patch_metrics as _pm

    b = stacked_batch(large_windows(70_000, n_windows=2), cuda_dev)
    _assert_patch_metrics_any_slots(b, 70_000)
    assert _pm._fns["scratch"](2, 70_000, 32, 640, 480, 0) > 0


@pytest.mark.cuda
def test_patch_metrics_pixel_count_squared_past_int32(cuda_dev):
    """K3 on a window whose hottest pixel holds 48,000 events: its count
    squared passes 2^31, and the moments still equal the plain version's."""
    from repro_torch.data.adversarial import hot_pixel_window, stacked_batch

    b = stacked_batch([hot_pixel_window(50_000, 48_000)], cuda_dev)

    def slots(b, k):
        cl = ref.cluster_accum_topk_ref(b.x, b.y, b.t, b.valid, GridConfig(min_events=1, max_clusters=k))
        assert int(cl.count.max()) >= 48_000  # a valid slot holds the hot pixel
        return (cl,)

    _assert_patch_metrics_any_slots(b, 50_000, slots)


@pytest.mark.cuda
def test_sum_t_past_two_to_the_24(cuda_dev):
    """One cell of many events near t = 100,000 us: K2 sums t exactly in
    int64 and rounds once, so its sum_t and centroid_t equal the exact
    sum rounded to float32 (and divided in float32), and stay within the
    stated bound of the plain version's float32 scatter."""
    from repro_torch.data.adversarial import sum_t_window, stacked_batch

    b = stacked_batch([sum_t_window()], cuda_dev)
    g = GridConfig(min_events=1)
    kw = dict(cell_size=16, grid_w=g.grid_w, grid_h=g.grid_h, width=640, height=480)
    rows = ops.cluster_accum(b.x, b.y, b.t, b.valid, **kw)
    exact = ref.abs_t_rows(b.x, b.y, b.t, b.valid, **kw)  # t >= 0: the exact sums
    assert int(exact.max()) > 2 ** 24
    assert torch.equal(rows[3], exact.float())
    plain = ref.cluster_accum_ref(b.x, b.y, b.t, b.valid, **kw)
    assert bool(((rows[3].double() - plain[3].double()).abs() <= ref.sum_t_bound(plain[0], exact)).all())
    got = ops.cluster_accum_topk(b.x, b.y, b.t, b.valid, g)
    want = ref.cluster_accum_topk_ref(b.x, b.y, b.t, b.valid, g)
    _assert_clusters_within_bound(got, want, b, g, "sum_t window")
    cell = (got.cell_y * g.grid_w + got.cell_x).clamp_min(0).long()
    n = got.count.float().clamp_min(1)
    once = exact.gather(-1, cell).float() / n
    assert torch.equal(got.centroid_t[got.valid], once[got.valid])


@pytest.mark.cuda
def test_stage_kernels_empty_block_launches_nothing(cuda_dev):
    from repro_torch.core.events import EventBatch

    z = torch.zeros((0, 256), dtype=torch.int32, device=cuda_dev)
    b = EventBatch(z, z, z, z, z.bool())
    ops.reset_launches()
    cl = ops.cluster_accum_topk(b.x, b.y, b.t, b.valid, GridConfig())
    mets = ops.patch_metrics(b, cl)
    assert sum(ops.LAUNCHES.values()) == 0
    assert cl.count.shape == (0, 32) and all(m.shape == (0, 32) for m in mets.values())


def _range_kernels(prof, names):
    """For each ``record_function`` range in ``names``, the device work
    (kernels, copies, fills) launched in each of its occurrences: the
    runtime calls among its descendants that put work on the device. The
    profiler links a kernel to the aten op that launched it, so a kernel
    a ctypes library launches is counted by its runtime call."""
    from torch.autograd import DeviceType

    calls = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset", "cudaGraphLaunch")

    def launched(e):
        return e.name.startswith(calls) + sum(launched(c) for c in e.cpu_children)

    out = {n: [] for n in names}
    for e in prof.events():
        if e.name in out and e.device_type == DeviceType.CPU:
            out[e.name].append(launched(e))
    return out


@pytest.mark.cuda
def test_float_stages_one_launch_per_block(cuda_dev):
    """On the float kernel route each block of windows makes exactly one
    device launch in its "clustering" range and one in "metrics": by the
    launch counters and by the profiler, in the scan and in the fleet."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.pipeline import FleetPipeline, PipelineConfig, run_recording_scan
    from repro_torch.core.pipeline import window_core as S
    from repro_torch.data.synthetic import make_recording

    cfg = PipelineConfig(use_kernels=True, metrics_impl="kernel")
    rec = make_recording(seed=11, duration_s=1.0, n_rsos=4, noise_rate_hz=20_000)
    block = S.WINDOW_BLOCK
    S.WINDOW_BLOCK = 16  # several blocks from a short recording
    try:
        run_recording_scan(rec, cfg, device=cuda_dev)
        ops.reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            scan = run_recording_scan(rec, cfg, with_tracking=False, device=cuda_dev)
            torch.cuda.synchronize()
    finally:
        S.WINDOW_BLOCK = block
    n_blocks = -(-scan.num_windows // 16)
    assert ops.LAUNCHES["cluster_accum"] == ops.LAUNCHES["patch_metrics"] == n_blocks > 1
    counts = _range_kernels(prof, ("clustering", "metrics"))
    assert counts == {"clustering": [1] * n_blocks, "metrics": [1] * n_blocks}, counts

    recs = [make_recording(seed=20 + s, duration_s=0.5, n_rsos=1 + s % 2) for s in range(4)]
    rounds = _fleet_rounds(recs)
    fp = FleetPipeline(cfg, n_sensors=4, device=cuda_dev)
    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        steps = sum(fp.feed(r).total_windows > 0 for r in rounds)
        torch.cuda.synchronize()
    assert ops.LAUNCHES["cluster_accum"] == ops.LAUNCHES["patch_metrics"] == steps > 0
    counts = _range_kernels(prof, ("clustering", "metrics"))
    assert counts == {"clustering": [1] * steps, "metrics": [1] * steps}, counts


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["float", "fixed"])
def test_main_path_on_card_equals_cpu(cuda_dev, path):
    from repro_torch.core.pipeline import PipelineConfig, evaluate_detection, run_recording_scan
    from repro_torch.data.synthetic import make_recording

    rec = make_recording(seed=7, duration_s=0.6)
    if path == "float":
        cfg, own = PipelineConfig(use_kernels=True, metrics_impl="kernel"), ("cluster_accum", "patch_metrics")
    else:
        cfg, own = PipelineConfig(numerics="fixed", metrics_impl="megakernel"), ("window_pipeline",)
    ops.reset_launches()
    gpu = run_recording_scan(rec, cfg, device=cuda_dev)
    assert all((n > 0) == (k in own) for k, n in ops.LAUNCHES.items()), ops.LAUNCHES
    cpu = run_recording_scan(rec, cfg, device="cpu")
    for f in Clusters._fields:
        assert torch.equal(getattr(gpu.clusters, f).cpu(), getattr(cpu.clusters, f)), f
    for m in EXACT:
        assert torch.equal(gpu.metrics[m].cpu(), cpu.metrics[m]), m
    for f in ("hits", "misses", "age", "active"):
        assert torch.equal(getattr(gpu.tracks, f).cpu(), getattr(cpu.tracks, f)), f
    assert evaluate_detection(rec, cfg, device=cuda_dev) == evaluate_detection(rec, cfg, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["float", "fixed"])
def test_loop_driver_and_sweep_on_card(cuda_dev, path):
    """The loop driver on the card equals its scan window for window, with
    one launch of each path kernel a window; the sweep's scores on the card
    equal the CPU run's with both drivers."""
    from repro_torch.core.pipeline import (
        PipelineConfig, run_recording, run_recording_scan, threshold_sweep,
    )
    from repro_torch.data.synthetic import make_recording

    if path == "float":
        cfg, own = PipelineConfig(use_kernels=True, metrics_impl="kernel"), ("cluster_accum", "patch_metrics")
    else:
        cfg, own = PipelineConfig(numerics="fixed", metrics_impl="megakernel"), ("window_pipeline",)
    rec = make_recording(seed=9, duration_s=0.6, n_rsos=2)
    ops.reset_launches()
    loop = run_recording(rec, cfg, device=cuda_dev)
    assert ops.LAUNCHES == {k: (len(loop) if k in own else 0) for k in ops.LAUNCHES}, ops.LAUNCHES
    scan = run_recording_scan(rec, cfg, device=cuda_dev)
    assert len(loop) == scan.num_windows > 0
    for a, b in zip(loop, scan.window_results()):
        for f in Clusters._fields:
            assert torch.equal(getattr(a.clusters, f), getattr(b.clusters, f)), f
        for k in a.metrics:
            np.testing.assert_array_equal(a.metrics[k], b.metrics[k], err_msg=k)
        for f in a.tracks._fields:
            assert torch.equal(getattr(a.tracks, f), getattr(b.tracks, f)), f
    recs = [make_recording(seed=s, duration_s=0.5, n_rsos=1 + s % 3) for s in (1, 2, 3)]
    score = lambda sw: {t: (v.tp, v.fp, v.fn, v.tn) for t, v in sw.items()}  # noqa: E731
    want = score(threshold_sweep(recs, config=cfg, device="cpu"))
    for driver in ("scan", "fleet"):
        assert score(threshold_sweep(recs, config=cfg, driver=driver, device=cuda_dev)) == want, driver


@pytest.mark.cuda
@pytest.mark.parametrize("cell_size", [16, 12])
def test_window_pipeline_kernel_matches_plain(cuda_dev, cell_size):
    from repro_torch.core.pipeline import PipelineConfig
    from repro_torch.data.adversarial import (
        adversarial_batch, clustered_window, named_windows, stacked_batch,
    )

    cfg = PipelineConfig(numerics="fixed", metrics_impl="megakernel",
                         grid=GridConfig(cell_size=cell_size))
    batches = [
        adversarial_batch(cuda_dev),
        stacked_batch(list(named_windows().values()), cuda_dev),
        stacked_batch([clustered_window(s) for s in range(4)], cuda_dev),
        stacked_batch([clustered_window(s, n=1000, capacity=1024) for s in range(2)], cuda_dev),
    ]
    for b in batches:
        before = ops.LAUNCHES["window_pipeline"]
        fc, mets, surf = ops.window_pipeline(b, cfg)
        assert ops.LAUNCHES["window_pipeline"] == before + 1
        rfc, rmets, rsurf = ref.window_pipeline_ref(b, cfg)
        for f in fc._fields:
            assert torch.equal(getattr(fc, f), getattr(rfc, f)), f
        for m in mets:
            assert torch.equal(mets[m].view(torch.int32), rmets[m].view(torch.int32)), m
        assert torch.equal(surf["norm_i"], rsurf["norm_i"])
        for k in surf:
            if k != "norm_i":
                assert torch.equal(surf[k][fc.valid], rsurf[k][fc.valid]), k


@pytest.mark.cuda
def test_window_pipeline_empty_block_counts_no_launch(cuda_dev):
    from repro_torch.core.events import EventBatch
    from repro_torch.core.pipeline import PipelineConfig

    cfg = PipelineConfig(numerics="fixed", metrics_impl="megakernel")
    z = torch.zeros((0, 256), dtype=torch.int32, device=cuda_dev)
    b = EventBatch(z, z, z, z, z.bool())
    before = ops.LAUNCHES["window_pipeline"]
    fc, mets, surf = ops.window_pipeline(b, cfg)
    assert ops.LAUNCHES["window_pipeline"] == before
    assert fc.count.shape == (0, cfg.grid.max_clusters) and surf["norm_i"].shape == (0,)


def _assert_fixed_equal(got, want):
    (fc, mets, surf), (rfc, rmets, rsurf) = got, want
    for f in fc._fields:
        assert torch.equal(getattr(fc, f), getattr(rfc, f)), f
    for m in mets:
        assert torch.equal(mets[m].view(torch.int32), rmets[m].view(torch.int32)), m
    assert torch.equal(surf["norm_i"], rsurf["norm_i"])
    for k in surf:
        if k != "norm_i":
            assert torch.equal(surf[k][fc.valid], rsurf[k][fc.valid]), k


def _wide_windows(width, height, scale_x, scale_y, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        n = 200
        x = rng.integers(0, 3000, n) * scale_x % width
        y = rng.integers(0, 2000, n) * scale_y % height
        out.append((np.pad(x, (0, 56)), np.pad(y, (0, 56)), np.pad(np.arange(n), (0, 56)),
                    np.pad(np.ones(n, bool), (0, 56))))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "cell 16", "cell 12, min_events 1", "cell 16, min_events 0", "cell 7, hot_pixel_max 0",
    "cell 16, hot_pixel_max 1000", "64-bit keys", "128-bit keys", "clipped grid"])
def test_window_pipeline_kernel_runs_ties_and_key_widths(cuda_dev, case):
    """The redesigned megakernel against its plain version on windows
    that stress its pixel and cell runs and its slot prefix
    (``run_and_tie_windows``), at other cells, thresholds and hot-pixel
    limits, with the 64- and 128-bit sort keys of wide sensors, and on a
    grid smaller than the sensor (whole-pixel keys)."""
    import dataclasses

    from repro_torch.core.pipeline import PipelineConfig
    from repro_torch.data.adversarial import run_and_tie_windows, stacked_batch

    cfg = PipelineConfig(numerics="fixed", metrics_impl="megakernel")
    grid = dict(cell_size=16)
    if case == "clipped grid":  # a grid smaller than the sensor: whole-pixel keys
        from repro_torch.data.adversarial import ClippedGrid

        cfg = dataclasses.replace(cfg, grid=ClippedGrid())
        b = stacked_batch(run_and_tie_windows(), cuda_dev)
        _assert_fixed_equal(ops.window_pipeline(b, cfg), ref.window_pipeline_ref(b, cfg))
        return
    if case == "64-bit keys":  # 2,560 x 30 cells of 16 px: 17 + 8 + 8 key bits
        grid, roi, wins = dict(width=40960), (0, 0, 40960, 480), _wide_windows(40960, 480, 64, 1)
    elif case == "128-bit keys":  # cells of 2^28 px: 2 + 56 + 8 key bits
        grid = dict(width=2**29, height=2**29, cell_size=2**28, min_events=1, max_clusters=4)
        roi, wins = (0, 0, 2**29, 2**29), _wide_windows(2**29, 2**29, 9, 5)
    else:
        for part in case.split(", "):
            key, val = part.rsplit(" ", 1)
            if key == "cell":
                grid["cell_size"] = int(val)
            elif key == "min_events":
                grid["min_events"] = int(val)
            else:
                cfg = dataclasses.replace(cfg, hot_pixel_max=int(val))
        roi, wins = cfg.roi, run_and_tie_windows()
    cfg = dataclasses.replace(cfg, roi=roi, grid=GridConfig(**grid))
    b = stacked_batch(wins, cuda_dev)
    before = ops.LAUNCHES["window_pipeline"]
    got = ops.window_pipeline(b, cfg)
    assert ops.LAUNCHES["window_pipeline"] == before + 1
    _assert_fixed_equal(got, ref.window_pipeline_ref(b, cfg))


def _wire_on(wire, dev):
    from repro_torch.core.events import wire_tensors

    return wire_tensors(wire, dev)


@pytest.mark.cuda
def test_event_unpack_kernel_matches_plain(cuda_dev):
    from repro_torch.data.adversarial import adversarial_wires, dual_bounds3, fleet_wire, wire_stream

    cases = dict(adversarial_wires())
    streams = [wire_stream(40 + s, n=900) for s in range(16)]
    cases["16-sensor round"] = (fleet_wire([(*st, dual_bounds3(st[2])[:3]) for st in streams], 256), 256)
    for name, (wire, cap) in cases.items():
        args = _wire_on(wire, cuda_dev)
        before = ops.LAUNCHES["event_unpack"]
        packed, valid = ops.event_unpack(*args, cap)
        assert ops.LAUNCHES["event_unpack"] == before + 1, name
        rp, rv = ref.unpack_wire_ref(*args, cap)
        assert torch.equal(packed, rp), name
        assert torch.equal(valid, rv), name


@pytest.mark.cuda
def test_event_unpack_kernel_overlay_one_launch_per_decode(cuda_dev):
    """Every wire case, spills out of position order, two entries on one
    slot and rows reaching past the wire included: one launch per decode,
    equal to the plain version run on the CPU (where of two entries on
    one slot the later wins)."""
    from repro_torch.data.adversarial import adversarial_wires, overlay_wires

    for name, (wire, cap) in {**adversarial_wires(), **overlay_wires()}.items():
        before = ops.LAUNCHES["event_unpack"]
        packed, valid = ops.event_unpack(*_wire_on(wire, cuda_dev), cap)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["event_unpack"] == before + 1, name
        rp, rv = ref.unpack_wire_ref(*_wire_on(wire, "cpu"), cap)
        assert torch.equal(packed.cpu(), rp), name
        assert torch.equal(valid.cpu(), rv), name


@pytest.mark.cuda
def test_event_unpack_empty_wire_launches_nothing(cuda_dev):
    from repro_torch.core.events import SPILL_SENTINEL

    z = np.zeros(32, np.uint32)
    spill = np.full((5, 8), SPILL_SENTINEL, np.int32)
    for offsets, cap in ((np.zeros((3, 1), np.int32), 256), (np.zeros((1, 4), np.int32), 0)):
        before = ops.LAUNCHES["event_unpack"]
        packed, valid = ops.event_unpack(*_wire_on((z, z.astype(np.uint16), z[:1], offsets, spill), cuda_dev), cap)
        assert ops.LAUNCHES["event_unpack"] == before
        s, w = offsets.shape[0], offsets.shape[1] - 1
        assert packed.shape == (4, s, w, cap) and valid.shape == (s, w, cap)


@pytest.mark.cuda
@pytest.mark.parametrize("cell_size", [16, 12, 1, 7])
def test_grid_quantize_kernel_matches_plain(cuda_dev, cell_size):
    rng = np.random.default_rng(cell_size)
    for n in (1, 127, 128, 1024, 1025, 40_961):
        w = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        w[0] = 0xFFFFFFFF
        words = torch.from_numpy(w.view(np.int32)).to(cuda_dev)
        before = ops.LAUNCHES["grid_quantize_packed"]
        got = ops.grid_quantize_packed(words, cell_size)
        assert ops.LAUNCHES["grid_quantize_packed"] == before + 1
        assert torch.equal(got, ref.grid_quantize_packed_ref(words, cell_size)), n


@pytest.mark.cuda
def test_window_entropy_kernel_matches_plain(cuda_dev):
    from repro_torch.data.adversarial import entropy_frame

    frame, cx, cy = entropy_frame()
    for f in (frame, np.zeros_like(frame)):
        args = [torch.from_numpy(a).to(cuda_dev) for a in (f, cx, cy)]
        before = ops.LAUNCHES["window_entropy"]
        got = ops.window_entropy(*args)
        assert ops.LAUNCHES["window_entropy"] == before + 1
        torch.testing.assert_close(got, ref.window_entropy_ref(*args), rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [0, 1, 8192])
def test_window_entropy_kernel_at_k(cuda_dev, k):
    """K = 0 (no launch), one centre (the wide path) and the K = 8,192
    probe (the warp path) against the plain version, one launch a call."""
    from repro_torch.data.adversarial import entropy_frame, entropy_probe_centres

    frame = entropy_frame()[0]
    cx, cy = entropy_probe_centres(k)
    args = [torch.from_numpy(a).to(cuda_dev) for a in (frame, cx, cy)]
    before = ops.LAUNCHES["window_entropy"]
    got = ops.window_entropy(*args)
    assert ops.LAUNCHES["window_entropy"] == before + (k > 0)
    assert got.shape == (3, k)
    torch.testing.assert_close(got, ref.window_entropy_ref(*args), rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [32, 8192])
def test_window_entropy_paths_agree(cuda_dev, k):
    """The wide path (a CTA a centre) and the warp path (a warp a centre)
    give the same outputs on the same centres, whichever the launch would
    choose, and both the plain version's."""
    from repro_torch.data.adversarial import entropy_frame, entropy_probe_centres
    from repro_torch.kernels import window_entropy as _we

    frame, cx, cy = entropy_frame()
    if k != len(cx):
        cx, cy = entropy_probe_centres(k)
    args = [torch.from_numpy(a).to(cuda_dev) for a in (frame, cx, cy)]
    assert _we.plan(32, cuda_dev) == "wide" and _we.plan(8192, cuda_dev) == "warp"
    wide = _we._launch(*args, "wide")
    warp = _we._launch(*args, "warp")
    torch.testing.assert_close(wide, warp, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(wide, ref.window_entropy_ref(*args), rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(_we.window_entropy(*args), wide if k == 32 else warp, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["wide", "warp"])
def test_window_entropy_paths_on_any_frame(cuda_dev, path):
    """A frame 637 wide and one whose base is not 16-byte aligned: both
    paths read any row stride and any origin, against the plain version."""
    from repro_torch.data.adversarial import entropy_frame, entropy_probe_centres
    from repro_torch.kernels import window_entropy as _we

    frame = torch.from_numpy(entropy_frame()[0]).to(cuda_dev)
    cx, cy = (torch.from_numpy(a).to(cuda_dev) for a in entropy_probe_centres(1000, w=637))
    narrow = frame[:, :637].contiguous()
    shifted = torch.cat([frame.new_zeros(1), frame.flatten()])[1:].view(frame.shape)
    assert shifted.data_ptr() % 16 == 4
    for f in (narrow, shifted):
        got = _we._launch(f, cx, cy, path)
        torch.testing.assert_close(got, ref.window_entropy_ref(f, cx, cy), rtol=1e-5, atol=1e-7)


def _fleet_rounds(recs, chunk_us=20_000):
    from repro_torch.data.evas import iter_chunks

    per = [list(iter_chunks(r, chunk_us)) for r in recs]
    return [[c[i] if i < len(c) else None for c in per] for i in range(max(map(len, per)))]


def _assert_parts_equal(got, want):
    for f in got.clusters._fields:
        assert torch.equal(getattr(got.clusters, f).cpu(), getattr(want.clusters, f).cpu()), f
    for m in want.metrics:
        assert torch.equal(got.metrics[m].cpu(), want.metrics[m].cpu()), m
    for f in want.tracks._fields:
        assert torch.equal(getattr(got.tracks, f).cpu(), getattr(want.tracks, f).cpu()), f


@pytest.mark.cuda
def test_fleet_async_equals_sync_and_scan_on_card(cuda_dev):
    from repro_torch.core.pipeline import FleetPipeline, PipelineConfig, run_recording_scan
    from repro_torch.data.synthetic import make_recording

    cfg = PipelineConfig(use_kernels=True, metrics_impl="kernel")
    recs = [make_recording(seed=20 + s, duration_s=0.5, n_rsos=1 + s % 2) for s in range(4)]
    rounds = _fleet_rounds(recs)
    ops.reset_launches()
    fp = FleetPipeline(cfg, n_sensors=4, device=cuda_dev)
    sync = [fp.feed(r) for r in rounds] + [fp.flush()]
    assert all(ops.LAUNCHES[k] > 0 for k in ("event_unpack", "cluster_accum", "patch_metrics"))
    fa = FleetPipeline(cfg, n_sensors=4, staging_depth=2, device=cuda_dev)
    pend = [fa.feed_async(r) for r in rounds] + [fa.feed_async([None] * 4, final=True)]
    got = [p.wait() for p in pend]
    for s, rec in enumerate(recs):
        scan = run_recording_scan(rec, cfg, device=cuda_dev)
        for a, b in zip(got, sync):
            _assert_parts_equal(a.sensor(s), b.sensor(s))
        parts = [b.sensor(s) for b in sync]
        for f in scan.clusters._fields:
            cat = torch.cat([getattr(p.clusters, f) for p in parts])
            assert torch.equal(cat, getattr(scan.clusters, f).cpu()), f
        for f in scan.final_tracks._fields:
            assert torch.equal(getattr(parts[-1].final_tracks, f), getattr(scan.final_tracks, f).cpu()), f


@pytest.mark.cuda
def test_fleet_on_a_four_entry_mesh_of_the_card_equals_unsharded(cuda_dev):
    """The fleet sharded over a 4-entry ``sensor`` mesh of the one card
    (four blocks, each its own tensors) equals the unsharded fleet on the
    card every round, to the bit; every kernel of the path launches once a
    block a round, and the carry stays sharded."""
    from repro_torch.core.pipeline import FleetPipeline, PipelineConfig
    from repro_torch.data.synthetic import make_recording
    from repro_torch.launch.mesh import make_mesh

    cfg = PipelineConfig(use_kernels=True, metrics_impl="kernel")
    recs = [make_recording(seed=20 + s, duration_s=0.3, n_rsos=1 + s % 2) for s in range(8)]
    rounds = _fleet_rounds(recs)
    mesh = make_mesh((4,), ("sensor",), devices=[cuda_dev] * 4)
    plain = FleetPipeline(cfg, n_sensors=8, device=cuda_dev)
    sharded = FleetPipeline(cfg, n_sensors=8, mesh=mesh)
    want = [plain.feed(r) for r in rounds] + [plain.flush()]
    ops.reset_launches()
    got = [sharded.feed(r) for r in rounds] + [sharded.flush()]
    steps = sum(1 for g in got if g.clusters is not None)
    for k in ("event_unpack", "cluster_accum", "patch_metrics"):
        assert ops.LAUNCHES[k] == 4 * steps, (k, ops.LAUNCHES, steps)
    assert sharded.state.atlas.spec == ("sensor",)
    for a, b in zip(got, want):
        for s in range(8):
            if b.sensor(s).num_windows:
                _assert_parts_equal(a.sensor(s), b.sensor(s))
        if b.final_tracks is not None:
            for f, u, v in zip(b.final_tracks._fields, a.final_tracks, b.final_tracks):
                assert torch.equal(u.full(), v), f


@pytest.mark.cuda
def test_stream_ragged_equals_scan_on_card(cuda_dev):
    """The live stream over the ragged wire on the card (decoded by the
    ``event_unpack`` kernel) equals the scan of the same recording on the
    card, every field, per-window tracks and the final carry included."""
    from repro_torch.core.pipeline import PipelineConfig, StreamingPipeline, run_recording_scan
    from repro_torch.data.evas import iter_chunks
    from repro_torch.data.synthetic import make_recording

    cfg = PipelineConfig(use_kernels=True, metrics_impl="kernel")
    rec = make_recording(seed=11, duration_s=1.0, n_rsos=4, noise_rate_hz=20_000)
    ops.reset_launches()
    sp = StreamingPipeline(cfg, wire="ragged", device=cuda_dev)
    parts = [sp.feed(*c) for c in iter_chunks(rec, 20_000)] + [sp.flush()]
    assert all(ops.LAUNCHES[k] > 0 for k in ("event_unpack", "cluster_accum", "patch_metrics"))
    scan = run_recording_scan(rec, cfg, device=cuda_dev)
    assert sum(p.num_windows for p in parts) == scan.num_windows
    whole = lambda get: torch.cat([get(p) for p in parts])  # noqa: E731
    for f in scan.clusters._fields:
        assert torch.equal(whole(lambda p: getattr(p.clusters, f)), getattr(scan.clusters, f)), f
    for m in scan.metrics:
        assert torch.equal(whole(lambda p: p.metrics[m]), scan.metrics[m]), m
    for f in scan.tracks._fields:
        assert torch.equal(whole(lambda p: getattr(p.tracks, f)), getattr(scan.tracks, f)), f
        assert torch.equal(getattr(parts[-1].final_tracks, f), getattr(scan.final_tracks, f)), f


def _served_parts(svc, chunks_by_name, rounds, detach_at=None):
    """Drive ``svc``: one chunk per live session a round, a forced pump,
    detach of ``detach_at`` = (round, name), then every session's
    detach. Returns {name: parts} and {name: the chunks it was fed}."""
    sids = {n: svc.attach(n) for n in chunks_by_name}
    parts = {n: [] for n in chunks_by_name}
    fed = {n: [] for n in chunks_by_name}
    by_sid = {sid: n for n, sid in sids.items()}
    for r in range(rounds):
        if detach_at is not None and r == detach_at[0]:
            n = detach_at[1]
            parts[n].append(svc.detach(sids.pop(n)))
        for n, sid in sids.items():
            if r < len(chunks_by_name[n]):
                fed[n].append(chunks_by_name[n][r])
                for fd in svc.feed(sid, *chunks_by_name[n][r]):
                    parts[by_sid[fd.sid]].append(fd.result)
        for fd in svc.pump(force=True):
            parts[by_sid[fd.sid]].append(fd.result)
    for n, sid in sids.items():
        parts[n].append(svc.detach(sid))
    return parts, fed


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["float", "fixed"])
def test_service_on_card_equals_streams_and_cpu(cuda_dev, path):
    """Five scenario-family sessions through ``DetectionService`` on the
    card (tiers 2, 4, 8: two promotions; one detach mid-run): every
    session equals a dedicated stream on the card to the bit and the same
    service on the CPU (integers exact, metrics rtol = atol = 1e-5,
    tracker floats rtol 1e-6, atol 1e-4); the path's kernels launched, no
    retry and no degraded round."""
    from repro_torch.core.pipeline import PipelineConfig, StreamingPipeline
    from repro_torch.data.evas import iter_chunks
    from repro_torch.data.synthetic import make_fleet_recordings
    from repro_torch.serve import DetectionService

    cfg = (PipelineConfig(use_kernels=True, metrics_impl="kernel") if path == "float"
           else PipelineConfig(numerics="fixed", metrics_impl="megakernel"))
    own = ("event_unpack", "cluster_accum", "patch_metrics") if path == "float" else ("window_pipeline",)
    recs = make_fleet_recordings(5, duration_s=0.5)
    chunks = {r.name: list(iter_chunks(r, 20_000)) for r in recs}
    ops.reset_launches()
    svc = DetectionService(cfg, tiers=(2, 4, 8), device=cuda_dev)
    gpu, fed = _served_parts(svc, chunks, 26, detach_at=(12, recs[1].name))
    torch.cuda.synchronize()
    assert all(ops.LAUNCHES[k] > 0 for k in own), ops.LAUNCHES
    assert svc.promotions == 2 and svc.step_retries == 0 and svc.degraded_rounds == 0
    cpu, _ = _served_parts(DetectionService(cfg, tiers=(2, 4, 8), device="cpu"), chunks, 26,
                           detach_at=(12, recs[1].name))
    for name, parts in gpu.items():
        sp = StreamingPipeline(cfg, device=cuda_dev)
        want = [sp.feed(*c) for c in fed[name]] + [sp.flush()]
        for group in ("clusters", "tracks"):
            for f in getattr(want[0], group)._fields:
                got_f = torch.cat([getattr(getattr(p, group), f).cpu() for p in parts])
                assert torch.equal(got_f, torch.cat([getattr(getattr(p, group), f).cpu() for p in want])), f
                cpu_f = torch.cat([getattr(getattr(p, group), f) for p in cpu[name]])
                if got_f.is_floating_point() and group == "tracks":
                    torch.testing.assert_close(got_f, cpu_f, rtol=1e-6, atol=1e-4)
                else:
                    assert torch.equal(got_f, cpu_f), (name, f)
        for m in want[0].metrics:
            got_m = torch.cat([p.metrics[m].cpu() for p in parts])
            assert torch.equal(got_m, torch.cat([p.metrics[m].cpu() for p in want])), m
            cpu_m = torch.cat([p.metrics[m] for p in cpu[name]])
            if m in EXACT:
                assert torch.equal(got_m, cpu_m), m
            else:
                torch.testing.assert_close(got_m, cpu_m, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_baselines_and_quantize_packed_on_card(cuda_dev):
    """DBSCAN's labels, core mask and cluster count on the card equal the
    CPU's exactly (n = 64 to 4096); k-means' assignments and counts too,
    centroids within rtol 1e-6; ``quantize_packed`` on CUDA tensors equals
    the ``grid_quantize_packed`` kernel bit for bit."""
    from repro_torch.core.baselines import dbscan, kmeans
    from repro_torch.core.grid_clustering import quantize_packed

    for n in (64, 512, 4096):
        rng = np.random.default_rng(n)
        args = (rng.integers(0, 640, n), rng.integers(0, 480, n), np.arange(n), np.zeros(n, np.int32), n)
        bg, bc = TE.batch_from_arrays(*args, device=cuda_dev), TE.batch_from_arrays(*args, device="cpu")
        g, c = dbscan(bg, eps=8.0, min_pts=5), dbscan(bc, eps=8.0, min_pts=5)
        assert torch.equal(g.labels.cpu(), c.labels) and torch.equal(g.core_mask.cpu(), c.core_mask)
        assert int(g.n_clusters) == int(c.n_clusters)
        g, c = kmeans(bg, k=8, iters=16), kmeans(bc, k=8, iters=16)
        assert torch.equal(g.assignment.cpu(), c.assignment) and torch.equal(g.counts.cpu(), c.counts)
        torch.testing.assert_close(g.centroids.cpu(), c.centroids, rtol=1e-6, atol=0.0)
    rng = np.random.default_rng(3)
    words = TE.pack_words(torch.as_tensor(rng.integers(0, 1 << 16, 1 << 20)),
                          torch.as_tensor(rng.integers(0, 1 << 16, 1 << 20))).to(cuda_dev)
    for cell in (16, 12):
        before = ops.LAUNCHES["grid_quantize_packed"]
        k1 = ops.grid_quantize_packed(words.to(torch.int32), cell)
        assert ops.LAUNCHES["grid_quantize_packed"] == before + 1
        assert torch.equal(k1.to(torch.int64) & 0xFFFFFFFF, quantize_packed(words, cell))


def _chaos_report(rep) -> dict:
    """A chaos report's deterministic fields (all but the wall times;
    error records by kind, session id and fake-clock time)."""
    d = {k: getattr(rep, k) for k in (
        "rounds", "fired", "quarantines", "evictions", "degraded_rounds", "step_retries",
        "demotions", "healthy_windows", "shed", "escaped_errors", "bit_identical")}
    d["errors"] = [(e.kind, e.sid, e.time_s) for e in rep.errors]
    return d


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["float", "fixed"])
def test_chaos_cut_on_card_equals_cpu(cuda_dev, path):
    """The cut of ``chip_smoke.py`` phase 7a (5 sensors, 4 of them faulty,
    32 rounds, tiers 4 and 8, 400-event chunks, 6000-event bursts) on the
    card and on the CPU: equal reports, the invariants, and the healthy
    session's outputs equal (integers exactly, metrics to rtol = atol =
    1e-5, tracker floats rtol 1e-6, atol 1e-4); the path's kernels ran."""
    from repro_torch.core.pipeline import PipelineConfig
    from repro_torch.serve.chaos import ChaosConfig, ChaosHarness, concat_outputs

    cfg = (PipelineConfig(use_kernels=True, metrics_impl="kernel") if path == "float"
           else PipelineConfig(numerics="fixed", metrics_impl="megakernel"))
    own = ("event_unpack", "cluster_accum", "patch_metrics") if path == "float" else ("window_pipeline",)
    cut = ChaosConfig(n_sensors=5, n_faulty=4, n_rounds=32, seed=7, chunk_events=400,
                      burst_events=6000, queue_budget_events=3200, tiers=(4, 8))

    class Keep(ChaosHarness):
        def _run_faulted(self):
            self.faulted = super()._run_faulted()
            return self.faulted

    ops.reset_launches()
    gpu = Keep(cut, cfg, device=cuda_dev)
    g = gpu.run()
    torch.cuda.synchronize()
    assert all(ops.LAUNCHES[k] > 0 for k in own), ops.LAUNCHES
    cpu = Keep(cut, cfg, device="cpu")
    c = cpu.run()
    assert g.bit_identical and g.escaped_errors == [] and g.shed["exact"], g.mismatches
    assert _chaos_report(g) == _chaos_report(c)
    for sid, parts in gpu.faulted["healthy_parts"].items():
        got = concat_outputs(parts)
        want = concat_outputs(cpu.faulted["healthy_parts"][sid])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            if np.issubdtype(a.dtype, np.floating):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)
            else:
                np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["float", "fixed"])
def test_exchange_push_leaves_the_device_busy(cuda_dev, path):
    """A constellation pump on the card, exchange push included, does not
    synchronize: with the stream held busy by a spin kernel, the round is
    dispatched and its summary plane published, and the stream's work is
    still unfinished right after ``pump`` returns. On the fixed path the
    wire is decoded by the plain route, which must not wait either."""
    from repro_torch.core.pipeline import PipelineConfig
    from repro_torch.data.synthetic import make_fleet_recordings
    from repro_torch.data.evas import iter_chunks
    from repro_torch.serve import AdmissionConfig, ConstellationService

    cfg = (PipelineConfig(use_kernels=True, metrics_impl="kernel") if path == "float"
           else PipelineConfig(numerics="fixed", metrics_impl="megakernel"))
    clock = [0.0]
    cs = ConstellationService(cfg, n_shards=2,
                              tiers=(2, 4), admission=AdmissionConfig(max_delay_s=1e9, max_items=1 << 30),
                              devices=[cuda_dev], clock=lambda: clock[0])
    recs = make_fleet_recordings(4, duration_s=0.5)
    feeds = {cs.attach(r.name): iter(list(iter_chunks(r, 20_000))) for r in recs}

    def feed_all():
        clock[0] += 0.02
        for gid, it in feeds.items():
            cs.feed(gid, *next(it))

    for _ in range(4):  # warm-up: staging sets, the caching allocator
        feed_all()
        cs.pump(force=True)
    torch.cuda.synchronize()
    feed_all()
    pushed = cs.exchange.rounds
    torch.cuda._sleep(2_000_000_000)  # about a second of device time
    cs.pump(force=True)
    busy = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    assert cs.exchange.rounds > pushed  # the round was published
    assert busy, "pump or the exchange push synchronized with the device"
    for p in cs.exchange.view().values():
        assert np.isfinite(p).all()


@pytest.mark.cuda
@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
def test_frame_route_equals_event_route_on_card(cuda_dev, use_kernels):
    """The frame oracle (a sensor-sized image a window, its patches sliced
    out) equals the event route on the card bit for bit, every metric,
    per-window track and the final carry, on the quickstart recording."""
    from repro_torch.core.pipeline import PipelineConfig, run_recording_scan
    from repro_torch.data.synthetic import make_recording

    rec = make_recording(seed=7, duration_s=2.0, n_rsos=2)
    ops.reset_launches()
    frame = run_recording_scan(rec, PipelineConfig(use_kernels=use_kernels, metrics_impl="frame"),
                               device=cuda_dev)
    assert (ops.LAUNCHES["cluster_accum"] > 0) == use_kernels and ops.LAUNCHES["patch_metrics"] == 0
    event = run_recording_scan(rec, PipelineConfig(use_kernels=use_kernels), device=cuda_dev)
    assert frame.num_windows == event.num_windows == 100
    for f in frame.clusters._fields:
        assert torch.equal(getattr(frame.clusters, f), getattr(event.clusters, f)), f
    for m in frame.metrics:
        assert torch.equal(frame.metrics[m], event.metrics[m]), m
    for f in frame.tracks._fields:
        assert torch.equal(getattr(frame.tracks, f), getattr(event.tracks, f)), f
        assert torch.equal(getattr(frame.final_tracks, f), getattr(event.final_tracks, f)), f


@pytest.mark.cuda
def test_event_core_atlas_on_card_equals_cpu_across_rollover(cuda_dev):
    """The atlas event core on the card: a ragged stream in 20 ms chunks
    with a forced rollover (``_tag_limit = 4``) writes the CPU stream's
    atlas after every feed; the ``event_unpack`` and ``cluster_accum``
    kernels ran; a tracked core call warns of no host synchronization
    under ``set_sync_debug_mode("warn")``, and the atlas update alone runs
    under ``"error"``."""
    from repro_torch.core.events import pad_windows
    import warnings

    from repro_torch.core.pipeline import PipelineConfig, StreamingPipeline, make_atlas, make_core
    from repro_torch.core.metrics import event_normalizer
    from repro_torch.core.pipeline.event_core import _write_atlas
    from repro_torch.core.pipeline.window_core import _condition
    from repro_torch.core.tracking import init_tracks
    from repro_torch.data.evas import iter_chunks
    from repro_torch.data.synthetic import make_recording

    cfg = PipelineConfig(use_kernels=True)
    rec = make_recording(seed=11, duration_s=0.6, n_rsos=4, noise_rate_hz=20_000)
    gpu = StreamingPipeline(cfg, wire="ragged", device=cuda_dev)
    cpu = StreamingPipeline(cfg, wire="ragged", device="cpu")
    gpu._tag_limit = cpu._tag_limit = 4
    ops.reset_launches()
    rolled = 0
    for c in iter_chunks(rec, 20_000):
        before = gpu.state.next_tag
        gpu.feed(*c)
        cpu.feed(*c)
        rolled += gpu.state.next_tag < before
        assert gpu.state.next_tag == cpu.state.next_tag
        assert torch.equal(gpu.state.atlas.cpu(), cpu.state.atlas)
    gpu.flush()
    cpu.flush()
    assert torch.equal(gpu.state.atlas.cpu(), cpu.state.atlas) and rolled > 2
    assert ops.LAUNCHES["event_unpack"] > 0 and ops.LAUNCHES["cluster_accum"] > 0
    win = pad_windows(rec.x, rec.y, rec.t, rec.p, cfg.batcher, cuda_dev)
    core = make_core(cfg)
    tracks = init_tracks(cfg.tracker, cuda_dev)
    core(win.batch, tracks, make_atlas(cfg, device=cuda_dev), 0)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            core(win.batch, tracks, make_atlas(cfg, device=cuda_dev), 0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message) for w in caught
             if "synchroniz" in str(w.message) and "prototype feature" not in str(w.message)]
    assert not syncs, syncs[:3]
    g = cfg.grid
    batch = _condition(cfg, win.batch)
    c, leader, _, _ = event_normalizer(batch, g.width, g.height)
    atlas = make_atlas(cfg, device=cuda_dev)
    ix = torch.arange(batch.x.shape[0], device=cuda_dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _write_atlas(atlas.view(-1), batch, c, leader, ix, batch.x.shape[0], 0,
                     max(batch.x.shape[-1].bit_length(), 1), atlas.numel(), atlas.shape[-1],
                     g.height)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int((atlas != 0).sum()) > 0


@pytest.mark.cuda
def test_window_entropy_against_frame_oracle_on_real_frames(cuda_dev):
    """``window_entropy`` on reconstructed frames of real windows, at the
    frame route's valid clusters with rounded centres: equal to its plain
    version under rtol 1e-5 (atol 1e-7), and its Shannon and Renyi entropy
    to ``cluster_metrics_frame``'s, its contrast to ``local_contrast`` of
    the same patch, within rtol = atol = 1e-5."""
    from repro_torch.core.events import EventBatch, pad_windows
    from repro_torch.core.pipeline import PipelineConfig
    from repro_torch.core.pipeline.window_core import _cluster, _condition
    from repro_torch.core.pipeline.config import _histogram_fn
    from repro_torch.data.synthetic import make_recording

    cfg = PipelineConfig(use_kernels=True, metrics_impl="frame")
    rec = make_recording(seed=11, duration_s=0.5, n_rsos=4, noise_rate_hz=20_000)
    win = pad_windows(rec.x, rec.y, rec.t, rec.p, cfg.batcher, cuda_dev)
    batch = _condition(cfg, EventBatch(*(a[:16] for a in win.batch)))
    cl = _cluster(cfg, _histogram_fn(cfg), batch)
    mets = TM.cluster_metrics_frame(batch, cl)
    frames = TM.reconstruct_frame(batch)
    checked = 0
    for w in range(frames.shape[0]):
        sel = cl.valid[w]
        if not bool(sel.any()):
            continue
        cx = torch.round(cl.centroid_x[w][sel]).to(torch.int32).contiguous()
        cy = torch.round(cl.centroid_y[w][sel]).to(torch.int32).contiguous()
        f = frames[w].contiguous()
        got = ops.window_entropy(f, cx, cy)
        torch.testing.assert_close(got, ref.window_entropy_ref(f, cx, cy), rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(got[0], mets["shannon_entropy"][w][sel], rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(got[1], mets["renyi_entropy"][w][sel], rtol=RTOL, atol=ATOL)
        patches = TM.extract_window(f, cl.centroid_x[w][sel], cl.centroid_y[w][sel])
        torch.testing.assert_close(got[2], TM.local_contrast(patches), rtol=RTOL, atol=ATOL)
        checked += int(sel.sum())
    assert checked > 20


def _lm_pair(cuda_dev, arch="llama3.2-1b", preset=None):
    """The same float32 weights on the card and on the CPU (TF32 off)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.train import reduced_config
    from repro_torch.models import params_from_jax, params_to_numpy, init_params

    if preset is None:  # tests/test_models.py's reduce_cfg
        cfg = dataclasses.replace(get_config(arch), n_layers=2, d_model=128, n_heads=4,
                                  n_kv_heads=4, d_ff=256, vocab=512, head_dim=32, dtype="float32")
    else:
        cfg = reduced_config(arch, preset)
    cpu = init_params(0, cfg, device="cpu")
    return cfg, cpu, params_from_jax(params_to_numpy(cpu), cfg, device=cuda_dev)


@pytest.mark.cuda
def test_lm_reduced_model_on_card_equals_cpu(cuda_dev):
    """A ``reduce_cfg`` Llama in float32 on the card against the CPU:
    forward, prefill of a padded batch and three decode steps within rtol =
    atol = 1e-4 with TF32 off; ``flash_attention`` within 1e-5."""
    from repro_torch.models import attention as TA
    from repro_torch.models import decode_step, forward_train, prefill

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, cpu, gpu = _lm_pair(cuda_dev)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (4, 11)).astype(np.int32)
    toks[:2, :4] = 0  # left padding, unmasked as in the reference
    torch.testing.assert_close(forward_train(gpu, {"tokens": toks})[0].cpu(), forward_train(cpu, {"tokens": toks})[0],
                               rtol=1e-4, atol=1e-4)
    lg, cg = prefill(gpu, {"tokens": toks[:, :8]}, cache_len=12)
    lc, cc = prefill(cpu, {"tokens": toks[:, :8]}, cache_len=12)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    for i in range(3):
        step = {"tokens": toks[:, 8 + i:9 + i]}
        (lg, cg), (lc, cc) = decode_step(gpu, step, cg, 8 + i), decode_step(cpu, step, cc, 8 + i)
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    q = torch.from_numpy(rng.standard_normal((2, 37, 2, 3, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 37, 2, 16)).astype(np.float32)) for _ in "kv")
    pos = torch.arange(37, dtype=torch.int32)
    want = TA.flash_attention(q, k, v, pos, pos, q_chunk=8, kv_chunk=16)
    got = TA.flash_attention(*(a.to(cuda_dev) for a in (q, k, v, pos, pos)), q_chunk=8, kv_chunk=16)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


def _count_syncs(fn):
    """(result of ``fn()``, host synchronizations it made) under
    ``torch.cuda.set_sync_debug_mode("warn")``."""
    import warnings

    mode = torch.cuda.get_sync_debug_mode()  # calls may nest
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    return out, sum("synchroniz" in str(w.message) and "prototype" not in str(w.message)
                    for w in caught)


@pytest.mark.cuda
def test_lm_engine_step_on_card_equals_cpu(cuda_dev):
    """One ``ServingEngine`` step of the tiny preset on the card and on the
    CPU (fake clock, mixed prompt lengths): the same tokens; no decode step
    synchronizes the host, and the whole step adds one synchronization a
    token (the read-back) to the prompt's upload."""
    from repro_torch.serve.lm import EngineConfig, Request, ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, cpu, gpu = _lm_pair(cuda_dev, preset="tiny")
    ecfg = EngineConfig(max_batch=3, max_seq=20)
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, n)] for n in (5, 9, 3)]
    outs, decode_syncs = {}, []
    for name, model, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, cuda_dev)):
        eng = ServingEngine(model, ecfg, lambda: 0.0, device=dev)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, tokens=p, max_new_tokens=6))
        if name == "cpu":
            outs[name] = [r.output for r in eng.step()]
            continue
        inner = eng._decode

        def counted(*a, inner=inner):
            out, n = _count_syncs(lambda: inner(*a))
            decode_syncs.append(n)
            return out

        eng._decode = counted
        batch, total = _count_syncs(eng.step)
        outs[name] = [r.output for r in batch]
    assert outs["cuda"] == outs["cpu"] and all(len(o) == 6 for o in outs["cuda"])
    assert decode_syncs == [0] * 5, decode_syncs
    assert 6 <= total <= 6 + 2, total


# The reduced LM families: the tiny preset (MoE, MLA and LRU widths cut as
# ``reduced_config`` cuts them) at a depth that holds every block type of
# the pattern (RG-LRU's local attention, xLSTM's sLSTM).
LM_FAMILIES = {"minicpm3-4b": 2, "moonshot-v1-16b-a3b": 2, "phi3.5-moe-42b-a6.6b": 2,
               "recurrentgemma-9b": 3, "xlstm-350m": 8}


def _family_pair(cuda_dev, arch):
    import dataclasses

    from repro_torch.launch.train import reduced_config
    from repro_torch.models import init_params, params_from_jax, params_to_numpy

    cfg = dataclasses.replace(reduced_config(arch, "tiny"), n_layers=LM_FAMILIES[arch])
    cpu = init_params(0, cfg, device="cpu")
    return cfg, cpu, params_from_jax(params_to_numpy(cpu), cfg, device=cuda_dev)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(LM_FAMILIES))
def test_lm_family_reduced_model_on_card_equals_cpu(cuda_dev, arch):
    """A reduced model of each MLA, MoE, RG-LRU and xLSTM family in float32
    on the card against the CPU (TF32 off): forward and its MoE aux loss, a
    prefill of a left-padded batch and three decode steps within rtol =
    atol = 1e-4; the first MoE layer's expert choices and keep mask equal
    on the same input."""
    from repro_torch.models import decode_step, forward_train, prefill
    from repro_torch.models.moe import moe_route

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, cpu, gpu = _family_pair(cuda_dev, arch)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (4, 11)).astype(np.int32)
    toks[:2, :4] = 0  # left padding, unmasked as in the reference
    (lg, ag), (lc, ac) = forward_train(gpu, {"tokens": toks}), forward_train(cpu, {"tokens": toks})
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ag.cpu(), ac, rtol=1e-4, atol=1e-4)
    lg, cg = prefill(gpu, {"tokens": toks[:, :8]}, cache_len=12)
    lc, cc = prefill(cpu, {"tokens": toks[:, :8]}, cache_len=12)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    for i in range(3):
        step = {"tokens": toks[:, 8 + i:9 + i]}
        (lg, cg), (lc, cc) = decode_step(gpu, step, cg, 8 + i), decode_step(cpu, step, cc, 8 + i)
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    if cfg.n_experts:
        x = torch.from_numpy(rng.standard_normal((44, cfg.d_model)).astype(np.float32))
        kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k, capacity_factor=0.5)
        rg = moe_route(gpu.layers[0].moe.router, x.to(cuda_dev), **kw)
        rc = moe_route(cpu.layers[0].moe.router, x, **kw)
        assert torch.equal(rg.experts.cpu(), rc.experts) and torch.equal(rg.keep.cpu(), rc.keep)
        assert not bool(rc.keep.all())  # capacity 0.5 drops


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(LM_FAMILIES))
def test_lm_family_engine_step_on_card_equals_cpu(cuda_dev, arch):
    """One ``ServingEngine`` step of each reduced family on the card and on
    the CPU (fake clock, mixed prompt lengths): the same tokens, and no
    decode step synchronizes the host (MoE routing and MLA's cache write
    read nothing back)."""
    from repro_torch.serve.lm import EngineConfig, Request, ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, cpu, gpu = _family_pair(cuda_dev, arch)
    ecfg = EngineConfig(max_batch=3, max_seq=20)
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, n)] for n in (5, 9, 3)]
    outs, decode_syncs = {}, []
    for name, model, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, cuda_dev)):
        eng = ServingEngine(model, ecfg, lambda: 0.0, device=dev)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, tokens=p, max_new_tokens=6))
        if name == "cuda":
            inner = eng._decode

            def counted(*a, inner=inner):
                out, n = _count_syncs(lambda: inner(*a))
                decode_syncs.append(n)
                return out

            eng._decode = counted
        outs[name] = [r.output for r in eng.step()]
    assert outs["cuda"] == outs["cpu"] and all(len(o) == 6 for o in outs["cuda"])
    assert decode_syncs == [0] * 5, decode_syncs


def _train_batch(cfg, seed=2):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (4, 12)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-1b", *LM_FAMILIES])
def test_lm_train_step_on_card_equals_cpu(cuda_dev, arch, tmp_path):
    """One train step of a reduced model in float32 on the card and on the
    CPU (TF32 off), from the same weights and batch, MoE without drops: the
    loss, the gradient norm and every updated parameter and moment within
    rtol = atol = 1e-4; a checkpoint of the card's state restores on the
    CPU leaf for leaf."""
    import dataclasses

    from repro_torch.models import opt_state_to_numpy, params_to_numpy
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import TrainConfig, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, cpu, gpu = _lm_pair(cuda_dev) if arch == "llama3.2-1b" else _family_pair(cuda_dev, arch)
    cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    cpu.cfg = gpu.cfg = cfg
    step = make_train_step(cfg, TrainConfig(opt=OptConfig(lr=1e-3), remat=True))
    batch = _train_batch(cfg)
    (_, og, mg), (_, oc, mc) = (step(gpu, init_opt_state(gpu), batch),
                                step(cpu, init_opt_state(cpu), batch))
    for k in ("loss", "grad_norm", "xent", "moe_aux"):
        assert mg[k].device == gpu.device
        torch.testing.assert_close(mg[k].cpu(), mc[k], rtol=1e-4, atol=1e-4)
    for k, v in dict(cpu.named_parameters()).items():
        torch.testing.assert_close(dict(gpu.named_parameters())[k].detach().cpu(), v.detach(),
                                   rtol=1e-4, atol=1e-4, msg=k)
    for k in ("mu", "nu"):
        for n, v in oc[k].items():
            torch.testing.assert_close(og[k][n].cpu(), v, rtol=1e-4, atol=1e-4 * float(v.abs().max()) + 1e-9)
    state = {"params": params_to_numpy(gpu), "opt": opt_state_to_numpy(og, cfg)}
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"params": dict(gpu.named_parameters()), "opt": og})
    _, back = mgr.restore({"params": dict(cpu.named_parameters()), "opt": oc}, device="cpu")
    for k, v in back["params"].items():
        assert torch.equal(v, dict(gpu.named_parameters())[k].detach().cpu()), k
    assert int(back["opt"]["step"]) == 1 and state["opt"]["step"] == 1


@pytest.mark.cuda
def test_lm_paged_decode_on_card_equals_cpu(cuda_dev):
    """A reduced Llama's paged decode (page 4, flushed when full) in
    float32 on the card and on the CPU: logits within rtol = atol = 1e-4
    over 10 steps, the flushed caches equal within 1e-5; neither a paged
    decode step nor a flush synchronizes the host."""
    from repro_torch.models import attention as TA
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.models import transformer as TT

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, cpu, gpu = _lm_pair(cuda_dev)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (4, 20)).astype(np.int32)
    old, TT.PAGED_DECODE = TT.PAGED_DECODE, 4
    try:
        pages = {d: init_cache(cfg, 4, 20, device=d) for d in ("cpu", cuda_dev)}
    finally:
        TT.PAGED_DECODE = old
    caches, syncs = {}, []
    for d, model in (("cpu", cpu), (cuda_dev, gpu)):
        _, caches[d] = prefill(model, {"tokens": toks[:, :10]}, cache_len=20)
        for c, p in zip(caches[d], pages[d]):
            c.update({k: v for k, v in p.items() if k not in c})
    for i in range(10):
        if i > 0 and i % 4 == 0:
            caches["cpu"] = [TA.flush_page(c) for c in caches["cpu"]]
            caches[cuda_dev], n = _count_syncs(lambda: [TA.flush_page(c) for c in caches[cuda_dev]])
            syncs.append(n)
        nxt = {"tokens": torch.from_numpy(toks[:, 10 + i:11 + i])}
        on_card = {"tokens": nxt["tokens"].to(cuda_dev)}  # the upload synchronizes, the step must not
        lc, caches["cpu"] = decode_step(cpu, nxt, caches["cpu"], 10 + i)
        (lg, caches[cuda_dev]), n = _count_syncs(lambda: decode_step(gpu, on_card, caches[cuda_dev], 10 + i))
        syncs.append(n)
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    assert syncs == [0] * len(syncs), syncs
    for cg, cc in zip(caches[cuda_dev], caches["cpu"]):
        for k in cc:
            torch.testing.assert_close(cg[k].cpu(), cc[k], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-1b", "moonshot-v1-16b-a3b", "xlstm-350m"])
def test_op_counter_on_card_equals_meta_count(cuda_dev, arch):
    """A decode step, a prefill and a train step of the tiny preset counted
    by ``launch/op_analysis.py`` on the card and on the meta device: FLOPs,
    bytes and operators equal, record for record (the dry run counts on the
    meta device what the card runs)."""
    from repro_torch.launch import op_analysis as O
    from repro_torch.launch.train import reduced_config
    from repro_torch.models import Transformer, decode_step, prefill
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import TrainConfig, make_train_step

    cfg = reduced_config(arch, "tiny")
    b, s = 2, 12

    def counts(dev):
        model = Transformer(cfg, None if dev.type == "meta" else 0, device=dev)
        toks = torch.zeros(b, s, dtype=torch.int32, device=dev)
        out = {"prefill": O.count(prefill, model, {"tokens": toks}, cache_len=s + 4)}
        _, cache = prefill(model, {"tokens": toks}, cache_len=s + 4)
        out["decode"] = O.count(decode_step, model, {"tokens": toks[:, :1]}, cache, s)
        step = make_train_step(cfg, TrainConfig())
        out["train"] = O.count(step, model, init_opt_state(model), {"tokens": toks, "labels": toks})
        return out

    card, meta = counts(cuda_dev), counts(torch.device("meta"))
    for kind in card:
        got = {k: (r.calls, r.flops, r.bytes) for k, r in card[kind].records.items()}
        want = {k: (r.calls, r.flops, r.bytes) for k, r in meta[kind].records.items()}
        assert got == want, kind
