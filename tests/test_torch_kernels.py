"""The port's two kernels. Here on the CPU the wrappers run the plain
PyTorch versions, held against the JAX package's Pallas kernels in
interpret mode on adversarial windows: cluster_accum exactly; for
patch_metrics event_count and edge_density exactly, the entropies and
contrast to rtol = atol = 1e-5 (order-dependent float32 reductions and
log2). The adversarial windows and the CUDA kernels' own tests are in
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
