"""The port's int8 quantization with error feedback
(``repro_torch.distributed.compression``) on the CPU, against the JAX
package's.

The cases of ``tests/test_compression.py`` for the three ported
functions, each also held against the reference on the same numpy
inputs: the int8 payload and the scale bit for bit, dequantized values
and EF residuals bit for bit. ``quantize_int8`` has two reference forms:
eager (IEEE division by 127) and under ``jax.jit``, where XLA multiplies
by ``f32(1/127)``; the port follows the first by default and the second
with ``jit_scale=True``, which the constellation's exchange uses in its
``_compress_fn``, held here against the reference's jitted
``_compress_fn``. The reference's int8 collectives wait for the mesh and
have no counterpart yet.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.distributed import compression as J
from repro.serve.constellation import _compress_fn as j_compress_fn
from repro_torch.distributed.compression import (
    dequantize_int8,
    ef_int8_roundtrip,
    quantize_int8,
)
from repro_torch.serve.constellation import _compress_fn

torch.set_num_threads(1)


def _np_quantize(x: np.ndarray) -> tuple[np.ndarray, float]:
    """Numpy oracle of the symmetric per-tensor int8 quantizer."""
    amax = np.max(np.abs(x)) if x.size else 0.0
    scale = max(amax, 1e-12) / 127.0
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return q, scale


def _same_bits(t: torch.Tensor, j) -> bool:
    a, b = np.atleast_1d(t.numpy()), np.atleast_1d(np.asarray(j))
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _random_planes(seed: int, n: int, shape=(16, 8)):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=shape) * rng.uniform(0.01, 1000)).astype(np.float32) for _ in range(n)]


# ---------------------------------------------------------------------------
# Quantize / dequantize.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64,), (7, 5), (1,), (3, 1, 4)])
def test_quantize_matches_numpy_oracle_and_reference(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    q, scale = quantize_int8(torch.from_numpy(x))
    oq, oscale = _np_quantize(x)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), oq)
    assert float(scale) == pytest.approx(oscale, rel=1e-6)
    jq, jscale = J.quantize_int8(jnp.asarray(x))
    assert _same_bits(q, jq) and _same_bits(scale, jscale)


def test_quantize_bit_equal_to_eager_reference_on_random_tensors():
    for x in _random_planes(1, 200):
        q, s = quantize_int8(torch.from_numpy(x))
        jq, js = J.quantize_int8(jnp.asarray(x))
        assert _same_bits(q, jq) and _same_bits(s, js)
        assert _same_bits(dequantize_int8(q, s), J.dequantize_int8(jq, js))


def test_roundtrip_error_bound():
    """|x - dequantize(quantize(x))| <= scale/2 everywhere (symmetric
    rounding; amax maps exactly to +-127 so nothing clips)."""
    x = np.random.default_rng(1).normal(size=4096).astype(np.float32) * 3.0
    q, scale = quantize_int8(torch.from_numpy(x))
    deq = dequantize_int8(q, scale).numpy()
    assert np.max(np.abs(x - deq)) <= float(scale) / 2 + 1e-7
    jq, js = J.quantize_int8(jnp.asarray(x))
    assert _same_bits(q, jq) and _same_bits(dequantize_int8(q, scale), J.dequantize_int8(jq, js))


def test_roundtrip_exact_on_grid():
    """Values already on the quantization grid survive bit-exactly."""
    x = np.arange(-127, 128, dtype=np.float32) * 0.5
    q, s = quantize_int8(torch.from_numpy(x))
    np.testing.assert_allclose(dequantize_int8(q, s).numpy(), x, rtol=0, atol=1e-6)
    jq, js = J.quantize_int8(jnp.asarray(x))
    assert _same_bits(q, jq) and _same_bits(s, js)


def test_quantize_zero_tensor():
    q, scale = quantize_int8(torch.zeros(16))
    np.testing.assert_array_equal(q.numpy(), np.zeros(16, np.int8))
    assert float(scale) > 0  # 1e-12 floor, never a 0/0
    np.testing.assert_array_equal(dequantize_int8(q, scale).numpy(), np.zeros(16, np.float32))
    _, jscale = J.quantize_int8(jnp.zeros(16))
    assert _same_bits(scale, jscale)


def test_quantize_empty_tensor():
    """Zero-size leaves are legal; the max over them is never taken."""
    q, scale = quantize_int8(torch.zeros((0,)))
    assert q.shape == (0,) and q.dtype == torch.int8
    assert float(scale) == 1.0 and scale.dtype == torch.float32
    deq = dequantize_int8(q, scale)
    assert deq.shape == (0,) and deq.dtype == torch.float32
    q2, _ = quantize_int8(torch.zeros((3, 0, 5)))
    assert q2.shape == (3, 0, 5)
    jq, js = J.quantize_int8(jnp.zeros((3, 0, 5)))
    assert tuple(jq.shape) == tuple(q2.shape) and float(js) == 1.0


@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "float32"])
def test_quantize_dtype_edges(dtype):
    """Half-precision inputs quantize in their own dtype, as the
    reference's weak-typed arithmetic does: q and scale equal bit for bit."""
    vals = [-1.0, -0.25, 0.0, 0.5, 1.0, 0.3, 0.77]
    x = torch.tensor(vals, dtype=getattr(torch, dtype))
    q, scale = quantize_int8(x)
    assert q.dtype == torch.int8 and scale.dtype == x.dtype
    deq = dequantize_int8(q, scale).to(torch.float32).numpy()
    np.testing.assert_allclose(deq, x.to(torch.float32).numpy(), atol=float(scale) / 2 + 1e-3)
    jq, js = J.quantize_int8(jnp.asarray(vals, getattr(jnp, dtype)))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(js) and str(js.dtype) == dtype


def test_quantize_scalar_and_int_input():
    q, scale = quantize_int8(torch.tensor(2.5))
    assert int(q) == 127  # amax maps to full scale
    assert float(dequantize_int8(q, scale)) == pytest.approx(2.5, rel=1e-6)
    qi, si = quantize_int8(torch.tensor([-3, 0, 7], dtype=torch.int32))
    np.testing.assert_array_equal(qi.numpy(), [-54, 0, 127])
    jqi, jsi = J.quantize_int8(jnp.asarray([-3, 0, 7], jnp.int32))
    assert _same_bits(qi, jqi) and _same_bits(si, jsi)


def test_quantize_under_jit_follows_each_reference_form():
    """Eager and jitted reference scales differ in the last bit for some
    amax (1.125: ``1.125 / 127`` against ``1.125 * f32(1/127)``); the port
    gives each with ``jit_scale`` off and on, and the payloads agree."""
    x = np.asarray([1.125, -0.3, 0.7, 0.01], np.float32)
    q_eager, s_eager = J.quantize_int8(jnp.asarray(x))
    q_jit, s_jit = jax.jit(J.quantize_int8)(jnp.asarray(x))
    assert float(s_eager) != float(s_jit)  # the case the two forms split on
    q, s = quantize_int8(torch.from_numpy(x))
    qj, sj = quantize_int8(torch.from_numpy(x), jit_scale=True)
    assert _same_bits(s, s_eager) and _same_bits(sj, s_jit)
    assert _same_bits(q, q_eager) and _same_bits(qj, q_jit)
    split = 0
    for xr in _random_planes(2, 200) + [np.linspace(-1, 1, 33, dtype=np.float32)]:
        jq, js = jax.jit(J.quantize_int8)(jnp.asarray(xr))
        tq, ts = quantize_int8(torch.from_numpy(xr), jit_scale=True)
        assert _same_bits(tq, jq) and _same_bits(ts, js)
        split += float(ts) != float(quantize_int8(torch.from_numpy(xr))[1])
    assert split > 0  # the random planes reach the split too


# ---------------------------------------------------------------------------
# Error feedback.
# ---------------------------------------------------------------------------


def _grads(seed: int):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(8, 4)).astype(np.float32), "b": rng.normal(size=4).astype(np.float32)}


def test_ef_roundtrip_reconstructs_input():
    """corrected == deq + residual: g + ef = deq + new_ef, and both equal
    the reference's bit for bit."""
    g = _grads(2)
    out, state = ef_int8_roundtrip({k: torch.from_numpy(v) for k, v in g.items()}, {})
    jout, jstate = J.ef_int8_roundtrip({k: jnp.asarray(v) for k, v in g.items()}, {})
    for k in g:
        np.testing.assert_allclose(g[k], out[k].numpy() + state["ef"][k].numpy(), atol=1e-6)
        assert _same_bits(out[k], jout[k]) and _same_bits(state["ef"][k], jstate["ef"][k])


def test_ef_residual_bounded_and_carried():
    w = np.random.default_rng(3).normal(size=256).astype(np.float32)
    g, jg = {"w": torch.from_numpy(w)}, {"w": jnp.asarray(w)}
    out1, state1 = ef_int8_roundtrip(g, {})
    _, scale = quantize_int8(g["w"])
    assert np.max(np.abs(state1["ef"]["w"].numpy())) <= float(scale)
    out2, state2 = ef_int8_roundtrip(g, state1)  # the residual is carried
    assert not np.array_equal(state1["ef"]["w"].numpy(), state2["ef"]["w"].numpy())
    mean_out = (out1["w"].numpy() + out2["w"].numpy()) / 2
    assert np.max(np.abs(mean_out - w)) <= float(scale)
    jout1, jstate1 = J.ef_int8_roundtrip(jg, {})
    jout2, jstate2 = J.ef_int8_roundtrip(jg, jstate1)
    for t, j in ((out1, jout1), (out2, jout2)):
        assert _same_bits(t["w"], j["w"])
    assert _same_bits(state2["ef"]["w"], jstate2["ef"]["w"])


def test_ef_roundtrip_over_lists_and_tuples():
    w = np.random.default_rng(4).normal(size=(3, 5)).astype(np.float32)
    out, state = ef_int8_roundtrip([torch.from_numpy(w), (torch.from_numpy(2 * w),)], {"step": 1})
    assert isinstance(out, list) and isinstance(out[1], tuple) and state["step"] == 1
    # The reference maps lists only: its leaf test takes any tuple for a
    # (deq, ef) pair.
    jout, _ = J.ef_int8_roundtrip([jnp.asarray(w), jnp.asarray(2 * w)], {})
    assert _same_bits(out[0], jout[0]) and _same_bits(out[1][0], jout[1])


def test_compress_fn_bit_equal_to_jitted_reference():
    """The exchange's EF round trip: q, scale, deq and the residual equal
    the reference's jitted ``_compress_fn`` bit for bit (its residual is
    one fused multiply-add), over random planes and EF buffers."""
    rng = np.random.default_rng(5)
    for plane in _random_planes(6, 200):
        ef = (rng.normal(size=plane.shape) * 0.01).astype(np.float32)
        got = _compress_fn(torch.from_numpy(plane), torch.from_numpy(ef))
        want = j_compress_fn()(jnp.asarray(plane), jnp.asarray(ef))
        for name, t, j in zip(("q", "scale", "deq", "ef"), got, want):
            assert _same_bits(t, j), name
        corrected = torch.from_numpy(plane) + torch.from_numpy(ef)
        assert torch.all((got[2] - corrected).abs() <= got[1] / 2)
