"""The port's int8 collectives (``repro_torch.distributed.compression``)
over a 4-rank ``gloo`` process group on the CPU, against the reference's
under ``jax.vmap(axis_name=...)``, as ``tests/test_compression.py`` and
``tests/test_train_infra.py`` run them.

One group is spawned for the whole file (``tools/torch_collective_ranks.py``,
one process a rank, meeting through a ``file://`` store under the test's
temporary directory, 120 s at most); it runs every case and saves each
rank's results, and the tests below compare them with the reference run
here on the same inputs. Held: the aligned int8 payloads and scales equal
to the reference's; every rank's output equal to every other's; the
float results equal to the reference's to the bit (same order of float
operations) and within the reference tests' tolerances of the float32
mean; each ring hop an int16 payload of |x|/N elements (2|x|/N bytes on
the wire, counted by ``launch/op_analysis.py``); a group of one returns
its input; a tensor on another device than the backend's is refused.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.distributed.compression import (
    compressed_psum_int8,
    dp_grad_sync_int8,
    quantize_int8,
    ring_allreduce_int8,
)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import torch_collective_ranks as R  # noqa: E402


@pytest.fixture(scope="module")
def ranks(tmp_path_factory) -> list[dict]:
    out = tmp_path_factory.mktemp("collective_ranks")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT / "src"), os.environ.get("PYTHONPATH")])))
    proc = subprocess.run([sys.executable, str(ROOT / "tools" / "torch_collective_ranks.py"), str(out)],
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(R.N)]


def _ref(fn, *args):
    return jax.vmap(fn, axis_name="shard")(*args)


def _ranks_agree(ranks, key: str) -> np.ndarray:
    first = ranks[0][key]
    for r in range(1, R.N):
        np.testing.assert_array_equal(ranks[r][key], first, err_msg=f"rank {r} {key}")
    return first


def test_compressed_psum_payloads_equal_reference(ranks):
    x = R.shards(4, (128,))

    def aligned(v):  # the reference's first half of compressed_psum_int8
        q, scale = quantize_int8(v)
        max_scale = jax.lax.pmax(scale, "shard")
        return jnp.round(q.astype(jnp.float32) * (scale / max_scale)).astype(jnp.int8), max_scale

    q_ref, scale_ref = _ref(aligned, jnp.asarray(x))
    for r in range(R.N):
        np.testing.assert_array_equal(ranks[r]["psum_q"], np.asarray(q_ref[r]), err_msg=f"rank {r}")
        assert ranks[r]["psum_q"].dtype == np.int8
        np.testing.assert_array_equal(ranks[r]["psum_scale"], np.asarray(scale_ref[r]))
    # Two all-reduces (the scale's max, the int32 sum), no other collective:
    # the count is the group's size, known without one.
    np.testing.assert_array_equal(ranks[0]["psum_kinds"], [2, 0])


def test_compressed_psum_matches_reference_and_fp32_mean(ranks):
    x = R.shards(4, (128,))
    out = _ranks_agree(ranks, "psum")
    ref = np.asarray(_ref(lambda v: compressed_psum_int8(v, "shard"), jnp.asarray(x)))
    np.testing.assert_array_equal(out, ref[0])
    tol = (np.abs(x).max(axis=1) / 127.0).max() + 1e-6
    np.testing.assert_allclose(out, x.mean(axis=0), atol=tol)


def test_dp_grad_sync_tree_matches_reference(ranks):
    tree = {"w": R.shards(5, (16, 3)), "b": R.shards(6, (3,))}
    ref = _ref(lambda g: dp_grad_sync_int8(g, "shard"), {k: jnp.asarray(v) for k, v in tree.items()})
    for k, v in tree.items():
        out = _ranks_agree(ranks, f"dp_{k}")
        np.testing.assert_array_equal(out, np.asarray(ref[k][0]), err_msg=k)
        np.testing.assert_allclose(out, v.mean(axis=0), atol=np.abs(v).max() / 127.0 + 1e-6)


@pytest.mark.parametrize("n", R.RING_SIZES)  # 63, 1: the padding path
def test_ring_allreduce_matches_reference(ranks, n):
    x = R.shards(7, (n,))
    out = _ranks_agree(ranks, f"ring{n}")
    assert out.shape == (n,)
    ref = np.asarray(_ref(lambda v: ring_allreduce_int8(v, "shard", R.N), jnp.asarray(x)))
    np.testing.assert_array_equal(out, ref[0])
    np.testing.assert_allclose(out, x.mean(axis=0), atol=np.abs(x).max() / 127.0 * 1.5 + 1e-6)


@pytest.mark.parametrize("n", R.RING_SIZES)
def test_ring_hops_carry_int16_of_a_chunk(ranks, n):
    """2 (N-1) hops, each an all-to-all of one chunk of int16 partial sums
    (ceil(n / N) elements) sent as its bytes."""
    chunk = -(-n // R.N)
    for r in range(R.N):
        hops = ranks[r][f"ring{n}_hops"]
        assert hops.shape == (1, 3), hops
        elements, calls, wire_bytes = hops[0]
        assert calls == 2 * (R.N - 1)
        assert elements == 2 * chunk  # uint8 view of `chunk` int16 values
        assert wire_bytes == calls * 2 * chunk


def test_ring_allreduce_preserves_shape_2d(ranks):
    x = R.shards(9, (5, 7))
    out = _ranks_agree(ranks, "ring2d")
    assert out.shape == (5, 7)
    ref = np.asarray(_ref(lambda v: ring_allreduce_int8(v, "shard", R.N), jnp.asarray(x)))
    np.testing.assert_array_equal(out, ref[0])
    np.testing.assert_allclose(out, x.mean(axis=0), atol=np.abs(x).max() / 127.0 * 1.5 + 1e-6)


def test_ring_allreduce_group_of_one_is_identity(ranks):
    x = R.identity_input()
    ref = np.asarray(_ref(lambda v: ring_allreduce_int8(v, "shard", 1), jnp.asarray(x)[None]))
    for r in range(R.N):
        np.testing.assert_array_equal(ranks[r]["ring_one"], x)
        np.testing.assert_array_equal(ranks[r]["ring_one"], ref[0])
        assert bool(ranks[r]["ring_one_is_x"])


def test_tensor_on_another_device_than_the_backend_is_refused(ranks):
    assert all(bool(ranks[r]["refused"]) for r in range(R.N))
