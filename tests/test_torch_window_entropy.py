"""The port's ``window_entropy`` (K6) against the JAX package, on the CPU.

The same seeded numpy frames and centres go through
``repro_torch.kernels.ops.window_entropy`` (here its plain version), the
JAX package's Pallas kernel ``repro.kernels.ops.window_entropy`` (in
interpret mode off the TPU) and its oracle ``repro.kernels.ref.
window_entropy_ref``: ``entropy_frame()`` and its empty frame, random
frames at K = 1, 4 and 17, corner-clipped centres, a single hot pixel, an
empty frame at the corners, and K = 0 (against the oracle alone: the
Pallas kernel cannot slice its (1, 0) centre block); rtol 1e-5, atol 1e-6 (the three
outputs come from order-dependent float32 sums and log2).

The CUDA kernel (``kernels/csrc/window_entropy.cu``) runs only on a card
(``tests/test_torch_cuda.py``). Its algorithm is held here through a numpy
model of both its paths: the bin rule without a float-to-int conversion,
the counts by warp votes (wide path) and by a private column a lane of a
shared table (warp path), the maps of a slice's pixels onto threads, and
the kernel's float32 summation orders, against the JAX kernel at the
same tolerance. So is ``chip_smoke.py``'s count of the distinct frame
pixels a launch reads, which its bound rests on.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.data.adversarial import entropy_frame
from repro_torch.kernels import ops

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
WINDOW, BINS = 48, 32
PIXELS = WINDOW * WINDOW


def _random_case(k, seed):
    rng = np.random.default_rng(seed)
    frame = rng.random((480, 640)).astype(np.float32)
    return frame, rng.integers(0, 640, k).astype(np.int32), rng.integers(0, 480, k).astype(np.int32)


def _hot_pixel():
    frame = np.zeros((480, 640), np.float32)
    frame[240, 320] = 1.0
    return frame, np.array([320], np.int32), np.array([240], np.int32)


def _case(name):
    if name == "entropy_frame":
        return entropy_frame()
    if name == "entropy_frame, empty":
        frame, cx, cy = entropy_frame()
        return np.zeros_like(frame), cx, cy
    if name.startswith("random, k="):
        k = int(name.split("=")[1])
        return _random_case(k, 100 + k)
    if name == "corners":  # tests/test_kernel_edges.py's corner-clipped centres
        frame = np.random.default_rng(7).random((480, 640)).astype(np.float32)
        return frame, np.array([0, 639, 0, 639, 320], np.int32), np.array([0, 0, 479, 479, 240], np.int32)
    if name == "hot pixel":
        return _hot_pixel()
    if name == "empty, corners":
        return np.zeros((480, 640), np.float32), np.array([0, 639], np.int32), np.array([479, 0], np.int32)
    if name == "k=0":
        return _random_case(0, 3)
    raise KeyError(name)


CASES = ["entropy_frame", "entropy_frame, empty", "random, k=1", "random, k=4", "random, k=17",
         "corners", "hot pixel", "empty, corners", "k=0"]


def _jax_kernel(frame, cx, cy):
    return np.asarray(jops.window_entropy(jnp.asarray(frame), jnp.asarray(cx), jnp.asarray(cy)))


def _jax_ref(frame, cx, cy):
    return np.asarray(jref.window_entropy_ref(jnp.asarray(frame), jnp.asarray(cx), jnp.asarray(cy)))


def _port(frame, cx, cy):
    return ops.window_entropy(*(torch.from_numpy(a) for a in (frame, cx, cy))).numpy()


@pytest.mark.parametrize("name", CASES)
def test_port_matches_jax_kernel_and_oracle(name):
    frame, cx, cy = _case(name)
    got = _port(frame, cx, cy)
    assert got.shape == (3, len(cx)) and got.dtype == np.float32
    want = _jax_ref(frame, cx, cy)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if len(cx):  # the JAX kernel refuses K = 0 (its (1, K) centre block); its oracle takes it
        np.testing.assert_allclose(got, _jax_kernel(frame, cx, cy), rtol=RTOL, atol=ATOL)
    if "empty" in name:
        np.testing.assert_array_equal(got[0], 0.0)  # one bin: no entropy, no contrast
        np.testing.assert_array_equal(got[2], 0.0)
    if name == "hot pixel":
        assert got[0, 0] > 0.0


# ---------------------------------------------------------------------------
# A numpy model of the CUDA kernel's two paths.
# ---------------------------------------------------------------------------

def _bins(v):
    """The kernel's bin rule: f clamped to [0, 31.5 / 32] in float32, then
    one fma rounding down to 2^23 + f * 32, whose low bits are floor(f *
    32) (f * 32 and the sum are exact in float64)."""
    f = np.clip(v.astype(np.float32), np.float32(0), np.float32(0.984375))
    return np.floor(f.astype(np.float64) * 32 + 2.0**23).astype(np.int64) - 2**23


def _warp_sum(v):
    """``__shfl_xor_sync`` butterfly over the last axis (32 lanes), float32."""
    v = v.astype(np.float32)
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[..., lanes ^ o]).astype(np.float32)
    return v[..., 0]


def _vote_counts(bins):
    """Wide path: lane b's count of the lanes of each (..., 32) group whose
    bin is b, from the five ballots of the bins' bit planes."""
    lanes = np.arange(32, dtype=np.uint64)
    planes = [(((bins >> q) & 1).astype(np.uint64) << lanes).sum(-1) for q in range(5)]
    out = np.zeros(bins.shape[:-1] + (32,), np.int64)
    for b in range(32):
        m = np.uint64(0xFFFFFFFF)
        for q in range(5):
            flip = np.uint64(0) if (b >> q) & 1 else np.uint64(0xFFFFFFFF)
            m = m & (planes[q] ^ flip)
        out[..., b] = np.vectorize(lambda x: bin(int(x)).count("1"))(m)
    return out


def _wide_map():
    """Wide path: thread t's 3 pixels (row t / 48 + 16 j, column t % 48)."""
    t = np.arange(768)
    return (t // WINDOW)[:, None] + 16 * np.arange(3), np.broadcast_to((t % WINDOW)[:, None], (768, 3))


def _warp_map():
    """Warp path: lane l's 72 pixels, 3 in each pair of rows p: q = l + 32 m
    of the pair's 96, row 2 p + q / 48, column q % 48 (read from the
    warp's shared-memory box at the slice's shift)."""
    q = np.arange(32)[:, None] + 32 * np.arange(3)  # (lane, m)
    rows = 2 * np.arange(24)[None, :, None] + (q // WINDOW)[:, None, :]
    cols = np.broadcast_to((q % WINDOW)[:, None, :], rows.shape)
    return rows.reshape(32, 72), cols.reshape(32, 72)


def _model(frame, cx, cy, path):
    h, w = frame.shape
    out = np.zeros((3, len(cx)), np.float32)
    for c in range(len(cx)):
        x0 = min(max(int(cx[c]) - WINDOW // 2, 0), w - WINDOW)
        y0 = min(max(int(cy[c]) - WINDOW // 2, 0), h - WINDOW)
        box = frame[y0:y0 + WINDOW, x0:x0 + WINDOW]
        if path == "wide":
            rows, cols = _wide_map()
            v = box[rows, cols].reshape(24, 32, 3)  # (warp, lane, j)
            counts = _vote_counts(_bins(v).transpose(0, 2, 1)).sum((0, 1))  # warps, passes
            lane_sum = np.zeros((24, 32), np.float32)
            for j in range(3):
                lane_sum = (lane_sum + v[..., j]).astype(np.float32)
            total = np.float32(0)
            for s in _warp_sum(lane_sum):
                total = np.float32(total + s)
            mean = np.float32(total / np.float32(PIXELS))
            sq = np.zeros((24, 32), np.float32)
            for j in range(3):
                d = (v[..., j] - mean).astype(np.float32)
                sq = (sq + d * d).astype(np.float32)
            var = np.float32(0)
            for s in _warp_sum(sq):  # thread 0 after the second barrier
                var = np.float32(var + s)
        else:
            rows, cols = _warp_map()
            v = box[rows, cols]  # (lane, 72)
            table = np.zeros((BINS, 32), np.int64)
            for lane in range(32):
                for b in _bins(v[lane]):
                    table[b, lane] += 1
            counts = np.array([sum(table[b, (i + b) & 31] for i in range(32)) for b in range(BINS)])
            lane_sum = np.zeros(32, np.float32)
            for j in range(72):
                lane_sum = (lane_sum + v[:, j]).astype(np.float32)
            mean = np.float32(_warp_sum(lane_sum) / np.float32(PIXELS))
            sq = np.zeros(32, np.float32)
            for j in range(72):
                d = (v[:, j] - mean).astype(np.float32)
                sq = (sq + d * d).astype(np.float32)
            var = _warp_sum(sq)
        assert counts.sum() == PIXELS
        np.testing.assert_array_equal(counts, np.bincount(_bins(box).ravel(), minlength=BINS))
        p = (counts.astype(np.float32) / np.float32(PIXELS)).astype(np.float32)
        ent = _warp_sum(np.where(p > 0, p * np.log2(np.maximum(p, np.float32(1e-12))), 0).astype(np.float32))
        out[0, c] = -ent
        out[1, c] = -np.log2(max(_warp_sum(p * p), np.float32(1e-12)))
        out[2, c] = np.sqrt(np.float32(var / np.float32(PIXELS)))
    return out


@pytest.mark.parametrize("path", ["wide", "warp"])
@pytest.mark.parametrize("name", ["entropy_frame", "entropy_frame, empty", "random, k=4",
                                  "corners", "hot pixel"])
def test_kernel_model_matches_jax_kernel(path, name):
    frame, cx, cy = _case(name)
    np.testing.assert_allclose(_model(frame, cx, cy, path), _jax_kernel(frame, cx, cy),
                               rtol=RTOL, atol=ATOL)


def test_bin_rule_is_truncation_clamped():
    """floor(clamp(f, 0, 31.5 / 32) * 32) equals the reference's
    clip(trunc(f * 32), 0, 31) on every bin edge, its float32 neighbours,
    and values a little outside [0, 1]."""
    edges = np.arange(BINS + 1, dtype=np.float32) / np.float32(BINS)
    f = np.concatenate([edges, np.nextafter(edges, np.float32(-1)), np.nextafter(edges, np.float32(2)),
                        np.array([-1.0, -0.0, -1e-30, 1.5, 7.0, -7.0], np.float32),
                        np.random.default_rng(0).random(100_000).astype(np.float32)])
    want = np.clip(np.trunc(f * np.float32(BINS)).astype(np.int64), 0, BINS - 1)
    np.testing.assert_array_equal(_bins(f), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vote_counts_equal_the_histogram(seed):
    rng = np.random.default_rng(seed)
    bins = np.where(rng.random((64, 32)) < 0.9, 0, rng.integers(0, BINS, (64, 32)))
    got = _vote_counts(bins)
    want = np.stack([np.bincount(g, minlength=BINS) for g in bins])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("path", ["wide", "warp"])
def test_pixel_maps_cover_a_slice_once(path):
    rows, cols = _wide_map() if path == "wide" else _warp_map()
    seen = np.zeros((WINDOW, WINDOW), np.int64)
    np.add.at(seen, (rows.ravel(), cols.ravel()), 1)
    np.testing.assert_array_equal(seen, 1)


def test_table_rows_are_read_one_bank_a_lane():
    """Warp path: every lane's increments go to its own column (bank l), and
    at step i lane b reads quad (i + b) mod 8 of its row b, 4 words: the 8
    lanes of each quarter-warp (one wavefront of a 16-byte read) meet in
    no bank."""
    lanes = np.arange(32)
    for b in range(BINS):
        assert len(set(((b * 32 + lanes) % 32).tolist())) == 32
    for i in range(8):
        for quarter in range(4):
            b = lanes[8 * quarter:8 * quarter + 8]
            words = b[:, None] * 32 + 4 * ((i + b[:, None]) % 8) + np.arange(4)
            assert len(set((words % 32).ravel().tolist())) == 32


# ---------------------------------------------------------------------------
# chip_smoke.py's bound: the distinct frame pixels a launch reads.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,cx,cy,pixels", [
    ("one", [320], [240], PIXELS),
    ("twice the same", [320, 320], [240, 240], PIXELS),
    ("clipped to one origin", [0, -40, 10], [0, -40, 24], PIXELS),
    ("disjoint", [100, 300], [100, 100], 2 * PIXELS),
    ("half overlap", [100, 124], [100, 100], PIXELS + PIXELS // 2),
    ("none", [], [], 0),
])
def test_window_entropy_cost_counts_distinct_pixels(name, cx, cy, pixels):
    cost = chip_smoke.window_entropy_cost((480, 640), cx, cy)
    assert cost["pixels"] == pixels
    assert cost["bytes"] == 4 * pixels + 20 * len(cx)
    assert cost["ops"] == 10 * PIXELS * len(cx)


def test_window_entropy_cost_against_a_pixel_set():
    frame, cx, cy = entropy_frame()
    cx = np.r_[cx, np.random.default_rng(5).integers(-60, 700, 200)]
    cy = np.r_[cy, np.random.default_rng(6).integers(-60, 540, 200)]
    h, w = frame.shape
    seen = set()
    for x, y in zip(cx, cy):
        x0 = min(max(int(x) - 24, 0), w - WINDOW)
        y0 = min(max(int(y) - 24, 0), h - WINDOW)
        seen.update((y0 + r) * w + x0 + c for r in range(WINDOW) for c in range(WINDOW))
    assert chip_smoke.window_entropy_cost((h, w), cx, cy)["pixels"] == len(seen)
    # entropy_frame's corner centres clip to shared origins: fewer pixels than 32 slices.
    assert chip_smoke.window_entropy_cost((h, w), *entropy_frame()[1:])["pixels"] < 32 * PIXELS
