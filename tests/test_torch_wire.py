"""The port's ragged ingest wire against the JAX reference, on the CPU.

The same numpy streams go through both packages: ``pack_wire`` and
``pack_bounds_into(layout="ragged")`` must write byte-for-byte the same
arrays (dtypes included), and the port's plain decoder
(``repro_torch.core.events.unpack_wire``, the ``event_unpack`` kernel's
plain version) must rebuild exactly the planes the reference's
``unpack_wire`` does, on its jnp route and on its Pallas
``event_unpack_call`` route (interpret mode). The plain versions of the
``grid_quantize_packed`` kernel (exact, compared as uint32 bits) and of
the ``window_entropy`` kernel (rtol 1e-5: float32 sums in another order
and another log2) are held against ``repro.kernels.ops``, and the host
helpers of the stream (``validate_monotone``, ``monotone_merge``,
``stride_bounds``, ``iter_chunks``) against the reference's.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import events as JE
from repro.data import evas as JV
from repro.data.synthetic import make_recording
from repro.kernels import ops as jops
from repro_torch.core import events as TE
from repro_torch.data import adversarial as AD
from repro_torch.data import evas as TV
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)


def _same_arrays(got, want, what=""):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, f"{what}[{i}]: {a.dtype} vs {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=f"{what}[{i}]")


# ---------------------------------------------------------------------------
# Host packing: byte-for-byte the reference's arrays.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("garbage", [False, True])
def test_pack_wire_equals_reference(garbage):
    x, y, t, p = AD.wire_stream(3, garbage=garbage)
    b3 = AD.dual_bounds3(t)
    got, want = TE.pack_wire(x, y, t, p, b3, 256), JE.pack_wire(x, y, t, p, b3, 256)
    _same_arrays(got[0], want[0], "wire")
    _same_arrays(got[1:], want[1:], "bookkeeping")
    assert (got[0][4].shape[1] >= 4) == garbage


def test_pack_wire_capacity_truncation_equals_reference():
    batcher = TE.BatcherConfig(capacity=32, size_threshold=200)
    x, y, t, p = AD.wire_stream(7, n=500, span_us=50_000)
    b3 = AD.dual_bounds3(t, batcher)
    got, want = TE.pack_wire(x, y, t, p, b3, 32), JE.pack_wire(x, y, t, p, b3, 32)
    assert got[4].sum() > 0  # the truncation happens
    _same_arrays(got[0], want[0], "wire")
    _same_arrays(got[1:], want[1:], "bookkeeping")


def test_pack_bounds_into_ragged_multi_sensor_equals_reference():
    """Three sensors into one wire behind running base offsets (garbage
    in the second, so its spill positions carry the base): every return
    value and every buffer equal to the reference's."""
    streams = [AD.wire_stream(20), AD.wire_stream(21, n=300, garbage=True), AD.wire_stream(22, n=90)]
    w, cap = 6, 256

    def pack(mod):
        words = np.zeros(4096, np.uint32)
        dt16 = np.zeros(4096, np.uint16)
        pbits = np.zeros(4096, np.uint8)
        offsets = np.zeros((3, w + 1), np.int32)
        base, outs = 17, []
        for i, (x, y, t, p) in enumerate(streams):
            r = mod.pack_bounds_into(
                x, y, t, p, AD.dual_bounds3(t)[:w], out=(words, dt16, pbits, offsets[i]),
                layout="ragged", base=base, capacity=cap,
            )
            base = r[4]
            outs.append(r)
        return outs, (words, dt16, pbits, offsets)

    (got, gbuf), (want, wbuf) = pack(TE), pack(JE)
    for g, r in zip(got, want):
        _same_arrays(g[:4], r[:4], "bookkeeping")
        assert g[4] == r[4]
        _same_arrays([g[5]], [r[5]], "spill entries")
    _same_arrays(gbuf, wbuf, "buffers")
    assert got[1][5].shape[1] == 4 and (got[1][5][0] >= 17).all()


def test_pack_wire_without_spill_raises_like_reference():
    x, y, t, p = AD.wire_stream(3, garbage=True)
    for mod in (TE, JE):
        with pytest.raises(ValueError, match="spill lane is disabled"):
            mod.pack_wire(x, y, t, p, AD.dual_bounds3(t), 256, spill=False)
    t2 = np.array([0, 1, 200_000, 200_001], np.int64)  # dt past 16 bits
    z = np.zeros(4, np.int64)
    for mod in (TE, JE):
        with pytest.raises(ValueError, match="spill lane is disabled"):
            mod.pack_wire(z, z, t2, z, [(0, 4, 0)], 8, spill=False)


def test_pack_bounds_into_argument_errors_like_reference():
    z = np.zeros(4, np.int64)
    words, dt = np.zeros(512, np.uint32), np.zeros(512, np.uint16)
    pb, off = np.zeros(512, np.uint8), np.zeros(2, np.int32)
    for mod in (TE, JE):
        with pytest.raises(TypeError, match="out= wire tuple"):
            mod.pack_bounds_into(z, z, z, z, [(0, 4, 0)], layout="ragged")
        with pytest.raises(TypeError, match="capacity"):
            mod.pack_bounds_into(z, z, z, z, [(0, 4, 0)], out=(words, dt, pb, off), layout="ragged")
        with pytest.raises(ValueError, match="unknown pack layout"):
            mod.pack_bounds_into(z, z, z, z, [(0, 4, 0)], layout="csr")


def test_wire_sizes_and_byte_accounting_equal_reference():
    assert (TE.WIRE_QUANTUM, TE.SPILL_QUANTUM, TE.SPILL_SENTINEL) == (
        JE.WIRE_QUANTUM, JE.SPILL_QUANTUM, JE.SPILL_SENTINEL)
    for n in (0, 1, 511, 512, 513, 70_000):
        assert TE.wire_pad(n) == JE.wire_pad(n) and TE.spill_pad(n) == JE.spill_pad(n)
    for s, w, cap, m in ((1, 1, 256, 0), (16, 3, 256, 8), (4, 7, 32, 24)):
        n_pad = TE.wire_pad(s * w * cap)
        assert TE.dense_wire_bytes(s, w, cap) == JE.dense_wire_bytes(s, w, cap)
        assert TE.ragged_wire_bytes(n_pad, s, w, m) == JE.ragged_wire_bytes(n_pad, s, w, m)


# ---------------------------------------------------------------------------
# The decoder: the port's plain route against both reference routes.
# ---------------------------------------------------------------------------

def _wire_cases():
    cases = dict(AD.adversarial_wires())
    streams = [AD.wire_stream(40 + s, n=400) for s in range(4)]
    cases["4-sensor round"] = (AD.fleet_wire([(*st, AD.dual_bounds3(st[2])[:2]) for st in streams], 256), 256)
    return cases


@pytest.mark.parametrize("case", list(_wire_cases()))
@pytest.mark.parametrize("kernel_route", [False, True], ids=["jnp", "event_unpack_call"])
def test_unpack_wire_equals_reference(case, kernel_route):
    wire, cap = _wire_cases()[case]
    impl = jops.event_unpack_call if kernel_route else None
    jp, jv = JE.unpack_wire(*(jnp.asarray(a) for a in wire), cap, unpack_impl=impl)
    tp, tv = ops.event_unpack(*TE.wire_tensors(wire, "cpu"), cap)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    rp, rv = ref.unpack_wire_ref(*TE.wire_tensors(wire, "cpu"), cap)
    assert torch.equal(rp, tp) and torch.equal(rv, tv)


@pytest.mark.parametrize("garbage", [False, True])
def test_unpack_wire_rebuilds_dense_planes(garbage):
    x, y, t, p = AD.wire_stream(5, garbage=garbage)
    b3 = AD.dual_bounds3(t)
    wire, starts, stops, t_start, overflow = TE.pack_wire(x, y, t, p, b3, 256)
    packed, valid = TE.unpack_wire(*TE.wire_tensors(wire, "cpu"), 256)
    dense = TE.pack_bounds(x, y, t, p, b3, 256, device="cpu")
    for lane, plane in zip(packed[:, 0], dense.batch[:4]):
        assert torch.equal(lane, plane)
    assert torch.equal(valid[0], dense.batch.valid)
    for a, b in ((starts, dense.starts), (stops, dense.stops), (t_start, dense.t_start_us),
                 (overflow, dense.overflow)):
        np.testing.assert_array_equal(a, b)


def test_unpack_wire_spill_positions_like_a_drop_scatter():
    """Spill positions past the wire are dropped and negative ones count
    from the end, as the reference's ``mode="drop"`` scatter does."""
    wire, cap = AD.adversarial_wires()["spill lane"]
    n = wire[0].shape[0]
    spill = np.full((5, 8), TE.SPILL_SENTINEL, np.int32)
    spill[:, 0] = (-n + 3, 11, 12, 13, 1)  # lands on position 3
    spill[:, 1] = (n + 5, 21, 22, 23, 0)  # dropped
    spill[:, 2] = (-n - 1, 31, 32, 33, 1)  # dropped
    w = (*wire[:4], spill)
    jp, jv = JE.unpack_wire(*(jnp.asarray(a) for a in w), cap)
    tp, tv = TE.unpack_wire(*TE.wire_tensors(w, "cpu"), cap)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert tp[0, 0, 0, 3] == 11


# ---------------------------------------------------------------------------
# The event_unpack kernel's algorithm (csrc/event_unpack.cu), modelled in
# numpy: each (sensor, window) row gathers its slots from the wire and
# overlays, per slot, the last spill entry whose position is the slot's
# clipped source. The kernel runs only on a card; its logic is held here
# against the plain decoder.
# ---------------------------------------------------------------------------

def _k5_model(wire, cap):
    words, dt16, pol, offsets, spill = (np.asarray(a) for a in wire)
    n, m = words.shape[0], spill.shape[1]
    s_, w_ = offsets.shape[0], offsets.shape[1] - 1
    packed = np.zeros((4, s_, w_, cap), np.int64)
    valid = np.zeros((s_, w_, cap), bool)
    pos = spill[0].astype(np.int64)
    pos = np.where(pos < 0, pos + n, pos)
    for s in range(s_):
        for w in range(w_):
            start = int(offsets[s, w])
            count = int(offsets[s, w + 1]) - start
            for j in range(min(max(count, 0), cap)):
                valid[s, w, j] = True
                if n == 0:
                    continue
                src = min(max(start + j, 0), n - 1)
                hits = np.flatnonzero((pos == src) & (pos >= 0) & (pos < n))
                if len(hits):  # one CTA's atomic max over the lane indices
                    packed[:, s, w, j] = spill[1:, hits.max()]
                else:
                    word = int(words[src])
                    packed[:, s, w, j] = (word & 0xFFFF, word >> 16, int(dt16[src]),
                                          (int(pol[src >> 5]) >> (src & 31)) & 1)
    return packed, valid


def _k5_cases():
    return {**AD.adversarial_wires(), **AD.overlay_wires()}


@pytest.mark.parametrize("case", list(_k5_cases()))
def test_event_unpack_algorithm_matches_plain(case):
    """The kernel's per-row gather and overlay equal the plain decoder on
    every wire case, spills out of position order, two entries on one
    slot (the later in the lane wins, as the plain version's index_put
    does on the CPU) and rows reaching past the wire included."""
    wire, cap = _k5_cases()[case]
    packed, valid = _k5_model(wire, cap)
    rp, rv = ref.unpack_wire_ref(*TE.wire_tensors(wire, "cpu"), cap)
    np.testing.assert_array_equal(packed, rp.numpy())
    np.testing.assert_array_equal(valid, rv.numpy())


# ---------------------------------------------------------------------------
# K1 and K6 plain versions against the reference's Pallas wrappers.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell_size", [16, 12])
@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 3000])
def test_grid_quantize_packed_plain_equals_reference(cell_size, n):
    rng = np.random.default_rng(n)
    w = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    w[0] = 0xFFFFFFFF
    want = np.asarray(jops.grid_quantize_packed(jnp.asarray(w), cell_size))
    got = ops.grid_quantize_packed(torch.from_numpy(w.view(np.int32)), cell_size)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_grid_quantize_packed_plain_on_recording_words():
    rec = make_recording(seed=3, duration_s=0.2)
    words = np.asarray(JE.pack_words(jnp.asarray(rec.x), jnp.asarray(rec.y))).astype(np.uint32)
    for cs in (16, 12):
        want = np.asarray(jops.grid_quantize_packed(jnp.asarray(words), cs))
        got = ref.grid_quantize_packed_ref(torch.from_numpy(words.view(np.int32)), cs)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("empty", [False, True], ids=["frame", "empty frame"])
def test_window_entropy_plain_equals_reference(empty):
    frame, cx, cy = AD.entropy_frame()
    if empty:
        frame = np.zeros_like(frame)
    want = np.asarray(jops.window_entropy(jnp.asarray(frame), jnp.asarray(cx), jnp.asarray(cy)))
    got = ops.window_entropy(*(torch.from_numpy(a) for a in (frame, cx, cy)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)


def test_cpu_routes_launch_no_kernel():
    ops.reset_launches()
    wire, cap = AD.adversarial_wires()["spill lane"]
    ops.event_unpack(*TE.wire_tensors(wire, "cpu"), cap)
    ops.grid_quantize_packed(torch.zeros(5, dtype=torch.int32))
    frame, cx, cy = AD.entropy_frame()
    ops.window_entropy(*(torch.from_numpy(a) for a in (frame, cx, cy)))
    assert all(v == 0 for v in ops.LAUNCHES.values()), ops.LAUNCHES


# ---------------------------------------------------------------------------
# Host helpers of the live path.
# ---------------------------------------------------------------------------

def test_monotone_helpers_equal_reference():
    t = np.array([0, 0, 5, 5, 9], np.int64)
    z = np.zeros(5, np.int64)
    pend = (z[:0],) * 4
    for a, b in zip(TE.monotone_merge(pend, z, z, t, z), JE.monotone_merge(pend, z, z, t, z)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for bad, last, match in ((t[::-1], None, "not non-decreasing"), (t, 3, "monotonically")):
        for mod in (TE, JE):
            with pytest.raises(ValueError, match=match):
                mod.validate_monotone(bad, last)
    TE.validate_monotone(t, 0)


def test_stride_bounds_and_iter_chunks_equal_reference():
    rec = make_recording(seed=4, duration_s=0.3)
    for us in (1_000, 20_000, 70_000):
        assert TE.stride_bounds(rec.t, us) == JE.stride_bounds(rec.t, us)
        for a, b in zip(TV.iter_chunks(rec, us), JV.iter_chunks(rec, us), strict=True):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)
    assert TE.stride_bounds(rec.t[:0]) == []
    with pytest.raises(ValueError, match="chunk_us"):
        next(TV.iter_chunks(rec, 0))
