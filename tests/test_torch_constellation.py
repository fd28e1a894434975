"""The port's constellation layer (``repro_torch.serve.constellation``)
and shard chaos harness (``repro_torch.serve.chaos_shards``) on the CPU,
against the JAX package's.

The cases of ``tests/test_constellation.py`` against the port, each also
run through the reference's constellation on the same schedule:
``partition_devices``, least-loaded routing and its errors, randomized
churn with migrations and rebalances, explicit migration, rebalance and
the exchange modes and their bounds (whole-shard rescue is in
``tests/test_torch_constellation_rescue.py`` and the shard chaos cases in
``tests/test_torch_chaos_shards.py``, so that each file stays under a
minute on one core: the reference compiles its fleet step once per
shape). Within the port every session equals a
dedicated ``StreamingPipeline`` of the same chunks to the bit, and the
exchange's per-round EF bound and telescoping identity hold as the
reference tests them. Across the packages: placements, loads, counters
and exchange byte counts exactly; session outputs to
``tests/test_torch_serve_service.py``'s bounds (integers exact, metrics
rtol = atol = 1e-5, tracker floats rtol 1e-6, atol 1e-4); summary planes
with the window and cluster columns exact and the metric sums (float32
sums in another order) within rtol 1e-5, atol 1e-4.

A shard group of more than one device raises ``NotImplementedError``
here (mesh sharding is ROADMAP §1 item 7), so the reference's
four-device case (``tests/test_constellation.py::test_constellation_multidevice``)
stays a reference-only test.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import events as JE
from repro.core import pipeline as JP
from repro.core.pipeline.fleet import FleetPipeline as JFleetPipeline
from repro.serve import AdmissionConfig as JAdmissionConfig
from repro.serve import FaultConfig as JFaultConfig
from repro.serve import constellation as JK
from repro_torch.core.events import BatcherConfig
from repro_torch.core.pipeline import PipelineConfig, StreamingPipeline
from repro_torch.core.pipeline.fleet import FleetPipeline
from repro_torch.serve import AdmissionConfig
from repro_torch.serve.chaos import _FakeClock, _Stream, compare_outputs, concat_outputs
from repro_torch.serve.constellation import (
    ConstellationService,
    CrossShardExchange,
    partition_devices,
)
from test_torch_serve_service import _assert_same, _surfaces

torch.set_num_threads(1)

BATCHER = dict(time_threshold_us=2_000, size_threshold=40, capacity=64)
CONFIG = PipelineConfig(batcher=BatcherConfig(**BATCHER))
J_CONFIG = JP.PipelineConfig(batcher=JE.BatcherConfig(**BATCHER))
# Manual pump only: admission never fires on its own, so rounds land
# exactly where the test dispatches them.
MANUAL = dict(max_delay_s=1e9, max_items=1 << 30)
PACKAGES = ("port", "reference")


def _make(pkg: str = "port", n_shards: int = 2, config=CONFIG, **kw):
    """The same constellation in either package (the port's on the CPU;
    ``config`` is the port's pipeline config)."""
    kw.setdefault("tiers", (2, 4, 8))
    kw.setdefault("clock", _FakeClock())
    kw.setdefault("sleep", lambda s: None)
    if pkg == "port":
        kw.setdefault("admission", AdmissionConfig(**MANUAL))
        return ConstellationService(config, n_shards=n_shards, devices=["cpu"], **kw)
    kw["admission"] = JAdmissionConfig(**MANUAL)
    if "faults" in kw:
        kw["faults"] = JFaultConfig(**dataclasses.asdict(kw["faults"]))
    return JK.ConstellationService(J_CONFIG, n_shards=n_shards, **kw)


def _drain_all(cs, gids):
    # Forced pumps clear the service queues; the batcher remainder inside
    # each slot carry only leaves at detach, so loop on queued events.
    out = []
    while any(cs.session(g).queued_events for g in gids):
        out += cs.pump(force=True)
    cs.drain()
    return out


def _dedicated(chunks, config=CONFIG):
    sp = StreamingPipeline(config, device="cpu")
    return [sp.feed(*c) for c in chunks] + [sp.flush()]


def _assert_sessions(runs: dict, fed: dict) -> None:
    """Within the port each session equals its dedicated stream to the
    bit; across the packages to the stated bounds."""
    t_parts, j_parts = runs["port"], runs["reference"]
    assert sorted(t_parts) == sorted(j_parts) == sorted(fed)
    for g in fed:
        assert compare_outputs(concat_outputs(t_parts[g]), concat_outputs(_dedicated(fed[g])),
                               f"gid {g}") == []
        _assert_same(_surfaces(t_parts[g]), _surfaces(j_parts[g]), exact=False, what=f"gid {g}")


# ---------------------------------------------------------------------------
# Device partitioning and placement.
# ---------------------------------------------------------------------------


def test_partition_devices():
    cases = [(range(10), 3), (range(4), 4), (range(2), 5), (range(1), 3), (range(7), 2)]
    for devs, n in cases:
        assert partition_devices(devs, n) == JK.partition_devices(devs, n)
    assert partition_devices(range(10), 3) == [(0, 1, 2, 3), (4, 5, 6), (7, 8, 9)]
    assert partition_devices(range(2), 5) == [(0,), (1,), (0,), (1,), (0,)]
    cpu = torch.device("cpu")
    assert partition_devices([cpu], 4) == [(cpu,)] * 4  # shards share one device
    for mod in (JK, None):
        part = JK.partition_devices if mod else partition_devices
        with pytest.raises(ValueError, match="n_shards"):
            part(range(2), 0)
        with pytest.raises(ValueError, match="at least one device"):
            part([], 2)


def test_multi_device_shard_group_raises():
    """A group of more than one distinct device needs the mesh (ROADMAP
    §1 item 7) and is refused before any service is built; shards that
    share one device, spelled either way, run unsharded."""
    with pytest.raises(NotImplementedError, match="item 7"):
        ConstellationService(CONFIG, n_shards=1, devices=["cpu", "meta"])
    with pytest.raises(NotImplementedError, match="item 7"):
        ConstellationService(CONFIG, n_shards=2, devices=["cpu", "meta", "cpu", "meta"])
    cs = ConstellationService(CONFIG, n_shards=3, devices=["cpu", torch.device("cpu")])
    assert [sh.devices for sh in cs._shards] == [(torch.device("cpu"),)] * 3
    assert {str(sh.service.device) for sh in cs._shards} == {"cpu"}
    assert cs.stats()["shards"][0]["devices"] == ["cpu"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_attach_routes_least_loaded(pkg):
    cs = _make(pkg)
    gids = [cs.attach() for _ in range(4)]
    assert [cs.shard_of(g) for g in gids] == [0, 1, 0, 1]  # ties by shard index
    assert cs.loads == [2, 2]
    cs.detach(gids[0])
    assert cs.loads == [1, 2]
    assert cs.shard_of(cs.attach()) == 0  # the freed capacity attracts it
    assert cs.n_sessions == 4
    assert cs.capacity == sum(sh.service.capacity for sh in cs._shards) == 4


@pytest.mark.parametrize("pkg", PACKAGES)
def test_routing_errors(pkg):
    cs = _make(pkg)
    gid = cs.attach()
    with pytest.raises(KeyError, match="unknown session"):
        cs.feed(999, *_Stream(0).next(8))
    cs.detach(gid)
    with pytest.raises(RuntimeError, match=f"session {gid} is"):
        cs.feed(gid, *_Stream(0).next(8))
    with pytest.raises(RuntimeError, match="live; detach first"):
        cs.forget(cs.attach())
    cs.forget(gid)
    with pytest.raises(KeyError):
        cs.shard_of(gid)
    cs.forget(gid)  # idempotent on unknown/forgotten ids


# ---------------------------------------------------------------------------
# Bit-identity under churn.
# ---------------------------------------------------------------------------


def _churn_run(pkg: str, sizes=(60, 100, 140), config=CONFIG):
    """5 sensors over 2 shards, 10 rounds with random migrations and
    rebalance sweeps, chunk sizes drawn from ``sizes``; decisions draw
    only on the rng."""
    rng = np.random.default_rng(3)
    cs = _make(pkg, config=config)
    gids = [cs.attach() for _ in range(5)]
    streams = {g: _Stream(100 + g) for g in gids}
    fed = {g: [] for g in gids}
    parts = {g: [] for g in gids}

    def collect(served):
        for f in served:
            parts[f.gid].append(f.result)

    for _ in range(10):
        for g in gids:
            chunk = streams[g].next(int(rng.choice(sizes)))
            fed[g].append(chunk)
            collect(cs.feed(g, *chunk))
        collect(cs.pump(force=True))
        if rng.random() < 0.5:
            g = int(rng.choice(gids))
            cs.migrate(g, 1 - cs.shard_of(g))  # always a real move
        if rng.random() < 0.3:
            cs.rebalance()
    collect(_drain_all(cs, gids))
    for g in gids:
        parts[g].append(cs.detach(g))
    return cs, parts, fed


def test_bit_identity_under_randomized_churn():
    """The reference test's schedule (ragged chunks of 60, 100 and 140
    events): every session's concatenated output equals a dedicated
    stream fed the same chunks, and the exchange saw and compressed the
    rounds."""
    cs, parts, fed = _churn_run("port")
    assert cs.migrations >= 2  # the schedule actually churned
    for g in fed:
        assert compare_outputs(concat_outputs(parts[g]), concat_outputs(_dedicated(fed[g])),
                               f"gid {g}") == []
    st = cs.exchange.stats
    assert st["rounds"] > 0 and st["compression_ratio"] > 3.0


@pytest.mark.parametrize("datapath", ["kernel", "fixed"])
def test_randomized_churn_on_the_chip_configs(datapath):
    """The reference test's churn on the chip's two configs (the float
    kernel routes, the fixed megakernel; here their plain versions): each
    session equals its dedicated stream to the bit."""
    batcher = BatcherConfig(**BATCHER)
    config = (PipelineConfig(batcher=batcher, use_kernels=True, metrics_impl="kernel")
              if datapath == "kernel" else
              PipelineConfig(batcher=batcher, numerics="fixed", metrics_impl="megakernel"))
    cs, parts, fed = _churn_run("port", config=config)
    assert cs.migrations >= 2 and cs.exchange.stats["rounds"] > 0
    for g in fed:
        assert compare_outputs(concat_outputs(parts[g]), concat_outputs(_dedicated(fed[g], config)),
                               f"gid {g}") == []


def test_randomized_churn_matches_reference():
    """The same churn in both packages, with every chunk 90 events (the
    rescue test's size, so the reference compiles few step shapes):
    migrations, rebalances, placements, the exchange's byte counts and
    every session's outputs equal the reference's; each session equals
    its dedicated stream to the bit."""
    runs = {pkg: _churn_run(pkg, sizes=(90,)) for pkg in PACKAGES}
    (t, t_parts, fed), (j, j_parts, _) = runs["port"], runs["reference"]
    assert t.migrations >= 2 and t.migrations == j.migrations
    assert (t.rebalances, t.loads) == (j.rebalances, j.loads)
    _assert_sessions({"port": t_parts, "reference": j_parts}, fed)
    assert t.exchange.stats == j.exchange.stats


@pytest.mark.parametrize("pkg", PACKAGES)
def test_explicit_migrate_keeps_gid_and_stats(pkg):
    cs = _make(pkg)
    g0, g1 = cs.attach(), cs.attach()
    cs.feed(g0, *_Stream(7).next(100))
    cs.pump(force=True)
    events_before = cs.session(g0).stats.events
    assert events_before > 0
    src = cs.shard_of(g0)
    cs.migrate(g0, 1 - src)
    assert cs.shard_of(g0) == 1 - src
    assert cs.migrations == 1
    assert cs.session(g0).stats.events == events_before  # record travels
    cs.migrate(g0, 1 - src)  # same-shard move is a no-op
    assert cs.migrations == 1
    assert cs.loads == [0, 2]
    stats = cs.stats()
    assert stats["migrations"] == 1 and len(stats["shards"]) == 2
    cs.detach(g0), cs.detach(g1)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_rebalance_moves_youngest_to_least_loaded(pkg):
    cs = _make(pkg, auto_rebalance=False, rebalance_margin=1)
    gids = [cs.attach() for _ in range(6)]
    for g in gids:  # pile everyone onto shard 0
        if cs.shard_of(g) != 0:
            cs.migrate(g, 0)
    assert cs.loads == [6, 0]
    assert cs.rebalance() == 3 and cs.loads == [3, 3]
    assert [cs.shard_of(g) for g in gids] == [0, 1, 0, 1, 0, 1]  # the youngest local sids moved
    assert cs.rebalances == 1
    assert cs.rebalance() == 0  # already within margin


# ---------------------------------------------------------------------------
# Compressed cross-shard exchange.
# ---------------------------------------------------------------------------


def _rounds(n_sensors, n_rounds, seed=11, reference=False):
    """Real rounds from the port's fleet, fed chunks dense enough to close
    windows, and with ``reference`` the reference fleet's rounds of the
    same chunks: (port rounds, reference rounds or [])."""
    fleet = FleetPipeline(CONFIG, n_sensors=n_sensors, device="cpu")
    j_fleet = JFleetPipeline(J_CONFIG, n_sensors=n_sensors, uniform_fast_path=False) if reference else None
    streams = [_Stream(seed + i, dt_us=60) for i in range(n_sensors)]
    out, j_out = [], []
    for _ in range(n_rounds):
        chunks = [s.next(120) for s in streams]
        out.append(fleet.feed_async(chunks))
        if reference:
            rnd = j_fleet.feed_async(chunks)
            rnd.wait()
            j_out.append(rnd)
    return out, j_out


def _assert_plane_close(got: np.ndarray, want: np.ndarray) -> None:
    """Window and cluster counts exact; metric sums to rtol 1e-5, atol 1e-4."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got[:, 2:], want[:, 2:], rtol=1e-5, atol=1e-4)


def test_exchange_int8_ef_bounds_and_telescoping():
    rounds, j_rounds = _rounds(2, 6, reference=True)
    ex = CrossShardExchange(1, "int8_ef")
    oracle = CrossShardExchange(1, "exact")
    j_ex = JK.CrossShardExchange(1, "int8_ef")
    sum_exact = sum_pub = None
    for rnd, j_rnd in zip(rounds, j_rounds):
        exact = CrossShardExchange.summary_plane(rnd).numpy()
        _assert_plane_close(exact, np.asarray(JK.CrossShardExchange.summary_plane(j_rnd)))
        ef_prev = ex.error_feedback(0)
        ef_prev = np.zeros_like(exact) if ef_prev is None else ef_prev
        ex.push_round(0, rnd)
        oracle.push_round(0, rnd)
        j_ex.push_round(0, j_rnd)
        assert np.array_equal(oracle.latest(0), exact)  # exact mode: the oracle
        deq = ex.latest(0)
        scale = ex.last_scale(0)
        # Per-round bound: symmetric int8 round-to-nearest of the
        # EF-corrected plane never errs by more than half a step.
        assert np.all(np.abs(deq - (exact + ef_prev)) <= scale / 2 + 1e-5)
        sum_exact = exact if sum_exact is None else sum_exact + exact
        sum_pub = deq if sum_pub is None else sum_pub + deq
    # Telescoping: published sums == exact sums - final residual.
    np.testing.assert_allclose(sum_pub, sum_exact - ex.error_feedback(0), rtol=1e-5, atol=1e-3)
    assert ex.columns == oracle.columns == j_ex.columns
    assert ex.columns[:2] == ("windows", "clusters")
    assert ex.stats == j_ex.stats
    assert ex.stats["compression_ratio"] > 3.0
    assert ex.wire_bytes < oracle.wire_bytes


def test_exchange_ef_survives_tier_resize():
    """Growing the slot pool mid-stream resizes the plane; surviving rows
    keep their EF residual (the bound holds with the padded EF)."""
    ex = CrossShardExchange(1, "int8_ef")
    small, _ = _rounds(2, 2, seed=21)
    big, _ = _rounds(4, 1, seed=22)
    for rnd in small:
        ex.push_round(0, rnd)
    ef_prev = ex.error_feedback(0)
    assert ef_prev.shape[0] == 2
    exact = CrossShardExchange.summary_plane(big[0]).numpy()
    padded = np.zeros_like(exact)
    padded[:2] = ef_prev
    ex.push_round(0, big[0])
    assert np.all(np.abs(ex.latest(0) - (exact + padded)) <= ex.last_scale(0) / 2 + 1e-5)
    assert ex.error_feedback(0).shape[0] == 4


def test_exchange_off_and_validation():
    ex = CrossShardExchange(2, "off")
    for rnd in _rounds(1, 1)[0]:
        ex.push_round(0, rnd)
    assert ex.latest(0) is None and ex.rounds == 0 and ex.view() == {}
    with pytest.raises(ValueError, match="exchange mode"):
        CrossShardExchange(2, "zstd")
    with pytest.raises(ValueError, match="exchange mode"):
        _make(exchange="gzip")
