"""The port's shard chaos harness (``repro_torch.serve.chaos_shards``)
on the CPU, against the JAX package's.

The shard chaos cases of ``tests/test_constellation.py``: the reference's
smoke config in both packages, with equal reports (fault counts,
migrations, rebalances, rescues, lost sessions, quarantines, evictions,
degraded rounds, healthy windows, the exchange's stats and the error
records' kind, session id and fake-clock time; the message texts are not
compared) and healthy outputs equal to
``tests/test_torch_serve_service.py``'s bounds (integers exact, metrics
rtol = atol = 1e-5, tracker floats rtol 1e-6, atol 1e-4); the whole
taxonomy on the float kernel config, with the invariants of
``repro_torch.serve.chaos_shards``; config validation.
"""
import dataclasses

import pytest
import torch

from repro.serve import chaos_shards as JCS
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.serve.chaos_shards import (
    SHARD_FAULT_TAXONOMY,
    ShardChaosConfig,
    ShardChaosHarness,
)
from test_torch_serve_service import _assert_same, _surfaces

torch.set_num_threads(1)


def _keeping(cls):
    """The harness class with its faulted run's record kept."""

    class Keep(cls):
        def _run_faulted(self):
            self.faulted = super()._run_faulted()
            return self.faulted

    return Keep


def _shard_report(r) -> dict:
    d = {k: getattr(r, k) for k in (
        "rounds", "fired", "migrations", "rebalances", "rescues", "lost_sessions", "quarantines",
        "evictions", "degraded_rounds", "healthy_windows", "escaped_errors", "bit_identical",
        "exchange")}
    d["errors"] = [(e.kind, e.sid, e.time_s) for e in r.errors]
    return d


def test_shard_chaos_smoke_matches_reference():
    """The reference's smoke config in both packages: equal reports (the
    message texts aside) and equal healthy outputs; within the port the
    healthy sessions are bit-identical to dedicated streams."""
    cfg = ShardChaosConfig(n_sensors=4, n_faulty=1, n_rounds=24, seed=3,
                           faults=("stall", "burst", "migrate", "rebalance", "shard_stall"))

    t = _keeping(ShardChaosHarness)(cfg, device="cpu")
    j = _keeping(JCS.ShardChaosHarness)(JCS.ShardChaosConfig(**dataclasses.asdict(cfg)))
    rep, j_rep = t.run(), j.run()
    assert rep.bit_identical, rep.mismatches
    assert rep.lost_sessions == 0 and rep.escaped_errors == [] and rep.rescues >= 1
    assert all(rep.fired.get(k, 0) >= 1 for k in cfg.faults), rep.fired
    assert rep.exchange["compression_ratio"] > 3.0
    assert t.schedule() == j.schedule()
    assert _shard_report(rep) == _shard_report(j_rep)
    tp, jp = t.faulted["healthy_parts"], j.faulted["healthy_parts"]
    assert sorted(tp) == sorted(jp)
    for s in tp:
        _assert_same(_surfaces(tp[s]), _surfaces(jp[s]), exact=False, what=f"healthy sensor {s}")


def test_feeding_fault_inside_a_stall_reattaches_unlike_reference():
    """At seed 3 a feeding fault lands inside a later-placed stall, after
    the heartbeat evicted the sensor: the reference feeds the evicted
    session and records an escaped ``RuntimeError``, the port re-attaches
    first (ROADMAP §3). Both keep every healthy session bit-identical and
    lose none, and the healthy outputs agree across the packages."""
    cfg = ShardChaosConfig(n_sensors=4, n_faulty=2, n_rounds=48, seed=3)
    t, j = _keeping(ShardChaosHarness)(cfg, device="cpu"), _keeping(JCS.ShardChaosHarness)(
        JCS.ShardChaosConfig(**dataclasses.asdict(cfg)))
    rep, j_rep = t.run(), j.run()
    assert len(j_rep.escaped_errors) == 1 and "is evicted" in j_rep.escaped_errors[0]
    assert rep.escaped_errors == [] and rep.bit_identical and j_rep.bit_identical
    assert rep.lost_sessions == j_rep.lost_sessions == 0
    tp, jp = t.faulted["healthy_parts"], j.faulted["healthy_parts"]
    for s in tp:
        _assert_same(_surfaces(tp[s]), _surfaces(jp[s]), exact=False, what=f"healthy sensor {s}")


def test_shard_chaos_full_taxonomy_on_the_chip_config():
    """The whole shard taxonomy on the float kernel config (the chip's
    phase 7c config, here on the kernels' plain versions): the invariants
    hold with a rescue and no lost session."""
    cfg = ShardChaosConfig(n_shards=2, n_sensors=6, n_faulty=2, n_rounds=48, seed=7)
    rep = ShardChaosHarness(cfg, PipelineConfig(use_kernels=True, metrics_impl="kernel"),
                            device="cpu").run()
    assert rep.bit_identical, rep.mismatches
    assert rep.escaped_errors == [] and rep.lost_sessions == 0 and rep.rescues >= 1
    assert min(rep.fired.values()) >= 1 and set(rep.fired) == set(SHARD_FAULT_TAXONOMY)


def test_shard_chaos_config_validation():
    with pytest.raises(ValueError, match=">= 2 shards"):
        ShardChaosConfig(n_shards=1)
    with pytest.raises(ValueError, match="unknown faults"):
        ShardChaosConfig(faults=("meteor",))
    with pytest.raises(ValueError, match="shard_stall_rounds"):
        ShardChaosConfig(shard_stall_rounds=2, rescue_after_degraded_rounds=2)
    assert set(SHARD_FAULT_TAXONOMY) > {"migrate", "rebalance", "shard_stall"}
    assert SHARD_FAULT_TAXONOMY == JCS.SHARD_FAULT_TAXONOMY
