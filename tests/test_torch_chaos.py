"""The port's chaos harness (``repro_torch.serve.chaos``) on the CPU,
against the JAX package's.

The ``SMALL`` config of ``tests/test_chaos.py`` runs in both packages:
the same seeded schedule, the same ``fired`` counts, service counters,
shed accounting and error records (kind, session id and fake-clock time;
the message text is not compared), and every healthy session's outputs
equal to the reference's to ``tests/test_torch_serve_service.py``'s
bounds (integers exact, metrics rtol = atol = 1e-5, tracker floats rtol
1e-6, atol 1e-4). Then the invariant tests of ``tests/test_chaos.py``
against the port: every fault fires, none escapes, healthy sessions are
bit-identical to the fault-free twin, shed accounting is exact, and the
quarantine, eviction and retry paths are all taken — on the default, the
float kernel and the fixed megakernel configs.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.serve import chaos as JC
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.serve.chaos import (
    FAULT_TAXONOMY,
    ChaosConfig,
    ChaosHarness,
    compare_outputs,
)
from test_torch_serve_service import _assert_same, _surfaces

torch.set_num_threads(1)

SMALL = ChaosConfig(n_sensors=5, n_faulty=2, n_rounds=32, tiers=(4, 8), seed=3)
KERNEL_CFG = PipelineConfig(use_kernels=True, metrics_impl="kernel")
FIXED_CFG = PipelineConfig(numerics="fixed", metrics_impl="megakernel")


def _keeping(cls):
    """The harness class with its faulted run's record kept, so the
    healthy sessions' outputs can be compared across packages."""

    class Keep(cls):
        def _run_faulted(self):
            self.faulted = super()._run_faulted()
            return self.faulted

    return Keep


def _both(cfg: ChaosConfig):
    t = _keeping(ChaosHarness)(cfg, device="cpu")
    j = _keeping(JC.ChaosHarness)(JC.ChaosConfig(**dataclasses.asdict(cfg)))
    return (t, t.run()), (j, j.run())


def _errors(report) -> list:
    return [(e.kind, e.sid, e.time_s) for e in report.errors]


def _counters(report) -> dict:
    return {k: getattr(report, k) for k in (
        "rounds", "fired", "quarantines", "evictions", "degraded_rounds", "step_retries",
        "demotions", "healthy_windows", "shed", "escaped_errors", "bit_identical")}


def _assert_matches_reference(both) -> None:
    (t, tr), (j, jr) = both
    assert t.schedule() == j.schedule()
    assert _counters(tr) == _counters(jr)
    assert _errors(tr) == _errors(jr)
    tp, jp = t.faulted["healthy_parts"], j.faulted["healthy_parts"]
    assert sorted(tp) == sorted(jp)
    for sid in tp:
        _assert_same(_surfaces(tp[sid]), _surfaces(jp[sid]), exact=False, what=f"healthy {sid}")


@pytest.fixture(scope="module")
def both_small():
    return _both(SMALL)


@pytest.fixture(scope="module")
def report(both_small):
    """The port's full-taxonomy run, shared by the invariant tests."""
    return both_small[0][1]


# ---------------------------------------------------------------------------
# Against the JAX package.
# ---------------------------------------------------------------------------


def test_small_config_matches_reference(both_small):
    """Schedule, fired counts, counters, shed, error records and every
    healthy session's outputs equal the reference's."""
    _assert_matches_reference(both_small)
    assert both_small[0][1].healthy_windows > 0


def test_degraded_rounds_match_reference():
    """The step_exception-only schedule of ``tests/test_chaos.py`` (both
    retry variants) in both packages: equal reports and healthy outputs."""
    cfg = ChaosConfig(n_sensors=4, n_faulty=1, n_rounds=24, tiers=(4,), seed=11,
                      faults=("step_exception",))
    both = _both(cfg)
    _assert_matches_reference(both)
    rep = both[0][1]
    assert rep.step_retries >= 1 and rep.degraded_rounds >= 1 and rep.bit_identical


def test_feeding_fault_inside_a_stall_reattaches_unlike_reference():
    """At seed 15 the guarantee pass puts a feeding fault on a sensor inside
    a stall it placed later, after the heartbeat evicted that sensor. The
    reference feeds the evicted session and records an escaped
    ``RuntimeError``; the port re-attaches the sensor first, as its round
    loop does, so nothing escapes (ROADMAP §3). The healthy sessions never
    see the difference: their outputs equal the reference's."""
    cfg = ChaosConfig(n_sensors=4, n_faulty=2, n_rounds=48, tiers=(4, 8), seed=15)
    (t, tr), (j, jr) = _both(cfg)
    assert len(jr.escaped_errors) == 1 and "is evicted" in jr.escaped_errors[0]
    assert tr.escaped_errors == [] and tr.bit_identical and jr.bit_identical
    assert t.schedule() == j.schedule() and tr.fired == jr.fired
    tp, jp = t.faulted["healthy_parts"], j.faulted["healthy_parts"]
    for sid in tp:
        _assert_same(_surfaces(tp[sid]), _surfaces(jp[sid]), exact=False, what=f"healthy {sid}")


# ---------------------------------------------------------------------------
# The invariants of tests/test_chaos.py against the port.
# ---------------------------------------------------------------------------


def test_every_fault_fires_at_least_once(report):
    assert set(report.fired) == set(FAULT_TAXONOMY)
    missing = [k for k, n in report.fired.items() if n < 1]
    assert not missing, f"faults never injected: {missing}"


def test_no_fault_escapes_the_service(report):
    assert report.escaped_errors == []


def test_healthy_sessions_bit_identical_under_faults(report):
    assert report.healthy_windows > 0  # the comparison is not vacuous
    assert report.bit_identical, report.mismatches


def test_shed_accounting_is_exact(report):
    shed = report.shed
    assert shed["exact"]
    assert shed["offered"] == shed["accepted"] + shed["shed"]
    assert shed["shed"] > 0  # the burst fault actually exercised the budget


def test_faults_leave_structured_error_records(report):
    kinds = {e.kind for e in report.errors}
    assert "validation" in kinds  # non_monotone / duplicate / garbage_coords
    assert "evicted" in kinds  # stall -> heartbeat eviction
    n_validation = sum(e.kind == "validation" for e in report.errors)
    assert n_validation == report.quarantines
    assert all(e.message for e in report.errors)
    assert all(e.sid >= 0 and e.time_s >= 0.0 for e in report.errors)


def test_quarantine_eviction_and_retry_paths_all_taken(report):
    assert report.quarantines >= 1
    assert report.evictions >= 1
    assert report.step_retries + report.degraded_rounds >= 1


def test_schedule_is_deterministic_per_seed():
    assert ChaosHarness(SMALL).schedule() == ChaosHarness(SMALL).schedule()
    other = ChaosHarness(dataclasses.replace(SMALL, seed=4)).schedule()
    assert other != ChaosHarness(SMALL).schedule()
    assert other == JC.ChaosHarness(JC.ChaosConfig(**dataclasses.asdict(
        dataclasses.replace(SMALL, seed=4)))).schedule()


def test_degraded_rounds_recover_bit_identically():
    """Only step_exception faults: heal-within-retries and retry-exhausted
    degraded rounds; the restored-and-refed chunks match the fault-free
    run bitwise."""
    cfg = ChaosConfig(n_sensors=4, n_faulty=1, n_rounds=24, tiers=(4,), seed=11,
                      faults=("step_exception",))
    rep = ChaosHarness(cfg, device="cpu").run()
    assert rep.fired["step_exception"] >= 2
    assert rep.step_retries >= 1
    assert rep.degraded_rounds >= 1
    assert rep.escaped_errors == []
    assert rep.bit_identical, rep.mismatches
    assert any(e.kind == "degraded_round" for e in rep.errors)


def test_eviction_churn_interleaved_with_live_feeds():
    """Heartbeat evictions and attach/detach churn interleave with live
    feeds on the other slots without perturbing the healthy streams."""
    cfg = ChaosConfig(n_sensors=5, n_faulty=2, n_rounds=36, tiers=(4, 8), seed=5,
                      faults=("stall", "churn"))
    rep = ChaosHarness(cfg, device="cpu").run()
    assert rep.fired["stall"] >= 1 and rep.fired["churn"] >= 1
    assert rep.evictions >= 1
    assert rep.escaped_errors == []
    assert rep.healthy_windows > 0
    assert rep.bit_identical, rep.mismatches
    assert any(e.kind == "evicted" for e in rep.errors)


@pytest.mark.parametrize("pipeline", [KERNEL_CFG, FIXED_CFG], ids=["kernel", "fixed"])
def test_full_taxonomy_on_the_card_configs(pipeline, report):
    """The chip's two configs (float kernel routes, fixed megakernel) under
    the full taxonomy, here on the kernels' plain versions: the invariants
    hold and the report equals the default config's (every counter is a
    property of the schedule, not of the datapath)."""
    rep = ChaosHarness(SMALL, pipeline, device="cpu").run()
    assert rep.escaped_errors == [] and rep.bit_identical, rep.mismatches
    assert min(rep.fired.values()) >= 1 and rep.shed["exact"]
    assert (rep.quarantines, rep.evictions, rep.shed, _errors(rep)) == \
        (report.quarantines, report.evictions, report.shed, _errors(report))


def test_chaos_config_validation():
    with pytest.raises(ValueError, match="n_faulty"):
        ChaosConfig(n_sensors=3, n_faulty=3)
    with pytest.raises(ValueError, match="unknown faults"):
        ChaosConfig(faults=("non_monotone", "gremlins"))
    with pytest.raises(ValueError, match="stall_rounds"):
        ChaosConfig(heartbeat_rounds=4, stall_rounds=5)
    with pytest.raises(ValueError, match="queue budget"):
        ChaosConfig(chunk_events=900, queue_budget_events=800)


def test_compare_outputs_flags_real_differences():
    a = [np.arange(6).reshape(2, 3), np.ones(4)]
    assert compare_outputs(a, [x.copy() for x in a], "s") == []
    b = [np.arange(6).reshape(2, 3), np.zeros(4)]
    bad = compare_outputs(a, b, "s")
    assert len(bad) == 1 and "4/4 elements differ" in bad[0]
    assert compare_outputs(a, a[:1], "s") == ["s: 2 surfaces vs 1"]
    c = [np.arange(6).reshape(3, 2), np.ones(4)]
    assert "shape" in compare_outputs(a, c, "s")[0]
