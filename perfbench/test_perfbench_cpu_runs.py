"""Whole runs of the cells on the CPU at small sizes, the card's check
skipped: the port (its kernels' plain versions) against the frozen
reference comes out correct; the control (the reference in bfloat16 in
the program's place) and each fault planted in the timed path come out
not correct."""
import json
import time
from pathlib import Path

import pytest
import torch

from harness import bench

HERE = Path(__file__).resolve().parent
SEED = 2**33 + 17  # past 32 bits, as the driver's seeds are
SMALL = {
    "archive.suite": dict(count=5, duration_s=0.4, warmup_passes=1, trace_units=1),
    "fleet18.suite": dict(lap_s=0.3, warmup_rounds=3, trace_units=6, sample_every=2),
}


@pytest.fixture(autouse=True)
def _one_thread():
    """One host thread, as ``run.py`` sets: these whole runs share the
    host with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(cell: str, trace: bool = False, control: bool = False, seconds: float = 0.5) -> dict:
    traffic = json.loads((HERE / "workloads" / f"{cell}.json").read_text())["traffic"]
    traffic.update(SMALL[cell])
    return bench.run_cell(cell, SEED, seconds, trace, time.perf_counter(), device="cpu",
                          control=control, traffic=traffic)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_port_agrees_with_the_reference(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert {"events_per_s", "setup_s"} <= set(out["metrics"])
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_traced_run_reads_the_program_spans(cell):
    out = _run(cell, trace=True)
    assert out["correct"], out["checks"]
    assert {"tracker.ms_per_step", "window_core.ms_per_kwin"} <= set(out["metrics"])
    assert ("fleet.round_p95_ms" in out["metrics"]) == cell.startswith("fleet")
    # No device on the CPU: no kernel share and no idle share.
    assert "kernels.stages_roofline" not in out["metrics"] and "device.idle_pct" not in out["metrics"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # The traced stretch follows the measured window: both count.
    assert out["attempted"] > SMALL[cell]["trace_units"]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_is_not_correct(cell):
    out = _run(cell, control=True)
    assert not out["correct"]
    checks = out["checks"]
    assert checks["metric_gap"]["value"] > checks["metric_gap"]["limit"]
    assert checks["centroid_gap"]["value"] > checks["centroid_gap"]["limit"]


def test_fleet_flattens_its_sample_after_the_window(monkeypatch):
    """A sampled round's host views are only kept inside the window; the
    copies into flat arrays come once it has closed."""
    from harness.drivers import fleet

    config = json.loads((HERE / "configs" / "fleet18.json").read_text())
    traffic = json.loads((HERE / "workloads" / "fleet18.suite.json").read_text())["traffic"]
    traffic.update(SMALL["fleet18.suite"], sample_every=1)
    calls = []
    original = fleet._answers
    monkeypatch.setattr(fleet, "_answers", lambda *a: calls.append(a) or original(*a))
    session = fleet.Session(config, traffic, SEED, "cpu")
    session.setup()
    for _ in range(5):
        session.step()
    session.drain()
    assert calls == [] and len(session.done) == traffic["warmup_rounds"] + 5
    answers = session.answers()
    assert len(calls) == 5 and len(answers.stream) == sum(u.windows for u in session.done[-5:])


def _state_unchanged(monkeypatch):
    from repro_torch.core import tracking

    def frozen(state, clusters, cluster_entropy, config=tracking.TrackerConfig()):
        return state, torch.full(state.x.shape, -1, dtype=torch.int32)

    monkeypatch.setattr(tracking, "tracker_step", frozen)


def _half_the_batch(monkeypatch):
    from repro_torch.core.pipeline import scan

    original = scan._window_core

    def half(config, hist_fn, metrics_fn, batch):
        keep = torch.arange(batch.x.shape[0]) < (batch.x.shape[0] + 1) // 2
        return original(config, hist_fn, metrics_fn, batch._replace(valid=batch.valid & keep[:, None]))

    monkeypatch.setattr(scan, "_window_core", half)


def _altered_metric(monkeypatch):
    from repro_torch.kernels import ops

    original = ops.patch_metrics

    def altered(batch, clusters, **kw):
        out = original(batch, clusters, **kw)
        out["local_contrast"] = out["local_contrast"] * 1.05
        return out

    monkeypatch.setattr(ops, "patch_metrics", altered)


def _altered_centroid(monkeypatch):
    from repro_torch.kernels import ops

    original = ops.cluster_accum_topk

    def altered(x, y, t, valid, grid):
        cl = original(x, y, t, valid, grid)
        return cl._replace(centroid_x=torch.where(cl.valid, cl.centroid_x + 1.0, cl.centroid_x))

    monkeypatch.setattr(ops, "cluster_accum_topk", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_batch, _altered_metric, _altered_centroid],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_fault_in_the_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    assert not _run(cell, seconds=0.2)["correct"]
