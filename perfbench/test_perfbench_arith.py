"""The harness's arithmetic: the end-to-end metrics over every unit of the
window, the trace's reductions, and the frozen cost counts."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from harness import costs, reference, traffic
from harness.bench import Run, Unit
from harness.trace import UNIT_SPAN, Trace, from_events

HERE = Path(__file__).resolve().parent
CONFIG = json.loads((HERE / "configs" / "archive.json").read_text())
NONE = np.zeros((0, 3), np.int64)  # a unit that produced no window


@pytest.fixture(autouse=True)
def _one_thread():
    """One host thread: the stride recording's reference shares the host
    with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read(name: str, run: Run):
    spec = importlib.util.spec_from_file_location(name, HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def _run(units, window_s=2.0, trace=None, figures=None, traced=()):
    return Run(cell={}, config=CONFIG, traffic={}, units=units, window_s=window_s, setup_s=7.5,
               trace=trace, figures=figures or [], params=reference.Params.from_config(CONFIG["pipeline"]),
               traced=list(traced))


def _round(ms: float, events: int = 100, submit_ms: float = 1.0) -> Unit:
    return Unit(events=events, windows=2, steps=1, seconds=ms / 1e3, spans=NONE, submit_s=submit_ms / 1e3)


def test_rate_counts_every_unit_over_the_whole_window():
    units = [_round(10.0, events=e) for e in (100, 300, 600)]
    assert _read("events_per_s", _run(units, window_s=2.0)) == pytest.approx(500.0)
    assert _read("setup_s", _run(units)) == 7.5


def test_p95_is_over_every_round():
    # 100 rounds: 90 fast, 10 slow. The p95 of all rounds lies among the
    # slow ones; a median of 20-round chunks would read 1 ms.
    ms = [1.0] * 90 + [50.0] * 10
    rng = np.random.default_rng(0)
    units = [_round(m) for m in rng.permutation(ms)]
    assert _read("fleet.round_p95_ms", _run(units)) == pytest.approx(float(np.percentile(ms, 95)))
    assert _read("fleet.round_p95_ms", _run(units)) == pytest.approx(50.0)
    archive_pass = Unit(events=1, windows=1, steps=1, seconds=3.0, spans=NONE)
    assert _read("fleet.round_p95_ms", _run([archive_pass])) is None
    assert _read("fleet.submit_ms", _run([_round(5.0, submit_ms=2.0), _round(5.0, submit_ms=4.0)])) == 3.0


def _trace() -> Trace:
    ms = 1_000_000
    ranges = {
        UNIT_SPAN: np.array([[0, 100 * ms]]),
        "tracker": np.array([[10 * ms, 30 * ms], [60 * ms, 70 * ms]]),
        "clustering": np.array([[40 * ms, 45 * ms]]),
        "metrics": np.array([[45 * ms, 50 * ms]]),
        "conditioning": np.array([[35 * ms, 40 * ms]]),
    }
    device = [  # (name, kind, start, end, correlation)
        ("cluster_accum_kernel", "kernel", 42 * ms, 44 * ms, 1),
        ("patch_metrics_kernel", "kernel", 46 * ms, 52 * ms, 2),
        ("elementwise", "kernel", 20 * ms, 25 * ms, 3),
        ("Memcpy DtoH", "gpu_memcpy", 24 * ms, 30 * ms, 4),
    ]
    launch_at = {1: 41 * ms, 2: 46 * ms, 3: 15 * ms, 4: 24 * ms}
    return Trace(ranges, device, launch_at)


def test_trace_reductions():
    tr = _trace()
    assert tr.window_s == pytest.approx(0.1)
    assert tr.busy_s() == pytest.approx(0.018)  # 20-30, 42-44, 46-52 ms
    assert tr.host_s("tracker") == pytest.approx(0.030)
    # Kernels launched inside clustering or metrics, whatever their names.
    assert tr.launched_in_s(("clustering", "metrics")) == pytest.approx(0.008)
    assert tr.launched_in_s(("wire decode",)) is None
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["patch_metrics_kernel", pytest.approx(0.006)]
    # Gaps 0-20, 30-42, 44-46, 52-100 ms, each by the innermost range at
    # its middle.
    idle = dict(bd["idle_gaps"])
    assert idle == pytest.approx({"tracker": 0.020, "conditioning": 0.012, "metrics": 0.002,
                                  UNIT_SPAN: 0.048})
    run = _run([], trace=tr, traced=[Unit(events=10, windows=1000, steps=4, seconds=0.1, spans=NONE)])
    assert _read("device.idle_pct", run) == pytest.approx(82.0)
    assert _read("tracker.ms_per_step", run) == pytest.approx(7.5)
    assert _read("window_core.ms_per_kwin", run) == pytest.approx(15.0)


def test_host_clock_readings_skip_the_traced_stretch():
    # The window's rounds are untraced; the traced stretch's run slower
    # under the profiler and feed only the span and device readings.
    window = [_round(10.0, submit_ms=2.0) for _ in range(40)]
    traced = [Unit(events=10, windows=250, steps=1, seconds=0.05, spans=NONE, submit_s=0.008)
              for _ in range(4)]
    run = _run(window, window_s=0.4, trace=_trace(), traced=traced)
    assert _read("fleet.submit_ms", run) == pytest.approx(2.0)
    assert _read("fleet.round_p95_ms", run) == pytest.approx(10.0)
    assert _read("events_per_s", run) == pytest.approx(40 * 100 / 0.4)
    assert _read("tracker.ms_per_step", run) == pytest.approx(30.0 / 4)
    assert _read("window_core.ms_per_kwin", run) == pytest.approx(15.0)


def test_chrome_trace_events_are_read_by_category():
    events = [
        {"ph": "X", "cat": "user_annotation", "name": UNIT_SPAN, "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "user_annotation", "name": "metrics", "ts": 10.0, "dur": 20.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 12.0, "dur": 3.0,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 20.0, "dur": 4.5, "args": {"correlation": 7}},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "metrics", "ts": 20.0, "dur": 4.5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 11.0, "dur": 1.0},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 50.0},
    ]
    tr = from_events(events)
    assert set(tr.ranges) == {UNIT_SPAN, "metrics"}
    assert tr.device == [("k", "kernel", 20_000, 24_500, 7)]
    assert tr.launch_at == {7: 12_000}
    assert tr.launched_in_s(("metrics",)) == pytest.approx(4.5e-6)
    assert tr.busy_s() == pytest.approx(4.5e-6)


def test_roofline_share_of_launched_kernels():
    fig = dict(events=np.array([250, 250]), kept=np.array([240, 100]), cells=np.array([3, 0]),
               slots=np.array([2, 0]), in_patch=np.array([30, 0]), candidates=np.array([150, 0]))
    run = _run([], trace=_trace(), figures=[fig],
               traced=[Unit(events=500, windows=2, steps=2, seconds=0.1, spans=np.array([[0, 0, 2]]))])
    p = run.params
    want = (costs.seconds(*costs.cluster_stage(fig, 256, 32, p.n_cells))
            + costs.seconds(*costs.metrics_stage(fig, 256, 32)))
    assert _read("kernels.stages_roofline", run) == pytest.approx(100 * want / 0.008)
    assert 0 < _read("kernels.stages_roofline", run) < 100


def test_k3_count_reproduces_the_stride_bound():
    """``chip_smoke.py``'s K3 stride cell: the scale recording (seed 11,
    60 s, 4 RSOs, 20 kHz noise) in 100 ms stride windows at capacity
    4,096 reads 10.79 MB, 19,053 valid slots, 1,589 kept events a window."""
    ev = traffic.make_recording(11, duration_s=60, n_rsos=4, noise_rate_hz=20_000)
    spans = np.asarray(traffic.chunk_bounds(ev.t, 100_000))
    pipe = dict(CONFIG["pipeline"], batcher=dict(CONFIG["pipeline"]["batcher"], capacity=4096))
    p = reference.Params.from_config(pipe)
    planes = reference.pack(ev, spans[:, 0], spans[:, 1], 4096, "cpu")
    fig = {k: v.numpy() for k, v in reference.window_stages(planes, p, torch.float32)["figures"].items()}
    nbytes, _ = costs.metrics_stage(fig, 4096, 32)
    assert len(spans) == 600 and int(fig["slots"].sum()) == 19_053
    assert round(nbytes / 1e6, 2) == 10.79
    assert costs.seconds(nbytes, 0) * 1e3 == pytest.approx(0.0032, abs=5e-5)
