"""The port stands alone: importing it loads neither ``jax`` nor the JAX
package, no source of the port, of ``chip_smoke.py`` or of the port's
scripts imports them, and
its entry points refuse to run silently on the CPU when a card was asked
for (the default) and none is present."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
STANDALONE = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"] + sorted(
    (REPO / "examples").glob("torch_*.py")) + sorted((REPO / "tools").glob("torch_*.py"))


def _modules():
    return sorted(
        ".".join(p.relative_to(REPO / "src").with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )


def test_every_module_of_the_port_is_covered():
    mods = _modules()
    for m in ("repro_torch.core.fixed_point", "repro_torch.kernels.window_pipeline",
              "repro_torch.kernels.ops", "repro_torch.data.adversarial",
              "repro_torch.core.pipeline.stream", "repro_torch.core.pipeline.fleet",
              "repro_torch.distributed.sharding", "repro_torch.data.evas",
              "repro_torch.kernels.event_unpack", "repro_torch.kernels.grid_quantize",
              "repro_torch.kernels.window_entropy", "repro_torch.core.pipeline.oracles",
              "repro_torch.core.pipeline.window_core", "repro_torch.core.pipeline.evaluate",
              "repro_torch.data.synthetic", "repro_torch.core.grid_clustering",
              "repro_torch.core.baselines", "repro_torch.distributed.fault_tolerance",
              "repro_torch.serve", "repro_torch.serve.batcher", "repro_torch.serve.sessions",
              "repro_torch.serve.faults", "repro_torch.serve.service",
              "repro_torch.distributed.compression", "repro_torch.serve.chaos",
              "repro_torch.serve.constellation", "repro_torch.serve.chaos_shards"):
        assert m in mods, m
    assert {p.stem for p in (PORT / "kernels" / "csrc").glob("*.cu")} == {
        "cluster_accum", "patch_metrics", "window_pipeline",
        "event_unpack", "grid_quantize", "window_entropy"}
    assert {p.name for p in (REPO / "examples").glob("torch_*.py")} == {
        "torch_quickstart.py", "torch_fleet_quickstart.py", "torch_serve_detections.py",
        "torch_stream_quickstart.py", "torch_constellation_quickstart.py"}


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(bad), bad[:5])\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("0 "), out.stdout


@pytest.mark.parametrize("path", STANDALONE, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import_in_source(path):
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    assert not pat.findall(path.read_text()), path


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card refusal cannot be shown here")


def test_entry_points_default_to_cuda_and_refuse_without_a_card():
    _no_card()
    from repro_torch import resolve_device
    from repro_torch.core.events import (
        batch_from_arrays, dual_threshold_batches, make_empty_batch, pad_windows, window_batches,
    )
    from repro_torch.core.pipeline import (
        FleetPipeline, PipelineConfig, StreamingPipeline, collect_candidates_loop,
        collect_candidates_many, collect_candidates_numpy, evaluate_detection, run_many_scan,
        run_recording, run_recording_scan, threshold_sweep,
    )
    from repro_torch.core.tracking import init_tracks, tracks_from_numpy, tracks_to_numpy
    from repro_torch.data.synthetic import make_recording
    from repro_torch.serve import (
        ChaosConfig, ChaosHarness, ConstellationService, DetectionService, ShardChaosConfig,
        ShardChaosHarness,
    )

    rec = make_recording(seed=1, duration_s=0.05)
    for call in (
        lambda: resolve_device(),
        lambda: pad_windows(rec.x, rec.y, rec.t, rec.p),
        lambda: run_recording_scan(rec),
        lambda: run_recording_scan(rec, PipelineConfig(use_kernels=True, metrics_impl="kernel")),
        lambda: run_recording_scan(rec, PipelineConfig(numerics="fixed", metrics_impl="megakernel")),
        lambda: evaluate_detection(rec, PipelineConfig(numerics="fixed")),
        lambda: evaluate_detection(rec),
        lambda: init_tracks(),
        lambda: tracks_from_numpy(tracks_to_numpy(init_tracks(device="cpu"))),
        lambda: StreamingPipeline(),
        lambda: StreamingPipeline(wire="ragged"),
        lambda: FleetPipeline(n_sensors=4),
        lambda: FleetPipeline(PipelineConfig(use_kernels=True, metrics_impl="kernel"), n_sensors=16),
        lambda: make_empty_batch(),
        lambda: batch_from_arrays(rec.x, rec.y, rec.t - rec.t[0], rec.p),
        lambda: next(dual_threshold_batches(rec.x, rec.y, rec.t, rec.p)),
        lambda: next(window_batches(rec.x, rec.y, rec.t, rec.p)),
        lambda: pad_windows(rec.x, rec.y, rec.t, rec.p, policy="stride"),
        lambda: run_recording(rec),
        lambda: run_recording(rec, PipelineConfig(numerics="fixed", metrics_impl="megakernel")),
        lambda: run_many_scan([rec]),
        lambda: threshold_sweep([rec]),
        lambda: threshold_sweep([rec], driver="fleet"),
        lambda: collect_candidates_many([rec]),
        lambda: collect_candidates_numpy(rec),
        lambda: collect_candidates_loop(rec),
        lambda: DetectionService(),
        lambda: DetectionService(PipelineConfig(use_kernels=True, metrics_impl="kernel")),
        lambda: DetectionService(PipelineConfig(numerics="fixed", metrics_impl="megakernel"),
                                 tiers=(4, 8, 16, 32)),
        lambda: ConstellationService(),
        lambda: ConstellationService(PipelineConfig(use_kernels=True, metrics_impl="kernel"),
                                     n_shards=4, tiers=(4, 8, 16)),
        lambda: ConstellationService(devices=["cuda"]),
        lambda: ChaosHarness().run(),
        lambda: ChaosHarness(ChaosConfig(n_sensors=16, n_faulty=4),
                             PipelineConfig(numerics="fixed", metrics_impl="megakernel")).run(),
        lambda: ShardChaosHarness().run(),
        lambda: ShardChaosHarness(ShardChaosConfig(n_shards=4)).run(),
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_fails_without_a_card():
    _no_card()
    out = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")], capture_output=True, text=True,
        cwd=REPO, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_example_quickstart_runs_on_the_cpu_when_asked():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / "torch_quickstart.py"), "--device", "cpu",
         "--duration", "0.3"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "Detection accuracy" in out.stdout
    assert np.isfinite(float(re.search(r"accuracy vs ground truth: ([\d.]+)%", out.stdout)[1]))


def test_example_quickstart_runs_the_fixed_path_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / "torch_quickstart.py"), "--device", "cpu",
         "--numerics", "fixed"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "Processed 100 windows" in out.stdout and "Confirmed tracks: 2" in out.stdout
    assert "(tp=199 fp=4 fn=5 tn=562)" in out.stdout


def test_example_fleet_quickstart_runs_on_the_cpu_when_asked():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / "torch_fleet_quickstart.py"), "--device", "cpu",
         "--duration", "0.4"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "Processed" in out.stdout and "fleet rounds" in out.stdout
    assert out.stdout.count("confirmed tracks") == 4


@pytest.mark.parametrize("numerics", ["float", "fixed"])
def test_example_serve_detections_runs_on_the_cpu_when_asked(numerics):
    """The serving example's schedule on the CPU: five stations, the 4 -> 8
    promotion, one detach, no retry and no degraded round."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / "torch_serve_detections.py"), "--device", "cpu",
         "--duration", "0.6", "--numerics", numerics],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "DetectionService up on cpu" in out.stdout
    assert "(pool promoted: capacity 8, promotions 1)" in out.stdout
    assert "session 0 detached" in out.stdout and out.stdout.count("confirmed tracks at detach") == 5
    assert "Promotions 1, step retries 0, degraded rounds 0" in out.stdout


def test_example_stream_quickstart_runs_on_the_cpu_when_asked():
    """The port's stream example on the CPU prints the reference
    example's windows, detections and tracks."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / "torch_stream_quickstart.py"), "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "Processed 100 windows from 100 chunked feeds on cpu." in out.stdout
    assert "Clusters passing min_events=5: 203" in out.stdout
    assert "Confirmed tracks: 2" in out.stdout
    assert "track 0: pos=( 267.1, 253.1) vel=(-1.98,-1.33) px/win hits=95" in out.stdout
    assert "track 1: pos=( 453.2, 397.0) vel=(+2.27,+1.86) px/win hits=95" in out.stdout


def test_example_constellation_quickstart_runs_on_the_cpu_when_asked():
    """The port's constellation example on the CPU: the reference
    example's placement, migration, rescue, revival and window count."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / "torch_constellation_quickstart.py"),
         "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "constellation up: 2 shards on cpu, 8 slots total, exchange=int8_ef" in out.stdout
    for i, fam in enumerate(("crossing", "geo_slow", "tumbling", "ballistic", "jitter", "crossing")):
        assert f"+ station{i}-{fam} -> gid {i} on shard {i % 2}" in out.stdout
    assert "placement: loads [3, 3]" in out.stdout
    assert "migrated gid 0 to shard 1" in out.stdout
    assert "shard 0 stalled -> rescued: down=[0], loads [0, 6], sessions lost: 0" in out.stdout
    assert "shard 0 repaired and revived: down=[]" in out.stdout
    assert "done: 114 windows, 3 migrations (1 rescue)" in out.stdout
