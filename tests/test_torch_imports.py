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
              "repro_torch.serve.constellation", "repro_torch.serve.chaos_shards",
              "repro_torch.core.pipeline.event_core", "repro_torch.core.metrics",
              "repro_torch.configs", "repro_torch.configs.base", "repro_torch.configs.llama3_2_1b",
              "repro_torch.configs.xlstm_350m", "repro_torch.models", "repro_torch.models.common",
              "repro_torch.models.attention", "repro_torch.models.transformer",
              "repro_torch.models.mla", "repro_torch.models.moe", "repro_torch.models.rglru",
              "repro_torch.models.xlstm",
              "repro_torch.serve.lm", "repro_torch.serve.engine", "repro_torch.launch",
              "repro_torch.launch.serve", "repro_torch.launch.train", "repro_torch.train",
              "repro_torch.train.optimizer", "repro_torch.train.train_step",
              "repro_torch.train.checkpoint", "repro_torch.data.lm_data",
              "repro_torch.launch.mesh", "repro_torch.launch.op_analysis", "repro_torch.launch.roofline",
              "repro_torch.launch.dryrun"):
        assert m in mods, m
    assert {p.stem for p in (PORT / "kernels" / "csrc").glob("*.cu")} == {
        "cluster_accum", "patch_metrics", "window_pipeline",
        "event_unpack", "grid_quantize", "window_entropy"}
    assert {p.name for p in (REPO / "examples").glob("torch_*.py")} == {
        "torch_quickstart.py", "torch_fleet_quickstart.py", "torch_serve_detections.py",
        "torch_stream_quickstart.py", "torch_constellation_quickstart.py", "torch_serve_lm.py",
        "torch_train_lm.py", "torch_multi_node_array.py"}
    assert {p.stem for p in (PORT / "configs").glob("*_*.py")} == {
        p.stem for p in (REPO / "src" / "repro" / "configs").glob("*_*.py")}


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


def test_dry_run_touches_no_card_and_sets_no_environment(tmp_path):
    """Importing the dry run sets nothing in the environment (the
    reference's sets ``XLA_FLAGS``), and a cell runs on the meta device
    with every way into CUDA closed."""
    code = (
        "import os, sys, torch\n"
        "def boom(*a, **k):\n"
        "    raise AssertionError('the dry run reached for a card')\n"
        "torch.cuda.is_available = torch.cuda.init = torch.cuda._lazy_init = torch.cuda.device_count = boom\n"
        "env = dict(os.environ)\n"
        "from repro_torch.launch import dryrun\n"
        "assert dict(os.environ) == env\n"
        f"rc = dryrun.main(['--arch', 'stablelm-3b', '--shape', 'decode_32k', '--mesh', 'both', '--out', {str(tmp_path)!r}])\n"
        "print('RC', rc, len(os.listdir(" + repr(str(tmp_path)) + ")))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "RC 0 2" in out.stdout


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card refusal cannot be shown here")


def test_entry_points_default_to_cuda_and_refuse_without_a_card(tmp_path):
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
    from repro_torch.launch.serve import serve_demo
    from repro_torch.data.lm_data import batches
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import reduced_config, train
    from repro_torch.models import opt_state_from_jax, opt_state_to_numpy
    from repro_torch.train import init_opt_state
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.models import (
        Transformer, cache_from_jax, init_cache, init_params, params_from_jax, params_to_numpy,
    )
    from repro_torch.serve.lm import ServingEngine
    from repro_torch.serve import (
        ChaosConfig, ChaosHarness, ConstellationService, DetectionService, ShardChaosConfig,
        ShardChaosHarness,
    )

    rec = make_recording(seed=1, duration_s=0.05)
    tiny = reduced_config("llama3.2-1b", "tiny")
    cpu_model = init_params(0, tiny, device="cpu")
    ckpt_dir = tmp_path / "ckpt"
    CheckpointManager(ckpt_dir).save(0, {"w": torch.ones(2)})
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
        lambda: Transformer(tiny),
        lambda: init_params(0, tiny),
        lambda: init_cache(tiny, 2, 8),
        lambda: params_from_jax(params_to_numpy(cpu_model), tiny),
        lambda: cache_from_jax({}, tiny),
        lambda: ServingEngine(cpu_model),
        lambda: serve_demo(),
        lambda: serve_demo(arch="qwen2-vl-2b", n_requests=2),
        *(lambda a=a: init_params(0, reduced_config(a, "tiny")) for a in (
            "minicpm3-4b", "moonshot-v1-16b-a3b", "recurrentgemma-9b", "xlstm-350m")),
        lambda: init_cache(reduced_config("xlstm-350m", "tiny"), 2, 8),
        lambda: serve_demo(arch="recurrentgemma-9b", n_requests=2),
        lambda: train(),
        lambda: train(preset=None, steps=1, remat=True),
        lambda: batches(tiny.vocab, 2, 8, 1),
        lambda: opt_state_from_jax(opt_state_to_numpy(init_opt_state(cpu_model), tiny), tiny),
        lambda: CheckpointManager(ckpt_dir).restore({"w": torch.zeros(2)}, device="cuda"),
        lambda: make_mesh((1,), ("sensor",)),
        lambda: make_mesh((2,), ("sensor",), devices=["cuda", "cuda"]),
        lambda: FleetPipeline(n_sensors=4, mesh=make_mesh((4,), ("sensor",), devices=["cuda"] * 4)),
        lambda: ConstellationService(n_shards=2, devices=["cuda"] * 4),
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("tool", [["torch_lm_teacher_bound.py"], ["torch_lm_phase.py", "10"],
                                  ["torch_lm_phase.py", "11"], ["torch_lm_phase.py", "12"],
                                  ["torch_lm_phase.py", "13"]])
def test_lm_tools_refuse_without_a_card(tool):
    """The LM tools run on the card unless told otherwise: with no
    ``--device`` and no card they exit non-zero before measuring."""
    _no_card()
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, str(REPO / "tools" / tool[0]), *tool[1:]], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode != 0
    assert "cuda" in out.stderr.lower() and "{" not in out.stdout


@pytest.mark.parametrize("tool", ["torch_fleet_rounds.py", "torch_host_view.py"])
def test_fleet_measurement_tools_refuse_without_a_card(tool):
    """The fleet's measurement tools time the card only: with no card they
    exit non-zero before measuring."""
    _no_card()
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, str(REPO / "tools" / tool)], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode != 0
    assert "cuda" in out.stderr.lower() and "{" not in out.stdout


@pytest.mark.parametrize("tool", ["torch_k6_compare.py"])
def test_window_entropy_tools_refuse_without_a_card(tool):
    """K6's measurement tools time the card only: with no card they exit
    non-zero before building or measuring anything."""
    _no_card()
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, str(REPO / "tools" / tool)], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode != 0
    assert "cuda" in out.stderr.lower() and "{" not in out.stdout


@pytest.mark.parametrize("tool", ["torch_k3_compare.py"])
def test_patch_metrics_tools_refuse_without_a_card(tool):
    """K3's measurement tool times the card only: with no card it exits
    non-zero before building or measuring anything."""
    _no_card()
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, str(REPO / "tools" / tool)], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode != 0
    assert "cuda" in out.stderr.lower() and "{" not in out.stdout


def test_chip_smoke_fails_without_a_card():
    _no_card()
    out = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")], capture_output=True, text=True,
        cwd=REPO, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_reports_a_failing_phase_on_stdout(monkeypatch, capsys):
    """A phase that raises: its number and traceback on standard output,
    exit code 1, no result line."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    def failing():
        chip_smoke.enter("8d")
        raise ZeroDivisionError("the phase's own error")

    monkeypatch.setattr(chip_smoke, "main", failing)
    assert chip_smoke.run() == 1
    out = capsys.readouterr().out
    assert "phase 8d failed" in out and "Traceback" in out
    assert "ZeroDivisionError: the phase's own error" in out and '"ok"' not in out


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


def test_example_serve_lm_runs_on_the_cpu_when_asked():
    """The port's LM serving example on the CPU: 24 requests of 8 tokens
    through the tiny preset."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / "torch_serve_lm.py"), "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "serving stats on cpu" in out.stdout
    assert "requests: 24" in out.stdout and "tokens_generated: 192" in out.stdout


def test_example_train_lm_runs_fast_on_the_cpu_when_asked(tmp_path):
    """The port's training example, ``--fast`` (the tiny preset, 40 steps)
    on the CPU: the loss drops by more than 0.05, checkpoints written."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / "torch_train_lm.py"), "--fast", "--device", "cpu",
         "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    drop = float(re.search(r"\(drop ([-\d.]+)\)", out.stdout)[1])
    assert drop > 0.05 and "on cpu" in out.stdout
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_00000019", "step_00000039"]


def test_example_multi_node_array_runs_on_the_cpu_when_asked():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    script = str(REPO / "examples" / "torch_multi_node_array.py")
    out = subprocess.run([sys.executable, script, "--nodes", "4", "--windows", "8", "--device", "cpu"],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "equal to one call over the stacked array" in out.stdout
    assert "devices=['cpu:0', 'cpu:1', 'cpu:2', 'cpu:3']" in out.stdout
    if not torch.cuda.is_available():
        out = subprocess.run([sys.executable, script, "--nodes", "2", "--windows", "2"],
                             capture_output=True, text=True, env=env, timeout=300)
        assert out.returncode != 0 and "cuda" in out.stderr.lower()
