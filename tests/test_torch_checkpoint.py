"""The port's checkpoints and restart loop against the JAX reference, on
the CPU.

``CheckpointManager`` keeps the reference's on-disk layout
(``step_XXXXXXXX/arrays.npz`` keyed by ``/``-joined paths, ``meta.json``,
the atomic ``.tmp`` rename, ``keep_n``), so a training state in the
reference's tree layout written by either package restores in the other:
the same leaves bit for bit, and the same logits from the restored
weights (rtol = atol = 1e-5, as ``tests/test_torch_lm_models.py``).
``ElasticRunner`` keeps the reference's loop; driven by the port's real
train step, a run with a node lost and a NaN injected ends on the same
parameters as a run without, bit for bit on the CPU.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import fault_tolerance as RF
from repro.models import transformer as RT
from repro.train import checkpoint as RC
from repro.train import optimizer as RO
from repro_torch.distributed.fault_tolerance import ElasticRunner, FailureEvent
from repro_torch.launch.train import reduced_config
from repro_torch.models import transformer as TT
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TS
from repro_torch.train.checkpoint import CheckpointManager
from test_torch_lm_models import _close, _inputs
from test_torch_train import _reference_reduced_config, _leaves

torch.set_num_threads(1)


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(8, 8, generator=g), "b": torch.zeros(8)},
        "opt": {"step": torch.tensor(3, dtype=torch.int32), "mu": {"w": torch.ones(8, 8)}},
    }


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# tests/test_train_infra.py's checkpoint cases.
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_n=2)
    state = _state()
    mgr.save(7, state, meta={"note": "test"})
    step, restored = mgr.restore(_zeros_like(state))
    assert step == 7
    for k, v in _leaves(state).items():
        np.testing.assert_array_equal(_leaves(restored)[k], v, err_msg=k)
    assert restored["opt"]["step"].dtype == torch.int32
    assert (tmp_path / "step_00000007" / "meta.json").read_text() == '{"note": "test", "step": 7}'
    assert not list(tmp_path.glob("*.tmp"))


def test_checkpoint_async_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_n=2)
    for s in (1, 2, 3, 4):
        mgr.save_async(s, _state(s))
    mgr.wait()
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.glob("step_*"))
    assert steps == [3, 4]  # keep_n=2
    assert mgr.latest_step() == 4


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"w": torch.zeros(4)})
    with pytest.raises(ValueError):
        mgr.restore({"w": torch.zeros(5)})
    with pytest.raises(KeyError, match="missing leaf"):
        mgr.restore({"v": torch.zeros(4)})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore({"w": torch.zeros(4)})


def test_save_async_snapshots_before_returning(tmp_path):
    """The port updates tensors in place: what was saved is the state at
    the call, not at the write."""
    mgr = CheckpointManager(tmp_path)
    state = _state(1)
    want = {k: v.copy() for k, v in _leaves(state).items()}
    mgr.save_async(5, state)
    state["params"]["w"].add_(1.0)
    state["opt"]["step"].fill_(9)
    mgr.wait()
    _, got = mgr.restore(_zeros_like(state))
    for k, v in want.items():
        np.testing.assert_array_equal(_leaves(got)[k], v, err_msg=k)


def test_restore_onto_a_device_and_lists(tmp_path):
    """``device=`` makes every leaf a tensor there (numpy templates too);
    list and tuple indices are path parts, as the reference's."""
    mgr = CheckpointManager(tmp_path)
    state = {"a": [np.arange(3, dtype=np.float32), (np.ones(2, np.int32),)], "b": torch.ones(2)}
    mgr.save(0, state)
    with np.load(tmp_path / "step_00000000" / "arrays.npz") as z:
        assert sorted(z.files) == ["a/0", "a/1/0", "b"]
    _, got = mgr.restore(state, device="cpu")
    assert isinstance(got["a"][0], torch.Tensor) and isinstance(got["a"][1], tuple)
    assert got["a"][1][0].dtype == torch.int32
    _, kept = mgr.restore(state)
    assert isinstance(kept["a"][0], np.ndarray)


# ---------------------------------------------------------------------------
# Across the packages.
# ---------------------------------------------------------------------------

def _trained_pair():
    """The tiny preset's weights and an optimizer state after one real
    step, in both packages' forms."""
    rcfg, tcfg = _reference_reduced_config("tiny"), reduced_config("llama3.2-1b", "tiny")
    params = RT.init_params(jax.random.PRNGKey(4), rcfg)
    model = TT.params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    opt = TO.init_opt_state(model)
    inputs = _inputs(tcfg, 2, 8, 5)
    inputs["labels"] = inputs["tokens"][:, ::-1].copy()
    model, opt, _ = TS.make_train_step(tcfg, TS.TrainConfig(remat=False))(model, opt, inputs)
    return rcfg, tcfg, model, opt, inputs


def test_state_saved_by_the_port_restores_in_the_reference(tmp_path):
    rcfg, tcfg, model, opt, inputs = _trained_pair()
    state = {"params": TT.params_to_numpy(model), "opt": TT.opt_state_to_numpy(opt, tcfg)}
    CheckpointManager(tmp_path).save(3, state)
    template = {"params": RT.init_params(jax.random.PRNGKey(0), rcfg),
                "opt": RO.init_opt_state(RT.init_params(jax.random.PRNGKey(0), rcfg))}
    step, got = RC.CheckpointManager(tmp_path).restore(template)
    assert step == 3
    for k, v in _leaves(state).items():
        np.testing.assert_array_equal(np.asarray(_leaves(got)[k]), v, err_msg=k)
    want = TT.forward_train(model, inputs)[0].detach()
    logits, _ = RT.forward_train(got["params"], {k: jnp.asarray(v) for k, v in inputs.items()}, rcfg,
                                 remat=False)
    _close(want, logits, what="logits of the restored weights")


def test_state_saved_by_the_reference_restores_in_the_port(tmp_path):
    rcfg, tcfg, model, opt, inputs = _trained_pair()
    params = RT.init_params(jax.random.PRNGKey(6), rcfg)
    ropt = RO.init_opt_state(params)
    ropt = dict(ropt, step=jnp.int32(7), mu=jax.tree.map(lambda a: a + 0.5, ropt["mu"]))
    RC.CheckpointManager(tmp_path).save(11, {"params": params, "opt": ropt})
    template = {"params": TT.params_to_numpy(model), "opt": TT.opt_state_to_numpy(opt, tcfg)}
    mgr = CheckpointManager(tmp_path)
    step, got = mgr.restore(template)
    assert step == 11
    for k, v in _leaves({"params": params, "opt": ropt}).items():
        np.testing.assert_array_equal(_leaves(got)[k], v, err_msg=k)
    restored = TT.params_from_jax(got["params"], tcfg, device="cpu")
    ropt_t = TT.opt_state_from_jax(got["opt"], tcfg, device="cpu")
    assert ropt_t["step"].dtype == torch.int32 and int(ropt_t["step"]) == 7
    assert ropt_t["mu"].keys() == dict(restored.named_parameters()).keys()
    want, _ = RT.forward_train(params, {k: jnp.asarray(v) for k, v in inputs.items()}, rcfg, remat=False)
    _close(TT.forward_train(restored, inputs)[0], want, what="logits of the restored weights")
    # On a device: tensors there with the template's dtypes.
    _, on_dev = mgr.restore(template, device="cpu")
    assert on_dev["opt"]["step"].dtype == torch.int32 and isinstance(on_dev["params"]["embed"], torch.Tensor)


def test_train_writes_the_reference_layout(tmp_path):
    from repro_torch.launch.train import train

    train(preset="tiny", steps=20, batch=2, seq=8, ckpt_dir=str(tmp_path), log_every=19, device="cpu")
    rcfg = _reference_reduced_config("tiny")
    p = RT.init_params(jax.random.PRNGKey(0), rcfg)
    step, got = RC.CheckpointManager(tmp_path).restore({"params": p, "opt": RO.init_opt_state(p)})
    assert step == 19 and int(got["opt"]["step"]) == 20


# ---------------------------------------------------------------------------
# The restart loop.
# ---------------------------------------------------------------------------

def test_elastic_runner_recovers_from_failure(tmp_path):
    """``tests/test_train_infra.py::test_elastic_runner_recovers_from_failure``
    with the port's runner and checkpoints: a node lost at step 7 restores
    the step-5 checkpoint and all 12 steps finish once."""
    ckpt = CheckpointManager(tmp_path, keep_n=3)
    fail_once = {"armed": True}

    def failure_hook(step):
        if step == 7 and fail_once["armed"]:
            fail_once["armed"] = False
            return FailureEvent(step, "node_lost", "simulated")
        return None

    def step_fn(state, batch):
        new = {"x": state["x"] + batch}
        return new, {"loss": float(batch), "x": float(new["x"])}

    runner = ElasticRunner(
        mesh_factory=lambda n_failures: f"mesh<{8 - n_failures}>",
        make_state=lambda mesh: {"x": torch.tensor(0.0)},
        step_fn=step_fn, ckpt=ckpt, ckpt_every=5, failure_hook=failure_hook,
    )
    state, log = runner.run([torch.tensor(1.0)] * 12)
    assert runner.restarts == 1
    assert [e.kind for e in runner.events] == ["node_lost"]
    assert float(state["x"]) == 12.0
    assert [m["step"] for m in log] == list(range(7)) + list(range(6, 12))


def test_failure_event_and_runner_match_reference_fields():
    import inspect

    assert [f.name for f in dataclasses.fields(FailureEvent)] == [
        f.name for f in dataclasses.fields(RF.FailureEvent)]
    assert str(inspect.signature(ElasticRunner.__init__)) == str(inspect.signature(RF.ElasticRunner.__init__))


def test_elastic_runner_over_the_real_train_step(tmp_path):
    """``chip_smoke.py`` phase 11d on the CPU: twelve steps of the tiny
    preset (cut to one layer), a node lost at step 7 restores the step-5
    checkpoint, a NaN at step 9 restores it again; the final parameters
    equal an uninterrupted run's bit for bit."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as C
    from repro_torch.data.lm_data import batches

    elastic_lm_run = C.elastic_lm_run

    cfg = dataclasses.replace(reduced_config("llama3.2-1b", "tiny"), n_layers=1)
    data = list(batches(cfg.vocab, 2, 16, 12, seed=1, device="cpu"))
    clean, clean_state, clean_log = elastic_lm_run(cfg, "cpu", tmp_path / "a", data)
    runner, state, log = elastic_lm_run(cfg, "cpu", tmp_path / "b", data, lose_at=7, nan_at=9)
    assert clean.events == [] and len(clean_log) == 12
    assert [(e.step, e.kind) for e in runner.events] == [(7, "node_lost"), (9, "nan_loss")]
    assert [m["step"] for m in log] == [0, 1, 2, 3, 4, 5, 6, 6, 7, 8, 6, 7, 8, 9, 10, 11]
    assert all(np.isfinite(float(m["loss"])) for m in log)
    for k, v in clean_state["params"].items():
        assert torch.equal(state["params"][k], v), k
    assert int(state["opt"]["step"]) == 12
    step, _ = CheckpointManager(tmp_path / "b").restore(state)
    assert step == 10
