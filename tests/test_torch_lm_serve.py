"""The port's LM serving path against the JAX reference, on the CPU.

``ServingEngine`` at the ``tiny`` preset (float32) with the reference's
weights (``params_from_jax``) and a fake clock: the same batches, the same
output token lists and the same batch latencies as the reference's engine,
with prompts of mixed lengths (left padding), an end-of-sequence token,
and a cache too short for the decode (positions past ``max_seq``). Each
served token is checked for its top-1/top-2 logit margin, so that the
equality of the greedy tokens is not luck: the margin must exceed the
float32 logit bound (1e-5, ``tests/test_torch_lm_models.py``) by far.
Also the LM batcher cases of ``tests/test_serve_batcher.py`` and
``tests/test_train_infra.py``, ``serve_demo`` on the CPU, and the import
laziness and shim warning of ``tests/test_serve_imports.py``.
"""
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.launch.train import reduced_config as ref_reduced_config
from repro.models.transformer import init_params as ref_init_params
from repro.serve import lm as RL
from repro_torch.configs import list_archs
from repro_torch.launch.serve import serve_demo
from repro_torch.launch.train import PRESETS, reduced_config
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TT
from repro_torch.serve import lm as TL

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
LOGIT_BOUND = 1e-5
MIN_MARGIN = 10 * LOGIT_BOUND


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self) -> float:
        return self.now


def _engines(arch, ecfg, seed=0):
    rcfg, tcfg = ref_reduced_config(arch, "tiny"), reduced_config(arch, "tiny")
    params = ref_init_params(jax.random.PRNGKey(seed), rcfg)
    model = TT.params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    rclock, tclock = FakeClock(), FakeClock()
    return (RL.ServingEngine(params, rcfg, ecfg, rclock), rclock,
            TL.ServingEngine(model, ecfg, tclock, device="cpu"), tclock, tcfg)


def _requests(mod, vocab, lens, max_new, seed=1):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, tokens=[int(t) for t in rng.integers(0, vocab, n)],
                        max_new_tokens=m) for i, (n, m) in enumerate(zip(lens, max_new))]


def _margins(model, batch, max_seq):
    """Top-1 minus top-2 logit at every served token, by replaying the
    batch's prefill and decode with the served tokens on the port."""
    lens = [len(r.tokens) for r in batch]
    max_len = max(lens)
    toks = np.zeros((len(batch), max_len), np.int32)
    for i, r in enumerate(batch):
        toks[i, max_len - lens[i]:] = r.tokens
    logits, cache = TT.prefill(model, {"tokens": toks}, cache_len=max_seq)
    out = []
    steps = max(len(r.output) for r in batch)
    for step in range(steps):
        top = torch.topk(logits, 2, dim=-1).values
        for i, r in enumerate(batch):
            if step < len(r.output):
                assert int(logits[i].argmax()) == r.output[step]
                out.append(float(top[i, 0] - top[i, 1]))
        if step + 1 < steps:
            nxt = [r.output[step] if step < len(r.output) else int(logits[i].argmax())
                   for i, r in enumerate(batch)]
            logits, cache = TT.decode_step(model, {"tokens": np.asarray(nxt)[:, None]}, cache,
                                           max_len + step)
    return out


def _serve_both(arch, ecfg, lens, max_new, arrivals, seed=0):
    """Submit at the given fake times, stepping both engines after each
    submit and at the end; returns both engines' completed batches."""
    reng, rclock, teng, tclock, tcfg = _engines(arch, ecfg, seed)
    rreqs = _requests(RL, tcfg.vocab, lens, max_new)
    treqs = _requests(TL, tcfg.vocab, lens, max_new)
    rb, tb = [], []
    for rr, tr, at in zip(rreqs, treqs, arrivals):
        rclock.now = tclock.now = at
        reng.submit(rr)
        teng.submit(tr)
        rb.append(reng.step())
        tb.append(teng.step())
    while reng.batcher.queue or teng.batcher.queue:
        rclock.now += ecfg.max_delay_s
        tclock.now = rclock.now
        rb.append(reng.step())
        tb.append(teng.step())
    return [b for b in rb if b], [b for b in tb if b], teng


@pytest.mark.parametrize("case", ["mixed_lengths", "eos", "past_max_seq",
                                  "mixed_lengths_recurrentgemma-9b",
                                  "mixed_lengths_moonshot-v1-16b-a3b"])
def test_engine_serves_the_reference_tokens(case, monkeypatch):
    """Left-padded batches of mixed lengths (pad tokens reach MoE routers
    as real tokens and take capacity, as in the reference), an
    end-of-sequence token, positions past the cache; ``llama3.2-1b``, and
    the reduced RG-LRU and MoE families."""
    arch = case.split("_", 2)[2] if case.startswith("mixed_lengths_") else "llama3.2-1b"
    lens = [5, 9, 3, 12, 7, 4, 8]
    max_new = [6, 6, 4, 6, 2, 6, 5]
    arrivals = [0.0, 0.001, 0.002, 0.030, 0.031, 0.032, 0.033]
    ecfg = TL.EngineConfig(max_delay_s=0.02, max_batch=3, max_seq=20)
    if case == "past_max_seq":  # positions max_len + step run past the cache's last slot
        ecfg = TL.EngineConfig(max_delay_s=0.02, max_batch=3, max_seq=13)
    if case == "eos":
        # A token the first request emits in mid-answer ends answers early.
        _, theirs, _ = _serve_both("llama3.2-1b", ecfg, lens, max_new, arrivals)
        ecfg = TL.EngineConfig(max_delay_s=0.02, max_batch=3, max_seq=20,
                               eos_token=theirs[0][0].output[2])
    rcfg = RL.EngineConfig(**vars(ecfg))
    drops = []
    route = TMOE.moe_route
    monkeypatch.setattr(TMOE, "moe_route", lambda *a, **kw: (
        lambda r: (drops.append(int((~r.keep).sum())), r)[1])(route(*a, **kw)))
    ref, port, teng = _serve_both(arch, rcfg, lens, max_new, arrivals)
    if "moonshot" in arch:  # the left-padded prefills drop assignments, as the reference's
        assert sum(drops) > 0, drops
    assert [[r.rid for r in b] for b in port] == [[r.rid for r in b] for b in ref]
    assert [[r.rid for r in b] for b in port] == [[0, 1, 2], [3, 4, 5], [6]]
    for bp, br in zip(port, ref):
        for p, r in zip(bp, br):
            assert p.output == r.output, (case, p.rid)
            assert p.arrival_s == r.arrival_s and p.batch_latency_s == r.batch_latency_s
            assert all(type(t) is int for t in p.output)
        margins = _margins(teng.model, bp, ecfg.max_seq)
        assert min(margins) > MIN_MARGIN, (case, min(margins))
    outs = [r.output for b in port for r in b]
    if case == "eos":
        for o, m in zip(outs, max_new):
            assert ecfg.eos_token not in o[:-1] and (o[-1] == ecfg.eos_token or len(o) == m)
        assert outs[0][-1] == ecfg.eos_token and len(outs[0]) < max_new[0]
    else:
        assert [len(o) for o in outs] == max_new
    if case == "past_max_seq":
        assert max(lens[3:6]) + max(max_new[3:6]) - 2 >= ecfg.max_seq


def test_engine_makes_max_new_minus_one_decode_calls():
    reng, rclock, teng, tclock, tcfg = _engines("llama3.2-1b", TL.EngineConfig(max_batch=2))
    calls = []
    inner = teng._decode
    teng._decode = lambda *a: (calls.append(a[2]), inner(*a))[1]
    for r in _requests(TL, tcfg.vocab, [4, 6], [5, 3]):
        teng.submit(r)
    (a, b) = teng.step()
    assert calls == [6, 7, 8, 9] and len(a.output) == 5 and len(b.output) == 3


def test_lm_batcher_is_thin_client_of_admitter():
    """tests/test_serve_batcher.py:84 on the port."""
    clock = FakeClock()
    b = TL.DualThresholdBatcher(TL.EngineConfig(max_delay_s=0.02, max_batch=3), clock=clock)
    clock.now = 0.5
    r = TL.Request(rid=0, tokens=[1])
    b.submit(r)
    assert r.arrival_s == 0.5
    assert not b.ready()
    for i in range(1, 4):
        b.submit(TL.Request(rid=i, tokens=[1]))
    assert b.ready()  # 4 >= max_batch
    batch = b.pop_batch()
    assert [r.rid for r in batch] == [0, 1, 2]  # max_batch prefix
    assert [r.rid for r in b.queue] == [3]


def test_dual_threshold_batcher_semantics():
    """tests/test_train_infra.py:244 on the port."""
    t = [0.0]
    b = TL.DualThresholdBatcher(TL.EngineConfig(max_delay_s=0.02, max_batch=4), clock=lambda: t[0])
    for i in range(3):
        b.submit(TL.Request(rid=i, tokens=[1]))
    assert not b.ready()  # 3 < 4 and no time elapsed
    t[0] = 0.025
    assert b.ready()  # time threshold fired
    assert len(b.pop_batch()) == 3
    for i in range(5):
        b.submit(TL.Request(rid=i, tokens=[1]))
    assert b.ready()  # size threshold fired immediately
    assert len(b.pop_batch()) == 4
    assert len(b.queue) == 1


def test_serving_engine_generates():
    """tests/test_train_infra.py:264 on the port, on the CPU."""
    stats = serve_demo(arch="llama3.2-1b", n_requests=6, prompt_len=8, max_new=4, max_batch=3,
                       device="cpu")
    assert stats["requests"] == 6
    assert stats["tokens_generated"] == 24
    assert set(stats) == {"requests", "tokens_generated", "wall_s", "tokens_per_s",
                          "mean_batch_latency_s"}


@pytest.mark.parametrize("arch", list_archs())
def test_serve_demo_serves_every_architecture(arch):
    """``serve_demo`` on the tiny preset of each of the ten architectures,
    the MLA, MoE, RG-LRU and xLSTM families included."""
    stats = serve_demo(arch=arch, n_requests=4, prompt_len=6, max_new=3, max_batch=4, device="cpu")
    assert stats["requests"] == 4 and stats["tokens_generated"] == 12


def test_presets_and_reduced_config_equal_reference():
    import dataclasses

    from repro.launch.train import PRESETS as REF_PRESETS

    assert PRESETS == REF_PRESETS
    from repro.configs.base import list_archs

    for arch in list_archs():
        for preset in (None, "tiny", "small100m"):
            assert (dataclasses.asdict(reduced_config(arch, preset))
                    == dataclasses.asdict(ref_reduced_config(arch, preset))), (arch, preset)


def _run(code: str) -> str:
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}, cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_serve_import_is_lm_lazy():
    """tests/test_serve_imports.py on the port: importing
    ``repro_torch.serve`` imports neither the LM client nor the models."""
    out = _run(
        """
import sys
import repro_torch.serve as s
assert "repro_torch.serve.lm" not in sys.modules, "LM client imported eagerly"
assert "repro_torch.models" not in sys.modules, "models imported eagerly"
s.DetectionService, s.ConstellationService, s.ShardChaosHarness
assert "ServingEngine" in dir(s)
s.DualThresholdBatcher, s.EngineConfig, s.Request, s.ServingEngine
assert "repro_torch.serve.lm" in sys.modules
try:
    s.NoSuchName
except AttributeError as e:
    assert "NoSuchName" in str(e)
else:
    raise AssertionError("missing attribute did not raise")
print("lazy ok")
"""
    )
    assert "lazy ok" in out


def test_engine_shim_warns_deprecated():
    out = _run(
        """
import warnings
with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    import repro_torch.serve.engine as engine
msgs = [str(w.message) for w in caught
        if issubclass(w.category, DeprecationWarning)]
assert any("repro_torch.serve.lm" in m for m in msgs), msgs
engine.DualThresholdBatcher, engine.ServingEngine
print("shim warns")
"""
    )
    assert "shim warns" in out


def test_phase10_models_and_decode_bounds():
    """``chip_smoke.py`` phase 10's models: the four families at full width,
    moonshot cut to 16 of 48 layers, and each decode step's bound (bf16
    weight bytes over 3.35 TB/s, the operations of batch 8 far below)."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as C

    want = {"recurrentgemma-9b": (38, 6.236), "minicpm3-4b": (62, 2.544), "xlstm-350m": (24, 0.315),
            "moonshot-v1-16b-a3b": (16, 5.851)}
    assert list(C.LM10_FAMILIES) == list(want)
    for arch, (layers, ms) in want.items():
        cfg = C.family_config(arch)
        assert cfg.n_layers == layers and cfg.d_model == reduced_config(arch, None).d_model
        bd = C.family_bounds(cfg, 8 * 64, 8)
        assert round(bd["decode"]["bound_ms"], 3) == ms and bd["decode"]["bound_by"] == "bytes", arch
        sound, control = C.LM10_TEACHER_CPU[arch]
        assert 2 * sound <= C.LM10_TEACHER_ATOL[arch] < min(2 * sound + 1 / 32, control), arch
    # The MoE family's teacher forcing runs without drops: capacity >= tokens.
    cfg = C.no_drop(C.family_config("moonshot-v1-16b-a3b"))
    assert int(cfg.top_k / cfg.n_experts * cfg.capacity_factor * 8) == 8


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "minicpm3-4b", "xlstm-350m", "moonshot-v1-16b-a3b"])
def test_phase10_teacher_forcing_and_its_control(arch):
    """Phase 10b's check on the CPU at the ``tiny`` preset in bf16: the
    served logits equal ``forward_train``'s to a few bf16 ULPs, and the
    control, the batch served with a cache that decode never writes,
    reads far more (the check can fail). The control's decode steps read
    the prompt's cache and not the tokens served since; its prefill
    logits are the sound ones."""
    import dataclasses

    sys.path.insert(0, str(REPO))
    import chip_smoke as C

    cfg = C.no_drop(dataclasses.replace(reduced_config(arch, "tiny"), dtype="bfloat16"))
    engine = TL.ServingEngine(TT.init_params(0, cfg, device="cpu"), TL.EngineConfig(**C.LM_ENGINE), device="cpu")
    prompts = [p[:12] for p in C.lm_requests(cfg.vocab, 4)]
    done, logits = C.served_logits(engine, prompts)
    sound = C.teacher_forcing(engine, done, logits, 0.0)
    assert sound["served"] and logits.shape == (4, C.LM_NEW, cfg.vocab)
    cdone, clogits = C.served_logits(engine, prompts, stale_cache=True)
    control = C.teacher_forcing(engine, cdone, clogits, 0.0)
    assert control["served"]
    assert torch.equal(clogits[:, 0], logits[:, 0])
    assert sound["max_abs_err"] <= 0.125
    assert control["max_abs_err"] > 4 * max(sound["max_abs_err"], 2 ** -7), (sound, control)
