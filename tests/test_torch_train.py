"""The port's LM training path against the JAX reference, on the CPU.

The same numpy inputs, drawn from a seed, go through ``repro`` and
``repro_torch``; the reference's weights and optimizer state reach the
port through ``params_from_jax`` / ``opt_state_from_jax`` and come back
through ``params_to_numpy`` / ``opt_state_to_numpy``. The reference's
train step runs under ``jax.jit``, as its ``train`` runs it, except with
int8 error feedback, whose scale the reference computes by IEEE division
only outside ``jax.jit`` (the port's ``quantize_int8`` form). Tolerances:

* the optimizer (``schedule``, ``adamw_update``, ``clip_by_global_norm``):
  rtol 1e-6, every op rounded to float32 in the reference's order;
* ``cross_entropy`` with z-loss, values and gradients: 1e-5;
* one train step of each architecture at the reference tests' reduced
  size (MoE at capacity factor 8, so no token is dropped): loss, gradient
  norm, every updated parameter and moment within rtol 1e-4, atol 1e-6
  (measured: parameters within 0.5 of that bound, moments within 5e-6
  relative to their largest entry);
* ``remat=True`` against ``remat=False``: 1e-6 (measured: equal);
* ten lock-step steps of the tiny preset on the Markov stream: 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as RB
from repro.data import lm_data as RD
from repro.models import transformer as RT
from repro.models import xlstm as RX
from repro.train import optimizer as RO
from repro.train import train_step as RS
from repro_torch.configs import base as TB
from repro_torch.data import lm_data as TD
from repro_torch.launch import train as TL
from repro_torch.models import transformer as TT
from repro_torch.models import xlstm as TX
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TS
from test_torch_lm_models import PORTED, _inputs, reduce_cfg

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _leaves(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _trees_close(got, want, rtol=RTOL, atol=ATOL, what=""):
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys(), sorted(set(g) ^ set(w))[:5]
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol, err_msg=f"{what} {k}")


# ---------------------------------------------------------------------------
# The optimizer.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [dict(lr=1e-3, warmup_steps=10, total_steps=100), dict(),
                                 dict(lr=3e-3, warmup_steps=0, total_steps=60, min_lr_ratio=0.0)])
def test_schedule_matches_reference(cfg):
    rc, tc = RO.OptConfig(**cfg), TO.OptConfig(**cfg)
    steps = np.arange(0, 101, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: RO.schedule(s, rc))(jnp.asarray(steps)))
    got = TO.schedule(_t(steps), tc)
    assert got.dtype == torch.float32
    # atol: min_lr_ratio 0 ends at lr * (1 + cos(pi)) / 2, about 1e-9
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * tc.lr)
    assert float(got[0]) == 0.0 if tc.warmup_steps else True


def _random_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in (("a", (4, 5)), ("b", (7,)), ("c", (3, 3, 2)), ("d", ()))}


@pytest.mark.parametrize("clip,decay", [(1.0, 0.1), (0.0, 0.0), (100.0, 0.1)])
def test_adamw_update_matches_reference(clip, decay):
    """Three steps on a random tree: the grads' norm is about 5, so
    ``clip_norm = 1`` clips and 100 does not."""
    rc = RO.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip, weight_decay=decay)
    tc = TO.OptConfig(**dataclasses.asdict(rc))
    rp = {k: jnp.asarray(v) for k, v in _random_tree(0).items()}
    tp = {k: _t(v) for k, v in _random_tree(0).items()}
    rs, ts = RO.init_opt_state(rp), TO.init_opt_state(tp)
    assert ts["step"].dtype == torch.int32 and all(v.dtype == torch.float32 for v in ts["mu"].values())
    for i in range(3):
        g = _random_tree(10 + i, scale=1.2)
        rp, rs, rm = RO.adamw_update({k: jnp.asarray(v) for k, v in g.items()}, rs, rp, rc)
        tp2, ts, tm = TO.adamw_update({k: _t(v) for k, v in g.items()}, ts, tp, tc)
        assert tp2 is tp  # updated in place
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(rm[k]), rtol=1e-6, err_msg=f"{i} {k}")
        _trees_close({k: v.numpy() for k, v in tp.items()}, rp, 1e-6, 1e-7, f"params {i}")
        _trees_close({k: {n: t.numpy() for n, t in ts[k].items()} for k in ("mu", "nu")},
                     {k: rs[k] for k in ("mu", "nu")}, 1e-6, 1e-9, f"moments {i}")
        assert int(ts["step"]) == int(rs["step"]) == i + 1


def test_clip_by_global_norm_matches_reference():
    g = {"a": np.full((4,), 3.0, np.float32), "b": np.full((4,), 4.0, np.float32)}  # norm 10
    clipped, norm = TO.clip_by_global_norm({k: _t(v) for k, v in g.items()}, 5.0)
    rclipped, rnorm = RO.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()}, 5.0)
    assert float(norm) == pytest.approx(10.0, rel=1e-6)
    np.testing.assert_allclose(float(norm), float(rnorm), rtol=1e-6)
    _trees_close({k: v.numpy() for k, v in clipped.items()}, rclipped, 1e-6, 0)
    big = _random_tree(3, scale=50.0)
    c, n = TO.clip_by_global_norm({k: _t(v) for k, v in big.items()}, 1.0)
    rc, rn = RO.clip_by_global_norm({k: jnp.asarray(v) for k, v in big.items()}, 1.0)
    np.testing.assert_allclose(float(n), float(rn), rtol=1e-6)
    _trees_close({k: v.numpy() for k, v in c.items()}, rc, 1e-6, 1e-9)
    assert float(TO.global_norm(c)) == pytest.approx(1.0, rel=1e-6)


def test_adamw_matches_manual_scalar():
    """``tests/test_train_infra.py::test_adamw_matches_manual_scalar``."""
    cfg = TO.OptConfig(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0,
                       warmup_steps=0, total_steps=10**9, clip_norm=0.0)
    p = {"w": torch.tensor(2.0)}
    state = TO.init_opt_state(p)
    TO.adamw_update({"w": torch.tensor(0.5)}, state, p, cfg)
    lr0 = float(TO.schedule(torch.tensor(1), cfg))
    assert float(p["w"]) == pytest.approx(2.0 - lr0 * 1.0, rel=1e-5)


# ---------------------------------------------------------------------------
# The loss.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("z", [0.0, 1e-4, 0.5])
def test_cross_entropy_values_and_gradients_match_reference(z):
    rng = np.random.default_rng(7)
    logits = (3 * rng.standard_normal((2, 5, 33))).astype(np.float32)
    labels = rng.integers(0, 33, (2, 5)).astype(np.int32)
    logits[0, 0, 4] = logits[0, 0].max()  # a tie at the row max (the detached max)
    (want, acc), g_want = jax.value_and_grad(
        lambda x: RS.cross_entropy(x, jnp.asarray(labels), z), has_aux=True)(jnp.asarray(logits))
    x = _t(logits).requires_grad_(True)
    got, tacc = TS.cross_entropy(x, _t(labels), z)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5, atol=1e-5)
    assert float(tacc) == float(acc)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# One train step of each architecture.
# ---------------------------------------------------------------------------

def _step_pair(arch, seed=1, **tcfg):
    rcfg, tcfg_ = reduce_cfg(RB.get_config(arch)), reduce_cfg(TB.get_config(arch))
    if rcfg.n_experts:
        rcfg = dataclasses.replace(rcfg, capacity_factor=8.0)
        tcfg_ = dataclasses.replace(tcfg_, capacity_factor=8.0)
    params = RT.init_params(jax.random.PRNGKey(seed), rcfg)
    model = TT.params_from_jax(jax.tree.map(np.asarray, params), tcfg_, device="cpu")
    inputs = _inputs(rcfg, 2, 16, seed + 2)
    inputs["labels"] = np.random.default_rng(seed + 3).integers(0, rcfg.vocab, (2, 16)).astype(np.int32)
    kw = dict(remat=False, opt=dict(lr=1e-3), **tcfg)
    rt = RS.TrainConfig(**dict(kw, opt=RO.OptConfig(**kw["opt"])))
    tt = TS.TrainConfig(**dict(kw, opt=TO.OptConfig(**kw["opt"])))
    return rcfg, tcfg_, params, model, inputs, rt, tt


def _one_step(arch, jit=True, **tcfg):
    rcfg, tcfg_, params, model, inputs, rt, tt = _step_pair(arch, **tcfg)
    rstep = RS.make_train_step(rcfg, rt)
    rp, ro, rm = (jax.jit(rstep) if jit else rstep)(
        params, RO.init_opt_state(params), {k: jnp.asarray(v) for k, v in inputs.items()})
    model, to, tm = TS.make_train_step(tcfg_, tt)(model, TO.init_opt_state(model),
                                                  {k: _t(v) for k, v in inputs.items()})
    return (rp, ro, rm), (model, to, tm), tcfg_


def _assert_step_close(ref, port, cfg, what, params_atol=ATOL, moments_rel=1e-4):
    (rp, ro, rm), (model, to, tm) = ref, port
    for k in ("loss", "grad_norm", "xent", "accuracy", "moe_aux", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(rm[k]), rtol=RTOL, atol=ATOL, err_msg=f"{what} {k}")
        assert tm[k].shape == () and tm[k].device == model.device
    _trees_close(TT.params_to_numpy(model), rp, atol=params_atol, what=f"{what} params")
    got = TT.opt_state_to_numpy(to, cfg)
    assert int(got["step"]) == int(ro["step"]) == 1 and got["step"].dtype == np.int32
    for k in ("mu", "nu"):  # moments against their leaf's largest entry
        for name, w in _leaves(ro[k]).items():
            g = _leaves(got[k])[name]
            np.testing.assert_allclose(g, w, rtol=0, atol=moments_rel * np.abs(w).max() + 1e-12,
                                       err_msg=f"{what} {k} {name}")


@pytest.mark.parametrize("arch", PORTED)
def test_train_step_matches_reference(arch):
    ref, port, cfg = _one_step(arch)
    _assert_step_close(ref, port, cfg, arch)
    assert all(p.requires_grad for p in port[0].parameters())


@pytest.mark.parametrize("arch", ["llama3.2-1b", "moonshot-v1-16b-a3b"])
def test_train_step_with_microbatches_matches_reference(arch):
    """Two microbatches of one row: g / m accumulated in float32 in the
    reference's order, metrics averaged."""
    ref, port, cfg = _one_step(arch, num_microbatches=2)
    _assert_step_close(ref, port, cfg, f"{arch} microbatches")


def test_train_step_with_int8_error_feedback_matches_reference():
    """``compression="int8_ef"`` on the first step, the reference run
    eagerly (IEEE division for the scale, as the port's ``quantize_int8``).
    Each leaf of the reference's tree has one scale (a cycle leaf's layers
    share it). A gradient entry within the packages' 1e-6 difference of a
    rounding boundary takes the neighbouring int8 level (2 of 65,536
    entries of one leaf here): its moments move by one quantum (held to
    2/127 of the leaf's largest moment), and Adam's first step, u = g /
    (|g| + eps), moves the parameter by up to 1% of lr where a quantum is
    near eps (held to 2e-5, 2% of lr). The error buffer: within one
    quantum of its leaf."""
    ref, port, cfg = _one_step("llama3.2-1b", jit=False, compression="int8_ef")
    _assert_step_close(ref, port, cfg, "int8_ef", params_atol=2e-5, moments_rel=2 / 127)
    from repro.distributed.compression import ef_int8_roundtrip

    rcfg, _, params, _, inputs, rt, _ = _step_pair("llama3.2-1b", compression="int8_ef")
    grads = jax.grad(lambda p: RS.loss_fn(p, {k: jnp.asarray(v) for k, v in inputs.items()}, rcfg, rt)[0])(params)
    want = _leaves(ef_int8_roundtrip(grads, {})[1]["ef"])
    got = _leaves(TT.opt_state_to_numpy(port[1], cfg)["ef"])
    assert got.keys() == want.keys()
    for name, w in want.items():
        quantum = np.abs(_leaves(grads)[name]).max() / 127
        np.testing.assert_allclose(got[name], w, rtol=0, atol=quantum, err_msg=name)
        assert (np.abs(got[name] - w) > 1e-3 * quantum).mean() < 1e-3, name


def test_int8_error_feedback_carries_to_the_next_step_unlike_reference():
    """The reference's step returns ``adamw_update``'s state, which has no
    ``"ef"``: the error buffer is dropped after every step, so each step
    compresses as if it were the first. The port keeps it."""
    rcfg, tcfg, params, model, inputs, rt, tt = _step_pair("llama3.2-1b", compression="int8_ef")
    _, ro, _ = RS.make_train_step(rcfg, rt)(params, RO.init_opt_state(params),
                                           {k: jnp.asarray(v) for k, v in inputs.items()})
    assert "ef" not in ro
    _, to, _ = TS.make_train_step(tcfg, tt)(model, TO.init_opt_state(model),
                                           {k: _t(v) for k, v in inputs.items()})
    ef = TT.opt_state_to_numpy(to, tcfg)["ef"]
    assert max(float(np.abs(v).max()) for v in _leaves(ef).values()) > 0


@pytest.mark.parametrize("arch", ["llama3.2-1b", "recurrentgemma-9b", "xlstm-350m"])
def test_remat_equals_no_remat(arch):
    """Checkpointed cycles recompute the same forward: loss and every
    gradient equal (recurrentgemma's reduced config has two cycles, xLSTM's
    pattern repeats its mLSTM and sLSTM blocks)."""
    _, tcfg, _, model, inputs, _, _ = _step_pair(arch)
    model.requires_grad_(True)
    batch = {k: _t(v) for k, v in inputs.items()}
    out = {}
    for remat in (False, True):
        loss, _ = TS.loss_fn(model, batch, tcfg, TS.TrainConfig(remat=remat))
        out[remat] = (loss.detach(), torch.autograd.grad(loss, list(model.parameters())))
    np.testing.assert_allclose(float(out[True][0]), float(out[False][0]), rtol=1e-6, atol=1e-6)
    for a, b in zip(out[True][1], out[False][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


def test_forward_without_grad_is_unchanged_by_training_state():
    """``forward_train`` of frozen weights (serving's teacher forcing)
    builds no graph, with or without ``remat``, and gives the same bits as
    with the weights made trainable."""
    _, tcfg, _, model, inputs, _, _ = _step_pair("xlstm-350m")
    frozen, _ = TT.forward_train(model, inputs)
    assert not frozen.requires_grad
    model.requires_grad_(True)
    trained, _ = TT.forward_train(model, inputs, remat=False)
    assert trained.requires_grad
    assert torch.equal(frozen, trained.detach())


# ---------------------------------------------------------------------------
# The sLSTM tie.
# ---------------------------------------------------------------------------

def _slstm_tie_case():
    """A cell from m = 0 and n = 0: wherever i_raw >= log_f, m_new =
    i_raw, the input gate is 1 and n_new is exactly 1.0."""
    d, h = 8, 2
    rng = np.random.default_rng(11)
    params = {
        "w_gates": (0.3 * rng.standard_normal((d, 4 * d))).astype(np.float32),
        "r_gates": (0.3 * rng.standard_normal((h, d // h, 4 * d // h))).astype(np.float32),
        "gate_bias": np.zeros(4 * d, np.float32),
    }
    x = rng.standard_normal((3, d)).astype(np.float32)
    state = {k: np.zeros((3, d), np.float32) for k in ("h", "c", "n", "m")}
    state["c"] = rng.standard_normal((3, d)).astype(np.float32)
    return params, x, state, h


def _slstm_cell_grads(maximum=None):
    """The cell's n_new, and the gradient of sum(h_new) with respect to the
    input and to the incoming ``n`` in both packages. With the state
    constant (a sequence's first step) the tied n_new has no derivative
    (i_g = exp(i_raw - m_new) with m_new = i_raw), so the tie shows in the
    gradient with respect to the incoming state, through f_g * n."""
    params, x, state, h = _slstm_tie_case()

    def ref(x_, n_):
        st = dict({k: jnp.asarray(v) for k, v in state.items()}, n=n_)
        return RX._slstm_cell({k: jnp.asarray(v) for k, v in params.items()}, x_, st, n_heads=h)

    out = ref(jnp.asarray(x), jnp.asarray(state["n"]))
    want = jax.grad(lambda x_, n_: ref(x_, n_)["h"].sum(), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(state["n"]))
    m = TX.SLSTM(x.shape[1], h, device="cpu")
    with torch.no_grad():
        for k, v in params.items():
            getattr(m, k).copy_(_t(v))
    xt, nt = _t(x).requires_grad_(True), _t(state["n"]).requires_grad_(True)
    patch = pytest.MonkeyPatch()
    if maximum is not None:
        patch.setattr(TX.torch, "maximum", maximum)
    try:
        got = TX._slstm_cell(m, xt @ m.w_gates, dict({k: _t(v) for k, v in state.items()}, n=nt),
                             n_heads=h)
    finally:
        patch.undo()
    got["h"].sum().backward()
    return (np.asarray(out["n"]), [np.asarray(w) for w in want], [xt.grad.numpy(), nt.grad.numpy()],
            got)


def test_slstm_tie_gradient_matches_reference():
    n, want, got, out = _slstm_cell_grads()
    assert (n == 1.0).sum() >= 8  # the tie is reached
    np.testing.assert_allclose(out["n"].detach().numpy(), n, rtol=1e-6, atol=0)
    for g, w, what in zip(got, want, ("x", "n")):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=what)


def test_slstm_tie_gradient_control_clamp_differs():
    """The control: with ``torch.clamp`` in place of ``torch.maximum``
    the whole gradient passes at the tie, twice the reference's."""
    clamp = lambda a, b: torch.clamp(a, min=b)  # noqa: E731
    n, want, got, _ = _slstm_cell_grads(clamp)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)  # no derivative through n_new
    tie = n == 1.0
    assert np.abs(got[1] - want[1])[tie].min() > 1e-3
    np.testing.assert_allclose(got[1][~tie], want[1][~tie], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# The training loop and the token stream.
# ---------------------------------------------------------------------------

def test_markov_tokens_equal_reference():
    r, t = RD.MarkovTokens(1024, seed=3), TD.MarkovTokens(1024, seed=3)
    np.testing.assert_array_equal(t.succ, r.succ)
    for _ in range(3):
        np.testing.assert_array_equal(t.sample(4, 9), r.sample(4, 9))
    for rb, tb in zip(RD.batches(512, 2, 8, 3, seed=5), TD.batches(512, 2, 8, 3, seed=5, device="cpu")):
        for k in ("tokens", "labels"):
            assert tb[k].dtype == torch.int32 and tb[k].is_contiguous()
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(rb[k]))


def test_training_reduces_loss():
    """``tests/test_train_infra.py::test_training_reduces_loss``."""
    _, log = TL.train(arch="llama3.2-1b", preset="tiny", steps=30, batch=8, seq=64, lr=3e-3,
                      log_every=29, device="cpu")
    assert log[-1]["loss"] < log[0]["loss"] - 0.1
    assert np.isfinite(log[-1]["loss"])
    assert [m["step"] for m in log] == [0, 29]


def test_ten_lock_step_steps_match_reference():
    """The tiny preset from the same weights on the same Markov batches:
    the reference's jitted step (``launch/train.py``'s schedule and
    config) and the port's, ten steps: loss, gradient norm and accuracy
    within 1e-4 at every step. The parameters after ten steps: within
    1e-4 but for entries whose gradient stays near zero, where Adam's
    u = m / (sqrt(v) + eps) turns the packages' float32 differences into
    up to a tenth of a step (lr 3e-3); so all within 1e-3 and at most one
    in 10,000 past 1e-4 (measured: 1 of 65,536 entries of one leaf, 2.7e-4)."""
    rcfg, tcfg = _reference_reduced_config("tiny"), TL.reduced_config("llama3.2-1b", "tiny")
    steps, lr = 10, 3e-3
    ropt = RO.OptConfig(lr=lr, warmup_steps=max(steps // 10, 1), total_steps=steps)
    rstep = jax.jit(RS.make_train_step(rcfg, RS.TrainConfig(opt=ropt, remat=False)))
    tstep = TS.make_train_step(tcfg, TS.TrainConfig(opt=TO.OptConfig(**dataclasses.asdict(ropt)), remat=False))
    params = RT.init_params(jax.random.PRNGKey(0), rcfg)
    model = TT.params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    ropt_state, topt = RO.init_opt_state(params), TO.init_opt_state(model)
    for i, (rb, tb) in enumerate(zip(RD.batches(rcfg.vocab, 8, 64, steps, 0),
                                     TD.batches(tcfg.vocab, 8, 64, steps, 0, device="cpu"))):
        np.testing.assert_array_equal(tb["tokens"].numpy(), np.asarray(rb["tokens"]))
        params, ropt_state, rm = rstep(params, ropt_state, rb)
        model, topt, tm = tstep(model, topt, tb)
        for k in ("loss", "grad_norm", "accuracy"):
            np.testing.assert_allclose(float(tm[k]), float(rm[k]), rtol=1e-4, atol=1e-4, err_msg=f"{i} {k}")
    got, want = _leaves(TT.params_to_numpy(model)), _leaves(params)
    n_past = 0
    for k in want:
        err = np.abs(got[k] - want[k])
        assert err.max() <= 1e-3, k
        n_past += int((err > 1e-4 + 1e-4 * np.abs(want[k])).sum())
    assert n_past <= sum(v.size for v in want.values()) // 10_000, n_past


def _reference_reduced_config(preset):
    from repro.launch.train import reduced_config

    return reduced_config("llama3.2-1b", preset)
