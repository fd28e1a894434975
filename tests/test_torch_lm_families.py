"""The port's MoE, RG-LRU, xLSTM and MLA functions against the JAX
reference, on the CPU.

The same numpy inputs, drawn from a seed, go through ``repro.models`` and
``repro_torch.models``; the reference's parameters are copied into the
port's modules by name. Sizes are the reference tests' ``reduce_cfg``
(d_model 128, 4 heads; MLA ranks 32 / 16, nope 16, rope 8, v 16; 4
experts, top 2). Tolerances:

* float32 within rtol = atol = 1e-5 (measured below 1e-6 but for the
  recurrences over 12 steps, at most 2e-6);
* integers and masks exactly: the MoE expert choices, ``keep`` and
  ``slot`` (against the reference's own lines, ``moe.py:60-76``, on the
  same input), the caches' ``pos``;
* bf16: a block's output within two bf16 ULPs of its magnitude (torch's
  fused activations round once where XLA rounds each op of ``jax.nn``'s,
  and a bf16 product can sum in another order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mla as RM
from repro.models import moe as RMOE
from repro.models import rglru as RR
from repro.models import xlstm as RX
from repro_torch.models import mla as TM
from repro_torch.models import moe as TMOE
from repro_torch.models import rglru as TR
from repro_torch.models import xlstm as TX

torch.set_num_threads(1)

RTOL = ATOL = 1e-5
D, H, B, S = 128, 4, 2, 12
MLA_DIMS = dict(n_heads=H, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, kv_lora_rank=16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x).astype(jnp.float32), dtype=np.float64)


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol, err_msg=what)


def _bf16_close(got, want, what=""):
    """Within two bf16 ULPs of the output's largest magnitude."""
    w = _np(want)
    atol = 2 * 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
    np.testing.assert_allclose(_np(got), w, rtol=0, atol=atol, err_msg=what)


def _load(module, tree):
    """The reference's parameter tree (a flat dict) into a port module."""
    with torch.no_grad():
        for k, v in tree.items():
            p = getattr(module, k)
            assert tuple(p.shape) == np.shape(v), k
            p.copy_(torch.from_numpy(np.array(v)))
    return module


def _x(seed, shape=(B, S, D), scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a).astype(dtype)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _states_close(got: dict, want: dict, what: str, **kw):
    assert set(got) == set(want), what
    for k in want:
        _close(got[k], want[k], what=f"{what}: {k}", **kw)


# ---------------------------------------------------------------------------
# MoE.
# ---------------------------------------------------------------------------

def _moe_pair(seed=1, e=4, f=256):
    params = jax.tree.map(np.asarray, RMOE.moe_init(jax.random.PRNGKey(seed), D, f, e))
    return params, _load(TMOE.MoE(D, f, e, device="cpu"), params)


def _reference_routing(router, x, *, n_experts, top_k, capacity_factor):
    """The reference's routing lines (``src/repro/models/moe.py:60-76``):
    expert choices, keep mask and dispatch slot of each assignment."""
    xt = x.reshape(-1, x.shape[-1])
    t, e = xt.shape[0], n_experts
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ router.astype(jnp.float32), axis=-1)
    gate_vals, expert_idx = jax.lax.top_k(probs, top_k)
    capacity = int(max(top_k, t * top_k / e * capacity_factor))
    flat_e = expert_idx.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
    pos_in_e = jnp.cumsum(onehot, axis=0) - onehot
    pos = jnp.take_along_axis(pos_in_e, flat_e[:, None], axis=1)[:, 0]
    keep = pos < capacity
    slot = jnp.where(keep, flat_e * capacity + pos, 0)
    return np.asarray(expert_idx), np.asarray(keep), np.asarray(slot), capacity


MOE_CASES = {
    "random": dict(capacity_factor=1.25, zero_router=False, e=4, k=2),
    # Every probability equal: jax.lax.top_k picks the lowest indices,
    # torch.topk would not.
    "zero_router_ties": dict(capacity_factor=1.25, zero_router=True, e=4, k=2),
    # moonshot's shape of routing, 64 experts, top 6, ties everywhere.
    "zero_router_64_top_6": dict(capacity_factor=1.25, zero_router=True, e=64, k=6),
    # A capacity that drops assignments.
    "drops": dict(capacity_factor=0.25, zero_router=False, e=4, k=2),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_and_routing_match_reference(case):
    c = MOE_CASES[case]
    params, moe = _moe_pair(e=c["e"], f=64 if c["e"] > 4 else 256)
    if c["zero_router"]:
        params["router"] = np.zeros_like(params["router"])
        moe.router.data.zero_()
    x = _x(2)
    kw = dict(n_experts=c["e"], top_k=c["k"], capacity_factor=c["capacity_factor"])
    experts, keep, slot, capacity = _reference_routing(_j(params["router"]), _j(x), **kw)
    r = TMOE.moe_route(moe.router, _t(x).reshape(-1, D), **kw)
    assert r.capacity == capacity
    np.testing.assert_array_equal(r.experts.numpy(), experts)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    if c["zero_router"]:
        np.testing.assert_array_equal(experts, np.broadcast_to(np.arange(c["k"]), experts.shape))
    if case == "drops":
        assert 0 < int((~keep).sum()) < keep.size
    want = RMOE.moe_apply(jax.tree.map(jnp.asarray, params), _j(x), **kw)
    got = TMOE.moe_apply(moe, _t(x), **kw)
    _close(got.y, want.y, what="y")
    _close(got.aux_loss, want.aux_loss, what="aux loss")
    _close(got.router_entropy, want.router_entropy, what="router entropy")


def test_moe_left_padded_batch_drops_what_the_reference_drops():
    """The engine's left padding: pad tokens (one row, all the same) are
    real tokens to the router and take capacity from the real ones, at a
    prefill's capacity and at a decode step's (batch 8, capacity = top_k)."""
    params, moe = _moe_pair(seed=3)
    x = _x(4, (4, 16, D))
    x[:, :6] = x[0, 0]  # six pad positions a row, one embedding
    kw = dict(n_experts=4, top_k=2, capacity_factor=1.25)
    for what, xs in (("prefill", x), ("decode", x[:, -1:].repeat(2, 0))):
        experts, keep, slot, capacity = _reference_routing(_j(params["router"]), _j(xs), **kw)
        r = TMOE.moe_route(moe.router, _t(xs).reshape(-1, D), **kw)
        assert (~keep).any(), what
        np.testing.assert_array_equal(r.keep.numpy(), keep, err_msg=what)
        np.testing.assert_array_equal(r.slot.numpy(), slot, err_msg=what)
        np.testing.assert_array_equal(r.experts.numpy(), experts, err_msg=what)
        want = RMOE.moe_apply(jax.tree.map(jnp.asarray, params), _j(xs), **kw)
        _close(TMOE.moe_apply(moe, _t(xs), **kw).y, want.y, what=what)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_moe_apply_bf16_matches_reference(act):
    params, moe = _moe_pair(seed=5)
    x = _x(6)
    kw = dict(n_experts=4, top_k=2, capacity_factor=1.25, act=act)
    want = RMOE.moe_apply(jax.tree.map(jnp.asarray, params), _j(x, jnp.bfloat16), **kw)
    got = TMOE.moe_apply(moe, _t(x, torch.bfloat16), **kw)
    assert got.y.dtype == torch.bfloat16
    _bf16_close(got.y, want.y, "bf16 y")
    _close(got.aux_loss, want.aux_loss, what="bf16 aux loss")


# ---------------------------------------------------------------------------
# RG-LRU.
# ---------------------------------------------------------------------------

def _rglru_pair(seed=1):
    params = jax.tree.map(np.asarray, RR.rglru_init(jax.random.PRNGKey(seed), D, D))
    return params, _load(TR.RGLRU(D, D, device="cpu"), params)


@pytest.mark.parametrize("s", [1, 2, 7, 12, 64, 81])
def test_rglru_scan_matches_reference(s):
    """The reference's associative scan, odd and even lengths."""
    rng = np.random.default_rng(s)
    log_a = -np.abs(rng.standard_normal((B, s, D))).astype(np.float32) * 0.1
    b_in = rng.standard_normal((B, s, D)).astype(np.float32)
    want = RR.rglru_scan(_j(log_a), _j(b_in))
    got = TR.rglru_scan(_t(log_a), _t(b_in))
    _close(got, want, what="scan")
    # The plain recurrence it evaluates.
    h, seq = np.zeros((B, D)), []
    for t in range(s):
        h = np.exp(log_a[:, t].astype(np.float64)) * h + b_in[:, t]
        seq.append(h)
    _close(got, np.stack(seq, 1), what="recurrence")


def test_rglru_apply_and_state_match_reference():
    params, m = _rglru_pair()
    jp = jax.tree.map(jnp.asarray, params)
    x = _x(2)
    y, st = RR.rglru_apply(jp, _j(x), return_state=True)
    ty, tst = TR.rglru_apply(m, _t(x), return_state=True)
    _close(ty, y, what="y")
    _states_close(tst, st, "state")
    # A carried state seeds the first step (rglru.py:99-103).
    x2 = _x(3, (B, 5, D))
    y2, st2 = RR.rglru_apply(jp, _j(x2), state=st, return_state=True)
    ty2, tst2 = TR.rglru_apply(m, _t(x2), state=tst, return_state=True)
    _close(ty2, y2, what="y, carried state")
    _states_close(tst2, st2, "state, carried")


def test_rglru_decode_matches_reference_and_prefill_state():
    """Step-by-step decode against the reference's, and its final state
    equal to the prefill state of the whole sequence."""
    params, m = _rglru_pair(seed=4)
    jp = jax.tree.map(jnp.asarray, params)
    x = _x(5)
    st, tst = RR.init_rglru_state(B, D), TR.init_rglru_state(B, D)
    _states_close(tst, st, "init")
    for t in range(S):
        y, st = RR.rglru_decode(jp, _j(x[:, t:t + 1]), st)
        ty, tst = TR.rglru_decode(m, _t(x[:, t:t + 1]), tst)
        _close(ty, y, what=f"decode {t}")
        _states_close(tst, st, f"decode state {t}")
    _, pre = TR.rglru_apply(m, _t(x), return_state=True)
    _states_close(pre, tst, "prefill state against decode")


def test_rglru_bf16_matches_reference():
    params, m = _rglru_pair(seed=6)
    jp = jax.tree.map(jnp.asarray, params)
    x = _x(7)
    y, st = RR.rglru_apply(jp, _j(x, jnp.bfloat16), return_state=True)
    ty, tst = TR.rglru_apply(m, _t(x, torch.bfloat16), return_state=True)
    _bf16_close(ty, y, "apply")
    yd, _ = RR.rglru_decode(jp, _j(x[:, :1], jnp.bfloat16), st)
    tyd, _ = TR.rglru_decode(m, _t(x[:, :1], torch.bfloat16), tst)
    _bf16_close(tyd, yd, "decode (i * u rounded in bf16 before the upcast)")


# ---------------------------------------------------------------------------
# mLSTM.
# ---------------------------------------------------------------------------

def _mlstm_pair(seed=1):
    params = jax.tree.map(np.asarray, RX.mlstm_init(jax.random.PRNGKey(seed), D, H))
    return params, _load(TX.MLSTM(D, H, device="cpu"), params)


@pytest.mark.parametrize("s,chunk", [(12, 256), (13, 4), (9, 9)])
def test_mlstm_parallel_matches_reference(s, chunk):
    rng = np.random.default_rng(s)
    q, k, v = (rng.standard_normal((B, s, H, 16)).astype(np.float32) for _ in "qkv")
    log_f = np.log(1 / (1 + np.exp(-rng.standard_normal((B, s, H)) - 2))).astype(np.float32)
    log_i = rng.standard_normal((B, s, H)).astype(np.float32)
    want = RX.mlstm_parallel(*(_j(a) for a in (q, k, v, log_f, log_i)), chunk=chunk)
    got = TX.mlstm_parallel(*(_t(a) for a in (q, k, v, log_f, log_i)), chunk=chunk)
    _close(got, want)


def test_mlstm_apply_and_state_match_reference():
    params, m = _mlstm_pair()
    jp = jax.tree.map(jnp.asarray, params)
    x = _x(2)
    y, st = RX.mlstm_apply(jp, _j(x), n_heads=H, return_state=True)
    ty, tst = TX.mlstm_apply(m, _t(x), n_heads=H, return_state=True)
    _close(ty, y, what="y")
    _states_close(tst, st, "state")
    # A carried state: the reference's parallel form reads its conv part.
    x2 = _x(3, (B, 5, D))
    y2, st2 = RX.mlstm_apply(jp, _j(x2), n_heads=H, state=st, return_state=True)
    ty2, tst2 = TX.mlstm_apply(m, _t(x2), n_heads=H, state=tst, return_state=True)
    _close(ty2, y2, what="y, carried state")
    _states_close(tst2, st2, "state, carried")


def test_mlstm_decode_matches_reference_and_prefill_state():
    params, m = _mlstm_pair(seed=4)
    jp = jax.tree.map(jnp.asarray, params)
    x = _x(5)
    st, tst = RX.init_mlstm_state(B, D, H), TX.init_mlstm_state(B, D, H)
    _states_close(tst, st, "init")
    for t in range(S):
        y, st = RX.mlstm_decode(jp, _j(x[:, t:t + 1]), st, n_heads=H)
        ty, tst = TX.mlstm_decode(m, _t(x[:, t:t + 1]), tst, n_heads=H)
        _close(ty, y, what=f"decode {t}")
        _states_close(tst, st, f"decode state {t}")
    # The prefill state (m = m_last) equals the step-by-step one, whose m
    # starts from init's 0: the same stabilised (C, n) up to exp(m - m').
    _, pre = TX.mlstm_apply(m, _t(x), n_heads=H, return_state=True)
    scale = torch.exp(tst["m"] - pre["m"])
    _close(pre["c"], tst["c"] * scale[..., None, None], what="C")
    _close(pre["n"], tst["n"] * scale[..., None], what="n")
    _close(pre["conv"], tst["conv"], what="conv")


def test_mlstm_prefill_then_decode_continues_the_sequence():
    """Decode after the prefill state gives the parallel form's outputs."""
    params, m = _mlstm_pair(seed=8)
    x = _x(9, (B, S + 3, D))
    full = TX.mlstm_apply(m, _t(x), n_heads=H)
    _, st = TX.mlstm_apply(m, _t(x[:, :S]), n_heads=H, return_state=True)
    for t in range(S, S + 3):
        y, st = TX.mlstm_decode(m, _t(x[:, t:t + 1]), st, n_heads=H)
        _close(y, full[:, t:t + 1], 1e-4, 1e-4, f"step {t}")  # the reference's prefill bound


# ---------------------------------------------------------------------------
# sLSTM.
# ---------------------------------------------------------------------------

def _slstm_pair(seed=1):
    params = jax.tree.map(np.asarray, RX.slstm_init(jax.random.PRNGKey(seed), D, H))
    return params, _load(TX.SLSTM(D, H, device="cpu"), params)


def test_slstm_apply_decode_and_states_match_reference():
    params, m = _slstm_pair()
    jp = jax.tree.map(jnp.asarray, params)
    x = _x(2)
    y, st = RX.slstm_apply(jp, _j(x), n_heads=H, return_state=True)
    ty, tst = TX.slstm_apply(m, _t(x), n_heads=H, return_state=True)
    _close(ty, y, what="y")
    _states_close(tst, st, "state")
    # A carried state, then step-by-step decode equal to the reference's and
    # ending in the prefill state of the whole sequence.
    x2 = _x(3, (B, 5, D))
    y2, st2 = RX.slstm_apply(jp, _j(x2), n_heads=H, state=st, return_state=True)
    ty2, tst2 = TX.slstm_apply(m, _t(x2), n_heads=H, state=tst, return_state=True)
    _close(ty2, y2, what="y, carried state")
    _states_close(tst2, st2, "state, carried")
    dst, rst = TX.init_slstm_state(B, D), RX.init_slstm_state(B, D)
    _states_close(dst, rst, "init")
    for t in range(S):
        yd, rst = RX.slstm_decode(jp, _j(x[:, t:t + 1]), rst, n_heads=H)
        tyd, dst = TX.slstm_decode(m, _t(x[:, t:t + 1]), dst, n_heads=H)
        _close(tyd, yd, what=f"decode {t}")
        _close(tyd, ty[:, t:t + 1], what=f"decode {t} against apply")
    _states_close(dst, tst, "decode state against prefill state")


def test_slstm_cell_matches_reference():
    params, m = _slstm_pair(seed=4)
    jp = jax.tree.map(jnp.asarray, params)
    rng = np.random.default_rng(5)
    st = {k: rng.standard_normal((B, D)).astype(np.float32) for k in ("h", "c", "m")}
    st["n"] = np.abs(rng.standard_normal((B, D))).astype(np.float32) + 0.5
    x = _x(6, (B, D))
    want = RX._slstm_cell(jp, _j(x), {k: _j(v) for k, v in st.items()}, n_heads=H)
    got = TX._slstm_cell(m, _t(x) @ m.w_gates, {k: _t(v) for k, v in st.items()}, n_heads=H)
    _states_close(got, want, "cell")


def test_xlstm_bf16_matches_reference():
    for pair, apply, decode in ((_mlstm_pair, "mlstm_apply", "mlstm_decode"),
                                (_slstm_pair, "slstm_apply", "slstm_decode")):
        params, m = pair(seed=7)
        jp = jax.tree.map(jnp.asarray, params)
        x = _x(8)
        y, st = getattr(RX, apply)(jp, _j(x, jnp.bfloat16), n_heads=H, return_state=True)
        ty, tst = getattr(TX, apply)(m, _t(x, torch.bfloat16), n_heads=H, return_state=True)
        assert ty.dtype == torch.bfloat16
        _bf16_close(ty, y, apply)
        yd, _ = getattr(RX, decode)(jp, _j(x[:, :1], jnp.bfloat16), st, n_heads=H)
        tyd, _ = getattr(TX, decode)(m, _t(x[:, :1], torch.bfloat16), tst, n_heads=H)
        _bf16_close(tyd, yd, decode)


# ---------------------------------------------------------------------------
# MLA.
# ---------------------------------------------------------------------------

def _mla_pair(seed=1):
    params = jax.tree.map(np.asarray, RM.mla_init(jax.random.PRNGKey(seed), D, H, 32, 16, 16, 8, 16))
    return params, _load(TM.MLA(D, H, 32, 16, 16, 8, 16, device="cpu"), params)


def test_mla_prefill_and_decode_match_reference():
    params, m = _mla_pair()
    jp = jax.tree.map(jnp.asarray, params)
    x = _x(2, (B, S + 3, D))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    clen = S + 3
    out, cache = RM.mla_prefill(jp, _j(x[:, :S]), dims=MLA_DIMS, positions=jnp.asarray(pos),
                                cache_len=clen)
    tout, tcache = TM.mla_prefill(m, _t(x[:, :S]), dims=MLA_DIMS, positions=torch.from_numpy(pos.copy()),
                                  cache_len=clen)
    _close(tout, out, what="prefill")
    full_ref = RM.mla_apply(jp, _j(x), dims=MLA_DIMS,
                            positions=jnp.broadcast_to(jnp.arange(clen, dtype=jnp.int32)[None], (B, clen)))
    decode = jax.jit(functools.partial(RM.mla_decode, dims=MLA_DIMS))
    for t in range(S, clen):
        y, cache = decode(jp, _j(x[:, t:t + 1]), cache, jnp.int32(t))
        ty, tcache = TM.mla_decode(m, _t(x[:, t:t + 1]), tcache, t, dims=MLA_DIMS)
        _close(ty, y, what=f"decode {t}")
        # The absorbed form equals the full one (the reference's own bound).
        _close(ty, full_ref[:, t:t + 1], 1e-4, 1e-4, f"absorbed decode {t} against mla_apply")
    for k in ("c_kv", "k_rope"):
        _close(tcache[k], cache[k], what=k)
    np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(cache["pos"]))
    assert tcache["pos"].dtype == torch.int32
    init = TM.init_mla_cache(B, clen, 16, 8, torch.float32)
    ref_init = RM.init_mla_cache(B, clen, 16, 8, jnp.float32)
    for k in init:
        np.testing.assert_array_equal(init[k].numpy(), np.asarray(ref_init[k]))


@pytest.mark.parametrize("past", [0, 2])
def test_mla_decode_past_the_cache_writes_the_last_slot_as_reference(past):
    """The clamped one-row update (ROADMAP §3), on the latent cache."""
    params, m = _mla_pair(seed=3)
    jp = jax.tree.map(jnp.asarray, params)
    x = _x(4, (B, 8, D))
    pos = np.broadcast_to(np.arange(6, dtype=np.int32)[None], (B, 6))
    _, cache = RM.mla_prefill(jp, _j(x[:, :6]), dims=MLA_DIMS, positions=jnp.asarray(pos), cache_len=7)
    _, tcache = TM.mla_prefill(m, _t(x[:, :6]), dims=MLA_DIMS, positions=torch.from_numpy(pos.copy()),
                               cache_len=7)
    decode = jax.jit(functools.partial(RM.mla_decode, dims=MLA_DIMS))
    for i, p in enumerate((6, 7 + past)):
        y, cache = decode(jp, _j(x[:, 6 + i:7 + i]), cache, jnp.int32(p))
        ty, tcache = TM.mla_decode(m, _t(x[:, 6 + i:7 + i]), tcache, p, dims=MLA_DIMS)
        _close(ty, y, what=f"position {p}")
    np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(cache["pos"]))
    assert int(tcache["pos"][-1]) == 7 + past


def test_mla_bf16_matches_reference():
    params, m = _mla_pair(seed=5)
    jp = jax.tree.map(jnp.asarray, params)
    x = _x(6)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    out, cache = RM.mla_prefill(jp, _j(x, jnp.bfloat16), dims=MLA_DIMS, positions=jnp.asarray(pos),
                                cache_len=S + 1)
    tout, tcache = TM.mla_prefill(m, _t(x, torch.bfloat16), dims=MLA_DIMS,
                                  positions=torch.from_numpy(pos.copy()), cache_len=S + 1)
    _bf16_close(tout, out, "prefill")
    xd = _x(7, (B, 1, D))
    y, _ = RM.mla_decode(jp, _j(xd, jnp.bfloat16), cache, jnp.int32(S), dims=MLA_DIMS)
    ty, _ = TM.mla_decode(m, _t(xd, torch.bfloat16), tcache, S, dims=MLA_DIMS)
    _bf16_close(ty, y, "decode (the rescale's constants rounded to bf16, as JAX's weak types)")
