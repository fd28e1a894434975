"""The port's LM configs and attention-only models against the JAX
reference, on the CPU.

The same numpy inputs, drawn from a seed, go through ``repro`` and
``repro_torch``; the reference's parameters reach the port through
``params_from_jax``. Tolerances:

* float32 (the reference tests' ``reduce_cfg``): logits of
  ``forward_train``, ``prefill`` and ``decode_step`` within rtol 1e-5 /
  atol 1e-5 (measured: at most 3.3e-6 over the five architectures, on
  logits of magnitude up to 4); the components (RoPE, M-RoPE, RMS norm,
  the FFNs, ``flash_attention``, ``decode_attention``) within rtol 1e-5.
* bfloat16 (the configs' own dtype): logits within atol 0.0625, four
  bf16 ULPs of a logit in [2, 4) (measured: at most 0.039 on the
  attention-only and MoE families), 0.125 on the recurrent families
  (``BF16_ATOL``, with the test that shows why); MoE tokens whose routing
  differs between the packages are left out and counted
  (``BF16_ROUTING_DIFFERS``); the MoE aux loss within 2^-7 relative. XLA rounds
  each bf16 elementwise op where torch rounds a fused op once, and the
  float32 reductions run in another order, so single-ULP differences in
  the residual stream carry to the logits.
* Weights and caches crossing the packages: bit for bit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as RB
from repro.models import attention as RA
from repro.models import common as RC
from repro.models import moe as RMOE
from repro.models import transformer as RT
from repro_torch.configs import base as TB
from repro_torch.models import attention as TA
from repro_torch.models import common as TC
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

PORTED = ("llama3.2-1b", "stablelm-3b", "deepseek-67b", "musicgen-large", "qwen2-vl-2b",
          "minicpm3-4b", "moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b", "recurrentgemma-9b",
          "xlstm-350m")
RTOL = ATOL = 1e-5
# bf16 logits: four bf16 ULPs of a logit in [2, 4). The recurrent families:
# eight (measured 0.0664 on recurrentgemma-9b, 0.0781 on xlstm-350m). The
# reference's forward, prefill and decode run their cycles in a compiled
# ``lax.scan``, where XLA fuses bf16 elementwise chains and keeps their
# intermediates in float32, while torch's fused activations round once:
# the recurrences carry these ULP differences from step to step. With both
# rounding every op, the two come within four ULPs (0.0156 and 0.0547,
# ``test_recurrent_bf16_logits_within_four_ulps_when_both_round_every_op``).
BF16_ATOL = {None: 0.0625, "recurrentgemma-9b": 0.125, "xlstm-350m": 0.125}
# bf16 MoE: tokens whose expert choices or keep mask differ between the
# packages in some layer are left out, and their number is pinned. The
# router reads bf16 hidden states a ULP apart, which can swap a near-tie:
# moonshot's token 12 of row 0, whose 2nd and 3rd router probabilities lie
# 0.0055 apart, takes other experts in forward_train.
BF16_ROUTING_DIFFERS = {"moonshot-v1-16b-a3b": 1, "phi3.5-moe-42b-a6.6b": 0}


def reduce_cfg(cfg):
    """``tests/test_models.py:reduce_cfg``, for either package's config."""
    plen = len(cfg.block_pattern)
    return dataclasses.replace(
        cfg,
        n_layers=max(2 * plen if plen > 1 else 2, plen),
        d_model=128, n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        d_ff=256 if cfg.d_ff else 0, vocab=512,
        head_dim=32 if cfg.head_dim else 0,
        n_experts=4 if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        q_lora_rank=32 if cfg.q_lora_rank else 0,
        kv_lora_rank=16 if cfg.kv_lora_rank else 0,
        qk_nope_dim=16 if cfg.qk_nope_dim else 0,
        qk_rope_dim=8 if cfg.qk_rope_dim else 0,
        v_head_dim=16 if cfg.v_head_dim else 0,
        local_window=8, lru_width=128 if cfg.lru_width else 0,
        mrope_sections=(4, 6, 6) if cfg.mrope_sections else None,
        dtype="float32",
    )


def _cfgs(arch, **over):
    return (dataclasses.replace(reduce_cfg(RB.get_config(arch)), **over),
            dataclasses.replace(reduce_cfg(TB.get_config(arch)), **over))


def _inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend:
        out["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    if cfg.pos_kind == "mrope":
        out["mrope_positions"] = np.broadcast_to(np.arange(s)[None, None], (3, b, s)).astype(np.int32)
    return out


def _cut(inputs, lo, hi):
    return {k: (v[:, :, lo:hi] if k == "mrope_positions" else v[:, lo:hi]) for k, v in inputs.items()}


def _pair(rcfg, tcfg, seed=2):
    params = RT.init_params(jax.random.PRNGKey(seed), rcfg)
    npp = jax.tree.map(np.asarray, params)
    return params, TT.params_from_jax(npp, tcfg, device="cpu")


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, dtype=np.float64)


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# Configs.
# ---------------------------------------------------------------------------

def test_registry_equals_reference():
    assert TB.list_archs() == RB.list_archs()
    for arch in RB.list_archs():
        r, t = RB.get_config(arch), TB.get_config(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(r), arch
        assert t.param_count() == r.param_count(), arch
        assert t.active_param_count() == r.active_param_count(), arch
        assert t.layer_types == r.layer_types and t.resolved_head_dim == r.resolved_head_dim
        assert TB.applicable_shapes(t) == RB.applicable_shapes(r), arch
    assert {k: dataclasses.asdict(v) for k, v in TB.LM_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in RB.LM_SHAPES.items()}
    assert TB.get_config("llama3.2-1b").param_count() == 1_235_746_816


# ---------------------------------------------------------------------------
# Components, on the reference tests' corpora (tests/test_models.py:199-258).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_rope_matches_reference(theta):
    x = np.array(jax.random.normal(jax.random.PRNGKey(0), (1, 8, 2, 32)))
    pos = np.arange(8)[None].astype(np.int32)
    _close(TC.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           RC.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    # The split-halves rotation keeps norms (tests/test_models.py:199).
    y = TC.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta).numpy()
    np.testing.assert_allclose(np.linalg.norm(x, axis=-1), np.linalg.norm(y, axis=-1), rtol=1e-5)


def test_mrope_matches_reference_and_reduces_to_rope():
    x = np.array(jax.random.normal(jax.random.PRNGKey(0), (2, 6, 2, 32)))
    rng = np.random.default_rng(3)
    mpos = rng.integers(0, 50, (3, 2, 6)).astype(np.int32)
    _close(TC.apply_mrope(torch.from_numpy(x), torch.from_numpy(mpos), (4, 6, 6)),
           RC.apply_mrope(jnp.asarray(x), jnp.asarray(mpos), (4, 6, 6)))
    pos = np.arange(6)[None].repeat(2, 0).astype(np.int32)
    text = np.broadcast_to(pos[None], (3, 2, 6)).copy()
    _close(TC.apply_mrope(torch.from_numpy(x), torch.from_numpy(text), (4, 6, 6)),
           TC.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)), atol=1e-6)
    with pytest.raises(ValueError, match="sections"):
        TC.apply_mrope(torch.from_numpy(x), torch.from_numpy(text), (4, 6, 5))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_sinusoidal_match_reference(dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32)
    got = TC.rmsnorm(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(scale), 1e-6)
    want = RC.rmsnorm(jnp.asarray(x).astype(dtype), jnp.asarray(scale), 1e-6)
    assert str(got.dtype).endswith(dtype)
    # bf16: one rounding of the same float32 value.
    _close(got, want, atol=ATOL if dtype == "float32" else 0.0)
    pos = rng.integers(0, 300, (2, 7)).astype(np.int32)
    _close(TC.sinusoidal_positions(torch.from_numpy(pos), 64),
           RC.sinusoidal_positions(jnp.asarray(pos), 64))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_ffn_matches_reference(act):
    rng = np.random.default_rng(5)
    params = jax.tree.map(np.asarray, RC.ffn_init(jax.random.PRNGKey(1), 32, 64))
    ffn = TC.FFN(32, 64, device="cpu")
    for name, w in params.items():
        getattr(ffn, name).data.copy_(torch.from_numpy(np.array(w)))
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    _close(TC.ffn_apply(ffn, torch.from_numpy(x), act),
           RC.ffn_apply(params, jnp.asarray(x), act))


def _qkv(b, s, kv, g, d, dtype=np.float32):
    q = np.array(jax.random.normal(jax.random.PRNGKey(0), (b, s, kv, g, d)))
    k = np.array(jax.random.normal(jax.random.PRNGKey(1), (b, s, kv, d)))
    v = np.array(jax.random.normal(jax.random.PRNGKey(2), (b, s, kv, d)))
    return q.astype(dtype), k.astype(dtype), v.astype(dtype)


FLASH_CASES = {
    # tests/test_models.py:230: causal, an odd length over q/kv chunks 8/16.
    "causal_odd": dict(shape=(2, 37, 2, 3, 16), causal=True, window=None, q_chunk=8, kv_chunk=16),
    # tests/test_models.py:246: a sliding window of 4.
    "window": dict(shape=(1, 24, 1, 1, 8), causal=True, window=4, q_chunk=8, kv_chunk=8),
    # An odd length that leaves the last chunk mostly padding, no causal mask.
    "odd_full": dict(shape=(1, 13, 2, 2, 8), causal=False, window=None, q_chunk=4, kv_chunk=5),
    # The default chunks (one chunk each).
    "default_chunks": dict(shape=(2, 21, 2, 2, 16), causal=True, window=None, q_chunk=None,
                           kv_chunk=None),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_matches_reference(case):
    c = FLASH_CASES[case]
    b, s, kv, g, d = c["shape"]
    q, k, v = _qkv(b, s, kv, g, d)
    pos = np.arange(s, dtype=np.int32)
    kw = dict(causal=c["causal"], window=c["window"], q_chunk=c["q_chunk"], kv_chunk=c["kv_chunk"])
    want = RA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                              jnp.asarray(pos), **kw)
    got = TA.flash_attention(*(torch.from_numpy(a) for a in (q, k, v, pos, pos)), **kw)
    assert got.shape == want.shape
    _close(got, want)


def test_flash_attention_invalid_slots_and_fully_masked_rows():
    """KV slots at position -1 and query rows that see no valid key: the
    reference's NEG_INF arithmetic (a fully masked row averages the
    values), kept by the port."""
    q, k, v = _qkv(1, 10, 1, 2, 8)
    qpos = np.arange(10, dtype=np.int32)
    kpos = np.where(np.arange(10) % 3 == 0, -1, np.arange(10) + 2).astype(np.int32)
    for kw in (dict(q_chunk=4, kv_chunk=3), dict(q_chunk=10, kv_chunk=10)):
        want = RA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(qpos), jnp.asarray(kpos), **kw)
        got = TA.flash_attention(*(torch.from_numpy(a) for a in (q, k, v, qpos, kpos)), **kw)
        _close(got, want)


def test_flash_attention_bf16_matches_reference():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(2, 19, 2, 2, 16))
    pos = torch.arange(19, dtype=torch.int32)
    got = TA.flash_attention(q, k, v, pos, pos, q_chunk=8, kv_chunk=8)
    want = RA.flash_attention(*(jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) for a in (q, k, v)),
                              jnp.asarray(pos.numpy()), jnp.asarray(pos.numpy()), q_chunk=8, kv_chunk=8)
    assert got.dtype == torch.bfloat16
    # One bf16 rounding of float32 values that agree to 1e-5.
    _close(got, np.asarray(want.astype(jnp.float32)), rtol=2 ** -7, atol=1e-5)


@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_matches_reference(window):
    q, k, v = _qkv(2, 12, 2, 3, 16)
    q = q[:, :1]
    kpos = np.where(np.arange(12) < 9, np.arange(12), -1).astype(np.int32)
    want = RA.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(8),
                               jnp.asarray(kpos), window=window)
    got = TA.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 8,
                              torch.from_numpy(kpos), window=window)
    _close(got, want)


# ---------------------------------------------------------------------------
# Whole models.
# ---------------------------------------------------------------------------

class RoutingDiffers:
    """Records, while active, every MoE call's routing in both packages, the
    expert choices and keep mask of each token (the reference's from inside
    its compiled scan, by ``jax.debug.callback`` on its own routing lines,
    ``src/repro/models/moe.py:63-75``), and gives the tokens whose routing
    differs between the packages in any layer."""

    def __init__(self, monkeypatch):
        self.port, self.ref = [], []
        route, apply = TM.moe_route, RMOE.moe_apply

        def spy(*a, **kw):
            r = route(*a, **kw)
            self.port.append((r.experts.numpy(), r.keep.reshape(r.experts.shape).numpy()))
            return r

        def ref_spy(params, x, *, n_experts, top_k, capacity_factor=1.25, act="silu"):
            out = apply(params, x, n_experts=n_experts, top_k=top_k, capacity_factor=capacity_factor, act=act)
            xt = x.reshape(-1, x.shape[-1])
            probs = jax.nn.softmax(xt.astype(jnp.float32) @ params["router"].astype(jnp.float32), axis=-1)
            _, idx = jax.lax.top_k(probs, top_k)
            capacity = int(max(top_k, xt.shape[0] * top_k / n_experts * capacity_factor))
            onehot = jax.nn.one_hot(idx.reshape(-1), n_experts, dtype=jnp.int32)
            pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=0) - onehot, idx.reshape(-1, 1), axis=1)[:, 0]
            jax.debug.callback(lambda e, k: self.ref.append((np.asarray(e), np.asarray(k).reshape(e.shape))),
                               idx, pos < capacity, ordered=True)
            return out

        monkeypatch.setattr(TM, "moe_route", spy)
        monkeypatch.setattr(RMOE, "moe_apply", ref_spy)

    def differ_rows(self, shape) -> np.ndarray:
        """Tokens (``shape`` = (B, S)) whose expert choices or keep mask
        differ between the packages in some MoE layer since the last call."""
        jax.effects_barrier()
        assert len(self.port) == len(self.ref) > 0
        differ = np.zeros(int(np.prod(shape)), bool)
        for (pe, pk), (re, rk) in zip(self.port, self.ref):
            differ |= (pe != re).any(1) | (pk != rk).any(1)
        self.port.clear()
        self.ref.clear()
        return differ.reshape(shape)


def _logits_against_reference(rcfg, tcfg, rtol, atol, s=12, n_decode=2, routing=None, n_differ=0):
    """forward_train, prefill and ``n_decode`` decode steps of the port
    against the reference. With ``routing`` (bf16 MoE), logits are compared
    only at tokens whose routing is the reference's in every layer; the
    others are counted and must number ``n_differ``."""
    params, model = _pair(rcfg, tcfg)
    b = 2
    full = _inputs(rcfg, b, s + n_decode, seed=7)
    skipped = [0]

    def close(got, want, what, shape):
        rows = np.ones(shape, bool) if routing is None else ~routing.differ_rows(shape)
        skipped[0] += int((~rows).sum())
        _close(_np(got)[rows], _np(want)[rows], rtol, atol, what)

    ref, ref_aux = RT.forward_train(params, {k: jnp.asarray(v) for k, v in full.items()}, rcfg,
                                    remat=False)
    got, aux = TT.forward_train(model, full)
    assert got.dtype == torch.float32 and got.shape == (b, s + n_decode, rcfg.vocab)
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert (float(aux) == 0.0) == (not rcfg.n_experts)
    # The aux loss is float32 from the router's probabilities; in bf16 the
    # router reads hidden states a ULP apart, so it is held to one bf16 ULP
    # relative (measured 8.9e-4 relative on moonshot).
    _close(aux, ref_aux, RTOL if rtol else 2 ** -7, ATOL, "moe aux loss")
    close(got, ref, "forward_train", (b, s + n_decode))
    pre = _cut(full, 0, s)
    lp, cache = RT.prefill(params, {k: jnp.asarray(v) for k, v in pre.items()}, rcfg,
                           cache_len=s + n_decode)
    tlp, tcache = TT.prefill(model, pre, cache_len=s + n_decode)
    if routing is not None:  # the last position's logits
        rows = ~routing.differ_rows((b, s))[:, -1]
        skipped[0] += int((~rows).sum())
        _close(_np(tlp)[rows], _np(lp)[rows], rtol, atol, "prefill")
    else:
        _close(tlp, lp, rtol, atol, "prefill")
    name = "embeds" if rcfg.frontend else "tokens"
    for i in range(n_decode):
        step = {name: full[name][:, s + i:s + i + 1]}
        ld, cache = RT.decode_step(params, {name: jnp.asarray(step[name])}, cache,
                                   jnp.int32(s + i), rcfg)
        tld, tcache = TT.decode_step(model, step, tcache, s + i)
        close(tld, ld, f"decode step {i}", (b,))
    assert skipped[0] == n_differ, skipped[0]  # of 34 rows compared
    return model, tcache, cache


@pytest.mark.parametrize("arch", PORTED)
def test_logits_match_reference_float32(arch):
    _logits_against_reference(*_cfgs(arch), RTOL, ATOL)


@pytest.mark.parametrize("arch", PORTED)
def test_logits_match_reference_bfloat16(arch, monkeypatch):
    rcfg, tcfg = _cfgs(arch, dtype="bfloat16")
    routing = RoutingDiffers(monkeypatch) if rcfg.n_experts else None
    _logits_against_reference(rcfg, tcfg, 0.0, BF16_ATOL.get(arch, BF16_ATOL[None]), routing=routing,
                              n_differ=BF16_ROUTING_DIFFERS.get(arch, 0))


def _sigmoid_per_op(x, sigmoid=torch.sigmoid):
    return sigmoid(x) if x.dtype == torch.float32 else 1 / (1 + torch.exp(-x))


def _silu_per_op(x):
    return x * _sigmoid_per_op(x)


def _gelu_per_op(x):
    """``jax.nn.gelu``'s tanh form with each op rounded in ``x``'s dtype,
    its constants rounded as JAX's weak types."""
    c = TC.weak_scalar((2 / np.pi) ** 0.5, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + TC.weak_scalar(0.044715, x.dtype) * (x * x * x)))))


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-350m"])
def test_recurrent_bf16_logits_within_four_ulps_when_both_round_every_op(arch, monkeypatch):
    """Why the recurrent families' bf16 bound is 0.125 (``BF16_ATOL``): with
    the reference run op by op (``jax.disable_jit``, so XLA rounds every
    bf16 op as it does in eager use) and the port's activations rounded op
    by op in the same way (``jax.nn.sigmoid`` as ``1 / (1 + exp(-x))``,
    silu, the tanh GELU), the logits come within the other families' four
    ULPs (measured 0.0156 and 0.0547; 0.0781 for both without the port's
    op-by-op activations)."""
    from repro_torch.models import rglru as TR
    from repro_torch.models import xlstm as TX

    monkeypatch.setattr(torch, "sigmoid", functools.partial(_sigmoid_per_op, sigmoid=torch.sigmoid))
    monkeypatch.setattr(torch.nn.functional, "silu", _silu_per_op)
    monkeypatch.setitem(TC._ACT, "silu", _silu_per_op)
    monkeypatch.setitem(TC._ACT, "gelu", _gelu_per_op)
    monkeypatch.setattr(TR, "gelu", _gelu_per_op)
    monkeypatch.setattr(TX, "gelu", _gelu_per_op)
    rcfg, tcfg = _cfgs(arch, dtype="bfloat16")
    with jax.disable_jit():
        _logits_against_reference(rcfg, tcfg, 0.0, BF16_ATOL[None])


def test_local_window_layers_and_remainder_layout():
    """``"local"`` blocks (the ring-buffer cache, a prompt longer than the
    window) beside ``"attn"`` ones, and a pattern that leaves a remainder
    layer (``rem0``) after the stacked cycle, against the reference."""
    rcfg, tcfg = _cfgs("llama3.2-1b", block_pattern=("attn", "local"), n_layers=3, local_window=5)
    model, tcache, rcache = _logits_against_reference(rcfg, tcfg, RTOL, ATOL, s=9, n_decode=4)
    assert [lp.bt for lp in model.layers] == ["attn", "local", "attn"]
    assert tcache[1]["k"].shape[1] == 5
    np.testing.assert_array_equal(tcache[1]["pos"].numpy(), np.asarray(rcache["cycles"]["blk1"]["pos"][0]))


def _one_cycle_and_a_remainder(cfg):
    """A depth that gives a stacked cycle and, for multi-block patterns, a
    remainder layer: two layers for single-block patterns."""
    plen = len(cfg.block_pattern)
    return 2 if plen == 1 else plen + 1


def test_full_width_weight_shapes_equal_reference():
    """At each config's full width (a cycle and a remainder layer), every
    weight's shape equals the reference's tree leaf (cycles stacked), by
    name: the stacked experts (n_cycles, E, d, f), the sLSTM r_gates
    (n_cycles, H, dh, 4dh), MLA's latents and RG-LRU's log_lambda."""
    for arch in PORTED:
        n = _one_cycle_and_a_remainder(RB.get_config(arch))
        rcfg = dataclasses.replace(RB.get_config(arch), n_layers=n)
        shapes = jax.eval_shape(lambda c=rcfg: RT.init_params(jax.random.PRNGKey(0), c))
        ref = {".".join(str(p.key) for p in path): tuple(leaf.shape)
               for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
        tcfg = dataclasses.replace(TB.get_config(arch), n_layers=n)
        n_cycles = n // len(tcfg.block_pattern)
        model = TT.Transformer(tcfg, None, device="meta")
        got = {}
        for name, p in model.named_parameters():
            if name.startswith("layers."):
                _, li, rest = name.split(".", 2)
                where, cycle = TT._layer_source(tcfg, int(li))
                if cycle is None:
                    got[f"{where}.{rest}"] = tuple(p.shape)
                else:
                    assert ref[f"cycles.{where}.{rest}"] == (n_cycles,) + tuple(p.shape), (arch, name)
            else:
                got[name] = tuple(p.shape)
        assert got == {k: v for k, v in ref.items() if not k.startswith("cycles.")}, arch
        n_stacked = sum(1 for name, _ in model.named_parameters()
                        if name.startswith("layers.") and TT._layer_source(tcfg, int(name.split(".")[1]))[1] == 0)
        assert n_stacked == sum(1 for k in ref if k.startswith("cycles.")), arch


ROUND_TRIP = {
    "llama3.2-1b": dict(n_layers=3, block_pattern=("attn", "attn")),
    "musicgen-large": dict(n_layers=3, block_pattern=("attn", "attn")),
    "minicpm3-4b": dict(n_layers=3, block_pattern=("attn", "attn")),
    "moonshot-v1-16b-a3b": dict(n_layers=3, block_pattern=("attn", "attn")),
    "recurrentgemma-9b": dict(n_layers=4),  # a cycle of three and rem0
    "xlstm-350m": dict(n_layers=9),  # a cycle of eight (one sLSTM) and rem0
}


@pytest.mark.parametrize("arch", list(ROUND_TRIP))
def test_weights_round_trip_bit_for_bit(arch):
    rcfg, tcfg = _cfgs(arch, **ROUND_TRIP[arch])
    params = jax.tree.map(np.asarray, RT.init_params(jax.random.PRNGKey(5), rcfg))
    back = TT.params_to_numpy(TT.params_from_jax(params, tcfg, device="cpu"))
    flat = lambda t: {"/".join(str(p.key) for p in path): leaf  # noqa: E731
                      for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]}
    a, b = flat(params), flat(back)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # The port's own weights go to the reference and serve there.
    model = TT.init_params(3, tcfg, device="cpu")
    tree = TT.params_to_numpy(model)
    toks = _inputs(rcfg, 2, 6, seed=1)
    want, _ = RT.forward_train(jax.tree.map(jnp.asarray, tree), {"tokens": jnp.asarray(toks.get(
        "tokens", np.zeros((2, 6), np.int32)))} if not rcfg.frontend else {
        "embeds": jnp.asarray(toks["embeds"])}, rcfg, remat=False)
    got, _ = TT.forward_train(model, toks)
    _close(got, want)


def test_seeded_init_is_deterministic_and_shaped_as_reference():
    cfg = reduce_cfg(TB.get_config("llama3.2-1b"))
    a, b, c = (TT.init_params(s, cfg, device="cpu") for s in (0, 0, 1))
    for (n, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb), n
        if pa.ndim == 2:
            assert not torch.equal(pa, pc), n
            d_in = cfg.d_model if n == "embed" else pa.shape[0]
            assert float(pa.abs().max()) <= 2.0 * d_in ** -0.5 * (1 + 1e-6), n
        else:
            assert torch.equal(pa, torch.ones_like(pa)), n
    # d^-0.5 scaled embeddings, d_in^-0.5 scaled dense weights, norms ones.
    emb = a.embed.numpy()
    assert abs(emb.std() * cfg.d_model ** 0.5 - 0.88) < 0.02


def test_cast_weights_gives_the_same_bits():
    """The served copy (dense weights cast once to bf16, norms float32)
    computes the masters' bits, which the reference casts at every use."""
    cfg = dataclasses.replace(reduce_cfg(TB.get_config("stablelm-3b")), dtype="bfloat16")
    model = TT.init_params(0, cfg, device="cpu")
    with torch.no_grad():
        for lp in model.layers:
            lp.norm1.mul_(1.3)
    served = TT.cast_weights(model)
    assert served.embed.dtype == torch.bfloat16 and served.layers[0].inner.wq.dtype == torch.bfloat16
    assert served.layers[0].norm1.dtype == torch.float32 and served.final_norm.dtype == torch.float32
    toks = {"tokens": _inputs(cfg, 2, 9, seed=3)["tokens"]}
    assert torch.equal(TT.forward_train(served, toks)[0], TT.forward_train(model, toks)[0])
    lp_m, cm = TT.prefill(model, toks, cache_len=12)
    lp_s, cs = TT.prefill(served, toks, cache_len=12)
    assert torch.equal(lp_m, lp_s)
    nxt = {"tokens": lp_m.argmax(-1)[:, None]}
    assert torch.equal(TT.decode_step(model, nxt, cm, 9)[0], TT.decode_step(served, nxt, cs, 9)[0])


FLOAT32_READS = {  # what the reference reads in float32, beside the norm scales
    "minicpm3-4b": ("inner.q_norm", "inner.kv_norm"),
    "moonshot-v1-16b-a3b": ("moe.router",),
    "phi3.5-moe-42b-a6.6b": ("moe.router",),
    "recurrentgemma-9b": ("inner.log_lambda",),
    "xlstm-350m": ("inner.fgate_bias", "inner.igate_bias"),
}


@pytest.mark.parametrize("arch", list(FLOAT32_READS))
def test_cast_weights_keeps_float32_what_the_reference_reads_in_float32(arch):
    """The served bf16 copy of each family computes the float32 masters'
    bits: the MoE router, log_lambda, the mLSTM gate biases and the MLA
    norms stay float32 (a cast router would move the router's logits by a
    bf16 rounding and could change the expert choices), every other
    weight is cast once."""
    cfg = dataclasses.replace(reduce_cfg(TB.get_config(arch)), dtype="bfloat16")
    model = TT.init_params(0, cfg, device="cpu")
    with torch.no_grad():  # give the float32 reads values that bf16 cannot hold
        for lp in model.layers:
            for name, p in lp.named_parameters():
                if name in FLOAT32_READS[arch]:
                    p.add_(torch.linspace(1e-4, 3e-4, p.numel()).reshape(p.shape))
    served = TT.cast_weights(model)
    kept = {name for name, p in served.named_parameters() if p.dtype == torch.float32}
    want = {f"layers.{i}.{n}" for i, lp in enumerate(model.layers) for n, _ in lp.named_parameters()
            if n in FLOAT32_READS[arch] or n.startswith("norm")} | {"final_norm"}
    assert kept == want
    assert all(p.dtype == torch.bfloat16 for name, p in served.named_parameters() if name not in want)
    toks = {"tokens": _inputs(cfg, 2, 9, seed=3)["tokens"]}
    assert torch.equal(TT.forward_train(served, toks)[0], TT.forward_train(model, toks)[0])
    assert torch.equal(TT.forward_train(served, toks)[1], TT.forward_train(model, toks)[1])
    lp_m, cm = TT.prefill(model, toks, cache_len=12)
    lp_s, cs = TT.prefill(served, toks, cache_len=12)
    assert torch.equal(lp_m, lp_s)
    nxt = {"tokens": lp_m.argmax(-1)[:, None]}
    for i in range(2):
        (lm, cm), (ls, cs) = TT.decode_step(model, nxt, cm, 9 + i), TT.decode_step(served, nxt, cs, 9 + i)
        assert torch.equal(lm, ls), i


ACROSS = [pytest.param("qwen2-vl-2b", d, id=d) for d in ("jax_prefill_port_decode", "port_prefill_jax_decode")] + [
    pytest.param(a, d, id=f"{a}-{d}") for a in ("minicpm3-4b", "moonshot-v1-16b-a3b", "recurrentgemma-9b", "xlstm-350m")
    for d in ("jax_prefill_port_decode", "port_prefill_jax_decode")]


@pytest.mark.parametrize("arch,direction", ACROSS)
def test_decode_continues_across_packages(arch, direction):
    """A cache made by one package's prefill decodes in the other's within
    the reference's teacher-forcing bound; the port's cache after the steps
    is the reference's prefill over the whole sequence, leaf for leaf (KV,
    MLA latents, RG-LRU and xLSTM states). MoE without drops (capacity 8,
    as the reference's own test), so teacher forcing applies."""
    over = dict(capacity_factor=8.0) if RB.get_config(arch).n_experts else {}
    rcfg, tcfg = _cfgs(arch, **over)
    params, model = _pair(rcfg, tcfg, seed=4)
    s, n = 10, 3
    full = _inputs(rcfg, 2, s + n, seed=9)
    name = "embeds" if rcfg.frontend else "tokens"
    jfull = {k: jnp.asarray(v) for k, v in full.items()}
    ref, _ = RT.forward_train(params, jfull, rcfg, remat=False)
    pre = _cut(full, 0, s)
    if direction == "jax_prefill_port_decode":
        _, rcache = RT.prefill(params, {k: jnp.asarray(v) for k, v in pre.items()}, rcfg,
                               cache_len=s + n)
        np_cache = jax.tree.map(np.asarray, rcache)
        cache = TT.cache_from_jax(np_cache, tcfg, device="cpu")
        flat = lambda t: {"/".join(str(p.key) for p in path): leaf  # noqa: E731
                          for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]}
        there_and_back = flat(TT.cache_to_numpy(cache, tcfg))
        assert there_and_back.keys() == flat(np_cache).keys()
        for k, v in flat(np_cache).items():  # the cache crosses bit for bit
            assert there_and_back[k].dtype == v.dtype
            np.testing.assert_array_equal(there_and_back[k], v, err_msg=k)
        for i in range(n):
            ld, cache = TT.decode_step(model, {name: full[name][:, s + i:s + i + 1]}, cache, s + i)
            _close(ld, ref[:, s + i], 1e-3, 2e-3, f"step {i}")  # the reference's own bound
        # And back: the port's cache is the reference's after the same steps.
        _, rc = RT.prefill(params, {k: jnp.asarray(v) for k, v in _cut(full, 0, s + n).items()},
                           rcfg, cache_len=s + n)
        got, want = flat(TT.cache_to_numpy(cache, tcfg)), flat(jax.tree.map(np.asarray, rc))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            if k.endswith("pos"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            else:
                _close(got[k], want[k], what=k)
    else:
        _, cache = TT.prefill(model, pre, cache_len=s + n)
        rcache = jax.tree.map(jnp.asarray, TT.cache_to_numpy(cache, tcfg))
        for i in range(n):
            ld, rcache = RT.decode_step(params, {name: jfull[name][:, s + i:s + i + 1]},
                                        rcache, jnp.int32(s + i), rcfg)
            _close(ld, ref[:, s + i], 1e-3, 2e-3, f"step {i}")


def test_prompt_longer_than_the_cache_raises_in_both():
    rcfg, tcfg = _cfgs("llama3.2-1b")
    params, model = _pair(rcfg, tcfg)
    toks = _inputs(rcfg, 2, 9, seed=1)
    with pytest.raises(ValueError):
        RT.prefill(params, {"tokens": jnp.asarray(toks["tokens"])}, rcfg, cache_len=8)
    with pytest.raises(ValueError, match="does not fit"):
        TT.prefill(model, toks, cache_len=8)


@pytest.mark.parametrize("past", [0, 1, 3])
def test_position_past_the_cache_writes_the_last_slot_as_reference(past):
    """``dynamic_update_slice_in_dim`` clamps a start index past the
    cache to its last slot (ROADMAP §3); the port does the same, so the
    logits and the cache stay equal to the reference's."""
    rcfg, tcfg = _cfgs("llama3.2-1b")
    params, model = _pair(rcfg, tcfg)
    s, clen = 6, 8
    toks = _inputs(rcfg, 2, s + 4, seed=2)["tokens"]
    _, rcache = RT.prefill(params, {"tokens": jnp.asarray(toks[:, :s])}, rcfg, cache_len=clen)
    _, tcache = TT.prefill(model, {"tokens": toks[:, :s]}, cache_len=clen)
    for i, pos in enumerate((s, clen - 1, clen + past, clen + past + 1)):
        step = toks[:, s + i:s + i + 1]
        ld, rcache = RT.decode_step(params, {"tokens": jnp.asarray(step)}, rcache, jnp.int32(pos), rcfg)
        tld, tcache = TT.decode_step(model, {"tokens": step}, tcache, pos)
        _close(tld, ld, what=f"position {pos}")
    back = TT.cache_to_numpy(tcache, tcfg)
    np.testing.assert_array_equal(back["cycles"]["blk0"]["pos"], np.asarray(rcache["cycles"]["blk0"]["pos"]))
    assert back["cycles"]["blk0"]["pos"][0, -1] == clen + past + 1
    assert TA.clamp_slot(clen + past, clen) == clen - 1 and TA.clamp_slot(-3, clen) == clen - 3


def test_init_cache_matches_reference_layout():
    cfg = reduce_cfg(TB.get_config("llama3.2-1b"))
    cache = TT.init_cache(cfg, 2, 7, device="cpu")
    ref = jax.tree.map(np.asarray, RT.init_cache(reduce_cfg(RB.get_config("llama3.2-1b")), 2, 7))
    back = TT.cache_to_numpy(cache, cfg)
    for name in ("k", "v", "pos"):
        got, want = back["cycles"]["blk0"][name], ref["cycles"]["blk0"][name]
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", list(FLOAT32_READS))
def test_init_cache_of_every_family_matches_reference_layout(arch):
    """The four new cache kinds ({c_kv, k_rope, pos}, {h, conv},
    {c, n, m, conv}, {h, c, n, m}) in the reference's stacked tree, with a
    remainder layer where the pattern leaves one; in a bf16 config the
    latents are bf16 and the recurrent states float32, as there."""
    n = _one_cycle_and_a_remainder(RB.get_config(arch))
    rcfg, tcfg = _cfgs(arch, n_layers=n)
    back = TT.cache_to_numpy(TT.init_cache(tcfg, 2, 7, device="cpu"), tcfg)
    ref = jax.tree.map(np.asarray, RT.init_cache(rcfg, 2, 7))
    flat = lambda t: {"/".join(str(p.key) for p in path): leaf  # noqa: E731
                      for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]}
    got, want = flat(back), flat(ref)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    rb, tb = _cfgs(arch, n_layers=n, dtype="bfloat16")
    want = {k: str(v.dtype) for k, v in flat(RT.init_cache(rb, 2, 7)).items()}
    cache = TT.init_cache(tb, 2, 7, device="cpu")
    for li, c in enumerate(cache):
        where, cycle = TT._layer_source(tb, li)
        for k, v in c.items():
            key = f"cycles/{where}/{k}" if cycle is not None else f"{where}/{k}"
            assert str(v.dtype) == f"torch.{want[key]}", key
