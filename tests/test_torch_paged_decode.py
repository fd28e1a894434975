"""The port's paged decode against the JAX reference, on the CPU.

``decode_attention_partial``, ``merge_attention_partials``,
``attention_decode_paged`` and ``flush_page`` take the same numpy inputs
in both packages; the reference's parameters reach the port through
``params_from_jax``. Tolerances: float32, rtol = atol = 1e-5 against the
reference (the components and the logits of a paged decode, measured at
most 2e-6 on logits up to 4); against the port's own ``forward_train``
(teacher forcing) the reference test's rtol 1e-3 / atol 2e-3.

``flush_page`` writes only the page's valid slots. The reference's
scatter sends every empty slot to index 0 with the old ``k[:, 0]``, so a
page that holds position 0 and empty slots can lose the new entry
(ROADMAP §3); the port keeps it. Both drop a position at or past the
cache length.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as RB
from repro.models import attention as RA
from repro.models import transformer as RT
from repro_torch.configs import base as TB
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from test_torch_lm_models import _close, _qkv, reduce_cfg

torch.set_num_threads(1)

PAGE = 4  # the reference test's page: wraps in its 6 decode steps


def _t(a):
    return torch.from_numpy(np.array(a))


def _partial_inputs(seed=0, t=12):
    q, k, v = _qkv(2, t, 2, 3, 16)
    rng = np.random.default_rng(seed)
    kpos = np.where(rng.random(t) < 0.75, rng.permutation(t), -1).astype(np.int32)
    return q[:, :1], k, v, kpos


@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_partial_matches_reference(window):
    q, k, v, kpos = _partial_inputs()
    want = RA.decode_attention_partial(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(8),
                                       jnp.asarray(kpos), window=window)
    got = TA.decode_attention_partial(_t(q), _t(k), _t(v), 8, _t(kpos), window=window)
    for g, w, name in zip(got, want, ("acc", "m", "l")):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        _close(g, w, what=name)


def test_decode_attention_partial_bf16_takes_float32_products():
    """The reference's default ``CACHE_DTYPE_DOTS = False`` branch: bf16
    operands, float32 products, ``p`` cast to bf16 before the second."""
    assert RA.CACHE_DTYPE_DOTS is False
    q, k, v, kpos = _partial_inputs(seed=1)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    want = RA.decode_attention_partial(bf(q), bf(k), bf(v), jnp.int32(9), jnp.asarray(kpos))
    tb = lambda a: _t(a).to(torch.bfloat16)  # noqa: E731
    got = TA.decode_attention_partial(tb(q), tb(k), tb(v), 9, _t(kpos))
    for g, w, name in zip(got, want, ("acc", "m", "l")):
        _close(g, np.asarray(w, np.float32), what=name)


def test_merge_of_two_partials_equals_one_softmax_and_reference():
    q, k, v, kpos = _partial_inputs(seed=2)
    split = 7
    args = lambda lo, hi: (_t(q), _t(k[:, lo:hi]), _t(v[:, lo:hi]), 11, _t(kpos[lo:hi]))  # noqa: E731
    got = TA.merge_attention_partials([TA.decode_attention_partial(*args(0, split)),
                                       TA.decode_attention_partial(*args(split, None))])
    jargs = lambda lo, hi: (jnp.asarray(q), jnp.asarray(k[:, lo:hi]), jnp.asarray(v[:, lo:hi]),  # noqa: E731
                            jnp.int32(11), jnp.asarray(kpos[lo:hi]))
    want = RA.merge_attention_partials([RA.decode_attention_partial(*jargs(0, split)),
                                        RA.decode_attention_partial(*jargs(split, None))])
    _close(got, want, what="merge")
    whole = TA.decode_attention(_t(q), _t(k), _t(v), 11, _t(kpos))  # (B, 1, KV, G, dv)
    _close(got.permute(0, 3, 1, 2, 4), whole, what="against one softmax")


def _layer_pair(seed=0):
    rcfg = reduce_cfg(RB.get_config("llama3.2-1b"))
    tcfg = reduce_cfg(TB.get_config("llama3.2-1b"))
    p = RA.attn_init(jax.random.PRNGKey(seed), rcfg.d_model, rcfg.n_heads, rcfg.n_kv_heads,
                     rcfg.resolved_head_dim)
    m = TA.Attention(tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads, tcfg.resolved_head_dim, device="cpu")
    with torch.no_grad():
        for name, w in p.items():
            getattr(m, name).copy_(_t(w))
    return rcfg, p, m


def test_attention_decode_paged_matches_reference_through_a_wrap():
    """Six tokens through one layer with a page of 4 (one wrap), the
    main cache prefilled with 8 positions; outputs and the page after
    each step."""
    cfg, p, m = _layer_pair()
    dims = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
                pos_cfg={"kind": "rope", "theta": cfg.rope_theta})
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 14, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(8, dtype=np.int32)[None], (2, 8))
    _, rc = RA.attention_prefill(p, jnp.asarray(x[:, :8]), positions=jnp.asarray(pos), cache_len=14, **dims)
    rc = dict(rc, **{k: v for k, v in RA.init_attn_cache(2, 14, cfg.n_kv_heads, cfg.resolved_head_dim,
                                                          jnp.float32, page=PAGE).items()
                     if k.endswith("page") or k == "page_pos"})
    tc = {k: _t(v) for k, v in rc.items()}
    for i in range(6):
        xi = x[:, 8 + i:9 + i]
        want, rc = RA.attention_decode_paged(p, jnp.asarray(xi), rc, jnp.int32(8 + i), **dims)
        got, tc2 = TA.attention_decode_paged(m, _t(xi), tc, 8 + i, **dims)
        assert tc2 is tc
        _close(got, want, what=f"step {i}")
        for k in ("k_page", "v_page", "page_pos", "k", "v", "pos"):
            _close(tc[k], rc[k], what=f"step {i} {k}")


def _flush_case(ppos, clen=6, seed=4):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((2, clen, 1, 4)).astype(np.float32)
    v = rng.standard_normal((2, clen, 1, 4)).astype(np.float32)
    pos = np.full((clen,), -1, np.int32)
    kp = rng.standard_normal((2, len(ppos), 1, 4)).astype(np.float32)
    vp = rng.standard_normal((2, len(ppos), 1, 4)).astype(np.float32)
    return dict(k=k, v=v, pos=pos, k_page=kp, v_page=vp, page_pos=np.array(ppos, np.int32))


def _flush_both(case):
    want = jax.tree.map(np.asarray, RA.flush_page({k: jnp.asarray(v) for k, v in case.items()}))
    tc = {k: _t(v) for k, v in case.items()}
    got = TA.flush_page(tc)
    assert got is tc
    return {k: v.numpy() for k, v in got.items()}, want


def test_flush_page_drops_positions_past_the_cache_as_reference():
    """Positions 8, 5, 6, 7 into a 6-slot cache: only position 5 lands,
    in both packages."""
    case = _flush_case([8, 5, 6, 7])
    got, want = _flush_both(case)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["pos"], [-1, -1, -1, -1, -1, 5])
    np.testing.assert_array_equal(got["k"][:, 5], case["k_page"][:, 1])
    np.testing.assert_array_equal(got["k"][:, :5], case["k"][:, :5])
    np.testing.assert_array_equal(got["page_pos"], [-1] * 4)
    assert not got["k_page"].any() and not got["v_page"].any()


def test_flush_page_keeps_position_zero_unlike_reference():
    """A page holding position 0 and three empty slots: the port writes
    the new entry at 0; the reference's scatter writes the old ``k[:, 0]``
    back from each empty slot, and on this XLA CPU it loses the entry."""
    case = _flush_case([0, -1, -1, -1])
    got, want = _flush_both(case)
    np.testing.assert_array_equal(got["pos"], [0, -1, -1, -1, -1, -1])
    np.testing.assert_array_equal(got["k"][:, 0], case["k_page"][:, 0])
    np.testing.assert_array_equal(got["v"][:, 0], case["v_page"][:, 0])
    np.testing.assert_array_equal(got["k"][:, 1:], case["k"][:, 1:])
    # The reference's side of the fault.
    np.testing.assert_array_equal(want["pos"], [-1] * 6)
    np.testing.assert_array_equal(want["k"][:, 0], case["k"][:, 0])
    # A full page of valid positions flushes the same in both packages.
    got, want = _flush_both(_flush_case([4, 1, 2, 3]))
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _paged(module, fn):
    old = module.PAGED_DECODE
    module.PAGED_DECODE = PAGE
    try:
        return fn()
    finally:
        module.PAGED_DECODE = old


@pytest.mark.parametrize("arch,paged", [("llama3.2-1b", True), ("recurrentgemma-9b", False)])
def test_init_cache_with_a_page_matches_reference_layout_and_crosses_packages(arch, paged):
    """Full-attention layers get the page; local-window and recurrent
    layers (recurrentgemma's pattern) do not, as in the reference."""
    rcfg = dataclasses.replace(reduce_cfg(RB.get_config(arch)), n_layers=4)
    tcfg = dataclasses.replace(reduce_cfg(TB.get_config(arch)), n_layers=4)
    ref = jax.tree.map(np.asarray, _paged(RT, lambda: RT.init_cache(rcfg, 2, 7)))
    cache = _paged(TT, lambda: TT.init_cache(tcfg, 2, 7, device="cpu"))
    flat = lambda t: {"/".join(str(p.key) for p in path): leaf  # noqa: E731
                      for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]}
    got, want = flat(TT.cache_to_numpy(cache, tcfg)), flat(ref)
    assert got.keys() == want.keys()
    assert any(k.endswith("k_page") for k in want) == paged
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back = TT.cache_from_jax(ref, tcfg, device="cpu")
    for c, b in zip(cache, back):
        assert c.keys() == b.keys()
    assert all("k_page" not in c for c in TT.init_cache(tcfg, 2, 7, device="cpu"))  # default 0


def _graft(cache, tmpl):
    for c, t in zip(cache, tmpl):
        for k, v in t.items():
            c.setdefault(k, v)
    return cache


def test_paged_decode_matches_teacher_forcing_and_reference():
    """``tests/test_models.py::test_paged_decode_matches_teacher_forcing``
    in both packages: a prefill of 8 tokens, 6 paged decode steps with a
    page of 4 (flushed every 4 steps), the logits against the port's
    forward_train and against the reference's paged decode step by step;
    the flushed cache holds every decoded position."""
    rcfg = reduce_cfg(RB.get_config("llama3.2-1b"))
    tcfg = reduce_cfg(TB.get_config("llama3.2-1b"))
    params = RT.init_params(jax.random.PRNGKey(3), rcfg)
    model = TT.params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    s = 8
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (2, s + 6), 0, rcfg.vocab))
    ref_full = TT.forward_train(model, {"tokens": toks})[0]
    tmpl = _paged(RT, lambda: jax.eval_shape(lambda: RT.init_cache(rcfg, 2, s + 6)))
    _, rc0 = RT.prefill(params, {"tokens": jnp.asarray(toks[:, :s])}, rcfg, cache_len=s + 6)
    rc = {"cycles": {"blk0": dict(rc0["cycles"]["blk0"], **{
        k: jnp.full(v.shape, -1 if "pos" in k else 0, v.dtype)
        for k, v in tmpl["cycles"]["blk0"].items() if k not in rc0["cycles"]["blk0"]})}}
    _, tc = TT.prefill(model, {"tokens": toks[:, :s]}, cache_len=s + 6)
    tc = _graft(tc, _paged(TT, lambda: TT.init_cache(tcfg, 2, s + 6, device="cpu")))
    assert all("k_page" in c for c in tc)
    for i in range(6):
        if i > 0 and i % PAGE == 0:  # page full: the serving loop flushes
            rc["cycles"] = {"blk0": jax.vmap(RA.flush_page)(rc["cycles"]["blk0"])}
            tc = [TA.flush_page(c) for c in tc]
        step = toks[:, s + i:s + i + 1]
        lr, rc = RT.decode_step(params, {"tokens": jnp.asarray(step)}, rc, jnp.int32(s + i), rcfg)
        lt, tc = TT.decode_step(model, {"tokens": step}, tc, s + i)
        _close(lt, lr, what=f"step {i} against the reference")
        np.testing.assert_allclose(lt.numpy(), ref_full[:, s + i].numpy(), rtol=1e-3, atol=2e-3,
                                   err_msg=f"step {i} teacher forcing")
    flushed = TA.flush_page(tc[0])
    assert int((flushed["page_pos"] >= 0).sum()) == 0
    assert set(range(s + 6)) <= {int(p) for p in flushed["pos"] if p >= 0}


def test_paged_and_dense_decode_serve_the_same_tokens():
    """Greedy decoding through the paged path (page 4, flushed when full)
    and through the dense path pick the same tokens, logits within 1e-5."""
    tcfg = reduce_cfg(TB.get_config("llama3.2-1b"))
    model = TT.init_params(5, tcfg, device="cpu")
    toks = np.random.default_rng(6).integers(0, tcfg.vocab, (3, 9)).astype(np.int32)
    lg_d, dense = TT.prefill(model, {"tokens": toks}, cache_len=9 + 10)
    lg_p, paged = TT.prefill(model, {"tokens": toks}, cache_len=9 + 10)
    paged = _graft(paged, _paged(TT, lambda: TT.init_cache(tcfg, 3, 19, device="cpu")))
    for i in range(10):
        if i > 0 and i % PAGE == 0:
            paged = [TA.flush_page(c) for c in paged]
        nxt = {"tokens": lg_d.argmax(-1)[:, None]}
        assert torch.equal(lg_d.argmax(-1), lg_p.argmax(-1)), i
        lg_d, dense = TT.decode_step(model, nxt, dense, 9 + i)
        lg_p, paged = TT.decode_step(model, nxt, paged, 9 + i)
        _close(lg_p, lg_d, what=f"step {i}")
