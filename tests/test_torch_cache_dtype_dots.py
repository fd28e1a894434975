"""The decode's ``CACHE_DTYPE_DOTS`` switch against the JAX reference's, on
the CPU (the reference's ``src/repro/models/attention.py:116``, the dry
run's ``bf16_dots`` variant).

With the switch on in both packages the decode's score and PV products run
in the cache's dtype and are upcast after the product. Bounds: decode
logits within rtol = atol = 1e-5 in float32, and in bf16 within the port's
bf16 bounds (``test_torch_lm_models.BF16_ATOL``: 0.0625, 0.125 for the
recurrent families); the paged decode's partials within 2^-7 relative; with
the switch off the port's decode is bit for bit what it was.
"""
import dataclasses

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
from test_torch_lm_models import BF16_ATOL, _close, _cut, _inputs, _pair, reduce_cfg

torch.set_num_threads(1)


def _decode_with_switch(arch, dtype, on, monkeypatch, n=3, s=9):
    rcfg, tcfg = (dataclasses.replace(reduce_cfg(c), dtype=dtype) for c in (RB.get_config(arch), TB.get_config(arch)))
    params, model = _pair(rcfg, tcfg)
    full = _inputs(rcfg, 2, s + n, seed=5)
    monkeypatch.setattr(RA, "CACHE_DTYPE_DOTS", on)
    monkeypatch.setattr(TA, "CACHE_DTYPE_DOTS", on)
    _, rcache = RT.prefill(params, {k: jnp.asarray(v) for k, v in _cut(full, 0, s).items()}, rcfg, cache_len=s + n)
    _, cache = TT.prefill(model, _cut(full, 0, s), cache_len=s + n)
    out = []
    for i in range(n):
        step = {"tokens": full["tokens"][:, s + i:s + i + 1]}
        ld, rcache = RT.decode_step(params, {"tokens": jnp.asarray(step["tokens"])}, rcache, jnp.int32(s + i), rcfg)
        tld, cache = TT.decode_step(model, step, cache, s + i)
        out.append((tld, ld))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "minicpm3-4b", "recurrentgemma-9b"])
def test_cache_dtype_dots_decode_matches_reference(arch, dtype, monkeypatch):
    """With ``CACHE_DTYPE_DOTS = True`` in both packages, decode continues
    against the reference (GQA, the MLA decode through the shared
    ``decode_attention``, RecurrentGemma's local attention): float32 within
    1e-5, bf16 within the port's bf16 bounds (``BF16_ATOL``: 0.0625, the
    recurrent family 0.125). With it False the port's logits are the
    default's bit for bit."""
    atol = 1e-5 if dtype == "float32" else BF16_ATOL.get(arch, BF16_ATOL[None])
    rtol = 1e-5 if dtype == "float32" else 0.0
    default = _decode_with_switch(arch, dtype, False, monkeypatch)
    for i, (got, want) in enumerate(_decode_with_switch(arch, dtype, True, monkeypatch)):
        _close(got, want, rtol, atol, f"{arch} {dtype} step {i}")
    again = _decode_with_switch(arch, dtype, False, monkeypatch)
    assert all(torch.equal(a[0], b[0]) for a, b in zip(default, again))


@pytest.mark.parametrize("on", [False, True])
def test_cache_dtype_dots_decode_partial_matches_reference(on, monkeypatch):
    """The paged decode's partials (acc, m, l) in bf16 against the
    reference's, the switch set alike in both: acc upcast after the product
    when on. Within 2^-7 relative (one bf16 rounding of q or p)."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 1, 2, 3, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 10, 2, 16)).astype(np.float32) for _ in "kv")
    pos = np.array([0, 1, 2, 3, 4, 5, 6, -1, -1, -1], np.int32)
    monkeypatch.setattr(RA, "CACHE_DTYPE_DOTS", on)
    monkeypatch.setattr(TA, "CACHE_DTYPE_DOTS", on)
    want = RA.decode_attention_partial(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), jnp.int32(6),
                                       jnp.asarray(pos))
    got = TA.decode_attention_partial(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)), 6,
                                      torch.from_numpy(pos))
    for g, w, name in zip(got, want, ("acc", "m", "l")):
        assert g.dtype == torch.float32 and str(w.dtype) == "float32", name
        _close(g, w, 2 ** -7, 2 ** -7, name)
