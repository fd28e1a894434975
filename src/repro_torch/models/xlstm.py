"""xLSTM blocks (Beck et al. 2024): mLSTM and sLSTM.

The port of ``repro.models.xlstm``. mLSTM: matrix-memory LSTM with
exponential gating; train/prefill use the parallel stabilized form
(chunked over queries), decode carries the (C, n, m) recurrent state, C a
(dk x dv) matrix a head. sLSTM: scalar-memory LSTM with exponential
gating and head-wise recurrent mixing; inherently sequential, a loop over
time (the reference's ``lax.scan``). The sLSTM input projection
``x_t @ w_gates`` does not depend on the carry, so it is made for the
whole sequence before the loop (one product in place of S).

Block wiring follows the xLSTM paper: mLSTM blocks use pre-up-projection
(factor 2) with a short causal conv feeding q/k; sLSTM blocks use
post-up-projection (factor 4/3) like a transformer FFN.

Where the reference rounds is kept: ``mlstm_parallel`` casts
``wts / denom`` to the value dtype before the PV product; the sLSTM gate
sum ``x @ w_gates + rec + gate_bias`` is in the activation dtype, left to
right. Stabilisers as there: mLSTM ``m = max(m, -1e30)`` and
``denom = max(|l|, exp(-m))``; sLSTM ``h = sigmoid(o) * c / max(n, 1)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import (
    all_trips,
    causal_conv,
    dense_weight,
    frozen_param,
    gelu,
    trips,
    truncated_normal_init,
)

MLSTM_PROJ_FACTOR = 2.0
SLSTM_PROJ_FACTOR = 4.0 / 3.0
CONV_WIDTH = 4


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    """Weights of the mLSTM block; ``fgate_bias`` and ``igate_bias`` are
    float32 always (the reference adds them to float32 gates)."""

    def __init__(self, d_model: int, n_heads: int, generator: torch.Generator | None = None, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        g = generator
        di = int(MLSTM_PROJ_FACTOR * d_model)
        kw = dict(device=device, dtype=dtype)

        def drawn(fn):  # in attribute order, so a seed gives the same weights
            return None if g is None else fn(g.device)

        self.w_up = dense_weight(g, d_model, di, **kw)
        self.w_up_gate = dense_weight(g, d_model, di, **kw)
        self.conv_w = frozen_param(drawn(lambda d: 0.1 * torch.randn(CONV_WIDTH, di, device=d, generator=g)),
                                   (CONV_WIDTH, di), device, dtype)
        self.conv_b = frozen_param(drawn(lambda d: torch.zeros(di, device=d)), (di,), device, dtype)
        self.wq = dense_weight(g, di, di, **kw)
        self.wk = dense_weight(g, di, di, **kw)
        self.wv = dense_weight(g, di, di, **kw)
        self.w_igate = dense_weight(g, di, n_heads, **kw)
        self.w_fgate = dense_weight(g, di, n_heads, **kw)
        # Init toward remembering.
        self.fgate_bias = frozen_param(drawn(lambda d: torch.full((n_heads,), 3.0, device=d)),
                                       (n_heads,), device, torch.float32)
        self.igate_bias = frozen_param(drawn(lambda d: torch.full((n_heads,), -1.0, device=d)),
                                       (n_heads,), device, torch.float32)
        self.skip_scale = frozen_param(drawn(lambda d: torch.ones(di, device=d)), (di,), device, dtype)
        self.w_down = dense_weight(g, di, d_model, **kw)


def mlstm_init(generator: torch.Generator, d_model: int, n_heads: int) -> MLSTM:
    return MLSTM(d_model, n_heads, generator)


def _mlstm_conv(p: MLSTM, u: torch.Tensor, state: torch.Tensor | None):
    out, new_state = causal_conv(p, u, state)
    return F.silu(out), new_state


def mlstm_parallel(
    q: torch.Tensor,  # (B, S, H, dh)
    k: torch.Tensor,
    v: torch.Tensor,
    log_f: torch.Tensor,  # (B, S, H) log sigmoid forget gates
    log_i: torch.Tensor,  # (B, S, H) log input gates (pre-exp)
    chunk: int = 256,
) -> torch.Tensor:
    """Stabilized parallel mLSTM, chunked over queries to bound memory.

    D[t,s] = exp(F[t] - F[s] + log_i[s] - m[t]), F = cumsum(log_f);
    h_t = (sum_s D[t,s] (q_t k_s / sqrt(d)) v_s) / max(|l_t|, exp(-m_t)).
    The reference pads the last chunk of queries; the port runs it short,
    which gives the same rows.
    """
    b, s, h, dh = q.shape
    scale = dh ** -0.5
    f_cum = torch.cumsum(log_f, dim=1)  # (B, S, H)
    f_k = f_cum.permute(0, 2, 1)[:, :, None, :]  # (B, H, 1, S)
    i_k = log_i.permute(0, 2, 1)[:, :, None, :]
    kf, vf = k.float(), v.float()
    pos = torch.arange(s, device=q.device)
    outs = []
    for lo in range(0, s, chunk):
        hi = min(lo + chunk, s)
        sc = torch.einsum("bqhd,bkhd->bhqk", q[:, lo:hi].float(), kf) * scale
        logd = f_cum[:, lo:hi].permute(0, 2, 1)[..., None] - f_k + i_k  # (B, H, c, S)
        causal = pos[None, :] <= pos[lo:hi, None]  # (c, S)
        logd = torch.where(causal, logd, float("-inf"))
        m = torch.clamp(logd.amax(-1, keepdim=True), min=-1e30)
        d = torch.exp(logd - m)
        wts = sc * d
        l = torch.abs(wts.sum(-1, keepdim=True))
        denom = torch.maximum(l, torch.exp(-m))
        outs.append(torch.einsum("bhqk,bkhd->bqhd", (wts / denom).to(v.dtype).float(), vf))
    return torch.cat(outs, dim=1).to(v.dtype)


def _mlstm_gates(p: MLSTM, c: torch.Tensor):
    """(log_f, log_i) float32 from the conv output ``c``."""
    dtype = c.dtype
    log_f = F.logsigmoid((c @ p.w_fgate.to(dtype)).float() + p.fgate_bias)
    log_i = (c @ p.w_igate.to(dtype)).float() + p.igate_bias
    return log_f, log_i


def mlstm_apply(
    p: MLSTM,
    x: torch.Tensor,  # (B, S, d)
    *,
    n_heads: int,
    state: dict[str, torch.Tensor] | None = None,
    return_state: bool = False,
):
    b, s, d = x.shape
    dtype = x.dtype
    u = x @ p.w_up.to(dtype)  # (B, S, di)
    z = x @ p.w_up_gate.to(dtype)
    c, new_conv = _mlstm_conv(p, u, None if state is None else state["conv"])
    di = u.shape[-1]
    dh = di // n_heads
    q = (c @ p.wq.to(dtype)).reshape(b, s, n_heads, dh)
    k = (c @ p.wk.to(dtype)).reshape(b, s, n_heads, dh)
    v = (u @ p.wv.to(dtype)).reshape(b, s, n_heads, dh)
    log_f, log_i = _mlstm_gates(p, c)
    h = mlstm_parallel(q, k, v, log_f, log_i).reshape(b, s, di)
    h = h + p.skip_scale.to(dtype) * c  # learnable skip
    y = (h * F.silu(z)) @ p.w_down.to(dtype)
    if not return_state:
        return y
    # The recurrent state from the full sequence (for prefill):
    # C_S = sum_s exp(F_S - F_s + i_s - m_S) v_s k_s^T, stabilized by m_S.
    f_cum = torch.cumsum(log_f, dim=1)
    rel = f_cum[:, -1:, :] - f_cum + log_i  # (B, S, H)
    m_last = rel.amax(dim=1)  # (B, H)
    w_s = torch.exp(rel - m_last[:, None, :])  # (B, S, H)
    kw = k.float() * w_s[..., None]
    c_mat = torch.einsum("bshk,bshv->bhkv", kw, v.float())
    n_vec = kw.sum(dim=1)  # (B, H, dh)
    return y, {"c": c_mat, "n": n_vec, "m": m_last, "conv": new_conv.float()}


def mlstm_decode(
    p: MLSTM,
    x: torch.Tensor,  # (B, 1, d)
    state: dict[str, torch.Tensor],
    *,
    n_heads: int,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    b = x.shape[0]
    dtype = x.dtype
    u = x @ p.w_up.to(dtype)
    z = x @ p.w_up_gate.to(dtype)
    c, new_conv = _mlstm_conv(p, u, state["conv"])
    di = u.shape[-1]
    dh = di // n_heads
    q = (c @ p.wq.to(dtype)).reshape(b, n_heads, dh)
    k = (c @ p.wk.to(dtype)).reshape(b, n_heads, dh)
    v = (u @ p.wv.to(dtype)).reshape(b, n_heads, dh)
    log_f, log_i = _mlstm_gates(p, c[:, 0])  # (B, H)
    m_new = torch.maximum(log_f + state["m"], log_i)
    f_s = torch.exp(log_f + state["m"] - m_new)
    i_s = torch.exp(log_i - m_new)
    kf, vf = k.float(), v.float()
    c_mat = f_s[..., None, None] * state["c"] + i_s[..., None, None] * (kf[..., :, None] * vf[..., None, :])
    n_vec = f_s[..., None] * state["n"] + i_s[..., None] * kf
    qf = q.float() * (dh ** -0.5)
    num = torch.einsum("bhk,bhkv->bhv", qf, c_mat)
    den = torch.maximum(torch.abs((qf * n_vec).sum(-1)), torch.exp(-m_new))
    h = (num / den[..., None]).reshape(b, 1, di).to(dtype)
    h = h + p.skip_scale.to(dtype) * c
    y = (h * F.silu(z)) @ p.w_down.to(dtype)
    return y, {"c": c_mat, "n": n_vec, "m": m_new, "conv": new_conv.float()}


def init_mlstm_state(b: int, d_model: int, n_heads: int, device=None) -> dict[str, torch.Tensor]:
    di = int(MLSTM_PROJ_FACTOR * d_model)
    dh = di // n_heads
    kw = dict(dtype=torch.float32, device=device)
    return {
        "c": torch.zeros((b, n_heads, dh, dh), **kw),
        "n": torch.zeros((b, n_heads, dh), **kw),
        "m": torch.zeros((b, n_heads), **kw),
        "conv": torch.zeros((b, CONV_WIDTH - 1, di), **kw),
    }


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLSTM(nn.Module):
    """Weights of the sLSTM block: ``w_gates`` (d, 4d, i|f|z|o),
    ``r_gates`` (H, dh, 4dh) head-wise recurrent mixing, ``gate_bias``
    (4d), and the post-up-projection FFN."""

    def __init__(self, d_model: int, n_heads: int, generator: torch.Generator | None = None, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        g = generator
        dh = d_model // n_heads
        d_up = int(SLSTM_PROJ_FACTOR * d_model)
        kw = dict(device=device, dtype=dtype)
        r_gates = bias = None
        if g is not None:
            r_gates = 0.5 * truncated_normal_init(g, (n_heads, dh, 4 * dh), dh ** -0.5)
            bias = torch.zeros(4 * d_model, device=g.device)
            bias[d_model:2 * d_model] = 3.0
        self.w_gates = dense_weight(g, d_model, 4 * d_model, **kw)
        self.r_gates = frozen_param(r_gates, (n_heads, dh, 4 * dh), device, dtype)
        self.gate_bias = frozen_param(bias, (4 * d_model,), device, dtype)
        self.w_up_gate = dense_weight(g, d_model, d_up, **kw)
        self.w_up = dense_weight(g, d_model, d_up, **kw)
        self.w_down = dense_weight(g, d_up, d_model, **kw)


def slstm_init(generator: torch.Generator, d_model: int, n_heads: int) -> SLSTM:
    return SLSTM(d_model, n_heads, generator)


_ONE = torch.tensor(1.0)  # a CPU scalar: no copy to the card


def _slstm_cell(p: SLSTM, xw_t: torch.Tensor, state: dict, *, n_heads: int) -> dict:
    """One sLSTM time step from ``xw_t = x_t @ w_gates`` (B, 4d), in the
    activation dtype, and the float32 carry."""
    b, d4 = xw_t.shape
    d = d4 // 4
    dh = d // n_heads
    dtype = xw_t.dtype
    hh = state["h"].to(dtype).reshape(b, n_heads, dh)
    # Recurrent head-wise contribution, head-blocked (i,f,z,o) chunks
    # reordered to w_gates' (i|f|z|o) layout.
    rec = torch.einsum("bhd,hde->bhe", hh, p.r_gates.to(dtype))
    rec = rec.reshape(b, n_heads, 4, dh).permute(0, 2, 1, 3).reshape(b, 4 * d)
    gates = (xw_t + rec + p.gate_bias.to(dtype)).float()
    i_raw, f_raw, z_raw, o_raw = gates.chunk(4, dim=-1)
    log_f = F.logsigmoid(f_raw)
    m_new = torch.maximum(log_f + state["m"], i_raw)
    i_g = torch.exp(i_raw - m_new)
    f_g = torch.exp(log_f + state["m"] - m_new)
    c_new = f_g * state["c"] + i_g * torch.tanh(z_raw)
    n_new = f_g * state["n"] + i_g
    # torch.maximum, as the reference's jnp.maximum, splits the gradient at a
    # tie (clamp would pass all of it): at the first step, with m = 0,
    # n_new is exactly 1.0 wherever i_raw >= log_f.
    h_new = torch.sigmoid(o_raw) * c_new / torch.maximum(n_new, _ONE)
    return {"h": h_new, "c": c_new, "n": n_new, "m": m_new}


def _slstm_up(p: SLSTM, h: torch.Tensor) -> torch.Tensor:
    dtype = h.dtype
    up = gelu(h @ p.w_up_gate.to(dtype)) * (h @ p.w_up.to(dtype))
    return up @ p.w_down.to(dtype)


def slstm_apply(
    p: SLSTM,
    x: torch.Tensor,  # (B, S, d)
    *,
    n_heads: int,
    state: dict[str, torch.Tensor] | None = None,
    return_state: bool = False,
):
    b, s, d = x.shape
    dtype = x.dtype
    st = init_slstm_state(b, d, device=x.device) if state is None else state
    xw = x @ p.w_gates.to(dtype)  # (B, S, 4d)
    hs = []
    for t in trips(s):
        st = _slstm_cell(p, xw[:, t], st, n_heads=n_heads)
        hs.append(st["h"])
    y = _slstm_up(p, torch.stack(all_trips(hs, s), dim=1).to(dtype))
    if return_state:
        return y, st
    return y


def slstm_decode(
    p: SLSTM,
    x: torch.Tensor,  # (B, 1, d)
    state: dict[str, torch.Tensor],
    *,
    n_heads: int,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    new = _slstm_cell(p, x[:, 0] @ p.w_gates.to(x.dtype), state, n_heads=n_heads)
    return _slstm_up(p, new["h"][:, None].to(x.dtype)), new


def init_slstm_state(b: int, d_model: int, device=None) -> dict[str, torch.Tensor]:
    z = torch.zeros((b, d_model), dtype=torch.float32, device=device)
    return {"h": z, "c": z.clone(), "n": z.clone(), "m": z.clone()}
