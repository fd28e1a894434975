"""RG-LRU recurrent block (RecurrentGemma / Griffin).

The port of ``repro.models.rglru``. The recurrence
``h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)`` is a diagonal
linear recurrence. The reference evaluates it over a prompt with
``jax.lax.associative_scan``; :func:`rglru_scan` runs the same recursive
odd/even algorithm (``jax._src.lax.control_flow.loops.associative_scan``)
with the same combine, so the port adds and multiplies in the same tree
(log depth in the sequence, a few dozen launches at S = 64) and differs
from the reference only by the rounding of ``exp``. Decode carries one
``(B, D)`` state.

Block structure (Griffin recurrent block):
  x -> [gate branch: linear -> GeLU]
    -> [main branch: linear -> short conv1d(w=4) -> RG-LRU]
  y = gate * rglru_out -> linear out

Where the reference rounds is kept: ``rglru_apply`` upcasts ``i_t`` and
``x_t`` before their product, ``rglru_decode`` multiplies them in the
activation dtype and then upcasts.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.common import causal_conv, dense_weight, frozen_param, gelu

C_SCALE = 8.0  # the paper's fixed `c` constant


_ZERO = torch.tensor(0.0)  # a CPU scalar: no copy to the card


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, ``logaddexp(x, 0)``. ``torch.maximum`` splits
    the gradient at x == 0 as ``logaddexp``'s does (0.5); ``clamp`` would
    pass all of it. Only an entry of ``log_lambda`` that is exactly 0.0
    meets it: init draws none (``softplus(0) = ln 2`` needs ``u`` =
    ``0.5 ** 8``, outside [0.9, 0.999]), an update could land on one."""
    return torch.maximum(x, _ZERO) + torch.log1p(torch.exp(-x.abs()))


class RGLRU(nn.Module):
    """Weights of the recurrent block, the reference's names and
    ``(d_in, d_out)`` orientation; ``log_lambda`` is float32 always (the
    reference reads it in float32)."""

    def __init__(self, d_model: int, lru_width: int, conv_width: int = 4,
                 generator: torch.Generator | None = None, *, device=None, dtype=torch.float32):
        super().__init__()
        g, w = generator, lru_width
        kw = dict(device=device, dtype=dtype)
        log_lambda = conv_w = conv_b = None
        if g is not None:
            # Lambda init so a^c in [0.9, 0.999] at sigma=0.5 (Griffin appendix).
            u = torch.empty(w, device=g.device).uniform_(0.9, 0.999, generator=g)
            log_lambda = torch.log(torch.expm1(-torch.log(u) / C_SCALE))  # softplus^-1
            conv_w = 0.1 * torch.randn(conv_width, w, device=g.device, generator=g)
            conv_b = torch.zeros(w, device=g.device)
        self.w_gate_branch = dense_weight(g, d_model, w, **kw)
        self.w_main = dense_weight(g, d_model, w, **kw)
        self.conv_w = frozen_param(conv_w, (conv_width, w), device, dtype)
        self.conv_b = frozen_param(conv_b, (w,), device, dtype)
        self.w_input_gate = dense_weight(g, w, w, **kw)
        self.w_rec_gate = dense_weight(g, w, w, **kw)
        self.log_lambda = frozen_param(log_lambda, (w,), device, torch.float32)
        self.w_out = dense_weight(g, w, d_model, **kw)


def rglru_init(generator: torch.Generator, d_model: int, lru_width: int, conv_width: int = 4) -> RGLRU:
    return RGLRU(d_model, lru_width, conv_width, generator)


def _gates(p: RGLRU, u: torch.Tensor):
    """Input gate i_t and log recurrence gate log(a_t) from conv output."""
    dtype = u.dtype
    i_gate = torch.sigmoid(u @ p.w_input_gate.to(dtype))
    r = torch.sigmoid(u @ p.w_rec_gate.to(dtype))
    log_a = -C_SCALE * _softplus(p.log_lambda).float() * r.float()
    return i_gate, log_a


def _combine(la1, b1, la2, b2):
    return la1 + la2, torch.exp(la2) * b1 + b2


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a[0], b[0], a[1], b[1], ... along axis 1 (``len(a)`` is ``len(b)`` or
    one more)."""
    out = a.new_empty((a.shape[0], a.shape[1] + b.shape[1]) + a.shape[2:])
    out[:, 0::2] = a
    out[:, 1::2] = b
    return out


def _assoc_scan(la: torch.Tensor, b: torch.Tensor):
    """``jax.lax.associative_scan(combine, (la, b), axis=1)``: the same
    recursion (pairs combined, the odd positions scanned, the even ones
    fixed up), so the same tree of additions and products."""
    n = la.shape[1]
    if n < 2:
        return la, b
    la_r, b_r = _combine(la[:, 0:-1:2], b[:, 0:-1:2], la[:, 1::2], b[:, 1::2])
    la_o, b_o = _assoc_scan(la_r, b_r)
    if n % 2 == 0:
        la_e, b_e = _combine(la_o[:, :-1], b_o[:, :-1], la[:, 2::2], b[:, 2::2])
    else:
        la_e, b_e = _combine(la_o, b_o, la[:, 2::2], b[:, 2::2])
    la_e = torch.cat([la[:, :1], la_e], dim=1)
    b_e = torch.cat([b[:, :1], b_e], dim=1)
    return _interleave(la_e, la_o), _interleave(b_e, b_o)


def rglru_scan(log_a: torch.Tensor, b_in: torch.Tensor) -> torch.Tensor:
    """Scan of h_t = a_t h_{t-1} + b_t over axis 1 (time), float32."""
    return _assoc_scan(log_a, b_in)[1]


def _beta(log_a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9))


def rglru_apply(
    p: RGLRU,
    x: torch.Tensor,  # (B, S, d)
    *,
    state: dict[str, torch.Tensor] | None = None,
    return_state: bool = False,
):
    """Train/prefill path. Returns y (and the final state when asked)."""
    dtype = x.dtype
    gate = gelu(x @ p.w_gate_branch.to(dtype))
    u = x @ p.w_main.to(dtype)
    u, new_conv = causal_conv(p, u, None if state is None else state["conv"])
    i_gate, log_a = _gates(p, u)
    b_in = _beta(log_a) * (i_gate.float() * u.float())
    if state is not None:
        # Seed the scan with the carried hidden state via the first step.
        h0 = state["h"].float()
        b_first = b_in[:, :1] + torch.exp(log_a[:, :1]) * h0[:, None]
        b_in = torch.cat([b_first, b_in[:, 1:]], dim=1)
    h = rglru_scan(log_a, b_in)  # (B, S, D) float32
    y = (gate * h.to(dtype)) @ p.w_out.to(dtype)
    if return_state:
        return y, {"h": h[:, -1], "conv": new_conv.float()}
    return y


def rglru_decode(
    p: RGLRU,
    x: torch.Tensor,  # (B, 1, d)
    state: dict[str, torch.Tensor],
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Single-step recurrence with the carried (h, conv) state."""
    dtype = x.dtype
    gate = gelu(x @ p.w_gate_branch.to(dtype))
    u = x @ p.w_main.to(dtype)
    u, new_conv = causal_conv(p, u, state["conv"])
    i_gate, log_a = _gates(p, u)
    h = (torch.exp(log_a[:, 0]) * state["h"].float()
         + _beta(log_a)[:, 0] * (i_gate[:, 0] * u[:, 0]).float())
    y = (gate[:, 0] * h.to(dtype)) @ p.w_out.to(dtype)
    return y[:, None], {"h": h, "conv": new_conv.float()}


def init_rglru_state(b: int, lru_width: int, conv_width: int = 4, device=None) -> dict[str, torch.Tensor]:
    return {
        "h": torch.zeros((b, lru_width), dtype=torch.float32, device=device),
        "conv": torch.zeros((b, conv_width - 1, lru_width), dtype=torch.float32, device=device),
    }

