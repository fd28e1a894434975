"""Token-choice top-k Mixture-of-Experts with capacity-based dispatch.

The port of ``repro.models.moe``, in the reference's formulation: the
router and its softmax in float32; top-k with the reference's tie order;
each assignment ranked within its expert by a one-hot cumsum in flat
``(token, k)`` order; tokens past an expert's capacity dropped (value
masked into slot 0 of the ``(E*C, d)`` buffer); every expert run over its
``C`` rows as one batched product; the gate-weighted results gathered
back. No shape depends on the data, so nothing here reads a value back to
the host: a decode step on the card makes no host synchronization.

Two orders are kept on purpose. ``jax.lax.top_k`` breaks ties toward the
lower index and ``torch.topk`` does not, so the selection is a stable
descending sort. The reference adds a token's ``k`` contributions with a
scatter-add in the activation dtype; the port adds them in ``k`` order
from zero, so a bf16 sum is the same on the card as on the CPU (an
atomic ``index_add_`` would add them in any order).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.models.common import _ACT, dense_weight, truncated_normal_init


class MoEOutput(NamedTuple):
    y: torch.Tensor  # (B, S, d)
    aux_loss: torch.Tensor  # scalar load-balancing loss, float32
    router_entropy: torch.Tensor  # scalar diagnostics, float32


class Routing(NamedTuple):
    """Where each of the ``T * k`` assignments goes, flat in ``(token, k)``
    order: its expert, its gate, whether it fits its expert's capacity, and
    its row of the ``(E*C, d)`` dispatch buffer (0 when dropped)."""
    probs: torch.Tensor  # (T, E) float32
    gates: torch.Tensor  # (T, k) float32, renormalised
    experts: torch.Tensor  # (T, k) int64
    keep: torch.Tensor  # (T*k,) bool
    slot: torch.Tensor  # (T*k,) int64
    capacity: int


class MoE(nn.Module):
    """``router`` (d, E), float32 always (the reference reads it in
    float32); the stacked experts ``wi_gate``, ``wi_up`` (E, d, f) and
    ``wo`` (E, f, d)."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int,
                 generator: torch.Generator | None = None, *, device=None, dtype=torch.float32):
        super().__init__()
        self.router = dense_weight(generator, d_model, n_experts, device=device)
        self.wi_gate = _experts(generator, n_experts, d_model, d_ff, device, dtype)
        self.wi_up = _experts(generator, n_experts, d_model, d_ff, device, dtype)
        self.wo = _experts(generator, n_experts, d_ff, d_model, device, dtype)


def _experts(generator, e: int, d_in: int, d_out: int, device, dtype) -> nn.Parameter:
    """E dense ``(d_in, d_out)`` weights stacked along a leading axis."""
    w = (truncated_normal_init(generator, (e, d_in, d_out), d_in ** -0.5) if generator is not None
         else torch.empty(e, d_in, d_out, dtype=dtype, device=device))
    return nn.Parameter(w, requires_grad=False)


def moe_init(generator: torch.Generator, d_model: int, d_ff: int, n_experts: int) -> MoE:
    return MoE(d_model, d_ff, n_experts, generator)


def select_top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index (a stable descending sort keeps the index order of equal
    values)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(router: torch.Tensor, xt: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25) -> Routing:
    """The router, top-k and capacity ranking of tokens ``xt`` (T, d)."""
    t, e = xt.shape[0], n_experts
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)  # (T, E)
    gates, experts = select_top_k(probs, top_k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    capacity = int(max(top_k, t * top_k / e * capacity_factor))
    # Rank each assignment within its expert: one-hot cumsum, no sort.
    flat_e = experts.reshape(-1)
    onehot = (flat_e[:, None] == torch.arange(e, device=xt.device)).to(torch.int32)  # (T*k, E)
    pos_in_e = torch.cumsum(onehot, 0, dtype=torch.int32) - onehot
    pos = pos_in_e.gather(1, flat_e[:, None])[:, 0]
    keep = pos < capacity
    slot = torch.where(keep, flat_e * capacity + pos, 0)
    return Routing(probs, gates, experts, keep, slot, capacity)


def moe_apply(
    p: MoE,
    x: torch.Tensor,  # (B, S, d)
    *,
    n_experts: int,
    top_k: int,
    capacity_factor: float = 1.25,
    act: str = "silu",
) -> MoEOutput:
    b, s, d = x.shape
    t, e, k = b * s, n_experts, top_k
    xt = x.reshape(t, d)
    dtype = x.dtype
    r = moe_route(p.router, xt, n_experts=e, top_k=k, capacity_factor=capacity_factor)
    c = r.capacity
    keep = r.keep.to(dtype)
    # Scatter into the (E*C, d) buffer. Kept slots are distinct and dropped
    # assignments add zeros at slot 0, so the sum is exact in any order.
    flat_t = torch.arange(t * k, device=x.device) // k  # the token of each assignment
    contrib = xt.index_select(0, flat_t) * keep[:, None]
    buf = torch.zeros((e * c, d), dtype=dtype, device=x.device).index_add_(0, r.slot, contrib)
    buf = buf.reshape(e, c, d)
    # Batched expert FFN.
    gate_h = torch.bmm(buf, p.wi_gate.to(dtype))
    up_h = torch.bmm(buf, p.wi_up.to(dtype))
    out_e = torch.bmm(_ACT[act](gate_h) * up_h, p.wo.to(dtype))  # (E, C, d)
    # Gather back, weighted by gates (slot-0 reads of dropped assignments
    # are gate-masked); a token's k contributions added in k order.
    flat_gate = r.gates.reshape(-1).to(dtype) * keep
    picked = (out_e.reshape(e * c, d).index_select(0, r.slot) * flat_gate[:, None]).reshape(t, k, d)
    yt = torch.zeros((t, d), dtype=dtype, device=x.device)
    for j in range(k):
        yt = yt + picked[:, j]
    # Switch-style load-balancing loss: E * sum_e f_e * P_e.
    counts = (r.experts[..., None] == torch.arange(e, device=x.device)).float().sum(1)  # (T, E)
    f_e = counts.mean(0) / k
    aux = e * torch.sum(f_e * r.probs.mean(0))
    entropy = -torch.mean(torch.sum(r.probs * torch.log(r.probs + 1e-9), dim=-1))
    return MoEOutput(yt.reshape(b, s, d), aux, entropy)
