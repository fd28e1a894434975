"""Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 style).

The port of ``repro.models.mla``. Queries and keys/values come through
low-rank latents:

  q = W_uq * norm(W_dq * x)              (q_lora_rank)
  c_kv = norm(W_dkv * x)                 (kv_lora_rank)  <- cached
  k_nope, v = W_uk * c_kv, W_uv * c_kv
  k_rope = RoPE(W_kr * x)                (single shared rope head) <- cached

Train/prefill assemble full per-head K = [k_nope ; k_rope] and run the
port's ``flash_attention`` (KV = H, G = 1, dk != dv). Decode uses the
absorbed form: W_uk is folded into the query, so attention runs against
the cached latents as one KV head shared by H query heads, then W_uv is
applied to the result. The cache write is the clamped one-row update of
``attention_decode`` (``clamp_slot``), its position set with ``fill_``,
so a decode step on the card makes no host synchronization.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.attention import clamp_slot, decode_attention, flash_attention
from repro_torch.models.common import apply_rope, dense_weight, rmsnorm, weak_scalar


class MLA(nn.Module):
    """The latent projections; the norm scales ``q_norm`` and ``kv_norm``
    are float32 always, as every norm scale."""

    def __init__(self, d_model: int, n_heads: int, q_lora_rank: int, kv_lora_rank: int,
                 qk_nope_dim: int, qk_rope_dim: int, v_head_dim: int,
                 generator: torch.Generator | None = None, *, device=None, dtype=torch.float32):
        super().__init__()
        g = generator
        kw = dict(device=device, dtype=dtype)
        qk = qk_nope_dim + qk_rope_dim
        dev = device if g is None else g.device
        self.w_dq = dense_weight(g, d_model, q_lora_rank, **kw)
        self.q_norm = nn.Parameter(torch.ones(q_lora_rank, device=dev), requires_grad=False)
        self.w_uq = dense_weight(g, q_lora_rank, n_heads * qk, **kw)
        self.w_dkv = dense_weight(g, d_model, kv_lora_rank, **kw)
        self.kv_norm = nn.Parameter(torch.ones(kv_lora_rank, device=dev), requires_grad=False)
        self.w_uk = dense_weight(g, kv_lora_rank, n_heads * qk_nope_dim, **kw)
        self.w_uv = dense_weight(g, kv_lora_rank, n_heads * v_head_dim, **kw)
        self.w_kr = dense_weight(g, d_model, qk_rope_dim, **kw)
        self.wo = dense_weight(g, n_heads * v_head_dim, d_model, **kw)


def mla_init(generator: torch.Generator, d_model: int, n_heads: int, q_lora_rank: int,
             kv_lora_rank: int, qk_nope_dim: int, qk_rope_dim: int, v_head_dim: int) -> MLA:
    return MLA(d_model, n_heads, q_lora_rank, kv_lora_rank, qk_nope_dim, qk_rope_dim, v_head_dim,
               generator)


def _latents(p: MLA, x: torch.Tensor, dims: dict[str, int]):
    b, s, _ = x.shape
    h, nope, rope = dims["n_heads"], dims["qk_nope_dim"], dims["qk_rope_dim"]
    dtype = x.dtype
    cq = rmsnorm(x @ p.w_dq.to(dtype), p.q_norm)
    q = (cq @ p.w_uq.to(dtype)).reshape(b, s, h, nope + rope)
    c_kv = rmsnorm(x @ p.w_dkv.to(dtype), p.kv_norm)
    k_rope = (x @ p.w_kr.to(dtype)).reshape(b, s, 1, rope)
    return q, c_kv, k_rope


def mla_apply(p: MLA, x: torch.Tensor, *, dims: dict[str, int], positions: torch.Tensor,
              theta: float = 10000.0, q_chunk: int | None = None,
              kv_chunk: int | None = None) -> torch.Tensor:
    """Full causal MLA for training (no cache)."""
    return mla_prefill(p, x, dims=dims, positions=positions, theta=theta, cache_len=None,
                       q_chunk=q_chunk, kv_chunk=kv_chunk)[0]


def mla_prefill(
    p: MLA,
    x: torch.Tensor,
    *,
    dims: dict[str, int],
    positions: torch.Tensor,
    theta: float = 10000.0,
    cache_len: int | None = None,
    q_chunk: int | None = None,
    kv_chunk: int | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor] | None]:
    """Forward (and the latent cache, padded to ``cache_len``, when asked;
    a prompt longer than the cache raises ``ValueError`` as the
    reference's negative pad does)."""
    b, s, _ = x.shape
    h, nope, rope, vdim = dims["n_heads"], dims["qk_nope_dim"], dims["qk_rope_dim"], dims["v_head_dim"]
    dtype = x.dtype
    q, c_kv, k_rope = _latents(p, x, dims)
    q_nope, q_rope = q[..., :nope], apply_rope(q[..., nope:], positions, theta)
    k_rope = apply_rope(k_rope, positions, theta)
    k_nope = (c_kv @ p.w_uk.to(dtype)).reshape(b, s, h, nope)
    v = (c_kv @ p.w_uv.to(dtype)).reshape(b, s, h, vdim)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, rope)], dim=-1)
    qg = torch.cat([q_nope, q_rope], dim=-1)[:, :, :, None, :]  # KV = H, G = 1
    out = flash_attention(qg, k, v, q_positions=positions[0], kv_positions=positions[0],
                          causal=True, q_chunk=q_chunk, kv_chunk=kv_chunk).reshape(b, s, h * vdim)
    out = out @ p.wo.to(dtype)
    if cache_len is None:
        return out, None
    if cache_len < s:
        raise ValueError(f"prompt of {s} tokens does not fit a cache of {cache_len}")
    cache = init_mla_cache(b, cache_len, c_kv.shape[-1], rope, dtype, device=x.device)
    cache["c_kv"][:, :s] = c_kv
    cache["k_rope"][:, :s] = k_rope[:, :, 0]
    cache["pos"][:s] = positions[0]
    return out, cache


def mla_decode(
    p: MLA,
    x: torch.Tensor,  # (B, 1, d)
    cache: dict[str, torch.Tensor],
    position: int,
    *,
    dims: dict[str, int],
    theta: float = 10000.0,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Absorbed-matrix MLA decode over the latent cache. The new latents and
    position are written into ``cache`` in place (the reference returns a
    new cache; the values are the same), and the same dict is returned."""
    b = x.shape[0]
    h, nope, rope, vdim = dims["n_heads"], dims["qk_nope_dim"], dims["qk_rope_dim"], dims["v_head_dim"]
    rank = dims["kv_lora_rank"]
    dtype = x.dtype
    q, c_kv_new, k_rope_new = _latents(p, x, dims)
    pos_b = torch.full((b, 1), position, dtype=torch.int32, device=x.device)
    q_nope, q_rope = q[..., :nope], apply_rope(q[..., nope:], pos_b, theta)
    k_rope_new = apply_rope(k_rope_new, pos_b, theta)
    slot = clamp_slot(position, cache["c_kv"].shape[1])
    cache["c_kv"][:, slot] = c_kv_new[:, 0]
    cache["k_rope"][:, slot] = k_rope_new[:, 0, 0]
    cache["pos"][slot].fill_(position)  # a CPU scalar set into a CUDA tensor would synchronize
    # Absorb W_uk into the query: q_lat[b,1,h,r] = sum_n q_nope * w_uk[r,h,n].
    w_uk = p.w_uk.to(dtype).reshape(rank, h, nope)
    q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope, w_uk)
    # Attention against the shared latents: one KV head, G = H query heads.
    # K = [c_kv ; k_rope], Q = [q_lat ; q_rope], V = c_kv; the rescale
    # turns decode_attention's (rank + rope)^-0.5 into (nope + rope)^-0.5.
    q_full = torch.cat([q_lat, q_rope], dim=-1)
    q_full = q_full * weak_scalar((rank + rope) ** 0.5, dtype) * weak_scalar((nope + rope) ** -0.5, dtype)
    k_full = torch.cat([cache["c_kv"], cache["k_rope"]], dim=-1)[:, :, None, :]
    out_lat = decode_attention(q_full.reshape(b, 1, 1, h, rank + rope), k_full,
                               cache["c_kv"][:, :, None, :], position, cache["pos"]).reshape(b, 1, h, rank)
    # Un-absorb W_uv: out[b,1,h,v] = sum_r out_lat * w_uv[r,h,v].
    w_uv = p.w_uv.to(dtype).reshape(rank, h, vdim)
    out = torch.einsum("bqhr,rhv->bqhv", out_lat, w_uv).reshape(b, 1, h * vdim)
    return out @ p.wo.to(dtype), cache


def init_mla_cache(b: int, cache_len: int, kv_lora_rank: int, qk_rope_dim: int, dtype,
                   device=None) -> dict[str, torch.Tensor]:
    return {
        "c_kv": torch.zeros((b, cache_len, kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((b, cache_len, qk_rope_dim), dtype=dtype, device=device),
        "pos": torch.full((cache_len,), -1, dtype=torch.int32, device=device),
    }
