"""GQA attention with chunked online-softmax (flash-style) computation.

The port of ``repro.models.attention``, the paged decode included.
``flash_attention`` is
the same algorithm in plain PyTorch: a loop over query chunks and, inside
it, over KV chunks carrying the (m, l, acc) online-softmax state, with
the reference's chunk sizes, ``NEG_INF = -1e30`` in place of ``-inf`` and
the same update formulas, so a fully masked chunk behaves as there.

Every score and PV product multiplies the operands upcast to float32: the
reference asks XLA for a float32 result of bf16 operands
(``preferred_element_type``), and a product of two bf16 values is exact in
float32. The probabilities are cast to the value dtype before the PV
product, as there. The decode's products can instead run in the cache's
dtype (``CACHE_DTYPE_DOTS``, off by default, as in the reference).

Supports: causal masking via absolute positions, sliding-window (local)
attention with a ring-buffer cache, GQA grouping (KV heads x group),
dk != dv, and cache validity masks (position < 0 = empty slot).
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from repro_torch.models.common import all_trips, apply_mrope, apply_rope, dense_weight, trips

NEG_INF = -1e30

# The reference's default chunk sizes.
Q_CHUNK = 512
KV_CHUNK = 1024

# When True, the decode score and PV products (``decode_attention``,
# ``decode_attention_partial``) run in the cache's dtype, the query cast to
# it, and are upcast to float32 after the product, as the reference's
# switch of the same name; the MLA decode reaches it through
# ``decode_attention``. False (the default) keeps the float32 products.
CACHE_DTYPE_DOTS = False


def flash_attention(
    q: torch.Tensor,  # (B, Sq, KV, G, dk)
    k: torch.Tensor,  # (B, Skv, KV, dk)
    v: torch.Tensor,  # (B, Skv, KV, dv)
    q_positions: torch.Tensor,  # (Sq,) absolute positions
    kv_positions: torch.Tensor,  # (Skv,); -1 marks invalid slots
    *,
    causal: bool = True,
    window: int | None = None,
    q_chunk: int | None = None,
    kv_chunk: int | None = None,
) -> torch.Tensor:
    q_chunk = Q_CHUNK if q_chunk is None else q_chunk
    kv_chunk = KV_CHUNK if kv_chunk is None else kv_chunk
    b, sq, kvh, g, dk = q.shape
    skv, dv = k.shape[1], v.shape[-1]
    scale = dk ** -0.5

    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    # Pad sequence axes to chunk multiples.
    sq_p = -(-sq // q_chunk) * q_chunk
    skv_p = -(-skv // kv_chunk) * kv_chunk
    if sq_p != sq:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, 0, 0, sq_p - sq))
        q_positions = torch.nn.functional.pad(q_positions, (0, sq_p - sq), value=0)
    if skv_p != skv:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, skv_p - skv))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, skv_p - skv))
        kv_positions = torch.nn.functional.pad(kv_positions, (0, skv_p - skv), value=-1)

    n_q, n_kv = sq_p // q_chunk, skv_p // kv_chunk
    outs = []
    for qi in trips(n_q):
        i = qi * q_chunk
        qc = q[:, i:i + q_chunk].float()  # (B, qc, KV, G, dk)
        qp = q_positions[i:i + q_chunk]
        m = torch.full((b, kvh, g, q_chunk), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, kvh, g, q_chunk), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, kvh, g, q_chunk, dv), dtype=torch.float32, device=q.device)
        for kj in trips(n_kv):
            j = kj * kv_chunk
            ks, vs = k[:, j:j + kv_chunk], v[:, j:j + kv_chunk]
            kp = kv_positions[j:j + kv_chunk]
            s = torch.einsum("bqkgd,btkd->bkgqt", qc, ks.float()) * scale  # (B, KV, G, qc, kc)
            mask = (kp[None, :] >= 0).expand(q_chunk, -1)  # valid slots
            if causal:
                mask = mask & (kp[None, :] <= qp[:, None])
            if window is not None:
                mask = mask & (kp[None, :] > qp[:, None] - window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqt,btkd->bkgqd", p.to(vs.dtype).float(), vs.float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]  # (B, KV, G, qc, dv)
        outs.append(out.permute(0, 3, 1, 2, 4))  # (B, qc, KV, G, dv)
    return torch.cat(all_trips(outs, n_q), dim=1)[:, :sq].to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # (B, 1, KV, G, dk)
    k: torch.Tensor,  # (B, Skv, KV, dk)
    v: torch.Tensor,  # (B, Skv, KV, dv)
    position: int,  # absolute position of the new token
    kv_positions: torch.Tensor,  # (Skv,)
    *,
    window: int | None = None,
) -> torch.Tensor:
    """Single-token attention over a cache: no chunking needed (Sq = 1).
    Float32 products, or with ``CACHE_DTYPE_DOTS`` products in the cache's
    dtype."""
    s = _decode_scores(q, k)
    mask = (kv_positions >= 0) & (kv_positions <= position)
    if window is not None:
        mask = mask & (kv_positions > position - window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if CACHE_DTYPE_DOTS:
        out = torch.einsum("bkgqt,btkd->bqkgd", p.to(v.dtype), v)
    else:
        out = torch.einsum("bkgqt,btkd->bqkgd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _decode_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Scaled float32 scores (B, KV, G, 1, Skv) of a decode query."""
    scale = q.shape[-1] ** -0.5
    if CACHE_DTYPE_DOTS:
        return torch.einsum("bqkgd,btkd->bkgqt", q.to(k.dtype), k).float() * scale
    return torch.einsum("bqkgd,btkd->bkgqt", q.float(), k.float()) * scale


# ---------------------------------------------------------------------------
# GQA attention layer (init/apply for train, prefill, decode).
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """GQA projection weights ``wq``, ``wk``, ``wv`` (d_model, heads x
    head_dim) and ``wo`` (n_heads x head_dim, d_model): the reference's
    ``(d_in, d_out)`` orientation."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int, head_dim: int,
                 generator: torch.Generator | None = None, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.wq = dense_weight(generator, d_model, n_heads * head_dim, **kw)
        self.wk = dense_weight(generator, d_model, n_kv_heads * head_dim, **kw)
        self.wv = dense_weight(generator, d_model, n_kv_heads * head_dim, **kw)
        self.wo = dense_weight(generator, n_heads * head_dim, d_model, **kw)


def attn_init(generator: torch.Generator, d_model: int, n_heads: int, n_kv_heads: int,
              head_dim: int) -> Attention:
    return Attention(d_model, n_heads, n_kv_heads, head_dim, generator)


def _project_qkv(p: Attention, x: torch.Tensor, n_heads: int, n_kv_heads: int, head_dim: int):
    b, s, _ = x.shape
    dtype = x.dtype
    q = (x @ p.wq.to(dtype)).reshape(b, s, n_heads, head_dim)
    k = (x @ p.wk.to(dtype)).reshape(b, s, n_kv_heads, head_dim)
    v = (x @ p.wv.to(dtype)).reshape(b, s, n_kv_heads, head_dim)
    return q, k, v


def _apply_positional(q, k, positions, cfg_pos: dict[str, Any]):
    kind = cfg_pos.get("kind", "rope")
    if kind == "rope":
        theta = cfg_pos.get("theta", 10000.0)
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    elif kind == "mrope":
        theta = cfg_pos.get("theta", 10000.0)
        q = apply_mrope(q, cfg_pos["mrope_positions"], cfg_pos["sections"], theta)
        k = apply_mrope(k, cfg_pos["mrope_positions"], cfg_pos["sections"], theta)
    elif kind != "none":
        raise ValueError(kind)
    return q, k


def _attend(p: Attention, x, *, n_heads, n_kv_heads, head_dim, positions, pos_cfg, window,
            q_chunk, kv_chunk):
    """Project, rotate, attend: (output (B, S, d), k, v) for train/prefill."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim)
    q, k = _apply_positional(q, k, positions, pos_cfg)
    qg = q.reshape(b, s, n_kv_heads, n_heads // n_kv_heads, head_dim)
    out = flash_attention(
        qg, k, v, q_positions=positions[0], kv_positions=positions[0],
        causal=True, window=window, q_chunk=q_chunk, kv_chunk=kv_chunk,
    )
    return out.reshape(b, s, n_heads * head_dim) @ p.wo.to(x.dtype), k, v


def attention_apply(
    p: Attention,
    x: torch.Tensor,  # (B, S, d)
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    positions: torch.Tensor,  # (B, S) absolute
    pos_cfg: dict[str, Any],
    window: int | None = None,
    q_chunk: int | None = None,
    kv_chunk: int | None = None,
) -> torch.Tensor:
    """Full causal (optionally banded) attention for train/prefill."""
    return _attend(p, x, n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim,
                   positions=positions, pos_cfg=pos_cfg, window=window,
                   q_chunk=q_chunk, kv_chunk=kv_chunk)[0]


def attention_prefill(
    p: Attention,
    x: torch.Tensor,
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    positions: torch.Tensor,
    pos_cfg: dict[str, Any],
    window: int | None = None,
    cache_len: int | None = None,
    q_chunk: int | None = None,
    kv_chunk: int | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Forward + build the decode cache.

    For full attention the cache holds all S (padded to cache_len) keys;
    for local attention only the trailing ``window`` ring buffer. A
    prompt longer than ``cache_len`` raises ``ValueError``, as the
    reference's negative ``jnp.pad`` does.
    """
    b, s, _ = x.shape
    out, k, v = _attend(p, x, n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim,
                        positions=positions, pos_cfg=pos_cfg, window=window,
                        q_chunk=q_chunk, kv_chunk=kv_chunk)
    if window is None:
        clen = cache_len if cache_len is not None else s
        if clen < s:
            raise ValueError(f"prompt of {s} tokens does not fit a cache of {clen}")
        ck = k.new_zeros((b, clen) + k.shape[2:])
        cv = v.new_zeros((b, clen) + v.shape[2:])
        ck[:, :s], cv[:, :s] = k, v
        cpos = torch.full((clen,), -1, dtype=torch.int32, device=x.device)
        cpos[:s] = positions[0]
    else:
        # Ring buffer holding the last `w` tokens at slot = pos % w.
        w = window
        take = min(s, w)
        slots = (positions[0, s - take:] % w).long()
        ck = k.new_zeros((b, w, n_kv_heads, head_dim))
        cv = v.new_zeros((b, w, n_kv_heads, head_dim))
        ck[:, slots] = k[:, s - take:]
        cv[:, slots] = v[:, s - take:]
        cpos = torch.full((w,), -1, dtype=torch.int32, device=x.device)
        cpos[slots] = positions[0, s - take:].to(torch.int32)
    return out, {"k": ck, "v": cv, "pos": cpos}


def clamp_slot(slot: int, size: int) -> int:
    """The start index ``jax.lax.dynamic_update_slice_in_dim`` uses for a
    one-row update: a negative index counts from the end, then the index
    is clamped into ``[0, size - 1]``. So a position past the cache writes
    its last slot (ROADMAP §3)."""
    if slot < 0:
        slot += size
    return min(max(slot, 0), size - 1)


def attention_decode(
    p: Attention,
    x: torch.Tensor,  # (B, 1, d)
    cache: dict[str, torch.Tensor],
    position: int,
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    pos_cfg: dict[str, Any],
    window: int | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One token against the cache. The new key, value and position are
    written into ``cache`` in place (the reference returns a new cache;
    the values are the same), and the same dict is returned."""
    b = x.shape[0]
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim)
    pos_b = torch.full((b, 1), position, dtype=torch.int32, device=x.device)
    q, k = _apply_positional(q, k, pos_b, pos_cfg)
    clen = cache["k"].shape[1]
    slot = clamp_slot(position % clen if window is not None else position, clen)
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    cache["pos"][slot].fill_(position)  # a CPU scalar set into a CUDA tensor would synchronize
    qg = q.reshape(b, 1, n_kv_heads, n_heads // n_kv_heads, head_dim)
    out = decode_attention(qg, cache["k"], cache["v"], position, cache["pos"], window=window)
    return out.reshape(b, 1, n_heads * head_dim) @ p.wo.to(x.dtype), cache


def init_attn_cache(b: int, cache_len: int, n_kv_heads: int, head_dim: int, dtype,
                    window: int | None = None, page: int = 0, device=None) -> dict[str, torch.Tensor]:
    """An empty cache; ``page > 0`` adds the hot ring page of the paged
    decode (``k_page``, ``v_page``, ``page_pos``)."""
    clen = min(cache_len, window) if window is not None else cache_len
    out = {
        "k": torch.zeros((b, clen, n_kv_heads, head_dim), dtype=dtype, device=device),
        "v": torch.zeros((b, clen, n_kv_heads, head_dim), dtype=dtype, device=device),
        "pos": torch.full((clen,), -1, dtype=torch.int32, device=device),
    }
    if page:
        out["k_page"] = torch.zeros((b, page, n_kv_heads, head_dim), dtype=dtype, device=device)
        out["v_page"] = torch.zeros((b, page, n_kv_heads, head_dim), dtype=dtype, device=device)
        out["page_pos"] = torch.full((page,), -1, dtype=torch.int32, device=device)
    return out


# ---------------------------------------------------------------------------
# Paged decode: hot-page writes + two-source online-softmax merge.
#
# With the main cache sequence-sharded (context parallelism), a one-token
# dynamic update rewrites the whole local cache shard every step. Instead,
# new tokens land in a small ring page; attention runs over the frozen
# cache and the page separately and merges the softmax partials; the page
# is flushed into the main cache every ``page`` steps. On one device the
# main cache is not sharded, so the paged path only adds work.
# ---------------------------------------------------------------------------

def decode_attention_partial(
    q: torch.Tensor,  # (B, 1, KV, G, dk)
    k: torch.Tensor,  # (B, Skv, KV, dk)
    v: torch.Tensor,  # (B, Skv, KV, dv)
    position: int,
    kv_positions: torch.Tensor,  # (Skv,)
    *,
    window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unnormalized single-token attention: (acc, m, l), with out = acc / l
    after merging the sources. Float32 products, the probabilities cast to
    the value dtype before the second; with ``CACHE_DTYPE_DOTS`` both
    products in the cache's dtype, each upcast after it."""
    s = _decode_scores(q, k)
    mask = (kv_positions >= 0) & (kv_positions <= position)
    if window is not None:
        mask = mask & (kv_positions > position - window)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1)  # (B, KV, G, 1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    if CACHE_DTYPE_DOTS:
        acc = torch.einsum("bkgqt,btkd->bkgqd", p.to(v.dtype), v).float()
    else:
        acc = torch.einsum("bkgqt,btkd->bkgqd", p.to(v.dtype).float(), v.float())
    return acc, m, l


def merge_attention_partials(parts: list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]]) -> torch.Tensor:
    """Combine (acc, m, l) online-softmax partials from disjoint KV sets."""
    m_star = parts[0][1]
    for _, m, _ in parts[1:]:
        m_star = torch.maximum(m_star, m)
    acc_tot = 0.0
    l_tot = 0.0
    for acc, m, l in parts:
        scale = torch.exp(m - m_star)
        acc_tot = acc_tot + acc * scale[..., None]
        l_tot = l_tot + l * scale
    return acc_tot / torch.clamp(l_tot, min=1e-30)[..., None]


def attention_decode_paged(
    p: Attention,
    x: torch.Tensor,  # (B, 1, d)
    cache: dict[str, torch.Tensor],
    position: int,
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    pos_cfg: dict[str, Any],
    window: int | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One token against the main cache and the hot page: the new key,
    value and position go into page slot ``position % page`` in place;
    the main cache is only read. Returns (output, the same dict)."""
    b = x.shape[0]
    page = cache["k_page"].shape[1]
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim)
    pos_b = torch.full((b, 1), position, dtype=torch.int32, device=x.device)
    q, k = _apply_positional(q, k, pos_b, pos_cfg)
    slot = position % page
    cache["k_page"][:, slot] = k[:, 0]
    cache["v_page"][:, slot] = v[:, 0]
    cache["page_pos"][slot].fill_(position)
    qg = q.reshape(b, 1, n_kv_heads, n_heads // n_kv_heads, head_dim)
    out = merge_attention_partials([
        decode_attention_partial(qg, cache["k"], cache["v"], position, cache["pos"], window=window),
        decode_attention_partial(qg, cache["k_page"], cache["v_page"], position, cache["page_pos"],
                                 window=window),
    ])  # (B, KV, G, 1, dv)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, 1, n_heads * head_dim)
    return out.to(x.dtype) @ p.wo.to(x.dtype), cache


def flush_page(cache: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Merge the hot page into the main cache (run every ``page`` steps),
    in place, and empty the page; returns the same dict.

    Each valid page slot writes its key, value and position at its
    absolute position; an empty slot (position -1) writes nothing, and a
    position at or past the cache length is dropped, as the reference's
    scatter drops it. Unlike the reference, an empty slot never writes
    back over position 0 (ROADMAP §3). No host synchronization: the
    cache is rewritten by a select, the amortized cost the page exists
    for."""
    if "k_page" not in cache:
        return cache
    ppos, clen = cache["page_pos"], cache["k"].shape[1]
    t = torch.arange(clen, dtype=ppos.dtype, device=ppos.device)
    hit = (ppos[None, :] == t[:, None]) & (ppos >= 0)[None, :]  # (clen, page)
    src = hit.to(torch.int32).argmax(1)  # the page slot landing at each position
    hit = hit.any(1)
    for name, page_name in (("k", "k_page"), ("v", "v_page")):
        cache[name].copy_(torch.where(hit[None, :, None, None], cache[page_name][:, src], cache[name]))
    cache["pos"].copy_(torch.where(hit, ppos[src], cache["pos"]))
    cache["k_page"].zero_()
    cache["v_page"].zero_()
    cache["page_pos"].fill_(-1)
    return cache
