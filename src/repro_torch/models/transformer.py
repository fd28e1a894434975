"""Decoder-only model assembly: the port of ``repro.models.transformer``
for every registered architecture.

Block types: ``"attn"`` and ``"local"`` (GQA attention, or MLA where the
config says ``use_mla``), ``"rglru"`` (the Griffin recurrent block),
``"mlstm"`` and ``"slstm"`` (xLSTM); attention and RG-LRU blocks carry a
gated FFN, or a top-k MoE where the config has experts. That covers the
dense families (``llama3.2-1b``, ``stablelm-3b``, ``deepseek-67b``,
``minicpm3-4b`` with MLA), the MoE ones (``moonshot-v1-16b-a3b``,
``phi3.5-moe-42b-a6.6b``), ``musicgen-large`` (audio: embeddings in,
sinusoidal positions), ``qwen2-vl-2b`` (vlm: embeddings in, M-RoPE),
``recurrentgemma-9b`` and ``xlstm-350m``.

The reference scans stacked cycle parameters; the port runs an
``nn.ModuleList`` of layers in order, which is the same arithmetic, and
keeps one decode-cache layout, a list of per-layer caches. Weights keep
the reference's ``(d_in, d_out)`` orientation (``x @ w``) and are float32
masters cast to the config's dtype at each use, as there;
:func:`cast_weights` makes a copy cast once (the serving engine's), which
gives the same bits: every parameter the reference reads in float32 (the
norm scales, the MoE router, the RG-LRU ``log_lambda``, the mLSTM gate
biases) stays float32 in the copy. ``params_from_jax`` / ``params_to_numpy``,
``opt_state_from_jax`` / ``opt_state_to_numpy`` and ``cache_from_jax`` /
``cache_to_numpy`` carry weights, optimizer moments and decode caches
across the two packages.

``forward_train`` is differentiable: the trainer
(:mod:`repro_torch.train.train_step`) sets ``requires_grad`` on the float32
masters, which are built frozen for serving; ``prefill`` and
``decode_step`` run without autograd.

Three entry points, matching the shape kinds:
  forward_train  — full causal forward, logits + MoE aux loss
  prefill        — forward + decode-cache construction
  decode_step    — one token against the cache/recurrent state

Inputs are a dict: {"tokens": (B, S) integer} or, for stubbed-frontend
archs (audio/vlm), {"embeds": (B, S, d)}; VLM adds "mrope_positions"
(3, B, S). Decode takes (inputs, cache, position).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import xlstm as XL
from repro_torch.models.common import (
    FFN,
    dense_weight,
    ffn_apply,
    rmsnorm,
    sinusoidal_positions,
    truncated_normal_init,
)

# One dict a layer: {"k", "v", "pos"} (attention; a full-attention layer
# adds {"k_page", "v_page", "page_pos"} when PAGED_DECODE > 0),
# {"c_kv", "k_rope", "pos"} (MLA), {"h", "conv"} (RG-LRU),
# {"c", "n", "m", "conv"} (mLSTM) or {"h", "c", "n", "m"} (sLSTM).
Cache = list

# When > 0, full-attention layer caches from init_cache get a hot ring page
# of this many slots, and decode_step takes the paged path
# (attention.attention_decode_paged); the caller flushes each such layer
# (attention.flush_page) once the page is full.
PAGED_DECODE = 0


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _split_layers(cfg: ModelConfig) -> tuple[int, tuple[str, ...]]:
    """(n_cycles, remainder_types), as the reference groups its layers."""
    plen = len(cfg.block_pattern)
    return cfg.n_layers // plen, cfg.layer_types[(cfg.n_layers // plen) * plen:]


# ---------------------------------------------------------------------------
# Layers.
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One layer: ``norm1``, the mixer ``inner`` (attention, MLA, RG-LRU,
    mLSTM or sLSTM) and, for attention and RG-LRU blocks where ``d_ff >
    0``, ``norm2`` and the gated FFN ``ffn`` or the experts ``moe``."""

    def __init__(self, cfg: ModelConfig, bt: str, generator: torch.Generator | None = None, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.bt = bt
        self.window = cfg.local_window if bt == "local" else None
        d = cfg.d_model
        kw = dict(device=device, dtype=dtype)
        self.norm1 = nn.Parameter(torch.ones(d, device=device), requires_grad=False)
        if bt in ("attn", "local") and cfg.use_mla:
            self.inner = MLA.MLA(d, cfg.n_heads, cfg.q_lora_rank, cfg.kv_lora_rank, cfg.qk_nope_dim,
                                 cfg.qk_rope_dim, cfg.v_head_dim, generator, **kw)
        elif bt in ("attn", "local"):
            self.inner = A.Attention(d, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, generator, **kw)
        elif bt == "rglru":
            self.inner = RG.RGLRU(d, cfg.lru_width or d, cfg.conv_width, generator, **kw)
        elif bt == "mlstm":
            self.inner = XL.MLSTM(d, cfg.n_heads, generator, **kw)
        elif bt == "slstm":
            self.inner = XL.SLSTM(d, cfg.n_heads, generator, **kw)
        else:
            raise ValueError(bt)
        if bt in ("attn", "local", "rglru") and cfg.d_ff:
            self.norm2 = nn.Parameter(torch.ones(d, device=device), requires_grad=False)
            if cfg.n_experts:
                self.moe = MOE.MoE(d, cfg.d_ff, cfg.n_experts, generator, **kw)
            else:
                self.ffn = FFN(d, cfg.d_ff, generator, **kw)


def init_layer(generator: torch.Generator, cfg: ModelConfig, bt: str) -> Block:
    return Block(cfg, bt, generator, device=generator.device)


def _pos_cfg(cfg: ModelConfig, mrope_positions=None) -> dict[str, Any]:
    if cfg.pos_kind == "mrope":
        return {"kind": "mrope", "theta": cfg.rope_theta, "sections": cfg.mrope_sections,
                "mrope_positions": mrope_positions}
    if cfg.pos_kind == "rope":
        return {"kind": "rope", "theta": cfg.rope_theta}
    return {"kind": "none"}


def _attn_dims(cfg: ModelConfig) -> dict[str, int]:
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim)


def _mla_dims(cfg: ModelConfig) -> dict[str, int]:
    return dict(n_heads=cfg.n_heads, qk_nope_dim=cfg.qk_nope_dim, qk_rope_dim=cfg.qk_rope_dim,
                v_head_dim=cfg.v_head_dim, kv_lora_rank=cfg.kv_lora_rank)


def _ffn_part(lp: Block, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The FFN or MoE half of a layer: (x, the MoE aux loss or None)."""
    if hasattr(lp, "moe"):
        out = MOE.moe_apply(lp.moe, rmsnorm(x, lp.norm2, cfg.norm_eps), n_experts=cfg.n_experts,
                            top_k=cfg.top_k, capacity_factor=cfg.capacity_factor, act=cfg.act)
        return x + out.y, out.aux_loss
    if hasattr(lp, "ffn"):
        x = x + ffn_apply(lp.ffn, rmsnorm(x, lp.norm2, cfg.norm_eps), cfg.act)
    return x, None


def apply_layer_train(lp: Block, x, *, cfg: ModelConfig, positions, pos_cfg):
    """(x, MoE aux loss or None) after one layer of the causal forward."""
    h = rmsnorm(x, lp.norm1, cfg.norm_eps)
    if lp.bt in ("attn", "local") and cfg.use_mla:
        y = MLA.mla_apply(lp.inner, h, dims=_mla_dims(cfg), positions=positions, theta=cfg.rope_theta)
    elif lp.bt in ("attn", "local"):
        y = A.attention_apply(lp.inner, h, **_attn_dims(cfg), positions=positions, pos_cfg=pos_cfg,
                              window=lp.window)
    elif lp.bt == "rglru":
        y = RG.rglru_apply(lp.inner, h)
    elif lp.bt == "mlstm":
        y = XL.mlstm_apply(lp.inner, h, n_heads=cfg.n_heads)
    else:
        y = XL.slstm_apply(lp.inner, h, n_heads=cfg.n_heads)
    return _ffn_part(lp, x + y, cfg)


def apply_layer_prefill(lp: Block, x, *, cfg: ModelConfig, positions, pos_cfg, cache_len: int):
    h = rmsnorm(x, lp.norm1, cfg.norm_eps)
    if lp.bt in ("attn", "local") and cfg.use_mla:
        y, cache = MLA.mla_prefill(lp.inner, h, dims=_mla_dims(cfg), positions=positions,
                                   theta=cfg.rope_theta, cache_len=cache_len)
    elif lp.bt in ("attn", "local"):
        y, cache = A.attention_prefill(lp.inner, h, **_attn_dims(cfg), positions=positions,
                                       pos_cfg=pos_cfg, window=lp.window, cache_len=cache_len)
    elif lp.bt == "rglru":
        y, cache = RG.rglru_apply(lp.inner, h, return_state=True)
    elif lp.bt == "mlstm":
        y, cache = XL.mlstm_apply(lp.inner, h, n_heads=cfg.n_heads, return_state=True)
    else:
        y, cache = XL.slstm_apply(lp.inner, h, n_heads=cfg.n_heads, return_state=True)
    return _ffn_part(lp, x + y, cfg)[0], cache


def apply_layer_decode(lp: Block, x, cache, position: int, *, cfg: ModelConfig, pos_cfg):
    h = rmsnorm(x, lp.norm1, cfg.norm_eps)
    if lp.bt in ("attn", "local") and cfg.use_mla:
        y, cache = MLA.mla_decode(lp.inner, h, cache, position, dims=_mla_dims(cfg),
                                  theta=cfg.rope_theta)
    elif lp.bt in ("attn", "local") and "k_page" in cache:
        y, cache = A.attention_decode_paged(lp.inner, h, cache, position, **_attn_dims(cfg),
                                            pos_cfg=pos_cfg, window=lp.window)
    elif lp.bt in ("attn", "local"):
        y, cache = A.attention_decode(lp.inner, h, cache, position, **_attn_dims(cfg),
                                      pos_cfg=pos_cfg, window=lp.window)
    elif lp.bt == "rglru":
        y, cache = RG.rglru_decode(lp.inner, h, cache)
    elif lp.bt == "mlstm":
        y, cache = XL.mlstm_decode(lp.inner, h, cache, n_heads=cfg.n_heads)
    else:
        y, cache = XL.slstm_decode(lp.inner, h, cache, n_heads=cfg.n_heads)
    return _ffn_part(lp, x + y, cfg)[0], cache


# ---------------------------------------------------------------------------
# Model.
# ---------------------------------------------------------------------------

class Transformer(nn.Module):
    """``embed`` (vocab, d), ``final_norm``, ``lm_head`` (d, vocab; absent
    with tied embeddings) and ``layers``, one :class:`Block` a layer.

    ``seed`` draws every weight from one ``torch.Generator`` on the device;
    ``seed=None`` leaves them uninitialised (for :func:`params_from_jax`
    and :func:`cast_weights`), as does the meta device, which holds shapes
    and dtypes only (the dry run's, :mod:`repro_torch.launch.dryrun`).
    ``weight_dtype`` is the dtype of the
    weights; those the reference reads in float32 (the norm scales, the MoE
    router, ``log_lambda``, the mLSTM gate biases) are float32 always. Runs
    on the card unless ``device="cpu"``.
    """

    def __init__(self, cfg: ModelConfig, seed: int | None = 0, *, device="cuda",
                 weight_dtype: torch.dtype = torch.float32):
        super().__init__()
        dev = resolve_device(device)
        gen = None if seed is None or dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
        self.cfg = cfg
        d, v = cfg.d_model, cfg.vocab
        # d^-0.5 keeps tied-embedding logits O(1) at init.
        embed = (truncated_normal_init(gen, (v, d), d ** -0.5) if gen is not None
                 else torch.empty(v, d, dtype=weight_dtype, device=dev))
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.final_norm = nn.Parameter(torch.ones(d, device=dev), requires_grad=False)
        if not cfg.tie_embeddings:
            self.lm_head = dense_weight(gen, d, v, device=dev, dtype=weight_dtype)
        self.layers = nn.ModuleList(
            Block(cfg, bt, gen, device=dev, dtype=weight_dtype) for bt in cfg.layer_types)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_params(seed: int, cfg: ModelConfig, *, device="cuda") -> Transformer:
    """Random weights from ``seed`` (the reference's ``init_params(key, cfg)``);
    on the meta device, shapes and dtypes only."""
    return Transformer(cfg, seed, device=device)


def cast_weights(model: Transformer, dtype: torch.dtype | None = None, device=None) -> Transformer:
    """A copy of ``model`` with every weight cast once to ``dtype`` (the
    config's by default) on ``device`` (the model's by default), except
    those the reference reads in float32, which stay float32 (see
    :class:`Transformer`). The forward casts every other weight to the
    activation dtype at use, so the copy computes the same bits as the
    float32 masters."""
    dtype = _dtype(model.cfg) if dtype is None else dtype
    out = Transformer(model.cfg, None, device=device or model.device, weight_dtype=dtype)
    with torch.no_grad():
        for dst, src in zip(out.parameters(), model.parameters()):
            dst.copy_(src)
    return out


# ---------------------------------------------------------------------------
# Forward passes.
# ---------------------------------------------------------------------------

def _tensor(a, dev) -> torch.Tensor:
    """An input as a tensor on ``dev`` (numpy arrays are copied)."""
    return a.to(dev) if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a)).to(dev)


def _embed(model: Transformer, inputs: dict, cfg: ModelConfig) -> torch.Tensor:
    """Token embeddings (gathered, then cast: the same bits as casting the
    table first) or the frontend's embeddings, in the config's dtype."""
    dt, dev = _dtype(cfg), model.device
    if cfg.frontend is not None and "embeds" in inputs:
        return _tensor(inputs["embeds"], dev).to(dt)
    return F.embedding(_tensor(inputs["tokens"], dev).long(), model.embed).to(dt)


def _embed_inputs(model: Transformer, inputs: dict, cfg: ModelConfig):
    dt, dev = _dtype(cfg), model.device
    x = _embed(model, inputs, cfg)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
    if cfg.pos_kind == "sinusoidal":
        x = x + sinusoidal_positions(positions, cfg.d_model).to(dt)
    return x, positions


def _mrope(inputs: dict, positions: torch.Tensor):
    """The inputs' (3, B, S) M-RoPE positions; without them (a text prompt,
    as the serving engine sends) t = h = w = position, as ``decode_step``
    continues text. The reference's engine cannot serve ``qwen2-vl-2b``
    from tokens (its ``_embed_inputs`` asks for ``"embeds"``)."""
    m = inputs.get("mrope_positions")
    return positions[None].expand(3, *positions.shape) if m is None else _tensor(m, positions.device)


def _logits(model: Transformer, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ model.embed.to(x.dtype).T
    else:
        logits = x @ model.lm_head.to(x.dtype)
    return logits.float()


def _train_layers(layers, x, aux, cfg: ModelConfig, positions, pos_cfg):
    for lp in layers:
        x, a = apply_layer_train(lp, x, cfg=cfg, positions=positions, pos_cfg=pos_cfg)
        if a is not None:
            aux = aux + a
    return x, aux


def forward_train(model: Transformer, inputs: dict, *, remat: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Full causal forward. Returns (logits float32 (B, S, V), moe_aux
    float32 scalar: the MoE layers' aux losses summed in layer order, 0
    without experts). Differentiable with respect to the parameters that
    require grad. ``remat`` recomputes each block-pattern cycle in the
    backward (``torch.utils.checkpoint``, non-reentrant), as the
    reference's ``jax.checkpoint`` over its scanned cycle; the remainder
    layers are not wrapped, as there. Where autograd records nothing
    (grad disabled, or no parameter requires grad) ``remat`` is moot and
    nothing is wrapped."""
    cfg = model.cfg
    x, positions = _embed_inputs(model, inputs, cfg)
    pos_cfg = _pos_cfg(cfg, _mrope(inputs, positions))
    aux = torch.zeros((), device=model.device)
    n_cycles, _ = _split_layers(cfg)
    plen = len(cfg.block_pattern)
    remat = remat and torch.is_grad_enabled() and any(p.requires_grad for p in model.parameters())
    for c in range(n_cycles):
        cycle = model.layers[c * plen:(c + 1) * plen]
        if remat:
            x, aux = checkpoint(_train_layers, cycle, x, aux, cfg, positions, pos_cfg, use_reentrant=False)
        else:
            x, aux = _train_layers(cycle, x, aux, cfg, positions, pos_cfg)
    x, aux = _train_layers(model.layers[n_cycles * plen:], x, aux, cfg, positions, pos_cfg)
    return _logits(model, x, cfg), aux


@torch.no_grad()
def prefill(model: Transformer, inputs: dict, *, cache_len: int | None = None) -> tuple[torch.Tensor, Cache]:
    """Forward + cache. Returns (last-position logits (B, V), cache)."""
    cfg = model.cfg
    x, positions = _embed_inputs(model, inputs, cfg)
    pos_cfg = _pos_cfg(cfg, _mrope(inputs, positions))
    clen = cache_len if cache_len is not None else x.shape[1]
    cache = []
    for lp in model.layers:
        x, c = apply_layer_prefill(lp, x, cfg=cfg, positions=positions, pos_cfg=pos_cfg,
                                   cache_len=clen)
        cache.append(c)
    return _logits(model, x[:, -1:], cfg)[:, 0], cache


@torch.no_grad()
def decode_step(model: Transformer, inputs: dict, cache: Cache, position) -> tuple[torch.Tensor, Cache]:
    """One decode step at absolute ``position`` (an int; a 0-d tensor is
    read once on the host). Returns (logits (B, V), cache): the new token
    is written into ``cache`` in place. A position past the cache writes
    its last slot, as the reference's clamped dynamic update does."""
    cfg = model.cfg
    position = int(position)
    dt, dev = _dtype(cfg), model.device
    x = _embed(model, inputs, cfg)
    b = x.shape[0]
    if cfg.pos_kind == "sinusoidal":
        pos_b = torch.full((b, 1), position, dtype=torch.int32, device=dev)
        x = x + sinusoidal_positions(pos_b, cfg.d_model).to(dt)
    mrope = None
    if cfg.pos_kind == "mrope":
        # Text continuation: t = h = w = position.
        mrope = torch.full((3, b, 1), position, dtype=torch.int32, device=dev)
    pos_cfg = _pos_cfg(cfg, mrope)
    for i, lp in enumerate(model.layers):
        x, cache[i] = apply_layer_decode(lp, x, cache[i], position, cfg=cfg, pos_cfg=pos_cfg)
    return _logits(model, x, cfg)[:, 0], cache


# ---------------------------------------------------------------------------
# Cache init.
# ---------------------------------------------------------------------------

def _layer_cache(cfg: ModelConfig, bt: str, b: int, cache_len: int, dt, device) -> dict:
    if bt in ("attn", "local") and cfg.use_mla:
        return MLA.init_mla_cache(b, cache_len, cfg.kv_lora_rank, cfg.qk_rope_dim, dt, device=device)
    if bt in ("attn", "local"):
        window = cfg.local_window if bt == "local" else None
        page = PAGED_DECODE if (bt == "attn" and PAGED_DECODE) else 0
        return A.init_attn_cache(b, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim, dt,
                                 window=window, page=page, device=device)
    if bt == "rglru":
        return RG.init_rglru_state(b, cfg.lru_width or cfg.d_model, cfg.conv_width, device=device)
    if bt == "mlstm":
        return XL.init_mlstm_state(b, cfg.d_model, cfg.n_heads, device=device)
    if bt == "slstm":
        return XL.init_slstm_state(b, cfg.d_model, device=device)
    raise ValueError(bt)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *, device="cuda") -> Cache:
    """An empty decode cache: one buffer set a layer (the reference's
    ``stacked=False`` layout); full-attention layers get a hot page of
    ``PAGED_DECODE`` slots when it is set."""
    dev = resolve_device(device)
    return [_layer_cache(cfg, bt, batch, cache_len, _dtype(cfg), dev) for bt in cfg.layer_types]


# ---------------------------------------------------------------------------
# Weights and caches across the two packages (numpy in between).
# ---------------------------------------------------------------------------

def _layer_source(cfg: ModelConfig, li: int) -> tuple[str, int | None]:
    """Where layer ``li`` sits in the reference's tree: (``"cycles/blk{j}"``,
    cycle index) or (``"rem{i}"``, None)."""
    n_cycles, _ = _split_layers(cfg)
    plen = len(cfg.block_pattern)
    if li < n_cycles * plen:
        return f"blk{li % plen}", li // plen
    return f"rem{li - n_cycles * plen}", None


def _flatten(tree: dict, prefix: str = "") -> dict[str, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _nest(flat: dict[str, Any]) -> dict:
    out: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _layer_tree(tree: dict, cfg: ModelConfig, li: int) -> dict:
    name, cycle = _layer_source(cfg, li)
    if cycle is None:
        return tree[name]
    return {k: v[cycle] for k, v in _flatten(tree["cycles"][name]).items()}


def tree_to_named(tree: dict, cfg: ModelConfig) -> dict[str, Any]:
    """A tree in the reference's parameter layout (numpy arrays or tensors)
    as a dict keyed by the port's parameter names (``named_parameters``);
    a cycle layer's entry is its row of the stacked leaf (a view)."""
    state = {"embed": tree["embed"], "final_norm": tree["final_norm"]}
    if not cfg.tie_embeddings:
        state["lm_head"] = tree["lm_head"]
    for li in range(cfg.n_layers):
        for k, v in _flatten(_layer_tree(tree, cfg, li)).items():
            state[f"layers.{li}.{k}"] = v
    return state


def load_named_(dst: dict[str, torch.Tensor], src: dict[str, Any]) -> None:
    """Copy ``src`` (numpy arrays or tensors, keyed by the port's parameter
    names) into the tensors of ``dst`` in place, names and shapes checked;
    a tensor that is already ``dst``'s own is left alone."""
    if set(dst) != set(src):
        raise ValueError(f"parameter trees differ: {sorted(set(dst) ^ set(src))[:5]}")
    with torch.no_grad():
        for k, v in src.items():
            if v is dst[k]:
                continue
            if tuple(dst[k].shape) != tuple(np.shape(v)):
                raise ValueError(f"{k}: shape {tuple(np.shape(v))} where {tuple(dst[k].shape)} is expected")
            dst[k].copy_(v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v)))


def params_from_jax(np_params: dict, cfg: ModelConfig, *, device="cuda") -> Transformer:
    """The reference's parameter tree (numpy arrays: ``embed``,
    ``final_norm``, optional ``lm_head``, ``cycles`` stacked along the
    leading dim, ``rem{i}``) as a port :class:`Transformer` on ``device``.
    The orientation is the reference's; nothing is transposed."""
    model = Transformer(cfg, None, device=device)
    load_named_(dict(model.named_parameters()), tree_to_named(np_params, cfg))
    return model


def _stack(xs: list):
    return torch.stack(xs) if isinstance(xs[0], torch.Tensor) else np.stack(xs)


def _to_reference_tree(per_layer: list[dict], cfg: ModelConfig) -> dict:
    """Per-layer trees (numpy arrays or tensors) in the reference's layout:
    cycles stacked."""
    n_cycles, rem = _split_layers(cfg)
    plen = len(cfg.block_pattern)
    out: dict = {}
    if n_cycles:
        out["cycles"] = {
            f"blk{j}": _nest({k: _stack([_flatten(per_layer[i * plen + j])[k] for i in range(n_cycles)])
                              for k in _flatten(per_layer[j])})
            for j in range(plen)
        }
    for i in range(len(rem)):
        out[f"rem{i}"] = per_layer[n_cycles * plen + i]
    return out


def named_to_tree(named: dict[str, Any], cfg: ModelConfig) -> dict:
    """Values keyed by the port's parameter names (weights, gradients or
    moments; numpy arrays or tensors) in the reference's parameter layout,
    each cycle leaf stacked over the cycles."""
    layers = [_nest({k.split(".", 2)[2]: v for k, v in named.items() if k.startswith(f"layers.{li}.")})
              for li in range(cfg.n_layers)]
    out = {"embed": named["embed"], "final_norm": named["final_norm"], **_to_reference_tree(layers, cfg)}
    if not cfg.tie_embeddings:
        out["lm_head"] = named["lm_head"]
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", copy=True).numpy()


def named_to_numpy(named: dict[str, torch.Tensor], cfg: ModelConfig) -> dict:
    """Tensors keyed by the port's parameter names as the reference's
    parameter tree of numpy arrays (host copies)."""
    return _tree_apply(_host, named_to_tree(named, cfg))


def params_to_numpy(model: Transformer) -> dict:
    """The model's weights as the reference's parameter tree of numpy arrays."""
    return named_to_numpy(dict(model.named_parameters()), model.cfg)


def opt_state_tree(opt_state: dict, cfg: ModelConfig) -> dict:
    """A port optimizer state (``step``; ``mu`` and ``nu`` keyed by
    parameter name; with int8 error feedback ``ef``, already in the
    reference's layout) in the reference's optimizer state layout, the
    tensors where they are."""
    out = {"step": opt_state["step"], "mu": named_to_tree(opt_state["mu"], cfg),
           "nu": named_to_tree(opt_state["nu"], cfg)}
    if "ef" in opt_state:
        out["ef"] = opt_state["ef"]
    return out


def opt_state_to_numpy(opt_state: dict, cfg: ModelConfig) -> dict:
    """:func:`opt_state_tree` as numpy arrays (host copies)."""
    return _tree_apply(_host, opt_state_tree(opt_state, cfg))


def opt_state_from_jax(np_opt: dict, cfg: ModelConfig, *, device="cuda") -> dict:
    """The reference's optimizer state tree (numpy arrays) as a port
    optimizer state on ``device``: ``step`` an int32 scalar, the moments
    float32 tensors keyed by parameter name, ``ef`` in the reference's
    layout."""
    dev = resolve_device(device)
    out = {"step": torch.as_tensor(np.asarray(np_opt["step"]), dtype=torch.int32).to(dev)}
    for k in ("mu", "nu"):
        out[k] = {n: _tensor(v, dev) for n, v in tree_to_named(np_opt[k], cfg).items()}
    if "ef" in np_opt:
        out["ef"] = _tree_apply(lambda a: _tensor(a, dev), np_opt["ef"])
    return out


def _tree_apply(fn, tree):
    return {k: _tree_apply(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def cache_to_numpy(cache: Cache, cfg: ModelConfig) -> dict:
    """A port decode cache as the reference's (stacked) cache tree of numpy
    arrays."""
    return _to_reference_tree([{k: v.cpu().numpy() for k, v in c.items()} for c in cache], cfg)


def cache_from_jax(np_cache: dict, cfg: ModelConfig, *, device="cuda") -> Cache:
    """The reference's stacked decode cache (numpy arrays, as ``prefill``
    or ``init_cache`` returns it) as a port cache on ``device``."""
    dev = resolve_device(device)
    return [{k: _tensor(v, dev) for k, v in _layer_tree(np_cache, cfg, li).items()}
            for li in range(cfg.n_layers)]
