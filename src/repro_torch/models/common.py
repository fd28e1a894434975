"""Shared building blocks: norms, rotary embeddings, FFNs, init helpers.

The port of ``repro.models.common``. Random init draws from an explicit
``torch.Generator`` (on the device the weights are made on), so a seed
gives the same weights on every run; it cannot give the JAX package's
weights, which cross over through ``transformer.params_from_jax``.
"""
from __future__ import annotations

import struct

import torch
import torch.nn.functional as F
from torch import nn


# A long Python loop whose iterations run the same operators on the same
# shapes (flash_attention's chunk pairs, the sLSTM's steps) iterates over
# ``trips(n)`` and passes its per-iteration outputs through ``all_trips``.
# With ``TRIPS`` unset both are the identity (``range(n)``; the list).
# ``launch.op_analysis.OpCounter(sampled_loops=True)`` sets it to run only
# the first iteration and count its operators n times.
TRIPS = None


def trips(n: int):
    """The iteration indices of a marked loop: ``range(n)``."""
    return range(n) if TRIPS is None else TRIPS(n)


def all_trips(outs: list, n: int) -> list:
    """A marked loop's ``n`` per-iteration outputs; where only the first
    iteration ran, its output ``n`` times (the same shapes)."""
    return outs if len(outs) == n else outs * n


def truncated_normal_init(generator: torch.Generator, shape, scale: float) -> torch.Tensor:
    """``scale`` times a standard normal truncated to [-2, 2] (not
    rescaled to unit variance, as ``jax.random.truncated_normal``), float32,
    on the generator's device."""
    out = torch.empty(shape, dtype=torch.float32, device=generator.device)
    nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return out.mul_(scale)


def dense_init(generator: torch.Generator, d_in: int, d_out: int) -> torch.Tensor:
    """A ``(d_in, d_out)`` weight: the reference's orientation, ``x @ w``."""
    return truncated_normal_init(generator, (d_in, d_out), d_in ** -0.5)


def dense_weight(generator: torch.Generator | None, d_in: int, d_out: int, *, device=None,
                 dtype=torch.float32) -> torch.Tensor:
    """A frozen ``(d_in, d_out)`` weight: drawn by :func:`dense_init` from
    ``generator``, or left uninitialised in ``dtype`` on ``device`` when
    there is none (weights that are copied in afterwards)."""
    w = (dense_init(generator, d_in, d_out) if generator is not None
         else torch.empty(d_in, d_out, dtype=dtype, device=device))
    return nn.Parameter(w, requires_grad=False)


def frozen_param(t: torch.Tensor | None, shape, device=None, dtype=torch.float32) -> nn.Parameter:
    """A frozen parameter holding ``t``, or uninitialised in ``dtype`` on
    ``device`` when there is none (weights that are copied in afterwards)."""
    return nn.Parameter(t if t is not None else torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32, cast back to ``x``'s dtype (``scale`` stays
    float32)."""
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale).to(dtype)


def causal_conv(p: nn.Module, u: torch.Tensor, state: torch.Tensor | None = None):
    """The RG-LRU and mLSTM blocks' short causal conv along time, in
    ``u``'s dtype, with ``p``'s ``conv_w`` (W, D) and ``conv_b`` (D). u: (B,
    S, D); state: (B, W-1, D), the last W-1 inputs before ``u`` (zeros
    without one). Returns the output and the new state, the last W-1
    inputs."""
    w, s = p.conv_w.shape[0], u.shape[1]
    pad = u.new_zeros((u.shape[0], w - 1, u.shape[2])) if state is None else state.to(u.dtype)
    full = torch.cat([pad, u], dim=1)  # (B, S+W-1, D)
    out = full[:, 0:s] * p.conv_w[0].to(u.dtype)
    for i in range(1, w):
        out = out + full[:, i:i + s] * p.conv_w[i].to(u.dtype)
    return out + p.conv_b.to(u.dtype), (full[:, -(w - 1):] if w > 1 else pad)


# ---------------------------------------------------------------------------
# Rotary position embeddings (standard + M-RoPE for Qwen2-VL).
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies, float32."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate the split halves (not interleaved pairs) of ``x`` (B, S, H, D)
    by ``ang`` (B, S, D/2), in float32, cast back to ``x``'s dtype."""
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotate (B, S, H, D) by per-token positions (B, S)."""
    inv = rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].float() * inv)


def apply_mrope(
    x: torch.Tensor,
    positions: torch.Tensor,
    sections: tuple[int, int, int],
    theta: float = 10000.0,
) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): the head dim is split into (t, h, w)
    frequency sections, each rotated by its own position stream.

    ``x``: (B, S, H, D); ``positions``: (3, B, S) integer (t/h/w indices).
    ``sections``: half-dim sizes per section, sum = D/2.
    """
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {sections} must sum to head_dim / 2 = {d // 2}")
    inv = rope_freqs(d, theta, x.device)
    sec_id = torch.cat([torch.full((s,), j, dtype=torch.long, device=x.device)
                        for j, s in enumerate(sections)])  # frequency i -> section
    pos = positions[sec_id].permute(1, 2, 0).float()  # (B, S, D/2)
    return _rotate(x, pos * inv)


def sinusoidal_positions(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """(B, S) -> (B, S, dim) sinusoidal embedding (MusicGen-style), float32."""
    half = dim // 2
    log_base = torch.log(torch.tensor(10000.0, device=positions.device))
    freq = torch.exp(-log_base * torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Gated FFN (SwiGLU / GeGLU).
# ---------------------------------------------------------------------------

def weak_scalar(value: float, dtype: torch.dtype) -> float:
    """A Python scalar as JAX's weak typing makes it against an array of
    ``dtype``: rounded to that dtype (as ``torch.tensor(value, dtype=dtype)``
    rounds it: to float32, then to nearest even). Computed on the host with
    no tensor, so it dispatches no operator."""
    if dtype == torch.float64:
        return float(value)
    f32 = struct.unpack("<I", struct.pack("<f", value))[0]
    if dtype == torch.bfloat16:
        f32 = (f32 + 0x7FFF + ((f32 >> 16) & 1)) & 0xFFFF0000
    elif dtype != torch.float32:
        raise ValueError(f"no weak scalar of {dtype}")
    return struct.unpack("<f", struct.pack("<I", f32))[0]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


_ACT = {"silu": F.silu, "gelu": gelu}


class FFN(nn.Module):
    """Gated FFN weights: ``wi_gate``, ``wi_up`` (d_model, d_ff) and ``wo``
    (d_ff, d_model)."""

    def __init__(self, d_model: int, d_ff: int, generator: torch.Generator | None = None, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.wi_gate = dense_weight(generator, d_model, d_ff, **kw)
        self.wi_up = dense_weight(generator, d_model, d_ff, **kw)
        self.wo = dense_weight(generator, d_ff, d_model, **kw)


def ffn_init(generator: torch.Generator, d_model: int, d_ff: int) -> FFN:
    return FFN(d_model, d_ff, generator)


def ffn_apply(p: FFN, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """SwiGLU / GeGLU in ``x``'s dtype (the weights cast to it)."""
    dtype = x.dtype
    gate = _ACT[act](x @ p.wi_gate.to(dtype))
    up = x @ p.wi_up.to(dtype)
    return (gate * up) @ p.wo.to(dtype)
