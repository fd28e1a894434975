"""AdamW (+ cosine schedule, global-norm clipping) as plain functions on
tensors: the port of ``repro.train.optimizer``.

Parameters, gradients and moments are dicts of tensors keyed by the
model's parameter names (``Transformer.named_parameters``); a
``Transformer`` may stand for its parameters. The optimizer state is
``{"step": int32 scalar, "mu": {...}, "nu": {...}}`` with float32
moments, as the reference's, so ``models.transformer.opt_state_to_numpy``
/ ``opt_state_from_jax`` carry it across the packages and checkpoints
cross them. Not ``torch.optim.AdamW``: its bias correction and weight
decay take another order of operations.

Every elementwise step is the reference's, in its order, each rounded to
float32 (``schedule``, ``b1 ** step`` and ``b2 ** step`` included); the
updates run as multi-tensor (``torch._foreach_*``) ops over all
parameters at once and write the parameters and moments in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    clip_norm: float = 1.0


def named(params: Any) -> dict[str, torch.Tensor]:
    """``params`` as a dict of tensors: a module's ``named_parameters``, or
    the dict itself."""
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else params


def schedule(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio * lr, in float32."""
    step_f = step.to(torch.float32)
    warm = step_f / max(cfg.warmup_steps, 1)
    progress = torch.clamp(
        (step_f - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * progress))
    return cfg.lr * torch.where(step_f < cfg.warmup_steps, warm, cos)


def init_opt_state(params: Any) -> dict[str, Any]:
    p = named(params)
    dev = next(iter(p.values())).device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "mu": {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device) for k, v in p.items()},
        "nu": {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device) for k, v in p.items()},
    }


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    """The reference's sqrt of the sum of each leaf's sum of squares.
    Not ``torch.linalg.vector_norm`` or ``_foreach_norm``: on the CPU they
    accumulate a large leaf in float32 lanes (0.5% off on 64M normals),
    where ``sum`` sums in cascade."""
    return torch.sqrt(torch.stack([torch.square(x.to(torch.float32)).sum() for x in tree.values()]).sum())


def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float
                        ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return dict(zip(grads, torch._foreach_mul(list(grads.values()), scale))), norm


@torch.no_grad()
def adamw_update(grads: dict[str, torch.Tensor], opt_state: dict[str, Any], params: Any, cfg: OptConfig
                 ) -> tuple[Any, dict[str, Any], dict[str, torch.Tensor]]:
    """Returns (params, new_opt_state, metrics {"lr", "grad_norm"}). The
    parameters and the moments are updated in place; other entries of
    ``opt_state`` (the int8 error-feedback buffer ``"ef"``) are kept."""
    p = named(params)
    names = list(p)
    step = opt_state["step"] + 1
    lr = schedule(step, cfg)
    grads = {k: grads[k].to(torch.float32) for k in names}
    if cfg.clip_norm:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gnorm = global_norm(grads)
    g = [grads[k] for k in names]
    mu = [opt_state["mu"][k] for k in names]
    nu = [opt_state["nu"][k] for k in names]
    b1, b2 = cfg.b1, cfg.b2
    torch._foreach_mul_(mu, b1)  # mu = b1 * m + (1 - b1) * g
    torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
    gg = torch._foreach_mul(g, 1 - b2)  # nu = b2 * v + (1 - b2) * g * g
    torch._foreach_mul_(gg, g)
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, gg)
    del gg
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)
    den = torch._foreach_div(nu, bc2)  # sqrt(v / bc2) + eps
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, cfg.eps)
    u = torch._foreach_div(mu, bc1)  # (m / bc1) / den
    torch._foreach_div_(u, den)
    del den
    w = [p[k] for k in names]
    if cfg.weight_decay:
        torch._foreach_add_(u, torch._foreach_mul(w, cfg.weight_decay))
    torch._foreach_mul_(u, lr)
    torch._foreach_sub_(w, u)
    return params, dict(opt_state, step=step), {"lr": lr, "grad_norm": gnorm}
