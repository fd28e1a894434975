"""Training step: loss, grads, microbatch accumulation, optimizer update.
The port of ``repro.train.train_step``.

``make_train_step(cfg, tcfg)`` gives ``train_step(model, opt_state,
batch) -> (model, opt_state, metrics)``: a forward and backward of
:func:`loss_fn` (through the port's differentiable ``forward_train``),
then :func:`~repro_torch.train.optimizer.adamw_update` on the model's
float32 masters in place. Gradients are keyed by parameter name, as the
moments. The metrics stay on the device; only a caller that reads them
synchronizes.

Left out: the reference's ``hint`` on the logits is a sharding
constraint, an identity on one device. With ``compression="int8_ef"`` the
gradients take the int8 round trip with error feedback
(``distributed.compression.ef_int8_roundtrip``, IEEE division for the
scale, as the reference computes it outside ``jax.jit``) over the
reference's parameter tree, so the layers of a cycle leaf share one scale
as there; the error buffer ``opt_state["ef"]``, in that layout, carries
to the next step, which the reference's step drops (ROADMAP §3).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.compression import ef_int8_roundtrip
from repro_torch.models.transformer import Transformer, _tensor, forward_train, named_to_tree, tree_to_named
from repro_torch.train.optimizer import OptConfig, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    moe_aux_weight: float = 0.01
    z_loss_weight: float = 1e-4
    num_microbatches: int = 1
    remat: bool = True
    compression: str | None = None  # None | "int8_ef"


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, z_loss_weight: float = 0.0
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean token xent (+ z-loss), plus accuracy for metrics. The row max
    is detached (the reference's ``stop_gradient``), so the z-loss's
    gradient flows only through ``lse``."""
    logits_max = logits.amax(-1, keepdim=True).detach()
    shifted = logits - logits_max
    lse = torch.log(torch.exp(shifted).sum(-1))
    gold = torch.gather(shifted, -1, labels[..., None].long())[..., 0]
    xent = (lse - gold).mean()
    if z_loss_weight:
        xent = xent + z_loss_weight * torch.square(lse + logits_max[..., 0]).mean()
    acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
    return xent, acc


def loss_fn(model: Transformer, batch: dict[str, torch.Tensor], cfg: ModelConfig, tcfg: TrainConfig
            ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    logits, aux = forward_train(model, batch, remat=tcfg.remat)
    xent, acc = cross_entropy(logits, _tensor(batch["labels"], logits.device), tcfg.z_loss_weight)
    loss = xent + tcfg.moe_aux_weight * aux
    return loss, {"xent": xent, "accuracy": acc, "moe_aux": aux}


def _split_microbatches(batch: dict[str, torch.Tensor], m: int) -> dict[str, torch.Tensor]:
    def split(x):
        if x.ndim >= 2 and x.shape[0] % m == 0:
            return x.reshape(m, x.shape[0] // m, *x.shape[1:])
        return x[None].expand((m,) + tuple(x.shape))

    return {k: split(v) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig = TrainConfig()):
    """Build ``train_step(model, opt_state, batch)``; it makes the model's
    parameters require grad."""

    def grads_of(model, params, batch):
        loss, metrics = loss_fn(model, batch, cfg, tcfg)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(model: Transformer, opt_state: dict[str, Any], batch: dict[str, torch.Tensor]):
        params = dict(model.requires_grad_(True).named_parameters())
        if tcfg.num_microbatches > 1:
            m = tcfg.num_microbatches
            micro = _split_microbatches(batch, m)
            grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for k, p in params.items()}
            loss, seq = 0.0, []
            for i in range(m):
                mb_loss, metrics, g = grads_of(model, params, {k: v[i] for k, v in micro.items()})
                grads = {k: grads[k] + g[k].to(torch.float32) / m for k in grads}
                loss = loss + mb_loss / m
                seq.append(metrics)
            metrics = {k: torch.stack([s[k] for s in seq]).mean() for k in seq[0]}
        else:
            loss, metrics, grads = grads_of(model, params, batch)

        if tcfg.compression == "int8_ef":
            # One scale a leaf of the reference's tree: a cycle leaf's
            # layers share it, so the round trip runs on the stacked tree.
            tree, opt_state = ef_int8_roundtrip(named_to_tree(grads, cfg), opt_state)
            grads = tree_to_named(tree, cfg)

        model, opt_state, opt_metrics = adamw_update(grads, opt_state, model, tcfg.opt)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return model, opt_state, metrics

    return train_step
