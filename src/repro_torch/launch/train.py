"""End-to-end training driver: the port of ``repro.launch.train``.

Usage (runs on the card; ``--device cpu`` for the CPU):

  python -m repro_torch.launch.train --arch llama3.2-1b --preset tiny \
      --steps 50 --batch 8 --seq 128
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.data import lm_data
from repro_torch.models.transformer import init_params, named_to_tree, opt_state_tree
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_step import TrainConfig, make_train_step

PRESETS = {
    # ~100M-param class config used by examples and the e2e test.
    "small100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
                      d_ff=3072, vocab=32000),
    "tiny": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                 d_ff=256, vocab=1024),
}


def reduced_config(arch: str, preset: str | None) -> ModelConfig:
    cfg = get_config(arch)
    if preset is None:
        return cfg
    over = dict(PRESETS[preset])
    if cfg.n_kv_heads == 1:
        over["n_kv_heads"] = 1
    if cfg.n_experts:
        over.update(n_experts=4, top_k=2, d_ff=over["d_ff"] // 4)
    if cfg.use_mla:
        over.update(q_lora_rank=256, kv_lora_rank=128, qk_nope_dim=32,
                    qk_rope_dim=16, v_head_dim=32, head_dim=48)
    if cfg.lru_width:
        over["lru_width"] = over["d_model"]
    if cfg.mrope_sections:
        hd = over["d_model"] // over["n_heads"]
        over["head_dim"] = hd
        over["mrope_sections"] = (hd // 8, hd // 4 - hd // 8 - hd // 16, hd // 16)
        # keep sections summing to hd//2
        s = over["mrope_sections"]
        over["mrope_sections"] = (s[0], s[1], hd // 2 - s[0] - s[1])
    return dataclasses.replace(cfg, dtype="float32", **over)


def train(
    arch: str = "llama3.2-1b",
    preset: str | None = "tiny",
    steps: int = 50,
    batch: int = 8,
    seq: int = 128,
    lr: float = 3e-3,
    ckpt_dir: str | None = None,
    log_every: int = 10,
    seed: int = 0,
    *,
    device="cuda",
    remat: bool = False,
):
    """Train ``arch`` (cut to ``preset``; ``None`` is the full config, float32
    masters and the config's compute dtype) on the Markov token stream.
    Returns (model, log): one dict of metrics a logged step, read back from
    the device only at those steps. With ``ckpt_dir``, every 20th step is
    saved in the reference's layout (``{"params", "opt"}``)."""
    dev = resolve_device(device)
    cfg = reduced_config(arch, preset)
    tcfg = TrainConfig(
        opt=OptConfig(lr=lr, warmup_steps=max(steps // 10, 1), total_steps=steps),
        remat=remat,
    )
    model = init_params(seed, cfg, device=dev)
    opt_state = init_opt_state(model)
    step_fn = make_train_step(cfg, tcfg)
    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    log: list[dict] = []
    t0 = time.time()
    for i, b in enumerate(lm_data.batches(cfg.vocab, batch, seq, steps, seed, device=dev)):
        model, opt_state, metrics = step_fn(model, opt_state, b)
        if i % log_every == 0 or i == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m.update(step=i, wall_s=round(time.time() - t0, 1))
            log.append(m)
            print(
                f"step {i:5d} loss {m['loss']:.4f} acc {m['accuracy']:.3f} "
                f"lr {m['lr']:.2e} gnorm {m['grad_norm']:.2f} ({m['wall_s']}s)"
            )
        if ckpt is not None and (i + 1) % 20 == 0:
            # The reference's layout, left on the device: save_async makes
            # the one host copy.
            ckpt.save_async(i, {"params": named_to_tree(dict(model.named_parameters()), cfg),
                                "opt": opt_state_tree(opt_state, cfg)})
    if ckpt is not None:
        ckpt.wait()
    return model, log


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--preset", default="tiny", choices=[*PRESETS, "full"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--remat", action="store_true")
    args = ap.parse_args()
    preset = None if args.preset == "full" else args.preset
    train(args.arch, preset, args.steps, args.batch, args.seq, args.lr, args.ckpt_dir,
          device=args.device, remat=args.remat)


if __name__ == "__main__":
    main()
