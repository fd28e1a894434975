"""Model presets of the training launcher: ``PRESETS`` and
``reduced_config``, as ``repro.launch.train`` defines them.

The training loop itself (``train``, the optimizer, checkpoints and the
LM data) waits for the training slice (ROADMAP item 9c).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, get_config

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
