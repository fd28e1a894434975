"""RecurrentGemma-9B (Griffin): RG-LRU + local attention, 2:1 pattern.

[arXiv:2402.19427; unverified] per assignment:
38L d_model=4096 16H (GQA kv=1, MQA) d_ff=12288 vocab=256000; block
pattern (rglru, rglru, local) with 2048-token attention window.
Sub-quadratic: bounded decode state => eligible for long_500k.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        arch_id="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        d_ff=12288,
        vocab=256000,
        head_dim=256,
        block_pattern=("rglru", "rglru", "local"),
        local_window=2048,
        lru_width=4096,
        act="gelu",
        subquadratic=True,
    )
)
