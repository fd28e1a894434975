"""Moonlight-16B-A3B (Kimi/Moonshot) MoE transformer.

[hf:moonshotai/Moonlight-16B-A3B; hf] per assignment:
48L d_model=2048 16H (GQA kv=16) expert d_ff=1408 vocab=163840,
MoE 64 experts top-6.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        arch_id="moonshot-v1-16b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab=163840,
        n_experts=64,
        top_k=6,
        rope_theta=50_000.0,
    )
)
