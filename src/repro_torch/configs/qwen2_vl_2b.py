"""Qwen2-VL-2B backbone with M-RoPE (vision frontend stubbed).

[arXiv:2409.12191; hf] per assignment:
28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936; M-RoPE splits
the 128-dim rotary space into (t, h, w) = (16, 24, 24) half-dim
sections. Patch embeddings arrive pre-merged via input_specs().
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        arch_id="qwen2-vl-2b",
        family="vlm",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_ff=8960,
        vocab=151936,
        head_dim=128,
        pos_kind="mrope",
        mrope_sections=(16, 24, 24),
        rope_theta=1_000_000.0,
        frontend="vision",
        tie_embeddings=True,
    )
)
