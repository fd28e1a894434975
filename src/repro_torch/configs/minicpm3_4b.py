"""MiniCPM3-4B: dense transformer with Multi-head Latent Attention.

[hf:openbmb/MiniCPM3-4B; hf] per assignment:
62L d_model=2560 40H d_ff=6400 vocab=73448; MLA with q_lora=768,
kv_lora=256, qk_nope=64, qk_rope=32, v_head=64 (HF config values).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        arch_id="minicpm3-4b",
        family="dense",
        n_layers=62,
        d_model=2560,
        n_heads=40,
        n_kv_heads=40,
        d_ff=6400,
        vocab=73448,
        use_mla=True,
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_dim=64,
        qk_rope_dim=32,
        v_head_dim=64,
        head_dim=96,  # qk_nope + qk_rope
        rope_theta=10_000.0,
    )
)
