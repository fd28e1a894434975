"""StableLM-3B family dense transformer.

[hf:stabilityai/stablelm-2-1_6b; unverified] per assignment:
32L d_model=2560 32H (GQA kv=32) d_ff=6912 vocab=50304.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        arch_id="stablelm-3b",
        family="dense",
        n_layers=32,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=6912,
        vocab=50304,
        rope_theta=10_000.0,
    )
)
