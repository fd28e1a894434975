"""MusicGen-large decoder over EnCodec tokens (backbone only).

[arXiv:2306.05284; hf] per assignment:
48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048. The EnCodec
modality frontend is a STUB per instructions: input_specs() provides
precomputed frame embeddings (B, S, d_model).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        arch_id="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab=2048,
        pos_kind="sinusoidal",
        frontend="audio",
        act="gelu",
    )
)
