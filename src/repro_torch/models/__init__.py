"""The LM model zoo of the port: decoder-only transformers in plain PyTorch.

Every registered architecture: dense GQA transformers, MLA, MoE, the
audio and VLM backbones with stubbed modality frontends, RG-LRU
(RecurrentGemma) and xLSTM.
"""
from repro_torch.models.transformer import (  # noqa: F401
    Transformer,
    cache_from_jax,
    cache_to_numpy,
    cast_weights,
    decode_step,
    forward_train,
    init_cache,
    init_params,
    opt_state_from_jax,
    opt_state_to_numpy,
    params_from_jax,
    params_to_numpy,
    prefill,
)
