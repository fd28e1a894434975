"""xLSTM-350M: mLSTM + sLSTM blocks at 7:1 (xLSTM[7:1]).

[arXiv:2405.04517; unverified] per assignment:
24L d_model=1024 4H d_ff=0 (blocks carry their own projections)
vocab=50304. Pure recurrent state => eligible for long_500k.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        arch_id="xlstm-350m",
        family="ssm",
        n_layers=24,
        d_model=1024,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab=50304,
        block_pattern=(
            "mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "slstm",
        ),
        pos_kind="none",
        subquadratic=True,
    )
)
