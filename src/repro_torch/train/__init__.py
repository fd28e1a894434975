"""LM training for the port: AdamW with its schedule and clipping
(:mod:`~repro_torch.train.optimizer`), the loss and train step
(:mod:`~repro_torch.train.train_step`) and checkpoints in the reference's
on-disk layout (:mod:`~repro_torch.train.checkpoint`)."""
from repro_torch.train.optimizer import OptConfig, adamw_update, init_opt_state  # noqa: F401
from repro_torch.train.train_step import TrainConfig, loss_fn, make_train_step  # noqa: F401
