"""Training substrate: optimizer, data pipeline, train loop, checkpointing."""
from repro_torch.training.optimizer import AdamWState, adamw_init, adamw_update, lr_schedule  # noqa: F401
from repro_torch.training.train_loop import Trainer, make_train_step, loss_fn  # noqa: F401
