"""The port's training substrate: AdamW, the cross-entropy train step and
msgpack checkpoints (ports of ``repro.training``)."""

from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            global_norm, init_opt_state,
                                            lr_schedule)
from repro_torch.training.train_step import (cross_entropy, init_state,
                                             loss_and_grads, loss_fn,
                                             make_train_step)

__all__ = ["AdamWConfig", "adamw_update", "global_norm", "init_opt_state",
           "lr_schedule", "cross_entropy", "init_state", "loss_and_grads",
           "loss_fn", "make_train_step"]
