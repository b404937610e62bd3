"""Training of the port (``repro/training``): the loss, AdamW on the
model's named parameters, the train step and loop, and checkpoints."""
from repro_torch.training.checkpoint import (  # noqa: F401
    load_checkpoint, save_checkpoint)
from repro_torch.training.loss import cross_entropy, total_loss  # noqa: F401
from repro_torch.training.optimizer import (  # noqa: F401
    OptState, adamw_update, init_opt_state, learning_rate)
from repro_torch.training.train_loop import (  # noqa: F401
    make_loss_fn, make_train_step, train)
