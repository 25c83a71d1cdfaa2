"""The train step of the port: set loss, optimizer, TrainState."""
from petr_tpu_torch.train.losses import petr_set_loss
from petr_tpu_torch.train.optim import build_optimizer, make_lr_schedule, param_labels
from petr_tpu_torch.train.train_step import (
    BATCH_KEYS,
    TrainState,
    accumulate_grads,
    batch_keys,
    create_train_state,
    make_eval_step,
    make_grad_fn,
    make_train_step,
    step_generator,
)
