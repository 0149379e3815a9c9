"""Training: optimizers, LR schedules and the step builders."""
from .optim import AdamW, FactoredAdam, cosine_schedule, global_norm
from .step import (default_optimizer, init_state, make_eval_step,
                   make_prefill_step, make_serve_step, make_train_step)

__all__ = ["AdamW", "FactoredAdam", "cosine_schedule", "default_optimizer",
           "global_norm", "init_state", "make_eval_step",
           "make_prefill_step", "make_serve_step", "make_train_step"]
