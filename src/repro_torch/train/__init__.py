"""Training substrate: optimizers, step builder, checkpointing, compression."""

from .optim import (OPTIMIZERS, Optimizer, adafactor, adamw,
                    clip_by_global_norm, get_optimizer, global_norm, lion,
                    warmup_cosine)
from .step import TrainCfg, init_state, make_train_step
