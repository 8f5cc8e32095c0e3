"""The LM stack: every architecture family behind one pure-function API."""

from .config import LMConfig, MoECfg, num_params
from .lm import (init_params, forward, loss_fn, init_cache, prefill,
                 decode_step, count_params, active_params, encode)
