"""Per-arch launch specs: the model and training configs a driver runs,
and the batch a train step takes.

``ARCH_TRAIN`` holds the reference's (``repro.launch.specs``) per-arch
training knobs, memory-driven: the optimizer, the microbatch count, and
arctic's bfloat16 params outside the smoke configs.  ``build_cell`` (the
dry-run lowering of a cell) waits for the cost-tooling slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs import canonical, get_config
from ..models.config import LMConfig
from ..models.layers import dtype_of
from ..train import TrainCfg

ARCH_TRAIN = {
    "arctic_480b": dict(optimizer="adafactor", microbatches=8,
                        param_dtype="bfloat16"),
    "gemma2_27b": dict(optimizer="adamw", microbatches=4),
    "mixtral_8x7b": dict(optimizer="adamw", microbatches=2),
}


def train_cfg_for(arch: str) -> TrainCfg:
    kw = ARCH_TRAIN.get(canonical(arch), {})
    kw = {k: v for k, v in kw.items() if k in ("optimizer", "microbatches")}
    return TrainCfg(total_steps=10_000, warmup_steps=200, **kw)


def model_cfg_for(arch: str, *, smoke: bool = False) -> LMConfig:
    """The arch's config, with its ``param_dtype`` override outside the
    smoke configs (as the reference's)."""
    cfg = get_config(arch, smoke=smoke)
    extra = ARCH_TRAIN.get(canonical(arch), {})
    if "param_dtype" in extra and not smoke:
        cfg = cfg.with_overrides(param_dtype=extra["param_dtype"])
    return cfg


def batch_struct(cfg: LMConfig, shape_kind: str, seq: int, batch: int
                 ) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """The (shape, dtype) of each batch entry of a ``shape_kind`` cell
    (the reference's ``_batch_struct``): "tokens" [B, S+1] for train,
    [B, S] otherwise, int32; encdec "frames" [B, enc_seq, d] and vlm
    "patches" [B, num_patches, d] in the activation dtype."""
    act = dtype_of(cfg.dtype)
    toks = seq + 1 if shape_kind == "train" else seq
    b = {"tokens": ((batch, toks), torch.int32)}
    if cfg.family == "encdec":
        b["frames"] = ((batch, cfg.enc_seq, cfg.d_model), act)
    if cfg.family == "vlm":
        b["patches"] = ((batch, cfg.num_patches, cfg.d_model), act)
    return b


def train_batch(cfg: LMConfig, tokens, device,
                gen: Optional[torch.Generator] = None) -> dict:
    """A train batch from ``tokens`` [B, S+1] (numpy or tensor): the
    stub frontend inputs of ``batch_struct`` are zeros, or standard
    normal draws of ``gen`` (a generator on ``device``) when given."""
    tokens = torch.as_tensor(tokens).to(device=device, dtype=torch.int32)
    B, S1 = tokens.shape
    out = {"tokens": tokens}
    for name, (shape, dtype) in batch_struct(cfg, "train", S1 - 1, B).items():
        if name == "tokens":
            continue
        out[name] = (torch.zeros(shape, dtype=dtype, device=device)
                     if gen is None else
                     torch.randn(shape, generator=gen, device=device,
                                 dtype=torch.float32).to(dtype))
    return out
