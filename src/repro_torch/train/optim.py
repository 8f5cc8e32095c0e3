"""Optimizers as plain functions over parameter trees (no torch.optim).

``Optimizer`` is an (init, update) pair; ``update`` maps
(grads, state, params, lr) -> (new_params, new_state).  All three
optimizers keep their state and do their arithmetic in float32 whatever
the parameters' dtype, and write each new parameter back in its own
dtype.  The formulas are the reference's (``repro.train.optim``), op for
op: ``torch.optim.AdamW`` would decay the weights as ``p * (1 - lr *
wd)`` ahead of the step and round differently.

* adamw     -- default for <= ~30B configs.
* adafactor -- factored second moment: optimizer state is O(rows+cols)
               per matrix instead of O(rows*cols); the arctic 480B config.
* lion      -- sign-momentum; 1 state slot.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from .tree import flatten, flatten_up_to, tree_map, unflatten

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable          # (grads, state, params, lr) -> (params, state)


def _device(tree):
    return flatten(tree)[0][0].device


def _zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=F32, device=p.device)


def _count(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=_device(params))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.to(F32)))
                          for l in flatten(tree)[0]))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm).
    A leaf of a lower precision is scaled in float32, as the reference's
    type promotion against the float32 scale does."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return tree_map(lambda g: g.to(torch.promote_types(g.dtype, F32))
                    * scale, grads), norm


def _apply(fn, grads, params, *states):
    """``fn(g, *state_leaves, p)`` per leaf in leaf order; returns the list
    of its result tuples and the grads' structure."""
    flat_g, structure = flatten(grads)
    flat_s = [flatten_up_to(structure, s) for s in states]
    flat_p = flatten_up_to(structure, params)
    return ([fn(g, *s, p) for g, *s, p in zip(flat_g, *flat_s, flat_p)],
            structure)


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------

def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        return {"mu": tree_map(_zeros, params), "nu": tree_map(_zeros, params),
                "count": _count(params)}

    def update(grads, state, params, lr):
        c = state["count"] + 1
        bc1 = 1 - b1 ** c.to(F32)
        bc2 = 1 - b2 ** c.to(F32)

        def upd(g, m, v, p):
            g = g.to(F32)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            step = step + weight_decay * p.to(F32)
            return (p.to(F32) - lr * step).to(p.dtype), m, v

        new, s = _apply(upd, grads, params, state["mu"], state["nu"])
        return (unflatten(s, [t[0] for t in new]),
                {"mu": unflatten(s, [t[1] for t in new]),
                 "nu": unflatten(s, [t[2] for t in new]), "count": c})

    return Optimizer(init, update)


# --------------------------------------------------------------------------
# Adafactor (factored second moment)
# --------------------------------------------------------------------------

def adafactor(eps: float = 1e-30, clip_threshold: float = 1.0,
              decay: float = 0.8, weight_decay: float = 0.0) -> Optimizer:
    def _factored(shape) -> bool:
        return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1

    def init(params):
        def slot(p):
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], dtype=F32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=F32, device=p.device)}
            return {"v": _zeros(p)}
        return {"slots": tree_map(slot, params), "count": _count(params)}

    def update(grads, state, params, lr):
        c = state["count"] + 1
        beta = 1.0 - (c.to(F32) + 1.0) ** -decay

        def upd(g, s, p):
            g = g.to(F32)
            g2 = g * g + eps
            if _factored(p.shape):
                vr = beta * s["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * s["vc"] + (1 - beta) * g2.mean(dim=-2)
                denom = torch.clamp_min(vr.mean(dim=-1, keepdim=True), eps)
                step = g * torch.rsqrt(vr / denom)[..., None] \
                    * torch.rsqrt(vc)[..., None, :]
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                step = g * torch.rsqrt(v)
                new_s = {"v": v}
            # relative clipping
            rms = torch.sqrt(torch.mean(step * step))
            step = step / torch.clamp_min(rms / clip_threshold, 1.0)
            if weight_decay:
                step = step + weight_decay * p.to(F32)
            return (p.to(F32) - lr * step).to(p.dtype), new_s

        new, s = _apply(upd, grads, params, state["slots"])
        return (unflatten(s, [t[0] for t in new]),
                {"slots": unflatten(s, [t[1] for t in new]), "count": c})

    return Optimizer(init, update)


# --------------------------------------------------------------------------
# Lion
# --------------------------------------------------------------------------

def lion(b1: float = 0.9, b2: float = 0.99,
         weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        return {"mu": tree_map(_zeros, params), "count": _count(params)}

    def update(grads, state, params, lr):
        def upd(g, m, p):
            g = g.to(F32)
            step = torch.sign(b1 * m + (1 - b1) * g) \
                + weight_decay * p.to(F32)
            m = b2 * m + (1 - b2) * g
            return (p.to(F32) - lr * step).to(p.dtype), m

        new, s = _apply(upd, grads, params, state["mu"])
        return (unflatten(s, [t[0] for t in new]),
                {"mu": unflatten(s, [t[1] for t in new]),
                 "count": state["count"] + 1})

    return Optimizer(init, update)


OPTIMIZERS = {"adamw": adamw, "adafactor": adafactor, "lion": lion}


def get_optimizer(name: str, **kw) -> Optimizer:
    return OPTIMIZERS[name](**kw)


# --------------------------------------------------------------------------
# LR schedules
# --------------------------------------------------------------------------

def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """``lr(step)`` -> a float32 0-d tensor (on ``step``'s device when it
    is a tensor): linear warmup to ``peak_lr``, then a cosine down to
    ``final_frac * peak_lr`` at ``total_steps``."""
    def lr(step):
        step = step.to(F32) if isinstance(step, torch.Tensor) \
            else torch.tensor(step, dtype=F32)
        warm = peak_lr * torch.clamp_max(step / max(warmup_steps, 1), 1.0)
        prog = torch.clamp((step - warmup_steps) /
                           max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)
    return lr
