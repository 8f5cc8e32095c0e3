"""Error-feedback int8 gradient compression.

Each step, the float32 gradient plus the carried error residual is
quantized to int8 with a per-leaf scale; the quantization error is fed
back into the next step's residual (EF-SGD, Karimireddy et al. 2019), so
the compression is unbiased *over time*.  Across several cards the int8
tensor is what a gradient reduction would move: a quarter of the bytes.

Used behind ``TrainCfg.compress_grads``.  ``torch.round`` rounds half to
even, as ``jnp.round`` does, so the int8 codes are the reference's
(``repro.train.compress``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .tree import flatten, flatten_up_to, tree_map, unflatten

Q = 127.0


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (int8, scale). scale is per-tensor amax / 127."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp_min(amax, 1e-12) / Q
    q = torch.clamp(torch.round(x / scale), -Q, Q).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_init(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def ef_compress_tree(grads, residuals):
    """Compress each gradient leaf with error feedback.

    Returns (dequantized grads -- what the optimizer consumes -- and the
    new residuals)."""
    def one(g, r):
        v = g.to(torch.float32) + r
        q, s = quantize(v)
        deq = dequantize(q, s)
        return deq, v - deq

    flat_g, structure = flatten(grads)
    flat_r = flatten_up_to(structure, residuals)
    new = [one(g, r) for g, r in zip(flat_g, flat_r)]
    return (unflatten(structure, [t[0] for t in new]),
            unflatten(structure, [t[1] for t in new]))
