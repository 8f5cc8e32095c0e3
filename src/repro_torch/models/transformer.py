"""Block assembly and layer stacks (the dense family).

Layers are organized into *groups*: ``group_layout(cfg)`` returns the
static tuple of block kinds that make up one group, and the full network
is ``num_groups(cfg)`` repetitions, run as a Python loop over the
leading group axis of the stacked parameters (the reference scans it
with ``lax.scan``; rematerialisation is a training concern and has no
counterpart here).  Examples:

  qwen2     -> ("attn:full",) x 28 groups
  gemma2    -> ("attn:swa", "attn:full") x 23   (local/global alternation)

Block kinds carry their attention window statically.  The kinds of the
other families (``moe:*``, ``rwkv``, ``mamba``, ``shared_attn``,
``dec_attn``, ``enc_attn``) raise ``NotImplementedError`` until their
families are ported (ROADMAP A17).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import layers as L
from .config import LMConfig


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: the port runs the dense family "
        f"(block kinds attn:full / attn:swa); the others are ROADMAP A17")


# --------------------------------------------------------------------------
# group layout
# --------------------------------------------------------------------------

def group_layout(cfg: LMConfig) -> Tuple[str, ...]:
    if cfg.family != "dense":
        raise _not_ported(f"family {cfg.family!r}")
    if cfg.attn_kind == "local_global":
        return ("attn:swa", "attn:full")
    if cfg.attn_kind == "swa":
        return ("attn:swa",)
    return ("attn:full",)


def num_groups(cfg: LMConfig) -> int:
    per = len(group_layout(cfg))
    assert cfg.num_layers % per == 0
    return cfg.num_layers // per


def _kind_window(cfg: LMConfig, kind: str) -> Optional[int]:
    return cfg.window if kind.endswith(":swa") else None


def _check_kind(kind: str) -> None:
    if kind not in ("attn:full", "attn:swa"):
        raise _not_ported(f"block kind {kind!r}")


# --------------------------------------------------------------------------
# per-kind params / cache / forward
# --------------------------------------------------------------------------

def block_params(cfg: LMConfig, kind: str, gen, device, lead=()) -> dict:
    """One block's params; ``lead`` prepends stacked axes to every leaf."""
    _check_kind(kind)
    return {"ln1": L.norm_params(cfg, device, lead),
            "attn": L.attn_params(cfg, gen, device, lead),
            "ln2": L.norm_params(cfg, device, lead),
            "mlp": L.mlp_params(cfg, gen, device, lead)}


def init_block_cache(cfg: LMConfig, kind: str, batch: int, max_len: int,
                     dtype, device, lead=()) -> dict:
    _check_kind(kind)
    window = _kind_window(cfg, kind)
    S_c = max_len if window is None else min(max_len, window)
    shape = (*lead, batch, cfg.num_kv_heads, S_c, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def block_forward(cfg: LMConfig, kind: str, p: dict, x: torch.Tensor,
                  freqs: torch.Tensor, cache: Optional[dict]) -> torch.Tensor:
    """One block; ``cache`` ({"k", "v", "pos"}), when given, is written in
    place."""
    _check_kind(kind)
    h = L.apply_norm(cfg, p["ln1"], x)
    a, _ = L.attn_forward(cfg, p["attn"], h, freqs,
                          window=_kind_window(cfg, kind), cache=cache)
    x = x + a
    h = L.apply_norm(cfg, p["ln2"], x)
    return x + L.mlp_forward(cfg, p["mlp"], h)


# --------------------------------------------------------------------------
# stacked groups
# --------------------------------------------------------------------------

def stack_params(cfg: LMConfig, gen, device, layout: Tuple[str, ...],
                 groups: int):
    """Params for `groups` repetitions of `layout`, leaves stacked on axis 0."""
    return tuple(block_params(cfg, kind, gen, device, lead=(groups,))
                 for kind in layout)


def _index(tree, g: int):
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]


def stack_forward(cfg: LMConfig, stacked, x: torch.Tensor,
                  layout: Tuple[str, ...], *, cache=None):
    """Run `x` through all groups. cache: {"pos": int, "slots": tuple of
    per-slot caches with a leading group axis} (or None), written in
    place.  Returns (x, new_cache)."""
    freqs = L.rope_freqs(cfg, x.device)
    pos = None if cache is None else cache["pos"]
    G = stacked[0]["ln1"]["scale"].shape[0]
    for g in range(G):
        for i, kind in enumerate(layout):
            slot_cache = None
            if cache is not None:
                slot_cache = _index(cache["slots"][i], g)
                slot_cache["pos"] = pos
            x = block_forward(cfg, kind, _index(stacked[i], g), x, freqs,
                              slot_cache)
    new_cache = None
    if cache is not None:
        new_cache = {"pos": pos + x.shape[1], "slots": cache["slots"]}
    return x, new_cache
