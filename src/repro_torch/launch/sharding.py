"""Declarative sharding policy: param / activation / input / cache specs.

The reference's (``repro.launch.sharding``) rules, over the port's trees:

* **Weights**: 2D FSDP x TP -- contraction-adjacent dim sharded over
  'data' (FSDP), head/ff/vocab dim over 'model' (TP).  Across pods
  weights are replicated ('pod' carries only batch).
* **Experts** (MoE): expert axis over 'model' when num_experts is a
  multiple of the model-axis size (arctic 128e); otherwise TP inside
  each expert (mixtral 8e); with ``moe_ep`` experts over 'data' and the
  FFN dim over 'model'.
* **Activations**: residual stream sharded over batch axes; logits over
  'model' (vocab); expert buffers over 'model' when experts are sharded.
  Sequence parallelism is the "res" tag override.
* **Decode caches**: batch axis over ('pod', 'data') when divisible; KV
  heads over 'model' when divisible, else the sequence dim over 'model'.

A *spec* is a tuple with one entry per tensor dim, as
``jax.sharding.PartitionSpec`` holds them: ``None``, an axis name, or a
tuple of names.  A leaf's path is written as ``jax.tree_util.keystr``
writes it (``['blocks'][0]['attn']['wq']``), over the leaf order of
``train/tree.py``, which is the reference's.  The tree builders return
:class:`NamedSharding` s (a mesh and a spec); :func:`placements` turns a
spec into the DTensor placements of a ``DeviceMesh``.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, List, Tuple

from ..models.config import LMConfig
from ..train.tree import flatten, flatten_up_to, unflatten
from .mesh import axis_names, axis_size, batch_axes

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec bound to its mesh (``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: Spec


def _entry(e):
    """A spec entry as ``PartitionSpec`` keeps it: an empty tuple is
    ``None``, a one-name tuple its name."""
    if isinstance(e, tuple):
        return None if not e else e[0] if len(e) == 1 else e
    return e


def _ns(mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, tuple(_entry(e) for e in spec))


def _keyed_into(t, path: str, out: list) -> None:
    # module-level, as train/tree.py's walks: a self-calling closure would
    # hold ``out`` (and so every leaf) in a cycle until the collector runs
    if t is None:
        return
    if isinstance(t, dict):
        for k in sorted(t):
            _keyed_into(t[k], f"{path}['{k}']", out)
    elif isinstance(t, (tuple, list)):
        for i, v in enumerate(t):
            _keyed_into(v, f"{path}[{i}]", out)
    else:
        out.append((path, t))


def keyed_leaves(tree) -> Tuple[List[Tuple[str, Any]], Any]:
    """``([(keystr path, leaf)], structure)`` in ``flatten`` order."""
    out: List[Tuple[str, Any]] = []
    _keyed_into(tree, "", out)
    return out, flatten(tree)[1]


def _map_keyed(fn, tree):
    leaves, structure = keyed_leaves(tree)
    return unflatten(structure, [fn(p, l) for p, l in leaves])


def placements(mesh, spec: Spec) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on
    each mesh dim that tensor dim ``d`` names, ``Replicate()`` on the
    others.  A dim sharded over several mesh dims names them in mesh
    order and DTensor nests them in that order, so the slices are
    major-to-minor as ``PartitionSpec`` lays them (``("data", "model")``
    is data-major)."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: {group} is not in mesh order "
                             f"{names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def local_numel(shape, spec: Spec, mesh) -> int:
    """Elements of one rank's shard of a ``shape`` leaf laid out by
    ``spec`` (every sharded dim divides evenly)."""
    n = math.prod(shape)
    for entry in spec:
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            n //= axis_size(mesh, a)
    return n


# --------------------------------------------------------------------------
# parameter policy
# --------------------------------------------------------------------------

# rules: (path regex, spec for the *trailing* dims of the leaf)
# leading stack dims (layer groups / expert axis handled separately) get None.
_PARAM_RULES = [
    (r"\['embed'\]$",                ("model", "data")),
    (r"\['head'\]$",                 ("data", "model")),
    (r"\['(wq|wk|wv)'\]$",           ("data", "model")),
    (r"\['wo'\]$",                   ("model", "data")),
    (r"\['(bq|bk|bv)'\]$",           ("model",)),
    (r"\['(w_gate|w_up)'\]$",        ("data", "model")),
    (r"\['w_down'\]$",               ("model", "data")),
    (r"\['router'\]$",               ("data", None)),
    (r"\['(w_r|w_k|w_v|w_g)'\]$",    ("data", "model")),   # rwkv projections
    (r"\['dec_a'\]$",                ("data", None)),
    (r"\['dec_b'\]$",                (None, "data")),
    (r"\['w_in'\]$",                 ("data", None)),      # mamba in-proj
    (r"\['w_out'\]$",                (None, "data")),
]


def param_pspec(cfg: LMConfig, mesh, path: str, ndim: int,
                shape, moe_ep: bool = False) -> Spec:
    moe_sharded = cfg.moe is not None and \
        cfg.moe.num_experts % axis_size(mesh, "model") == 0
    is_expert = bool(re.search(r"\['moe'\]", path)) and \
        bool(re.search(r"w_(gate|up|down)", path))
    trailing: tuple = ()
    for rx, spec in _PARAM_RULES:
        if re.search(rx, path):
            trailing = spec
            break
    if is_expert:
        key = re.search(r"w_(gate|up|down)", path).group(0)
        ep_ok = cfg.moe.num_experts % axis_size(mesh, "data") == 0 and \
            cfg.moe.d_ff % axis_size(mesh, "model") == 0
        if moe_ep and ep_ok:
            # expert-parallel storage == compute layout (GShard):
            # experts over 'data', FFN dim over 'model'
            trailing = ("data", None, "model") if key != "w_down" \
                else ("data", "model", None)
        elif moe_sharded:
            # experts over 'model', FSDP over 'data' on the d dim
            trailing = ("model", "data", None)
        else:
            base = dict(w_gate=("data", "model"), w_up=("data", "model"),
                        w_down=("model", "data"))
            trailing = (None,) + base[key]
    spec: List[Any] = [None] * ndim
    for i, ax in enumerate(reversed(trailing)):
        di = ndim - 1 - i
        if di < 0:
            break
        if ax is not None and shape[di] % axis_size(mesh, ax) == 0:
            spec[di] = ax
    return tuple(spec)


def param_shardings(cfg: LMConfig, mesh, params, moe_ep: bool = False):
    """Map a params tree (of tensors, meta or fake ones included) to
    :class:`NamedSharding` s."""
    return _map_keyed(
        lambda path, leaf: NamedSharding(mesh, param_pspec(
            cfg, mesh, path, len(leaf.shape), tuple(leaf.shape),
            moe_ep=moe_ep)), params)


# --------------------------------------------------------------------------
# activation policy (tags consumed by models.sharding_ctx)
# --------------------------------------------------------------------------

def activation_specs(cfg: LMConfig, mesh, *, seq_parallel: bool = False,
                     moe_alltoall: bool = False) -> Dict[str, NamedSharding]:
    b = (batch_axes(mesh),)
    res_seq = "model" if seq_parallel else None
    specs = {
        "btd": _ns(mesh, *b, None, None),
        "res": _ns(mesh, *b, res_seq, None),
        "btv": _ns(mesh, *b, None, "model"),
    }
    if moe_alltoall and cfg.moe is not None:
        e_sharded = cfg.moe.num_experts % axis_size(mesh, "model") == 0
        if e_sharded:       # arctic: experts over 'model', capacity over 'data'
            specs["moe_ecd"] = _ns(mesh, "model", "data", None)
            specs["moe_w_in"] = _ns(mesh, "model", None, None)
            specs["moe_w_out"] = _ns(mesh, "model", None, None)
        else:               # mixtral: TP inside expert, capacity over 'data'
            specs["moe_ecd"] = _ns(mesh, None, "data", None)
            specs["moe_w_in"] = _ns(mesh, None, None, "model")
            specs["moe_w_out"] = _ns(mesh, None, "model", None)
    return specs


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------

def _batch_spec(mesh, global_batch: int) -> Tuple[str, ...]:
    """Largest prefix of (pod, data) that divides the batch."""
    axes = []
    size = 1
    for a in batch_axes(mesh):
        s = axis_size(mesh, a)
        if global_batch % (size * s) == 0:
            axes.append(a)
            size *= s
    return tuple(axes)


def batch_shardings(cfg: LMConfig, mesh, batch) -> Any:
    """Shardings for a batch dict ({"tokens", "frames", "patches", ...})."""
    def one(path, leaf):
        ba = _batch_spec(mesh, leaf.shape[0])
        return _ns(mesh, ba, *([None] * (len(leaf.shape) - 1)))

    return _map_keyed(one, batch)


# --------------------------------------------------------------------------
# decode cache
# --------------------------------------------------------------------------

def cache_shardings(cfg: LMConfig, mesh, cache) -> Any:
    """Cache leaves: [G, B, heads?, S, D] / ssm / conv / shift states.

    Preference order per leaf: shard batch over (pod, data) if divisible;
    shard a heads-like dim over 'model' if divisible; else shard the
    sequence dim over 'model' (and over 'data' too for batch=1
    long-context decode).
    """
    model = axis_size(mesh, "model")
    names = axis_names(mesh)

    def one(path, leaf):
        if path.endswith("['pos']"):          # the port's is a Python int
            return _ns(mesh)
        shape = tuple(leaf.shape)
        nd = len(shape)
        spec: List[Any] = [None] * nd
        # leading dim is the group stack; dim 1 is batch.
        if nd >= 2:
            ba = _batch_spec(mesh, shape[1])
            if ba:
                spec[1] = ba
        batch_sharded = nd >= 2 and spec[1] is not None and \
            math.prod(axis_size(mesh, a) for a in (spec[1] or ())) > 1
        if re.search(r"\['(k|v|xk|xv)'\]$", path) and nd == 5:
            # [G, B, KV, S, Dh]
            if shape[2] % model == 0:
                spec[2] = "model"
            elif shape[3] % model == 0:
                spec[3] = "model"
                if not batch_sharded and "data" in names and \
                        shape[3] % (model * axis_size(mesh, "data")) == 0:
                    spec[3] = ("data", "model")
                    if "pod" in names and \
                            shape[3] % (model * axis_size(mesh, "data")
                                        * axis_size(mesh, "pod")) == 0:
                        spec[3] = ("pod", "data", "model")
        elif re.search(r"\['(wkv|ssm)'\]$", path) and nd == 5:
            # [G, B, H, Dk, Dv] / [G, B, H, N, P]
            if shape[2] % model == 0:
                spec[2] = "model"
        return _ns(mesh, *spec)

    return _map_keyed(one, cache)


# --------------------------------------------------------------------------
# optimizer state (mirror the param sharding leaf-wise)
# --------------------------------------------------------------------------

def state_shardings(cfg: LMConfig, mesh, state, moe_ep: bool = False) -> Any:
    """train state {"params", "opt", "step"[, "ef"]} -> shardings.

    Optimizer slots share their parameter's sharding when shapes match
    (mu / nu / ef); adafactor's factored rows / cols take the spec the
    parameter's rules give their own shape."""
    def lookup(sub, leaf):
        return NamedSharding(mesh, param_pspec(
            cfg, mesh, sub, len(leaf.shape), tuple(leaf.shape),
            moe_ep=moe_ep))

    def match(path, leaf):
        if path.startswith("['params']"):
            return lookup(path[len("['params']"):], leaf)
        if path.startswith("['opt']") or path.startswith("['ef']"):
            m = re.match(r"\['(opt|ef)'\]\['(mu|nu|slots)'\](.*)", path)
            if m and m.group(2) in ("mu", "nu"):
                return lookup(m.group(3), leaf)
            if path.startswith("['ef']"):
                return lookup(path[len("['ef']"):], leaf)
            if m and m.group(2) == "slots":
                # adafactor: strip the trailing ['vr']/['vc']/['v'] selector
                return lookup(re.sub(r"\['(vr|vc|v)'\]$", "", m.group(3)),
                              leaf)
        return _ns(mesh)

    return _map_keyed(match, state)


# --------------------------------------------------------------------------
# placing trees
# --------------------------------------------------------------------------

def place_tree(tree, shardings):
    """Every leaf of ``tree`` as a ``DTensor`` laid out by its
    :class:`NamedSharding` in ``shardings`` (a tree of the same
    structure).  Each rank passes the whole tensor and keeps its slice:
    nothing is communicated.  A leaf that is not a tensor (a cache's
    ``pos``) stays as it is."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    leaves, structure = flatten(tree)
    shs = flatten_up_to(structure, shardings)
    out = [distribute_tensor(t, sh.mesh, placements(sh.mesh, sh.spec),
                             src_data_rank=None)
           if isinstance(t, torch.Tensor) else t
           for t, sh in zip(leaves, shs)]
    # ``distribute_tensor`` leaves this frame referenced from a cycle
    # until the collector runs: drop the whole tensors from it, so that
    # a caller who drops its tree frees them at once
    del tree, leaves
    return unflatten(structure, out)


def gather_leaf(t, keep=lambda name, placement: False):
    """A ``DTensor``'s local shard gathered over each mesh dim it is
    sharded on, except those where ``keep(mesh dim name, placement)``:
    a plain tensor.  The gathers are ``dist.comm.all_gather`` over the
    mesh dim's group, the innermost mesh dim first, so a tensor dim
    split over several mesh dims (major-to-minor) comes back in order;
    gloo stages them through the host (``dist/comm.py``)."""
    from ..dist.comm import all_gather

    mesh = t.device_mesh
    names = axis_names(mesh)
    local = t.to_local()
    for i in reversed(range(mesh.ndim)):
        pl = t.placements[i]
        if not pl.is_shard() or mesh.size(i) == 1 or keep(names[i], pl):
            continue
        local = all_gather(local.movedim(pl.dim, 0).contiguous(),
                           mesh.get_group(i)).movedim(0, pl.dim)
    return local


def gather_tree(tree):
    """Every ``DTensor`` leaf of ``tree`` as its whole tensor
    (:func:`gather_leaf`)."""
    from torch.distributed.tensor import DTensor

    leaves, structure = flatten(tree)
    return unflatten(structure, [gather_leaf(t) if isinstance(t, DTensor)
                                 else t for t in leaves])
