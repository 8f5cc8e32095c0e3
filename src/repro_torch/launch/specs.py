"""Per-arch launch specs: the model and training configs a driver runs,
and the batch a train step takes.

``ARCH_TRAIN`` holds the reference's (``repro.launch.specs``) per-arch
training knobs, memory-driven: the optimizer, the microbatch count, and
arctic's bfloat16 params outside the smoke configs.

``build_cell(arch, shape)`` returns ``(fn, args, info)`` such that
``fn(*args)`` is that (architecture x input-shape) cell's step on one
device: the train step, the prefill or one decode step.  Every tensor of
``args`` is a fake tensor (``FakeTensorMode``), so nothing is allocated:
``launch/dryrun.py`` runs the cell under the mode of its arguments
(``torch._guards.detect_fake_mode``) and the accountant of
``launch/costs.py``, as the reference lowers and compiles its
ShapeDtypeStructs.

With ``mesh`` (a ``DeviceMesh``; the dry run's is over a fake process
group) the cell is one rank's step: the arguments are ``DTensor`` s over
fake local shards, placed by ``launch/sharding.py`` (params by
``param_shardings``, the train state by ``state_shardings``, inputs by
``batch_shardings``, caches by ``cache_shardings``), the activation
policy (``seq_parallel``) is installed and ``moe_alltoall`` routes the
MoE blocks to the explicit-collective variants with expert-parallel
storage, as the reference's ``build_cell`` does.  The train cell is
``make_train_step``'s FSDP x TP form; prefill and decode
(:func:`prefill_on_mesh`, :func:`decode_on_mesh`) run on the params'
local view under tensor parallelism on the model axis
(``models/tensor_parallel.py``) and the rank's batch rows, and return
the cache in its placements: a KV cache keeps its model-sharded heads
local, and a sequence-sharded one its shard, which the rank writes and
over which a decode step's attention is split.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from ..configs import ShapeCfg, canonical, get_config, get_shape
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


def build_cell(arch: str, shape: Union[str, ShapeCfg], *, device=None,
               attn_impl: Optional[str] = None,
               overrides: Optional[dict] = None,
               microbatches: Optional[int] = None, smoke: bool = False,
               mesh=None, seq_parallel: bool = False,
               moe_alltoall: bool = False):
    """(fn, args, info) of one cell on one device, or of one rank of
    ``mesh`` (module docstring).

    ``shape`` is a name of ``configs.shapes.SHAPES`` or a ``ShapeCfg``;
    ``device`` defaults to the CUDA device and raises without one;
    ``attn_impl`` / ``overrides`` change the model config, and
    ``microbatches`` the train config of ``train_cfg_for``; ``smoke``
    takes the arch's smoke config (CPU-scale).  Params are
    built as ``jax.eval_shape`` builds them: ``init_params`` on the
    ``meta`` device, then fake tensors of the same shapes and dtypes on
    ``device``; the train state, the batch (``batch_struct``) and the
    cache (``init_cache``) are made under the same fake mode.  With a
    ``mesh`` the activation policy and the MoE route stay installed
    (``models.sharding_ctx``) until the next ``build_cell``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..engine.adaptive import resolve_device
    from ..models import (decode_step, init_cache, init_params, prefill,
                          sharding_ctx)
    from ..train import (get_optimizer, init_state, make_train_step,
                         warmup_cosine)
    from ..train.tree import tree_map

    dev = resolve_device(device)
    cfg = model_cfg_for(arch, smoke=smoke)
    if attn_impl:
        cfg = cfg.with_overrides(attn_impl=attn_impl)
    if overrides:
        cfg = cfg.with_overrides(**overrides)
    sc = get_shape(shape) if isinstance(shape, str) else shape
    meta = init_params(cfg, None, "meta")
    mode = FakeTensorMode()

    def fake(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device=dev)

    def batch(kind):
        return {name: fake(shp, dt) for name, (shp, dt) in
                batch_struct(cfg, kind, sc.seq_len, sc.global_batch).items()}

    with mode:
        params = tree_map(lambda t: fake(t.shape, t.dtype), meta)
    info = {"arch": arch, "shape": sc.name, "kind": sc.kind}
    if mesh is None:
        sharding_ctx.set_policy(None)
        sharding_ctx.set_shardmap_moe(None)
    else:
        from . import sharding as shd
        from .mesh import batch_axes
        sharding_ctx.set_policy(shd.activation_specs(
            cfg, mesh, seq_parallel=seq_parallel))
        sharding_ctx.set_shardmap_moe(
            (mesh, batch_axes(mesh), "model")
            if moe_alltoall and cfg.moe is not None else None)

        def put(tree, shardings):
            with mode:
                return shd.place_tree(tree, shardings(tree))

    if sc.kind == "train":
        tcfg = train_cfg_for(arch)
        if microbatches is not None:
            tcfg = dataclasses.replace(tcfg, microbatches=microbatches)
        opt = get_optimizer(tcfg.optimizer)
        step_fn = make_train_step(cfg, tcfg, opt, warmup_cosine(
            tcfg.peak_lr, tcfg.warmup_steps, tcfg.total_steps))
        with mode:
            state = init_state(cfg, tcfg, opt, params)
            train_in = batch("train")
        if mesh is not None:
            step_fn = make_train_step(cfg, tcfg, opt, warmup_cosine(
                tcfg.peak_lr, tcfg.warmup_steps, tcfg.total_steps),
                mesh=mesh)
            state = put(state, lambda t: shd.state_shardings(
                cfg, mesh, t, moe_ep=moe_alltoall))
            train_in = put(train_in, lambda t: shd.batch_shardings(
                cfg, mesh, t))
        info["microbatches"] = tcfg.microbatches
        return step_fn, (state, train_in), info

    max_len = sc.seq_len + (cfg.num_patches if cfg.family == "vlm" else 0)
    with mode:
        cache = init_cache(cfg, sc.global_batch, max_len, dev)
        if sc.kind == "prefill":
            prompt = batch("prefill")
        else:
            tokens = fake((sc.global_batch,), torch.int32)
    if mesh is not None:
        params = put(params, lambda t: shd.param_shardings(
            cfg, mesh, t, moe_ep=moe_alltoall))
        cache = put(cache, lambda t: shd.cache_shardings(cfg, mesh, t))
        if sc.kind == "prefill":
            prompt = put(prompt, lambda t: shd.batch_shardings(
                cfg, mesh, t))
        else:
            tokens = put({"tokens": tokens}, lambda t: shd.batch_shardings(
                cfg, mesh, t))["tokens"]

    if sc.kind == "prefill":
        def prefill_step(params, batch, cache):
            if mesh is None:
                return prefill(cfg, params, batch, cache)
            return prefill_on_mesh(cfg, mesh, params, batch, cache)

        return prefill_step, (params, prompt, cache), info

    # decode: one new token against a seq_len-deep cache
    def serve_step(params, tokens, cache):
        if mesh is None:
            return decode_step(cfg, params, tokens, cache)
        return decode_on_mesh(cfg, mesh, params, tokens, cache)

    return serve_step, (params, tokens, cache), info


def prefill_on_mesh(cfg: LMConfig, mesh, params, batch, cache):
    """One rank's prefill of placed trees (``param_shardings``,
    ``batch_shardings``, ``cache_shardings``) under tensor parallelism on
    the model axis: the params' local view
    (``tensor_parallel.local_params``), the rank's batch rows
    (:func:`_rows`) and the cache's local view (:func:`_local_cache`).
    Returns the rank's (last-position logits over the whole vocab, the
    placed cache): ``cache``'s own ``DTensor`` s with the rank's writes
    in their shards, and the new ``pos``."""
    from ..models import prefill, sharding_ctx
    from ..models import tensor_parallel as tp
    with sharding_ctx.tensor_parallel((mesh, tp.MODEL_AXIS)):
        view, write_back = _local_cache(cache)
        logits, out = prefill(cfg, tp.local_params(cfg, params),
                              _rows(batch, 0), view)
        write_back()
    return logits, {"pos": out["pos"], "slots": cache["slots"]}


def decode_on_mesh(cfg: LMConfig, mesh, params, tokens, cache):
    """One rank's decode step of placed trees, as
    :func:`prefill_on_mesh`; ``tokens`` a ``DTensor`` [B]."""
    from ..models import decode_step, sharding_ctx
    from ..models import tensor_parallel as tp
    with sharding_ctx.tensor_parallel((mesh, tp.MODEL_AXIS)):
        view, write_back = _local_cache(cache)
        logits, out = decode_step(cfg, tp.local_params(cfg, params),
                                  _rows(tokens, 0), view)
        write_back()
    return logits, {"pos": out["pos"], "slots": cache["slots"]}


def _rows(tree, dim: int):
    """This rank's rows of a batch tree: every ``DTensor`` leaf keeps its
    sharding of ``dim`` and is gathered over every other mesh dim it is
    sharded on (``sharding.gather_leaf``), then taken local.  Other
    leaves pass as they are."""
    from torch.distributed.tensor import DTensor

    from ..train.tree import flatten, unflatten
    from .sharding import gather_leaf

    leaves, structure = flatten(tree)
    return unflatten(structure, [
        gather_leaf(t, keep=lambda name, pl: pl.is_shard(dim))
        if isinstance(t, DTensor) else t for t in leaves])


def _local_cache(cache):
    """(the local view of a placed cache that a step computes on, a
    function that writes the step's results back into the placed
    shards), under the tensor-parallel context.

    Every ``DTensor`` leaf but one keeps its shards: the batch (dim 1),
    a KV cache's heads (dim 2) or sequence (dim 3), rwkv6's ``wkv`` heads.
    The model splits its compute where ``cache_shardings`` splits those
    dims (a dim of the model axis's size's multiple), so these views are
    the ``DTensor`` s' own local tensors and the step writes into them.
    A slot whose KV cache is sequence-sharded gets its shard's
    descriptor (``tensor_parallel.SeqShard``) under ``"seq"`` (``k`` /
    ``v``) or ``"xseq"`` (``xk`` / ``xv``).  The mamba ``ssm`` state, split
    over heads but computed whole, is gathered (``sharding.gather_leaf``)
    and the write-back copies the rank's slice of it into its shard."""
    from torch.distributed.tensor import DTensor

    from ..models import tensor_parallel as tp
    from .sharding import gather_leaf

    def keep(name, pl):
        return name != "ssm" or pl.is_shard(1)

    def seq_shard(t):
        mesh = t.device_mesh
        dims = [i for i, pl in enumerate(t.placements)
                if pl.is_shard(3) and mesh.size(i) > 1]
        rank, size = 0, 1
        for i in dims:
            rank = rank * mesh.size(i) + mesh.get_local_rank(i)
            size *= mesh.size(i)
        return tp.SeqShard(tuple(mesh.get_group(i) for i in dims), size,
                           rank) if dims else None

    gathered, slots = [], []
    for slot in cache["slots"]:
        view = dict(slot)
        for name, t in slot.items():
            if isinstance(t, DTensor):
                view[name] = gather_leaf(t, lambda _, pl: keep(name, pl))
                dims = [i for i, pl in enumerate(t.placements)
                        if pl.is_shard() and t.device_mesh.size(i) > 1
                        and not keep(name, pl)]
                if dims:
                    gathered.append((t, view[name], dims))
        for name, key in (("k", "seq"), ("xk", "xseq")):
            shard = seq_shard(slot[name]) \
                if isinstance(slot.get(name), DTensor) else None
            if shard is not None:
                view[key] = shard
        slots.append(view)

    def write_back():
        for t, whole, dims in gathered:
            for i in dims:
                d, mesh = t.placements[i].dim, t.device_mesh
                n = whole.shape[d] // mesh.size(i)
                whole = whole.narrow(d, mesh.get_local_rank(i) * n, n)
            t.to_local().copy_(whole)

    return {"pos": cache["pos"], "slots": tuple(slots)}, write_back
