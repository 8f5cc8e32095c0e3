"""Training step: loss + grads + optimizer, with microbatch accumulation.

``make_train_step`` builds ``train_step(state, batch) -> (state,
metrics)``, the reference's (``repro.train.step``) structure run eagerly:

  * grads by ``torch.autograd.grad`` of the chunked-CE loss over the
    flattened parameter leaves,
  * optional microbatch accumulation (a Python loop in float32 where the
    reference scans; the sum divided by the count, the last
    microbatch's metrics kept),
  * optional error-feedback int8 gradient compression (compress.py),
  * global-norm clipping,
  * the learning rate of the step count before its increment, and the
    optimizer update.

The metrics stay tensors: the step reads nothing back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..models import loss_fn
from ..models.config import LMConfig
from .compress import ef_compress_tree, ef_init
from .optim import Optimizer, clip_by_global_norm
from .tree import flatten, unflatten


@dataclasses.dataclass(frozen=True)
class TrainCfg:
    optimizer: str = "adamw"
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    grad_clip: float = 1.0
    microbatches: int = 1          # gradient accumulation factor
    compress_grads: bool = False   # error-feedback int8 (see compress.py)


def grads_of(cfg: LMConfig, params, batch):
    """(loss, metrics, gradient tree) of ``loss_fn`` at ``params``: the
    gradient of every leaf (zeros for a leaf the loss does not reach),
    loss and metrics detached."""
    flat, structure = flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        loss, metrics = loss_fn(cfg, unflatten(structure, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, flat)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten(structure, grads))


def make_train_step(cfg: LMConfig, tcfg: TrainCfg, opt: Optimizer,
                    lr_fn: Callable, mesh=None):
    """Returns train_step(state, batch) -> (state, metrics).

    state = {"params", "opt", "step"}  (plus "ef" when compressing).
    batch = {"tokens": [B, S+1], ...modality extras}.

    With ``mesh`` (a ``DeviceMesh``; one process per rank) every state
    leaf is a ``DTensor`` placed by ``launch.sharding.state_shardings``
    and every batch entry a ``DTensor`` sharded over the batch axes
    (``launch.sharding.place_tree``).  The step is FSDP x TP over those
    placements: it gathers each param over the batch axes and keeps its
    model-axis slice where ``models.tensor_parallel.keeps_model_slice``
    says so (the rest whole), computes the loss of its own batch rows
    under ``sharding_ctx.tensor_parallel((mesh, "model"))`` (each model
    rank its own heads, ``d_ff`` and vocab slices), takes the gradients
    of those local leaves, sums them over the batch axes into each
    param's placement (a reduce-scatter where the param is sharded over
    a batch axis, an all-reduce where it is not), and updates the
    sharded state with DTensor's elementwise ops.  A leaf gathered whole
    has the same gradient on every model rank, but the MoE experts of
    the explicit-collective variants (``set_shardmap_moe``), whose
    per-rank gradients are summed over the model axis too.  Loss and
    metrics are the means over the batch blocks (the global batch split
    evenly).
    """

    def accumulate(params, batch):
        mb = tcfg.microbatches
        if mb == 1:
            return grads_of(cfg, params, batch)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in flatten(params)[0]]
        tot = torch.zeros((), dtype=torch.float32, device=acc[0].device)
        for i in range(mb):
            b = {k: v.reshape((mb, v.shape[0] // mb) + v.shape[1:])[i]
                 for k, v in batch.items()}
            loss, metrics, grads = grads_of(cfg, params, b)
            for a, g in zip(acc, flatten(grads)[0]):
                a.add_(g)                       # float32 + g, in place
            tot = tot + loss
            del grads
        return tot / mb, metrics, unflatten(flatten(params)[1],
                                            [a.div_(mb) for a in acc])

    def train_step(state, batch):
        params = state["params"]
        if mesh is None:
            loss, metrics, grads = accumulate(params, batch)
        else:
            loss, metrics, grads = _mesh_grads(cfg, mesh, accumulate,
                                               params, batch)
        if tcfg.compress_grads:
            grads, ef = ef_compress_tree(grads, state["ef"])
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        lr = lr_fn(state["step"])
        new_params, new_opt = opt.update(grads, state["opt"], params, lr)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        if tcfg.compress_grads:
            new_state["ef"] = ef
        metrics = dict(metrics)
        metrics.update({"loss": loss, "grad_norm": gnorm, "lr": lr})
        return new_state, metrics

    return train_step


def _mesh_grads(cfg, mesh, accumulate, params, batch):
    """(loss, metrics, grads) of the global batch on a mesh: the
    gradients of this rank's rows on its local view of the params,
    summed over the batch axes into each param's placement
    (``make_train_step``)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from ..launch.mesh import axis_names
    from ..launch.sharding import keyed_leaves
    from ..models import sharding_ctx
    from ..models import tensor_parallel as tp

    local = {k: v.to_local() for k, v in batch.items()}
    rows = next(iter(batch.values()))
    # the mesh dims the batch rows are split over; the other ranks of a
    # block hold the same rows
    split = [i for i, pl in enumerate(rows.placements) if pl.is_shard(0)]
    n = 1
    for i in split:
        n *= mesh.size(i)
    over = [Partial() if i in split else Replicate()
            for i in range(mesh.ndim)]
    names = axis_names(mesh)

    def placed_as(path, p):
        """The placements of a leaf's local gradient: partial over the
        split batch dims, on the model axis ``grad_placement``'s."""
        return [tp.grad_placement(cfg, path, p.placements[i])
                if name == tp.MODEL_AXIS and i not in split else over[i]
                for i, name in enumerate(names)]

    def total(t, scale):
        # a sum over the split dims: an all-reduce, which gloo completes
        # on CUDA tensors (its all-gather of them hangs: dist/comm.py)
        return DTensor.from_local(t * scale, mesh, over).full_tensor()

    view = tp.local_params(cfg, params)
    with sharding_ctx.tensor_parallel((mesh, tp.MODEL_AXIS)):
        loss, metrics, grads = accumulate(view, local)
    keyed, structure = keyed_leaves(params)
    flat = flatten(grads)[0]
    grads = unflatten(structure, [
        DTensor.from_local(g / n, mesh, placed_as(path, p)).redistribute(
            mesh, p.placements) for g, (path, p) in zip(flat, keyed)])
    metrics = {k: total(v, 1.0 if k == "tokens" else 1.0 / n)
               for k, v in metrics.items()}
    return total(loss, 1.0 / n), metrics, grads


def init_state(cfg: LMConfig, tcfg: TrainCfg, opt: Optimizer, params):
    """{"params", "opt", "step"} (+ "ef" when compressing); ``step`` an
    int32 0-d tensor on the params' device."""
    device = flatten(params)[0][0].device
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if tcfg.compress_grads:
        state["ef"] = ef_init(params)
    return state
