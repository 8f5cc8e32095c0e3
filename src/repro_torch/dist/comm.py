"""The cross-shard moves of the distributed cluster step.

The step (``dist/step.py``) moves data between shards four times: the
ghost halos from the slab neighbours, the ghosts' labels sent back, the
concatenation of the per-shard edge lists, and the OR of the overflow
reports; the fit then gathers every shard's rows.  Each move has two
forms behind one interface, over the shards a process holds
(``comm.shards``, global shard ids in slab order; every argument and
result is a list with one tensor per held shard):

* :class:`LoopComm` -- every shard in this process, shard ``s`` on
  ``devices[s]`` (repeats allowed); a move is a copy to the receiving
  shard's device.
* :class:`GroupComm` -- one shard per rank of a ``torch.distributed``
  process group (the ranks of a ``DeviceMesh``, flattened row-major, as
  the reference's ``shard_map`` flattens its mesh axes): the halos go to
  the left and right ranks by ``batch_isend_irecv`` (the reference's
  ``ppermute``), the edges by ``all_gather_into_tensor`` (its
  ``all_gather``), the report by ``all_reduce(MAX)`` over ``uint8``
  (one byte a flag, as the reference's ``psum`` ships bool).

Backends: the collectives run on whatever backend the caller's process
group has.  Under NCCL the tensors stay on the card (contiguous).  Gloo
moves host tensors only: with gloo and a CUDA shard, every move copies
its tensors to the host and the result back to the card, explicitly,
here (:meth:`GroupComm.stage`).  Nothing picks gloo when NCCL fails: an
NCCL error raises.  The same rule serves the MoE and tensor-parallel
collectives (:func:`all_reduce`, :func:`all_gather`,
:func:`reduce_scatter`, :func:`all_to_all`), and
``launch.sharding.gather_leaf``'s gathers of a placed tree: gloo's
``all_gather_into_tensor`` of CUDA tensors hangs (torch 2.11 on the
H100), so nothing gathers a CUDA tensor through gloo unstaged.

``SENT`` counts the bytes each move of a :class:`GroupComm` sends from
this rank (``exchange``, ``gather``, ``any``), for a caller that reads
the collectives' volume; set an entry to 0 to start a count.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core.sync import count_read

SENT = {"exchange": 0, "gather": 0, "any": 0}


def _staged(group, device: torch.device) -> bool:
    """Whether collectives of ``group`` on ``device`` go through the
    host: gloo with a CUDA tensor."""
    return device.type == "cuda" and dist.get_backend(group) == "gloo"


def _c10d():
    return torch.ops._c10d_functional


def _run(t: torch.Tensor, group, collective) -> torch.Tensor:
    """``collective(tensor sent, group name)`` -- a ``_c10d_functional``
    op, waited on -- with ``t`` staged through the host under gloo and
    the result back on ``t``'s device."""
    send = t.cpu() if _staged(group, t.device) else t.contiguous()
    out = _c10d().wait_tensor(collective(send, group.group_name))
    return out.to(t.device)


def all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """``all_reduce`` of ``t`` over ``group`` (``op``: "sum", "max",
    ...)."""
    return _run(t, group, lambda x, g: _c10d().all_reduce(x, op, g))


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """``all_gather_into_tensor`` of ``t`` over ``group``: the ranks'
    tensors concatenated along dim 0 in rank order (a bool tensor
    travels as uint8)."""
    n = dist.get_world_size(group)
    send = t.to(torch.uint8) if t.dtype == torch.bool else t
    out = _run(send, group, lambda x, g:
               _c10d().all_gather_into_tensor(x, n, g))
    return out.to(t.dtype)


def reduce_scatter(t: torch.Tensor, group) -> torch.Tensor:
    """``reduce_scatter_tensor`` (sum) of ``t`` over ``group``: rank
    ``j`` gets block ``j`` of dim 0 summed over the ranks."""
    n = dist.get_world_size(group)
    return _run(t, group, lambda x, g:
                _c10d().reduce_scatter_tensor(x, "sum", n, g))


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` of ``t`` over ``group`` in equal splits of
    dim 0: block ``j`` goes to rank ``j``, and block ``j`` of the result
    came from rank ``j``."""
    n = dist.get_world_size(group)
    split = [t.shape[0] // n] * n
    return _run(t, group, lambda x, g:
                _c10d().all_to_all_single(x, split, split, g))


class LoopComm:
    """Every shard in this process, shard ``s`` on ``devices[s]``."""

    def __init__(self, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        self.n_shards = len(self.devices)
        self.shards = list(range(self.n_shards))

    def neighbour_exchange(self, to_right: List[torch.Tensor],
                           to_left: List[torch.Tensor], fill):
        """Each shard sends ``to_right`` to its right neighbour and
        ``to_left`` to its left one.  Returns ``(from_left,
        from_right)``: what each shard received, or ``fill`` everywhere
        where it has no such neighbour (shard 0 on the left, the last
        shard on the right)."""
        last = self.n_shards - 1
        from_left, from_right = [], []
        for s, dev in enumerate(self.devices):
            from_left.append(to_right[s - 1].to(dev) if s > 0
                             else torch.full_like(to_right[s], fill))
            from_right.append(to_left[s + 1].to(dev) if s < last
                              else torch.full_like(to_left[s], fill))
        return from_left, from_right

    def shard_concat(self, tensors: List[torch.Tensor]) -> torch.Tensor:
        """Every shard's tensor concatenated along dim 0 in shard order,
        on the first shard's device."""
        dev = self.devices[0]
        return torch.cat([t.to(dev) for t in tensors])

    def shard_any(self, vecs: List[torch.Tensor]) -> torch.Tensor:
        """The OR of the shards' bool vectors, on the first shard's
        device."""
        dev = self.devices[0]
        return torch.stack([v.to(dev) for v in vecs]).any(dim=0)

    def host_rows(self, tensors: List[torch.Tensor]) -> np.ndarray:
        """Every shard's tensor as one host array [n_shards, ...] (a
        counted host read per shard)."""
        for _ in tensors:
            count_read()
        return np.stack([t.cpu().numpy() for t in tensors])


class GroupComm:
    """This rank's shard of a ``DeviceMesh`` (its mesh ranks flattened
    row-major are the shards in slab order), on ``device``."""

    def __init__(self, mesh, device):
        ranks = mesh.mesh.flatten().tolist()
        if ranks != list(range(dist.get_world_size())):
            raise ValueError("the mesh must hold every rank of the process "
                             "group, in rank order")
        self.device = torch.device(device)
        self.n_shards = len(ranks)
        self.me = dist.get_rank()
        self.shards = [self.me]
        self.devices = [self.device]
        self.group = dist.group.WORLD
        self.stage_host = _staged(self.group, self.device)

    def stage(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor a collective sends: a host copy under gloo with a
        CUDA shard, else ``t`` itself (contiguous)."""
        return t.cpu() if self.stage_host else t.contiguous()

    def neighbour_exchange(self, to_right: List[torch.Tensor],
                           to_left: List[torch.Tensor], fill):
        """:meth:`LoopComm.neighbour_exchange` between ranks: one batch of
        ``isend`` / ``irecv`` to the left and right ranks."""
        right, left = self.stage(to_right[0]), self.stage(to_left[0])
        me, last = self.me, self.n_shards - 1
        from_left = torch.full_like(right, fill)
        from_right = torch.full_like(left, fill)
        ops = []
        if me < last:
            ops += [dist.P2POp(dist.isend, right, me + 1),
                    dist.P2POp(dist.irecv, from_right, me + 1)]
        if me > 0:
            ops += [dist.P2POp(dist.isend, left, me - 1),
                    dist.P2POp(dist.irecv, from_left, me - 1)]
        if ops:
            SENT["exchange"] += sum(op.tensor.numel()
                                    * op.tensor.element_size()
                                    for op in ops[::2])      # the sends
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return [from_left.to(self.device)], [from_right.to(self.device)]

    def shard_concat(self, tensors: List[torch.Tensor]) -> torch.Tensor:
        (t,) = tensors
        SENT["gather"] += t.numel() * max(t.element_size(), 1)
        return all_gather(t, self.group)

    def shard_any(self, vecs: List[torch.Tensor]) -> torch.Tensor:
        (v,) = vecs
        SENT["any"] += v.numel()
        return all_reduce(v.to(torch.uint8), "max", self.group).to(torch.bool)

    def host_rows(self, tensors: List[torch.Tensor]) -> np.ndarray:
        (t,) = tensors
        rows = self.shard_concat([t[None]])
        count_read()
        return rows.cpu().numpy()
