"""A FLOP / byte / collective accountant over eager PyTorch programs.

The counterpart of the reference's ``repro.launch.hlo_costs``, which
parses compiled HLO and scales each computation by its loop trip counts.
An eager program has no HLO and no loop to scale: every iteration
dispatches its own operators.  So the accountant is a
``TorchDispatchMode`` that sees each aten operator as it runs (on real
tensors, or on fake ones under ``FakeTensorMode``, where nothing is
allocated) and counts, as ``hlo_costs.analyze`` does:

* dot FLOPs: 2 * |output| * contraction size for ``mm``, ``bmm``,
  ``addmm``, ``baddbmm``, ``mv``, ``dot``, ``convolution`` and the
  ``_scaled_dot_product_*`` attention ops (both products; five in a
  backward, which recomputes QK^T); ``torch.utils.flop_counter`` counts
  the same products, except ``mv``, ``dot`` and the CPU's attention op,
  which it does not see;
* elementwise FLOPs: the floating elements every other operator writes
  (the reference's |output| per float op);
* free operators (views and metadata: ``view``, ``_unsafe_view``,
  ``expand``, ``as_strided``, ``t``, ``transpose``, ``slice``,
  ``select``, ``alias``, ``detach``, ``empty``, ...): nothing;
* bytes: the inputs plus the outputs of every operator that
  materialises, which in eager mode is the traffic the program really
  makes.  An input is read once over its distinct elements (an expanded
  view reads its base once).  An index or gather reads what it returns
  and its indices, not its whole input (the reference's ``_SLICY``).  An
  in-place write counts once: ``copy_`` / ``fill_`` write their target
  without reading it, a scatter (``index_put_``, ``index_add_``,
  ``scatter_add_``, ...) writes the elements it updates (and reads them
  too when it accumulates), any other in-place op reads and writes its
  target;
* the port's CUDA kernels (``repro_torch::*`` custom ops): the work
  formula of ``kernels.ops.KERNEL_WORK`` for their operations, and the
  byte rule above (q / k / v or a / b and the masks read once, the
  outputs written once);
* collectives: the ``_c10d_functional`` ops, at the wire factors of
  ``launch/roofline.py``; a point-to-point ``c10d::send`` (the halo
  exchange's ``batch_isend_irecv``) as ``collective-permute`` at wire
  factor 1, on the sending side only: a receive (``c10d::recv_``)
  writes its buffer and moves no wire bytes of its own;
* a ``DTensor`` operator is counted as the operators it runs on its
  local shard and the collectives it sends: the count of a mesh run
  is per rank.

Operations are kept by class (``flops_by_class``): ``bf16`` (bf16 / fp16
products on the tensor cores), ``tf32`` (float32 products when TF32 is
allowed), ``f32`` (float32 products on the CUDA cores, the elementwise
work, the distance kernels); ``roofline.roofline_terms`` divides each by
its own peak.  ``torch.utils.flop_counter.FlopCounterMode``'s total is
reported beside the count as ``torch_flop_counter``, where the
reference reports XLA's ``cost_analysis``.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, List, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..kernels import ops as kops
from .roofline import COLLECTIVES, wire_bytes

# operators that move and compute nothing (besides every view op)
_FREE = {"aten::_unsafe_view", "aten::empty", "aten::empty_strided",
         "aten::empty_like", "aten::new_empty", "aten::new_empty_strided",
         "aten::sym_size", "aten::sym_stride", "aten::sym_numel",
         "aten::sym_storage_offset", "aten::is_same_size",
         "aten::_has_compatible_shallow_copy_type", "aten::is_contiguous",
         "prim::device", "prim::layout", "aten::set_", "aten::resize_",
         "_c10d_functional::wait_tensor"}
# they read what they return (and their indices), not their whole input
_GATHER = {"aten::index", "aten::gather", "aten::index_select",
           "aten::embedding", "aten::take"}
# they write their mutated argument without reading it
_OVERWRITE = {"aten::copy_", "aten::fill_", "aten::zero_", "aten::normal_",
              "aten::uniform_", "aten::random_", "aten::bernoulli_",
              "aten::exponential_", "c10d::recv_"}
# they write part of their mutated argument: written elements from the
# update, and read them too when they accumulate
_SCATTER = {"aten::index_put_", "aten::_index_put_impl_", "aten::scatter_",
            "aten::scatter_add_", "aten::scatter_reduce_",
            "aten::index_add_", "aten::index_copy_", "aten::index_fill_"}
_ACCUMULATE = {"aten::scatter_add_", "aten::scatter_reduce_",
               "aten::index_add_"}
_C10D = {"_c10d_functional::all_reduce": "all-reduce",
         "_c10d_functional::all_gather_into_tensor": "all-gather",
         "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
         "_c10d_functional::all_to_all_single": "all-to-all"}
_SEND = "c10d::send"
_SDPA = {"aten::_scaled_dot_product_flash_attention",
         "aten::_scaled_dot_product_flash_attention_for_cpu",
         "aten::_scaled_dot_product_efficient_attention",
         "aten::_scaled_dot_product_cudnn_attention"}
_SDPA_BACKWARD = {n + "_backward" for n in _SDPA}


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements ``t`` reads: a stride-0 (expanded)
    dimension reads its one element once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= int(size)
    return n * t.element_size() if t.numel() else 0


def _dense_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_float(t: torch.Tensor) -> bool:
    return t.dtype.is_floating_point


def _bound_args(func, args, kwargs) -> Dict[str, object]:
    """The op's arguments by schema name."""
    out = dict(kwargs)
    for a, v in zip(func._schema.arguments, args):
        out[a.name] = v
    return out


def _written(func, bound: dict) -> List[torch.Tensor]:
    """The tensor arguments the op writes in place (``out=`` included)."""
    return [t for a in func._schema.arguments
            if a.alias_info is not None and a.alias_info.is_write
            for t in _tensors(bound.get(a.name))]


def _scatter_elems(name: str, bound: dict, target: torch.Tensor) -> int:
    """Elements a scatter-like op writes into ``target``."""
    if name in ("aten::index_put_", "aten::_index_put_impl_"):
        idx, rest, dim = [], 1, 0
        for t in bound["indices"]:
            if t is None:
                rest *= target.shape[dim]
                dim += 1
            else:
                idx.append(t.shape)
                dim += t.dim() if t.dtype == torch.bool else 1
        rest *= _numel(target.shape[dim:])
        n = _numel(torch.broadcast_shapes(*idx)) * rest
        return max(n, bound["values"].numel())
    if name in ("aten::index_add_", "aten::index_copy_"):
        return bound["source"].numel()
    if name == "aten::index_fill_":
        dim = bound["dim"] % max(target.dim(), 1)
        return bound["index"].numel() * (target.numel()
                                         // max(target.shape[dim], 1))
    return bound["index"].numel()       # scatter_, scatter_add_, ...


def _dot_flops(name: str, args, out) -> Optional[float]:
    """Dot FLOPs of a product op, or None for any other op."""
    if name in ("aten::mm", "aten::bmm", "aten::mv", "aten::dot"):
        return 2.0 * max(out.numel(), 1) * args[0].shape[-1]
    if name in ("aten::addmm", "aten::baddbmm", "aten::addmv"):
        return 2.0 * out.numel() * args[1].shape[-1]
    if name == "aten::convolution":
        w = args[1]
        return 2.0 * out.numel() * _numel(w.shape[1:])
    if name in _SDPA or name in _SDPA_BACKWARD:
        # forward QK^T and PV; a backward recomputes QK^T and forms dP, dV,
        # dQ and dK: (3 D + 2 Dv) per pair
        q, k, v = args[0:3] if name in _SDPA else args[1:4]
        pairs = 2.0 * _numel(q.shape[:-2]) * q.shape[-2] * k.shape[-2]
        D, Dv = q.shape[-1], v.shape[-1]
        return pairs * ((D + Dv) if name in _SDPA else (3 * D + 2 * Dv))
    return None


def _dot_class(t: torch.Tensor, tf32: bool) -> str:
    if t.dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    return "tf32" if tf32 and t.dtype == torch.float32 else "f32"


def _group_size(bound: dict) -> int:
    if "group_size" in bound:
        return int(bound["group_size"])
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    if not dist.is_initialized():
        return 1
    return _resolve_process_group(bound["group_name"]).size()


class CostMode(TorchDispatchMode):
    """Counts every operator dispatched while it is active (see the
    module docstring); ``report()`` gives the totals.  It also keeps the
    bytes of the tensors the run allocated that are still alive, and
    their peak (``peak_live_bytes``): the memory the run held above its
    arguments."""

    def __init__(self):
        super().__init__()
        self.tf32 = torch.get_float32_matmul_precision() != "highest"
        self.flops_by_class = {"bf16": 0.0, "tf32": 0.0, "f32": 0.0}
        self.dot_flops = 0.0
        self.kernel_flops = 0.0
        self.bytes = 0.0
        self.coll = dict.fromkeys(COLLECTIVES, 0.0)
        self.ops: Dict[str, Dict[str, float]] = {}
        self.live = 0
        self.peak_live = 0
        # tensors die on the autograd engine's threads too
        self._lock = threading.Lock()

    # ---- live-memory tracking --------------------------------------------
    def _freed(self, nbytes: int) -> None:
        with self._lock:
            self.live -= nbytes

    def _allocated(self, t: torch.Tensor) -> None:
        nbytes = _dense_bytes(t)
        with self._lock:
            self.live += nbytes
            self.peak_live = max(self.peak_live, self.live)
        weakref.finalize(t, self._freed, nbytes)

    # ---- the count --------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # a DTensor runs its op on its local shards (and sends its
            # own collectives): those reach this mode and are counted,
            # per rank
            return NotImplemented
        out = func(*args, **kwargs)
        name = func._schema.name
        if func.is_view or name in _FREE:
            return out
        flops, cls, nbytes = self._count(func, name, args, kwargs, out)
        key = str(func.overloadpacket)
        rec = self.ops.setdefault(key, {"calls": 0, "flops": 0.0,
                                        "bytes": 0.0})
        rec["calls"] += 1
        rec["flops"] += flops
        rec["bytes"] += nbytes
        self.flops_by_class[cls] += flops
        self.bytes += nbytes
        return out

    def _count(self, func, name, args, kwargs, out):
        rets = func._schema.returns
        per_ret = [out] if len(rets) == 1 else list(out)
        fresh = [t for r, o in zip(rets, per_ret) if r.alias_info is None
                 for t in _tensors(o)]
        for t in fresh:
            self._allocated(t)
        outs = sum(_dense_bytes(t) for t in fresh)
        bound = _bound_args(func, args, kwargs)
        inputs = _tensors(list(bound.values()))
        work = kops.KERNEL_WORK.get(name)
        if work is not None:
            flops, cls = work(*args, **kwargs)
            self.kernel_flops += flops
            return flops, cls, sum(map(_distinct_bytes, inputs)) + outs
        if name in _C10D:
            kind = _C10D[name]
            size = _dense_bytes(fresh[0]) if fresh else 0
            self.coll[kind] += wire_bytes(kind, size, _group_size(bound))
            return 0.0, "f32", _distinct_bytes(args[0]) + outs
        if name == _SEND:
            sent = sum(map(_dense_bytes, inputs))
            self.coll["collective-permute"] += wire_bytes(
                "collective-permute", sent, 2)
            return 0.0, "f32", sum(map(_distinct_bytes, inputs))
        dot = _dot_flops(name, args, fresh[0]) if fresh else None
        if dot is not None:
            self.dot_flops += dot
            return (dot, _dot_class(inputs[0], self.tf32),
                    sum(map(_distinct_bytes, inputs)) + outs)
        written = _written(func, bound)
        skip = {id(t) for t in written}
        reads = 0
        if name in _GATHER:
            reads = outs + sum(_distinct_bytes(t) for n, v in bound.items()
                               if n not in ("self", "weight", "input")
                               for t in _tensors(v))
        else:
            for n, v in bound.items():
                for t in _tensors(v):
                    if id(t) in skip and (name in _OVERWRITE
                                          or name in _SCATTER
                                          or n == "out"):
                        continue
                    reads += _distinct_bytes(t)
        writes, flops = outs, sum(t.numel() for t in fresh if _is_float(t))
        for t in written:
            n = (_scatter_elems(name, bound, t) if name in _SCATTER
                 else t.numel())
            wb = n * t.element_size()
            writes += wb
            if name in _ACCUMULATE or (name in _SCATTER
                                       and bound.get("accumulate")):
                reads += wb
            if _is_float(t):
                flops += n
        return float(flops), "f32", reads + writes

    def report(self) -> dict:
        coll = {f"coll_{k}": v for k, v in self.coll.items()}
        return {"flops": sum(self.flops_by_class.values()),
                "bytes": self.bytes,
                "coll_bytes": sum(self.coll.values()), **coll,
                "flops_by_class": dict(self.flops_by_class),
                "dot_flops": self.dot_flops,
                "kernel_flops": self.kernel_flops,
                "peak_live_bytes": self.peak_live,
                "ops": {k: dict(v) for k, v in sorted(self.ops.items())}}


def measure(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under the accountant and under
    ``FlopCounterMode``: (its result, the count).  The count holds
    ``flops`` (all classes), ``bytes``, ``coll_bytes``, ``coll_<kind>``
    (0 on one card), ``flops_by_class``, ``dot_flops``, ``kernel_flops``
    (the port's kernels, by formula), ``peak_live_bytes``, ``ops`` (calls,
    FLOPs and bytes per operator) and ``torch_flop_counter``."""
    with FlopCounterMode(display=False) as fc:
        with CostMode() as cm:
            result = fn(*args, **kwargs)
    return result, {**cm.report(), "torch_flop_counter":
                    float(fc.get_total_flops())}


def analyze(fn, *args, **kwargs) -> dict:
    """The count of ``fn(*args, **kwargs)`` (see ``measure``)."""
    return measure(fn, *args, **kwargs)[1]
