"""Meshes over ``torch.distributed`` process groups.

The reference's ``repro.launch.mesh`` builds ``jax.sharding.Mesh`` es;
here a mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
process group that exists, one process per rank:

* single pod: 16 x 16 = 256 ranks, dims ("data", "model");
* multi-pod:  2 x 16 x 16 = 512 ranks, dims ("pod", "data", "model");
  "pod" composes with "data" for batch sharding;
* host mesh: ``(world // model_axis, model_axis)`` over the ranks that
  were started (``torchrun``, or spawned processes in the tests).

Every mesh is made by a function call, never at import.  The dry run
makes its production meshes over a fake process group
(:func:`fake_world`): one process plays one rank of 256 or 512 (rank 0
unless it asks for another), the collectives are recorded and move
nothing.

The helpers also take the reference tests' stand-in mesh, any object
with ``axis_names`` and a ``shape`` dict, so the spec builders of
``launch/sharding.py`` run without a process group.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def axis_size(mesh, name: str) -> int:
    names = axis_names(mesh)
    if name not in names:
        return 1
    if isinstance(mesh.shape, dict):
        return int(mesh.shape[name])
    return int(mesh.size(names.index(name)))


def _device_type(device) -> str:
    """``None`` is the card (the port's device rule: it raises without
    one); otherwise the type of the device given."""
    from ..engine.adaptive import resolve_device
    return "cuda" if resolve_device(device).type == "cuda" else "cpu"


def make_mesh(shape, names, device=None):
    """A ``DeviceMesh`` of ``shape`` over ranks ``0 .. prod(shape) - 1``
    of the default process group, rank-major (the last dim varies
    fastest, as ``jax.make_mesh`` lays its devices).  ``device=None``
    lays it over the CUDA devices and raises when there is none, as the
    reference's meshes lie over the devices that exist; pass ``"cpu"``
    for a mesh of CPU ranks."""
    from torch.distributed.device_mesh import DeviceMesh

    device_type = _device_type(device)

    n = 1
    for s in shape:
        n *= int(s)
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks, the "
                         f"process group has {world}")
    return DeviceMesh(device_type,
                      torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """(16, 16) ("data", "model") or (2, 16, 16) ("pod", "data",
    "model"), over a process group of 256 / 512 ranks (the dry run's
    :func:`fake_world`)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_host_mesh(model_axis: int = 1, device=None):
    """``(world // model_axis, model_axis)`` over every rank of the
    process group that exists (``device`` as in :func:`make_mesh`)."""
    n = dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"model_axis {model_axis} does not divide the "
                         f"world of {n} ranks")
    return make_mesh((n // model_axis, model_axis), ("data", "model"),
                     device)


def init_world(backend: str, *, device=None, store_path: Optional[str] = None,
               init_method: Optional[str] = None, rank: Optional[int] = None,
               world_size: Optional[int] = None) -> torch.device:
    """Start the default process group and return this rank's device.

    Without ``store_path`` / ``init_method`` the rank, the world size and
    the rendezvous come from ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); the tests pass a
    ``FileStore`` path and their own rank.  ``device=None`` is CUDA
    device ``LOCAL_RANK`` (the rank itself without it) under NCCL, the
    current CUDA device under gloo, and raises without a card; the
    tests pass ``"cpu"``.  NCCL runs one rank per card: its failures
    raise, nothing switches to gloo."""
    if rank is None:
        rank = int(os.environ["RANK"])
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available: pass "
                               "device=\"cpu\" to run the ranks on the CPU")
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local if backend == "nccl"
                              else torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {}
    if store_path is not None:
        kw["store"] = dist.FileStore(store_path, world_size)
    else:
        kw["init_method"] = init_method or "env://"
    if backend == "nccl":
        kw["device_id"] = device
    dist.init_process_group(backend, rank=rank, world_size=world_size, **kw)
    return device


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A fake process group of ``world_size`` ranks in this process
    (playing ``rank``), for the dry run: collectives are recorded, not
    run.  The group is destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group already exists")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_main(fn, rank, world, backend, device, store_path, out_dir,
               args):
    import pickle
    import traceback

    path = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        dev = init_world(backend, device=device, store_path=store_path,
                         rank=rank, world_size=world)
        try:
            result = fn(rank, world, dev, *args)
        finally:
            dist.destroy_process_group()
        with open(path, "wb") as f:
            pickle.dump(("ok", result), f)
    except BaseException:
        with open(path, "wb") as f:
            pickle.dump(("error", traceback.format_exc()), f)
        raise


def spawn_ranks(fn, world: int, *, backend: str = "gloo", device=None,
                args: tuple = (), timeout: float = 300.0,
                workdir: Optional[str] = None) -> list:
    """Run ``fn(rank, world, device, *args)`` in ``world`` fresh
    processes (the ``spawn`` start method, so each may use CUDA), one
    rank each of a process group of ``backend`` that meets at a
    ``FileStore`` under ``workdir`` (a new temporary directory by
    default): no port is taken.  ``fn`` must be importable by name.
    ``device`` is the ranks' device (``init_world``'s rule).

    Returns the ranks' results in rank order (``fn``'s return value,
    pickled back).  A rank that fails raises here with its traceback;
    when ``timeout`` seconds pass first, every rank is killed and
    ``TimeoutError`` raised."""
    import multiprocessing
    import pickle
    import tempfile
    import time

    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, backend, device, store, tmp,
                                   args), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                failed = [p for p in procs
                          if p.exitcode not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            alive = [p for p in procs if p.is_alive()]
            for p in alive:
                p.kill()
            for p in procs:
                p.join()
        results, errors = [], []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.pkl")
            if not os.path.exists(path):
                errors.append(f"rank {r}: no result (exit code "
                              f"{procs[r].exitcode})")
                continue
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status == "ok":
                results.append(value)
            else:
                errors.append(f"rank {r}:\n{value}")
        if alive and not any("Traceback" in e for e in errors):
            raise TimeoutError(f"{len(alive)} of {world} ranks still ran "
                               f"after {timeout} s; killed")
        if errors:
            raise RuntimeError("\n".join(errors))
        return results
