"""Checkpointing: async, atomic, elastic (placement-agnostic).

Layout of one checkpoint, the reference's (``repro.train.checkpoint``):

  <dir>/step_000123.tmp/        -- written first
      manifest.json             -- step, leaf count, tree structure, extra
      arrays/<idx>.npy          -- one file per leaf (host layout)
  <dir>/step_000123/            -- atomic rename after fsync
  <dir>/LATEST                  -- text file naming the newest step

* **Async**: ``save_async`` copies the leaves to host memory on the
  caller's thread, then serializes on a background thread, so the train
  loop stalls only for the device -> host copy.
* **Atomic**: the manifest and arrays land in a ``.tmp`` dir; the rename
  and the LATEST update happen only after everything is flushed, so a
  mid-write failure never corrupts the restore path.
* **Elastic**: arrays are saved in host layout; ``restore`` places them
  on ``device`` or through the caller's ``place`` hook.
* **Cursor**: the data-pipeline cursor rides in the manifest's ``extra``.
* **Sharded state**: a ``DTensor`` leaf (a mesh run, one process per
  rank) is saved as its whole tensor -- every rank takes part in the
  gather, rank 0 alone writes -- and restored into a ``DTensor``
  template with the template's placements, so a mesh run and a
  one-device run of either package restore each other's checkpoints.

Leaves are numbered in the reference's order (``tree.flatten``: dict keys
sorted, tuples in order, ``None`` dropped), so a checkpoint written by
either package restores into the other's template bit for bit.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from ..engine.adaptive import resolve_device
from .tree import describe, flatten, unflatten


def _writer() -> bool:
    """Whether this process writes checkpoints: rank 0 of the process
    group, or the only process."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _host(leaf: torch.Tensor) -> np.ndarray:
    """A leaf as a host array; bfloat16 as ``ml_dtypes.bfloat16`` (the
    reference's numpy type for it), carried bit for bit.  A ``DTensor``
    is gathered whole first (a collective of every rank,
    ``launch.sharding.gather_leaf``)."""
    from torch.distributed.tensor import DTensor

    from ..launch.sharding import gather_leaf
    if isinstance(leaf, DTensor):
        leaf = gather_leaf(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes          # numpy's bfloat16, needed only here
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _snapshot(state):
    leaves, structure = flatten(state)
    return [_host(l) for l in leaves], describe(structure)


def save(ckpt_dir: str, step: int, state, extra: Optional[dict] = None
         ) -> str:
    """Synchronous atomic save. Returns the final checkpoint path."""
    host, treedef = _snapshot(state)
    return _write(ckpt_dir, step, host, treedef, extra or {})


def save_async(ckpt_dir: str, step: int, state,
               extra: Optional[dict] = None) -> threading.Thread:
    """Device -> host snapshot now; disk write on a background thread."""
    host, treedef = _snapshot(state)
    t = threading.Thread(
        target=_write, args=(ckpt_dir, step, host, treedef, extra or {}),
        daemon=True)
    t.start()
    return t


def _write(ckpt_dir, step, host_leaves, treedef, extra) -> str:
    name = f"step_{step:09d}"
    tmp = os.path.join(ckpt_dir, name + ".tmp")
    final = os.path.join(ckpt_dir, name)
    if not _writer():
        return final
    os.makedirs(os.path.join(tmp, "arrays"), exist_ok=True)
    for i, a in enumerate(host_leaves):
        with open(os.path.join(tmp, "arrays", f"{i}.npy"), "wb") as f:
            np.save(f, a)
            f.flush()
            os.fsync(f.fileno())
    manifest = {
        "step": int(step),
        "num_leaves": len(host_leaves),
        "treedef": treedef,
        "extra": extra,
    }
    mpath = os.path.join(tmp, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    # unique tmp name: concurrent writers (async + emergency sync saves)
    # must not race each other's rename.  Writers that died mid-save
    # leave their tmp behind, so prune stale ones.  The generous age
    # threshold protects a live writer stalled on slow storage: pruning
    # its tmp would turn its os.replace into a lost LATEST update.
    for entry in os.listdir(ckpt_dir):
        if entry.startswith("LATEST.") and entry.endswith(".tmp"):
            stale = os.path.join(ckpt_dir, entry)
            try:
                if time.time() - os.stat(stale).st_mtime > 600.0:
                    os.unlink(stale)
            except OSError:
                pass
    latest_tmp = os.path.join(
        ckpt_dir, f"LATEST.{os.getpid()}.{threading.get_ident()}.tmp")
    with open(latest_tmp, "w") as f:
        f.write(name)
        f.flush()
        os.fsync(f.fileno())
    os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    latest = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        name = f.read().strip()
    path = os.path.join(ckpt_dir, name)
    if not os.path.exists(os.path.join(path, "manifest.json")):
        return None
    return int(name.split("_")[1])


def _tensor(a: np.ndarray, tmpl: torch.Tensor, device) -> torch.Tensor:
    """A host array as a tensor of the template leaf's dtype on
    ``device``, or as a ``DTensor`` of a ``DTensor`` template's
    placements.  bfloat16 comes from its bits: ``np.save`` writes an
    ``ml_dtypes.bfloat16`` array as two-byte voids."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    a = np.asarray(a, order="C")            # keeps a 0-d leaf 0-d
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                      and a.dtype.itemsize == 2):
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    t = t.to(device=device, dtype=tmpl.dtype)
    if isinstance(tmpl, DTensor):
        return distribute_tensor(t, tmpl.device_mesh, tmpl.placements,
                                 src_data_rank=None)
    return t


def restore(ckpt_dir: str, template,
            place: Optional[Callable[[np.ndarray, Any], Any]] = None,
            step: Optional[int] = None, device=None) -> Tuple[Any, dict]:
    """Restore into the structure of ``template``.

    ``place(host_array, template_leaf)`` controls placement; without it
    each leaf becomes a tensor of its template leaf's dtype on ``device``
    (default: the CUDA device, raising when there is none).  Returns
    (state, manifest_extra)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves, structure = flatten(template)
    if manifest["num_leaves"] != len(leaves):
        raise ValueError(f"leaf count mismatch: ckpt "
                         f"{manifest['num_leaves']} vs {len(leaves)}")
    if place is None:
        device = resolve_device(device)
    out = []
    for i, tmpl in enumerate(leaves):
        a = np.load(os.path.join(path, "arrays", f"{i}.npy"))
        if tuple(a.shape) != tuple(tmpl.shape):
            raise ValueError(f"leaf {i}: shape {a.shape} vs template "
                             f"{tuple(tmpl.shape)}")
        out.append(place(a, tmpl) if place is not None
                   else _tensor(a, tmpl, device))
    return unflatten(structure, out), manifest["extra"]


def gc_checkpoints(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` complete checkpoints."""
    if not _writer() or not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
        if n.startswith("step_") and not n.endswith(".tmp")
        and os.path.exists(os.path.join(ckpt_dir, n, "manifest.json")))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:09d}"),
                      ignore_errors=True)
