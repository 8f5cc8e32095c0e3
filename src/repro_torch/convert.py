"""State carried between numpy (or another package's arrays) and the port.

The clustering state is points, caps and the stage tables.  These
functions build the port's dataclasses from plain numpy fields and turn
them back into numpy, so that stage *k* of the port can be fed with
another implementation's output of stage *k-1* and a fault is found in
the stage that has it.  The LM's state is its parameter tree:
``lm_params_from_numpy`` / ``lm_params_to_numpy`` carry a tree of numpy
arrays in the reference's layout (nested dicts, the blocks a tuple of
dicts stacked on a leading group axis) to tensors and back, so that both
packages compute with the same weights; ``train_state_from_numpy`` /
``train_state_to_numpy`` do the same for a whole train state.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from .core.device_dbscan import DeviceDBSCANResult, GritCaps, OverflowReport
from .core.grids import DeviceGrids

_GRID_DTYPES = {
    "sorted_points": torch.float32, "order": torch.int32,
    "ids": torch.int32, "starts": torch.int32, "counts": torch.int32,
    "point_grid": torch.int32, "num_grids": torch.int32,
    "side": torch.float32, "mins": torch.float32, "overflow": torch.bool}


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=dtype).to(device)


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def lm_params_from_numpy(tree, device="cpu"):
    """The port's LM params from a tree of numpy arrays (or anything
    ``np.asarray`` takes) of the same layout (the expert stacks
    ``[G, E, d, ff]``, the hybrid family's ``"shared"`` block, the rwkv
    ``mu`` stacks alike); each leaf keeps its dtype: float32, or bfloat16
    (arctic's ``param_dtype``; numpy holds it as ``ml_dtypes.bfloat16``,
    carried across bit for bit)."""
    if isinstance(tree, dict):
        return {k: lm_params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(lm_params_from_numpy(v, device) for v in tree)
    a = np.array(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def lm_params_to_numpy(tree):
    """The inverse of :func:`lm_params_from_numpy`."""
    if isinstance(tree, dict):
        return {k: lm_params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(lm_params_to_numpy(v) for v in tree)
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes          # numpy's bfloat16, needed only here
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def train_state_from_numpy(state, device="cpu"):
    """The port's train state from a reference train state in numpy
    (``{"params", "opt", "step"}`` and ``"ef"`` when compressing; the
    optimizer's ``mu`` / ``nu`` (adamw), ``slots`` (adafactor), ``mu``
    (lion) and ``count``), leaf by leaf as :func:`lm_params_from_numpy`
    carries them: every dtype kept, the counts int32 0-d tensors."""
    return lm_params_from_numpy(state, device)


def train_state_to_numpy(state):
    """The inverse of :func:`train_state_from_numpy`."""
    return lm_params_to_numpy(state)


def caps_from_dict(fields: Dict) -> GritCaps:
    """``GritCaps`` from ``dataclasses.asdict`` of any caps object with
    the same field names (unknown keys are rejected by the constructor)."""
    return GritCaps(**fields)


def device_grids_from_numpy(device="cpu", **fields) -> DeviceGrids:
    """``DeviceGrids`` from numpy fields (one keyword per field)."""
    missing = set(DeviceGrids.FIELDS) - set(fields)
    if missing:
        raise ValueError(f"missing DeviceGrids fields: {sorted(missing)}")
    return DeviceGrids(**{f: _tensor(fields[f], _GRID_DTYPES[f], device)
                          for f in DeviceGrids.FIELDS})


def device_grids_to_numpy(dg: DeviceGrids) -> Dict[str, np.ndarray]:
    return {f: _numpy(getattr(dg, f)) for f in DeviceGrids.FIELDS}


def neighbor_table_from_numpy(nbr, nbr_off, device="cpu"
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (nbr, nbr_off) int32 tables of ``device_neighbor_table``."""
    return (_tensor(nbr, torch.int32, device),
            _tensor(nbr_off, torch.int32, device))


def neighbor_table_to_numpy(nbr, nbr_off) -> Tuple[np.ndarray, np.ndarray]:
    return _numpy(nbr), _numpy(nbr_off)


def result_from_numpy(labels, core, point_grid, num_clusters, report,
                      dispatch_tiers, device="cpu") -> DeviceDBSCANResult:
    """``DeviceDBSCANResult`` from numpy fields; ``report`` is the
    boolean overflow vector in ``OverflowReport.FIELDS`` order."""
    vec = _tensor(report, torch.bool, device)
    rep = OverflowReport.from_vector(vec)
    return DeviceDBSCANResult(
        labels=_tensor(labels, torch.int32, device),
        core=_tensor(core, torch.bool, device),
        point_grid=_tensor(point_grid, torch.int32, device),
        num_clusters=_tensor(num_clusters, torch.int32, device),
        overflow=vec.any(), report=rep,
        dispatch_tiers=_tensor(dispatch_tiers, torch.int32, device),
        tier_counts=tuple(int(c) for c in np.asarray(dispatch_tiers)))


def result_to_numpy(res: DeviceDBSCANResult) -> Dict[str, np.ndarray]:
    out = {f.name: _numpy(getattr(res, f.name))
           for f in dataclasses.fields(res)
           if f.name not in ("report", "tier_counts")}   # dispatch_tiers
    out["report"] = _numpy(res.report.as_vector())
    return out
