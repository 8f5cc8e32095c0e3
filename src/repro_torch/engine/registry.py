"""Engine registry: one ``cluster()`` entry point, many backends.

Every clustering backend of the port registers itself here under a
short name (``brute``, ``grit``, ``grit-ldf``, ``device``,
``device-kernels``, ``distributed``) and is invoked through
:func:`cluster` with identical semantics: exact DBSCAN, labels in
original point order.  ``engine="auto"`` picks a backend from the
device the caller asked for (several CUDA devices -> the distributed
pipeline, one -> the kernelized device pipeline, ``device="cpu"`` ->
the host GriT pipeline).

Input validation happens *here*, once, for every engine: empty point
sets, ``n < min_pts`` (every point would be noise -- always a caller
bug) and non-finite coordinates raise ``ValueError`` before any engine
runs, so no backend needs its own guards and all of them fail
identically.

Registering a new engine:

    @register_engine("my-engine", description="...")
    def _my_engine(points, eps, min_pts, *, device=None, **opts): ...

Engines receive host numpy points and must return a
:class:`~repro_torch.engine.result.ClusterResult`; anything cap-bounded
must either resolve overflow itself (adaptive retry) or surface it in
``result.overflow``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from .. import obs
from .adaptive import resolve_device
from .result import ClusterResult


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    name: str
    fn: Callable[..., ClusterResult]
    description: str


_REGISTRY: Dict[str, EngineSpec] = {}


def register_engine(name: str, description: str = ""):
    """Decorator: register ``fn(points, eps, min_pts, **opts)`` under ``name``."""

    def deco(fn: Callable[..., ClusterResult]):
        if name in _REGISTRY:
            raise ValueError(f"engine {name!r} already registered")
        _REGISTRY[name] = EngineSpec(
            name=name, fn=fn,
            description=description or (fn.__doc__ or "").strip())
        return fn

    return deco


def _ensure_loaded() -> None:
    # the built-in engines live in .engines; importing it populates the
    # registry (deferred to break the registry <-> engines import cycle)
    from . import engines  # noqa: F401


def available_engines() -> Tuple[str, ...]:
    _ensure_loaded()
    return tuple(sorted(_REGISTRY))


def get_engine(name: str) -> EngineSpec:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown engine {name!r}; available: {available_engines()}")
    return _REGISTRY[name]


def engine_descriptions() -> Dict[str, str]:
    _ensure_loaded()
    return {n: s.description for n, s in sorted(_REGISTRY.items())}


def resolve_auto(device=None) -> str:
    """Pick a backend for ``engine="auto"``.

    * ``device=None`` with more than one CUDA device visible
                            -> "distributed" (slab sharding + halo, one
                               shard per card, the kernel plane on each)
    * the CUDA device (``device=None`` or a ``cuda`` device)
                            -> "device-kernels" (the device pipeline
                               with the hand-written distance kernels)
    * ``device="cpu"``      -> "grit" (host pipeline, dynamic shapes:
                               fastest on a CPU)

    ``device=None`` without a CUDA device raises, as every entry point
    of the port does.
    """
    if resolve_device(device).type != "cuda":
        return "grit"
    if device is None and torch.cuda.device_count() > 1:
        return "distributed"
    return "device-kernels"


def _attach_index(result: ClusterResult, pts: np.ndarray, eps: float,
                  min_pts: int) -> ClusterResult:
    """Build the fitted :class:`~repro_torch.index.GritIndex` from an
    engine result (the ``return_index=True`` path).

    Host engines already carry the float64 ``GridIndex`` and core flags,
    so this is pure reshuffling; device results trigger a host partition
    rebuild (and, for an engine that reports no core flags, a grid-based
    core identification) inside ``from_fit``.  The caps of the final
    adaptive attempt ride along with the index.
    """
    from ..index import GritIndex
    from ..core.device_dbscan import GritCaps

    caps = None
    if result.attempts:
        names = {f.name for f in dataclasses.fields(GritCaps)}
        kw = {k: v for k, v in result.attempts[-1]["caps"].items()
              if k in names}
        try:
            caps = GritCaps(**kw) if kw else None
        except TypeError:
            caps = None
    index = GritIndex.from_fit(pts, eps, min_pts, labels=result.labels,
                               core=result.core, grid=result.grid,
                               caps=caps)
    result.index = index
    if result.grid is None:
        result.grid = index.fit_grid
    if result.core is None:
        result.core = index.core_arrival()
        result.core_idx = np.flatnonzero(result.core)
    return result


def _check_input(pts: np.ndarray, eps: float, min_pts: int) -> None:
    """The input rules of every engine (``ValueError`` on a breach)."""
    if pts.ndim != 2 or pts.shape[0] == 0:
        raise ValueError(f"points must be [n, d] with n > 0, got {pts.shape}")
    if not (eps > 0):
        raise ValueError(f"eps must be positive, got {eps}")
    if min_pts < 1:
        raise ValueError(f"min_pts must be >= 1, got {min_pts}")
    if pts.shape[0] < min_pts:
        raise ValueError(
            f"n={pts.shape[0]} < min_pts={min_pts}: no point can ever be "
            f"core, every point would come out as noise")
    if not np.isfinite(pts).all():
        bad = int((~np.isfinite(pts).all(axis=1)).sum())
        raise ValueError(
            f"points contain non-finite coordinates ({bad} row(s) with "
            f"NaN/Inf); clean the input before clustering")


def cluster(points, eps: float, min_pts: int, *,
            engine: str = "auto", device=None, return_index: bool = False,
            **opts) -> ClusterResult:
    """Exact DBSCAN via the named engine (the production entry point).

    Args:
      points: [n, d] array-like.
      eps, min_pts: DBSCAN parameters (paper's eps / MinPts).
      engine: registry name, or "auto" (see :func:`resolve_auto`).
      device: where the device engines run.  ``None`` is the CUDA
        device (``RuntimeError`` when there is none); ``"cpu"`` runs the
        same pipeline on the CPU with the kernels' plain versions.
      return_index: also build a fitted
        :class:`~repro_torch.index.GritIndex` (grid partition + core
        flags + labels, ready for ``predict`` / ``insert`` /
        ``snapshot``) and attach it as ``result.index`` -- the
        fit-once / serve-many path, available for every engine.
      **opts: engine-specific options (e.g. ``caps=`` -- see each
        engine's docstring).

    Returns a :class:`ClusterResult`; ``labels[i] >= 0`` is a cluster
    id, ``-1`` noise, in the original order of ``points``.
    """
    with obs.span("engine.cluster") as sp:
        pts = np.asarray(points)
        _check_input(pts, eps, min_pts)
        name = resolve_auto(device) if engine == "auto" else engine
        spec = get_engine(name)
        obs.counter(f"engine.cluster.{name}").inc()
        sp.set(engine=name, n=int(pts.shape[0]), d=int(pts.shape[1]))
        result = spec.fn(pts, float(eps), int(min_pts), device=device,
                         **opts)
        assert result.labels.shape == (pts.shape[0],), \
            f"engine {name}: labels shape {result.labels.shape}"
        if return_index:
            with obs.span("engine.attach_index", engine=name):
                result = _attach_index(result, np.asarray(pts, np.float64),
                                       float(eps), int(min_pts))
    return result
