"""Build and load the CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``<build dir>/lib<name>-<hash>.so``, then
loaded with ``ctypes``.  Every source gets ``NVCC_FLAGS`` and its own
entry of ``SOURCE_FLAGS``: the distance kernels are built with
``-fmad=false`` (each squared term rounded as in their plain versions),
flash attention without it (its dot products are fused multiply-adds);
both with ``-Xptxas -v``, and the compiler's output, with ptxas's report
of registers and spills per kernel, is kept beside each library as
``lib<name>-<hash>.log``.  The hash is of the source text, the text of
every local header it includes (``#include "x.cuh"``, followed
recursively) and the source's flags, so an edited source, header or flag
never meets a stale library.  Nothing is built or loaded when this
module is imported: :func:`load` does both at first use, and
:func:`build_all` starts one compiler per source, all at once, for
callers that want every kernel ready up front.

The build directory is ``build/repro_torch`` at the root of the
checkout (``REPRO_TORCH_BUILD_DIR`` overrides it for an installed
package whose directory is not writable).

Listeners added with :func:`add_listener` hear of every compile
(``("compile", seconds=...)``, the compiler's wall time) and every
library load (``("load",)``); ``repro_torch.obs`` counts them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
SOURCE_FLAGS: Dict[str, Tuple[str, ...]] = {
    "pairwise": ("-fmad=false", "-Xptxas", "-v"),
    "flash_attention": ("-Xptxas", "-v"),
}
_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LISTENERS: List[Callable[..., None]] = []


def add_listener(fn: Callable[..., None]) -> None:
    """Call ``fn(event, **info)`` on every compile and library load."""
    _LISTENERS.append(fn)


def _notify(event: str, **info: Any) -> None:
    for fn in _LISTENERS:
        fn(event, **info)


def build_dir() -> Path:
    override = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if override:
        return Path(override)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def sources() -> List[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels cannot be built on this machine")


def flags(name: str) -> Tuple[str, ...]:
    """The nvcc flags of ``csrc/<name>.cu``."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def headers(src: Path) -> List[Path]:
    """The local headers ``src`` includes, directly or through another
    header, in the order first met (system headers are not followed)."""
    found: List[Path] = []
    todo = [src]
    while todo:
        cur = todo.pop(0)
        for inc in _LOCAL_INCLUDE.findall(cur.read_text()):
            path = (cur.parent / inc).resolve()
            if path not in found:
                found.append(path)
                todo.append(path)
    return found


def _target(name: str, src: Optional[Path] = None,
            like: Optional[str] = None) -> Tuple[Path, Path]:
    src = CSRC / f"{name}.cu" if src is None else Path(src)
    if not src.exists():
        raise KeyError(f"no kernel source {src}")
    h = hashlib.sha256(src.read_bytes())
    for path in headers(src):
        h.update(path.read_bytes())
    h.update(" ".join(flags(like or name)).encode())
    return src, build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def log_path(name: str) -> Path:
    """The compiler's output of the current build of ``csrc/<name>.cu``."""
    return _target(name)[1].with_suffix(".log")


def _start(name: str, src: Optional[Path] = None,
           like: Optional[str] = None):
    """Start nvcc for one source unless its library exists.  Returns
    (process or None, temporary output, final library path, start
    time)."""
    src, lib = _target(name, src, like)
    t0 = time.perf_counter()
    if lib.exists():
        return None, None, lib, t0
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *flags(like or name), "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib, t0


def _finish(name: str, proc, tmp, lib, t0: float) -> Path:
    if proc is None:
        return lib
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name} "
                           f"(exit {proc.returncode}):\n{out}")
    lib.with_suffix(".log").write_text(out)
    os.replace(tmp, lib)          # atomic: a reader never sees half a file
    _notify("compile", name=name, seconds=time.perf_counter() - t0)
    return lib


def build_all() -> Dict[str, Path]:
    """Compile every source of ``csrc/`` that has no library yet, one
    compiler process per source, all running together."""
    started = [(name, *_start(name)) for name in sources()]
    return {name: _finish(name, *rest) for name, *rest in started}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(_finish(name, *_start(name))))
        _notify("load", name=name)
    return _LIBS[name]


def load_source(src, name: str, like: str) -> ctypes.CDLL:
    """Build and load another version of a kernel source, ``src`` (a
    path anywhere), as ``lib<name>-<hash>.so`` with the flags of
    ``csrc/<like>.cu``: for timing two versions of a kernel side by side
    in one process."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(_finish(name, *_start(name, src, like))))
        _notify("load", name=name)
    return _LIBS[name]
