"""Shared snapshot plumbing for the fitted indexes.

``GritIndex`` and ``ShardedGritIndex`` both serialize as a dict of flat
numpy arrays; the ``.npz`` read/write boilerplate (and the version
guard) used to be copy-pasted between them.  This module is the single
home for it: a snapshot *is* a ``Dict[str, np.ndarray]``, and these
helpers move one between memory and a ``np.savez`` file.
"""

from __future__ import annotations

import zipfile
import zlib
from typing import Dict, Sequence

import numpy as np


def save_snapshot(path, snap: Dict[str, np.ndarray]) -> None:
    """Write a flat-array snapshot dict as one ``.npz`` file/buffer."""
    np.savez(path, **snap)


def load_snapshot(path) -> Dict[str, np.ndarray]:
    """Read a ``.npz`` file/buffer back into a plain snapshot dict.

    A truncated or otherwise corrupt file raises a ``ValueError`` that
    names the file -- a half-written snapshot (crashed writer, partial
    download) must fail loudly at load, not as a ``BadZipFile`` /
    ``zlib.error`` deep inside the array reader.
    """
    try:
        with np.load(path) as data:
            return {k: data[k] for k in data.files}
    except (zipfile.BadZipFile, zlib.error, EOFError, OSError) as e:
        raise ValueError(
            f"snapshot file {path!r} is not a readable .npz "
            f"(truncated or corrupt?): {e}") from e


def check_version(snap: Dict[str, np.ndarray], key: str,
                  accepted: Sequence[int], what: str) -> int:
    """Validate a snapshot's schema version and return it.

    ``accepted`` lists every version ``restore()`` knows how to read
    (older versions stay restorable: missing arrays are rebuilt lazily
    by the caller).  Unknown versions raise, never mis-parse; a mapping
    without the version field (wrong file, truncated writer) raises the
    same clear ``ValueError`` instead of a raw ``KeyError``.
    """
    if key not in snap:
        raise ValueError(
            f"{what} has no {key!r} field -- not a {what} "
            f"(found keys {sorted(snap)[:8]}) or truncated")
    arr = np.asarray(snap[key])
    if arr.size == 0:
        raise ValueError(f"{what} {key!r} field is empty -- truncated?")
    version = int(arr.reshape(-1)[0])
    if version not in tuple(accepted):
        raise ValueError(
            f"{what} version {version} not in supported {tuple(accepted)}")
    return version
