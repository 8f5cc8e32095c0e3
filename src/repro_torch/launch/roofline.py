"""Roofline terms of a counted program on one NVIDIA H100 SXM5 80 GB.

The counterpart of the reference's ``repro.launch.hlo_analysis``: the
byte size of a tensor shape, the wire bytes of collective records, and
the three roofline times of a count.  The reference parses its numbers
out of compiled HLO text; here the accountant of ``launch/costs.py``
hands over a count of the eager program, so only the arithmetic stays.

Collective wire factors per chip, as the reference's (k the group size):

  all-reduce          2 (k-1)/k   (reduce-scatter + all-gather phases)
  all-gather            (k-1)/k   (each chip receives (k-1)/k of result)
  reduce-scatter        (k-1)/k   (of the *input*, = output * (k-1))
  all-to-all            (k-1)/k
  collective-permute    1

``t_compute`` sums over operation classes, each class's operations over
its own peak: a float32 product on the CUDA cores (the CE head and the
attention's QK^T of the plain path) runs at 67 TFLOP/s, not at the bf16
tensor cores' 989, so one bf16 peak would make its bound 15x too small.
The constants are NVIDIA's data-sheet peaks of the H100 SXM5 80 GB
(dense, no sparsity, at the 700 W power limit); ``chip_smoke.py``'s
kernel bounds use the same three.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Tuple, Union

import torch

# H100 SXM5 80 GB peaks (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12       # bf16 / fp16 dense, tensor cores
PEAK_TF32_FLOPS = 494.7e12     # tf32 dense, tensor cores
PEAK_F32_FLOPS = 67e12         # float32 on the CUDA cores
HBM_BW = 3.35e12               # HBM3 bytes/s
NVLINK_BW = 450e9              # NVLink bytes/s, each direction

# the operation classes of a count (``costs.analyze``'s
# ``flops_by_class``) and the peak each runs at
PEAKS = {"bf16": PEAK_BF16_FLOPS, "tf32": PEAK_TF32_FLOPS,
         "f32": PEAK_F32_FLOPS}

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def shape_bytes(shape, dtype: torch.dtype) -> int:
    """Bytes of a dense tensor of ``shape`` and torch ``dtype`` (a bool is
    one byte)."""
    n = 1
    for s in shape:
        n *= int(s)
    return n * torch.empty((), dtype=dtype, device="meta").element_size()


def wire_bytes(kind: str, nbytes: float, group: int) -> float:
    """Per-chip wire bytes of one collective moving ``nbytes`` (its result;
    a reduce-scatter's input) over a group of ``group`` chips."""
    if kind not in COLLECTIVES:
        raise ValueError(f"unknown collective {kind!r}")
    frac = (group - 1) / group if group > 1 else 0.0
    if kind == "all-reduce":
        return 2 * frac * nbytes
    if kind == "reduce-scatter":
        return frac * nbytes * group
    if kind in ("all-gather", "all-to-all"):
        return frac * nbytes
    return float(nbytes)                # collective-permute


def collective_bytes(records: Iterable[Tuple[str, float, int]]
                     ) -> Dict[str, float]:
    """Per-chip wire bytes by kind of ``(kind, bytes, group_size)``
    records, plus their ``total``."""
    out: Dict[str, float] = {}
    for kind, nbytes, group in records:
        out[kind] = out.get(kind, 0.0) + wire_bytes(kind, nbytes, group)
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


def compute_seconds(flops: Union[float, Mapping[str, float]]) -> float:
    """Seconds the card's peaks need for ``flops``: a mapping of operation
    class (``PEAKS``' keys) to operations, or one number of bf16
    tensor-core operations."""
    if not isinstance(flops, Mapping):
        return flops / PEAK_BF16_FLOPS
    return sum(n / PEAKS[c] for c, n in flops.items())


def roofline_terms(flops_per_chip: Union[float, Mapping[str, float]],
                   bytes_per_chip: float,
                   coll_bytes_per_chip: float) -> Dict[str, float]:
    """The reference's roofline record at the H100's peaks: compute time
    (summed over operation classes), HBM time, NVLink time, the dominant
    term, the bound (the largest) and the compute share of the bound."""
    t_c = compute_seconds(flops_per_chip)
    t_m = bytes_per_chip / HBM_BW
    t_x = coll_bytes_per_chip / NVLINK_BW
    dominant = max((t_c, "compute"), (t_m, "memory"), (t_x, "collective"))
    return {"t_compute": t_c, "t_memory": t_m, "t_collective": t_x,
            "dominant": dominant[1],
            "bound": max(t_c, t_m, t_x),
            "compute_fraction": t_c / max(t_c, t_m, t_x, 1e-30)}
