"""The roofline of the two batched distance kernels of the fit.

Frozen copies, from ``chip_smoke.py`` at commit
2a510f07d994490e1c1c2f354f6b6064be47a8b3, of ``_needed_work``,
``_work_to_bars`` and ``_bound`` (with the two helpers they take from
``src/repro_torch/kernels/ops.py`` at that commit, ``_eps2`` and
``sq_dists_direct``; ``work_to_bars`` sums on the device and reads the
sums once, where the original reads them a slot chunk at a time): the
bytes and float32 operations that the inputs of one call need, every input read once, every output written once,
distances only between live rows and valid candidates, and a count that
ends a row's scan at its bar only up to that bar.  The least time is the
larger of bytes over the card's bandwidth and operations over its
float32 rate (NVIDIA's H100 SXM data sheet, at its 700 W limit).
"""

from __future__ import annotations

import numpy as np
import torch

PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12


def eps2_f32(eps) -> float:
    """eps squared as the float32 both planes compare against."""
    if isinstance(eps, torch.Tensor):
        eps = eps.item()
    e = np.float32(eps)
    return float(e * e)


def sq_dists_direct(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, P, d] x [B, c, d] -> [B, P, c]: sum_k (a_k - b_k)^2, the terms
    added in the order of k."""
    d2 = None
    for k in range(a.shape[-1]):
        t = a[:, :, None, k] - b[:, None, :, k]
        t = t * t
        d2 = t if d2 is None else d2 + t
    if d2 is None:
        d2 = a.new_zeros((a.shape[0], a.shape[1], b.shape[1]))
    return d2


def needed_work(a_rows_live, n_valid, B, P, C, d, with_va):
    """(bytes, f32 operations) the function needs on these inputs: every
    input read once, every output written once; distances only between
    live rows and valid candidates."""
    pairs = float((a_rows_live * n_valid).sum())
    nbytes = (4.0 * d * float(a_rows_live.sum()) + 4.0 * d * float(n_valid.sum())
              + B * C + (B * P if with_va else 0) + 4.0 * B * P)
    return nbytes, 3.0 * d * pairs


def bound(nbytes: float, ops: float):
    """(least milliseconds, what bounds them)."""
    tb, to = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_OPS_S * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def work_to_bars(a, b, vb, eps, bar, row_bytes, n_out, slots=256):
    """(bound ms, by, pairs) of a count kernel that ends a row's scan at
    a per-row bar on its count at ``eps``.  A row needs its valid
    candidates in ascending order up to the one at which its count
    reaches its bar (all of them if it never does, none if its bar is
    <= 0); a slot needs the mask bytes and the candidates' coordinates up
    to the last candidate any of its rows needs; ``row_bytes`` a row are
    read for every row, the coordinates of the rows with a bar above 0,
    and ``n_out`` int32 outputs are written a row."""
    B, P, d = a.shape
    C = b.shape[1]
    e2 = eps2_f32(eps)
    acc = torch.zeros(3, dtype=torch.float64, device=a.device)
    for s in range(0, B, slots):
        vs = vb[s:s + slots]
        bs = bar[s:s + slots].to(torch.int64)
        hit = (sq_dists_direct(a[s:s + slots], b[s:s + slots]) <= e2) \
            & vs[:, None, :]
        reach = hit.cumsum(-1) >= bs[..., None]
        last = torch.where(reach.any(-1), reach.int().argmax(-1), C - 1)
        last = torch.where(bs > 0, last, -1)         # no bar: nothing
        vcum = torch.nn.functional.pad(vs.to(torch.int64).cumsum(-1), (1, 0))
        span = last.max(dim=1).values + 1            # positions per slot
        acc += torch.stack([vcum.gather(1, last + 1).sum(),
                            vcum.gather(1, span[:, None]).sum(),
                            span.sum()]).double()
    pairs, cand, mask = acc.tolist()
    rows = float((bar > 0).sum().item())
    nbytes = 4.0 * d * rows + 4.0 * d * cand + mask \
        + (row_bytes + 4.0 * n_out) * B * P
    return (*bound(nbytes, 3.0 * d * pairs), pairs)


def eps_count_batch_ms(a, b, eps, valid_b=None, valid_a=None, stop_at=None):
    """Least milliseconds of one ``eps_count_batch`` call on these inputs."""
    B, P, d = a.shape
    C = b.shape[1]
    vb = valid_b if valid_b is not None else torch.ones(
        (B, C), dtype=torch.bool, device=a.device)
    va = valid_a if valid_a is not None else torch.ones(
        (B, P), dtype=torch.bool, device=a.device)
    if stop_at:
        return work_to_bars(a, b, vb, eps, torch.where(va, int(stop_at), 0),
                            1, 1)[0]
    live, valid = va.sum(1).double(), vb.sum(1).double()
    return bound(*needed_work(live, valid, B, P, C, d, True))[0]


def row_min_batch_ms(a, b, valid_b=None):
    """Least milliseconds of one ``row_min_batch`` call (two outputs)."""
    B, P, d = a.shape
    C = b.shape[1]
    vb = valid_b if valid_b is not None else torch.ones(
        (B, C), dtype=torch.bool, device=a.device)
    nbytes, nops = needed_work(
        torch.full((B,), float(P), device=a.device).double(),
        vb.sum(1).double(), B, P, C, d, False)
    return bound(nbytes + 4.0 * B * P, nops)[0]
