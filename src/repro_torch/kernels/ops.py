"""Public wrappers of the pairwise-distance and attention kernels.

Seven kernel functions, same signatures and contracts as
``repro.kernels.ops``:

* ``eps_count(a, b, eps, valid_b)``  -> [M] int32
* ``row_min(a, b, valid_b)``         -> ([M] f32, [M] int32)
* ``eps_count_batch(a, b, eps, valid_b, valid_a, stop_at)`` -> [B, M] int32
* ``row_min_batch(a, b, valid_b)``   -> ([B, M] f32, [B, M] int32)
* ``eps_count_band_batch(a, b, eps_lo, eps_hi, valid_b, stop_row)``
  -> ([B, M] int32 hits at ``eps_lo``, [B, M] int32 hits at ``eps_hi``)
* ``row_min2_batch(a, b, valid_b)``  -> ([B, M] f32 min, [B, M] f32
  runner-up, [B, M] int32 first argmin)
* ``flash_attention(q, k, v, causal, window, softcap, scale)`` -> [B, H,
  Sq, D] in q's dtype (blocked online-softmax attention, right-aligned;
  k / v may have fewer heads than q, read through the GQA map)

and the two flat ragged gathers of the resident serving plane,
``pairwise_d2_flat`` / ``pairwise_d2_flat_res``, which are plain
gather-and-reduce in the reference too (no kernel of their own).

Dispatch is by where the tensors live.  CUDA tensors launch the
hand-written kernels of ``csrc/pairwise.cu`` and
``csrc/flash_attention.cu`` (built at first use, see ``build.py``) or
raise: there is no fallback on the card.  CPU tensors take the plain
PyTorch versions in this module (``eps_count_batch_plain``,
``row_min_batch_plain``, ..., ``flash_attention_plain``), which are also
what the kernels are held against on the card.  The ``aa + bb - 2ab``
oracles of ``ref.py`` are for tests; no wrapper calls them.
``flash_attention_plain`` builds its logits and mask with
``ref.masked_logits``, the helper of the attention oracle ``ref.mha``,
so the masking convention lives in one place.

Padding and masking: the kernels take arbitrary ``M``, ``N`` and ``d``
and read the validity masks themselves, so nothing is padded to tile
multiples and no coordinate is folded to a far-away sentinel.  The
distance is ``sum_k (a_k - b_k)^2`` in float32, term by term in the
order of ``k``, in kernel and plain version alike.

``stop_at`` contract: with ``stop_at=k`` the returned counts satisfy
``min(count, k) == min(exact_count, k)`` on every row that ``valid_a``
marks live (values below k are exact; values >= k mean "at least k").
Thresholding at ``>= k`` is therefore exact.  The plain version returns
full counts; the kernel stops scanning a slot once every live row of it
has k hits.  Rows that ``valid_a`` masks receive counts the caller must
ignore.

``stop_row`` contract (``eps_count_band_batch``): a per-row bar on the
lo count.  A row whose returned lo count is below its bar has scanned
every valid candidate, so both of its counts are complete.  A row whose
bar is <= 0 is exempt: the kernel does not scan it and returns 0 for
both of its counts.  The kernel ends a task (a slot's rows, or a split's
share of its candidates) once every other row of it has reached its bar,
checked every 32 candidates.  The plain version returns full counts.

No-candidate contract: a row none of whose candidates is valid reports
``(inf, -1)`` from ``row_min`` / ``row_min_batch`` and ``(inf, inf, -1)``
from ``row_min2_batch``; ties resolve to the lowest candidate index.  The
runner-up is over the remaining candidate slots, so a duplicate of the
minimum makes ``min2 == min``; a row with one valid candidate reports
``(d2, inf, idx)``.

``LAUNCHES`` counts kernel launches per wrapper (nothing else
increments it), so a run can show which kernels its path went through.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import obs
from . import build, ref

LAUNCHES: Dict[str, int] = {"eps_count": 0, "row_min": 0,
                            "eps_count_batch": 0, "row_min_batch": 0,
                            "eps_count_band_batch": 0, "row_min2_batch": 0,
                            "flash_attention": 0}

# the plain versions never hold a [B, P, chunk] tensor above this many
# elements (128 MiB of float32)
PLAIN_CHUNK_ELEMS = 1 << 25
# query rows per slot when one candidate set is shared (unbatched calls)
ROWS_PER_SLOT = 32
# head dims the flash-attention kernel is instantiated for
FLASH_HEAD_DIMS = (16, 32, 64, 80, 128)
_FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _eps2(eps) -> float:
    """eps squared as the float32 both planes compare against."""
    if isinstance(eps, torch.Tensor):
        eps = eps.item()
    e = np.float32(eps)
    return float(e * e)


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------

def _chunk(bp: int, c: int) -> int:
    return max(1, min(c, PLAIN_CHUNK_ELEMS // max(bp, 1)))


def sq_dists_direct(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, P, d] x [B, c, d] -> [B, P, c]: sum_k (a_k - b_k)^2, the terms
    added in the order of k (no [B, P, c, d] tensor is formed).  Also the
    distance of the device pipeline's plain plane."""
    d2 = None
    for k in range(a.shape[-1]):
        t = a[:, :, None, k] - b[:, None, :, k]
        t = t * t
        d2 = t if d2 is None else d2 + t
    if d2 is None:
        d2 = a.new_zeros((a.shape[0], a.shape[1], b.shape[1]))
    return d2


def eps_count_batch_plain(a: torch.Tensor, b: torch.Tensor, eps,
                          valid_b: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain version of :func:`eps_count_batch`: masked direct-difference
    reduce, chunked over candidates; returns full counts."""
    B, P, _ = a.shape
    C = b.shape[1]
    eps2 = _eps2(eps)
    cnt = torch.zeros((B, P), dtype=torch.int32, device=a.device)
    step = _chunk(B * P, C)
    for s in range(0, C, step):
        hit = sq_dists_direct(a, b[:, s:s + step]) <= eps2
        if valid_b is not None:
            hit = hit & valid_b[:, None, s:s + step]
        cnt += hit.sum(dim=2, dtype=torch.int32)
    return cnt


def row_min_batch_plain(a: torch.Tensor, b: torch.Tensor,
                        valid_b: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`row_min_batch`: chunked over candidates,
    strict ``<`` across chunks and first-occurrence ``argmin`` within
    one, so ties resolve to the lowest index."""
    B, P, _ = a.shape
    C = b.shape[1]
    best = torch.full((B, P), torch.inf, dtype=torch.float32, device=a.device)
    arg = torch.full((B, P), -1, dtype=torch.int64, device=a.device)
    step = _chunk(B * P, C)
    for s in range(0, C, step):
        d2 = sq_dists_direct(a, b[:, s:s + step])
        if valid_b is not None:
            d2 = torch.where(valid_b[:, None, s:s + step], d2, torch.inf)
        cmin, carg = d2.min(dim=2)
        better = cmin < best
        best = torch.where(better, cmin, best)
        arg = torch.where(better, carg + s, arg)
    arg = torch.where(torch.isinf(best), torch.full_like(arg, -1), arg)
    return best, arg.to(torch.int32)


def eps_count_band_batch_plain(a: torch.Tensor, b: torch.Tensor, eps_lo,
                               eps_hi, valid_b: Optional[torch.Tensor] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`eps_count_band_batch`: both thresholds'
    counts from one chunked sweep; returns full counts."""
    B, P, _ = a.shape
    C = b.shape[1]
    lo2, hi2 = _eps2(eps_lo), _eps2(eps_hi)
    lo = torch.zeros((B, P), dtype=torch.int32, device=a.device)
    hi = torch.zeros((B, P), dtype=torch.int32, device=a.device)
    step = _chunk(B * P, C)
    for s in range(0, C, step):
        d2 = sq_dists_direct(a, b[:, s:s + step])
        if valid_b is not None:
            d2 = torch.where(valid_b[:, None, s:s + step], d2, torch.inf)
        lo += (d2 <= lo2).sum(dim=2, dtype=torch.int32)
        hi += (d2 <= hi2).sum(dim=2, dtype=torch.int32)
    return lo, hi


def row_min2_batch_plain(a: torch.Tensor, b: torch.Tensor,
                         valid_b: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`row_min2_batch`: the chunked
    ``row_min_batch_plain`` loop with the runner-up merge (the smaller
    of both chunks' runners-up and the loser of the two minima)."""
    B, P, _ = a.shape
    C = b.shape[1]
    best = torch.full((B, P), torch.inf, dtype=torch.float32, device=a.device)
    best2 = torch.full_like(best, torch.inf)
    arg = torch.full((B, P), -1, dtype=torch.int64, device=a.device)
    step = _chunk(B * P, C)
    for s in range(0, C, step):
        d2 = sq_dists_direct(a, b[:, s:s + step])
        if valid_b is not None:
            d2 = torch.where(valid_b[:, None, s:s + step], d2, torch.inf)
        cmin, carg = d2.min(dim=2)
        cols = torch.arange(d2.shape[2], device=a.device)
        d2_wo = torch.where(cols[None, None, :] == carg[:, :, None],
                            torch.inf, d2)
        cmin2 = d2_wo.min(dim=2).values
        better = cmin < best
        loser = torch.maximum(best, cmin)
        best2 = torch.minimum(torch.minimum(best2, cmin2), loser)
        best = torch.where(better, cmin, best)
        arg = torch.where(better, carg + s, arg)
    arg = torch.where(torch.isinf(best), torch.full_like(arg, -1), arg)
    return best, best2, arg.to(torch.int32)


def pairwise_d2_flat(points_res: torch.Tensor, qa: torch.Tensor,
                     rr: torch.Tensor, qo: torch.Tensor,
                     av: torch.Tensor) -> torch.Tensor:
    """Flat ragged candidate distances: [T] float32 squared distances.

    ``points_res`` is the [row_cap, d] float32 resident buffer; ``rr`` /
    ``qo`` [T] int64 give each flat element's resident row and query
    slot; ``qa`` [m, d] float32 holds anchor-centred queries and ``av``
    [T, d] each element's cell anchor, so the subtraction runs on
    stencil-scale coordinates.  The caller reduces the distances per
    segment.  Plain gather-and-reduce, as in the reference (no kernel)."""
    obs.counter("kernels.dispatch.pairwise_d2_flat").inc()
    diff = (points_res[rr] - av) - qa[qo]
    return (diff * diff).sum(dim=1)


def pairwise_d2_flat_res(points_res: torch.Tensor, ra: torch.Tensor,
                         rb: torch.Tensor, av: torch.Tensor) -> torch.Tensor:
    """:func:`pairwise_d2_flat` with both operands resident: ``ra`` /
    ``rb`` [T] int64 pick the two rows of each flat element, both
    re-centred by the same element anchor ``av`` [T, d]."""
    obs.counter("kernels.dispatch.pairwise_d2_flat_res").inc()
    diff = (points_res[ra] - av) - (points_res[rb] - av)
    return (diff * diff).sum(dim=1)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of :func:`flash_attention`: the kernel's function in
    float32 (logits, softmax and the product with v; p stays float32),
    one softmax over all keys per chunk of query rows, the output cast
    to q's dtype.  A row with no live key gives 0, as in the kernel.
    k / v with fewer heads than q are broadcast here (head h reads KV
    head h // (H // H_kv))."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if scale is None:
        scale = D ** -0.5
    if Sk == 0:
        return torch.zeros_like(q)
    out = torch.empty_like(q)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    if k.shape[1] != H:
        kf = kf.repeat_interleave(H // k.shape[1], dim=1)
        vf = vf.repeat_interleave(H // k.shape[1], dim=1)
    step = _chunk(B * H * Sk, Sq)
    for s in range(0, Sq, step):
        logits, mask = ref.masked_logits(
            q[:, :, s:s + step], kf, q_offset=s + Sk - Sq, causal=causal,
            window=window, softcap=softcap, scale=scale)
        p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        o = (p @ vf) / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        o = torch.where(mask.any(dim=-1)[:, None], o, 0.0)
        out[:, :, s:s + step] = o.to(q.dtype)
    return out


# --------------------------------------------------------------------------
# kernel launches
# --------------------------------------------------------------------------

_VP, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_float)


_LIB: Optional[ctypes.CDLL] = None


def declare_distance(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of the four batched distance entries and
    ``grit_pairwise_route`` on a loaded library (this one's, or another
    version of ``csrc/pairwise.cu`` built to be timed beside it)."""
    lib.grit_eps_count_batch.argtypes = [
        _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _LL, _LL, _F, _I, _VP]
    lib.grit_row_min_batch.argtypes = [
        _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _LL, _LL, _VP]
    lib.grit_eps_count_band_batch.argtypes = [
        _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _F, _F, _VP]
    lib.grit_row_min2_batch.argtypes = [
        _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP]
    lib.grit_pairwise_route.argtypes = [_I]
    for fn in (lib.grit_eps_count_batch, lib.grit_row_min_batch,
               lib.grit_eps_count_band_batch, lib.grit_row_min2_batch,
               lib.grit_pairwise_route):
        fn.restype = _I
    return lib


def _lib() -> ctypes.CDLL:
    """The kernel library with its C signatures declared (built and
    loaded at the first launch, never at import)."""
    global _LIB
    if _LIB is None:
        _LIB = declare_distance(build.load("pairwise"))
    return _LIB


def pairwise_route(d: int) -> str:
    """How the built distance kernels (all four batched ones and the
    unbatched pair) stage candidates at feature dim ``d``, as their
    library reports it:
    ``"packed"`` (float4 {x, y, z, index}, d <= 3), ``"planes"`` (one
    plane per coordinate, rows in registers, d <= 8) or ``"wide"``
    (planes, rows read from device memory).  Builds and loads the
    library."""
    return ("packed", "planes", "wide")[_lib().grit_pairwise_route(int(d))]


def _flash_lib() -> ctypes.CDLL:
    """The flash-attention library with its C signature declared."""
    lib = build.load("flash_attention")
    fn = lib.grit_flash_attention
    if fn.argtypes is None:
        fn.argtypes = [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _I,
                       _F, _I, _I, _F, _I, _VP]
        fn.restype = _I
        lib.grit_flash_route.argtypes = [_I, _I]
        lib.grit_flash_route.restype = _I
    return lib


def flash_route(dtype: torch.dtype, head_dim: int) -> str:
    """The route the built flash kernel takes for this input type and head
    dim, as its library reports it: ``"wgmma"`` (bf16, tensor cores, TMA)
    or ``"scalar"`` (float32, CUDA cores: TF32 would miss the reference's
    tolerance).  Builds and loads the library; raises for what the kernel
    does not take."""
    code = _flash_lib().grit_flash_route(_FLASH_DTYPES.get(dtype, -1),
                                         int(head_dim))
    if code < 0:
        raise ValueError(f"flash_attention: no kernel route for {dtype}, "
                         f"head_dim {head_dim}")
    return ("scalar", "wgmma")[code]


def _check(name: str, a, b, valid_b, valid_a, batched: bool):
    """Validate the operands of a kernel launch; returns them as
    (a f32, b f32, valid_b u8, valid_a u8 or None)."""
    nd = 3 if batched else 2
    if a.dim() != nd or b.dim() != nd:
        raise ValueError(f"{name}: a and b must be {nd}-D, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.shape[-1] != b.shape[-1] or a.shape[-1] < 1:
        raise ValueError(f"{name}: feature dims differ or are empty: "
                         f"{tuple(a.shape)} vs {tuple(b.shape)}")
    if batched and a.shape[0] != b.shape[0]:
        raise ValueError(f"{name}: batch sizes differ: {a.shape[0]} vs "
                         f"{b.shape[0]}")
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    if valid_b is None:
        valid_b = torch.ones(b.shape[:-1], dtype=torch.bool, device=b.device)
    masks = [("valid_b", valid_b, b.shape[:-1])]
    if valid_a is not None:
        masks.append(("valid_a", valid_a, a.shape[:-1]))
    for mname, m, shape in masks:
        if m.dtype != torch.bool or tuple(m.shape) != tuple(shape):
            raise ValueError(f"{name}: {mname} must be bool {tuple(shape)}, "
                             f"got {m.dtype} {tuple(m.shape)}")
    for tname, t in [("a", a), ("b", b)] + [(n, m) for n, m, _ in masks]:
        if t.device != a.device:
            raise ValueError(f"{name}: {tname} is on {t.device}, a is on "
                             f"{a.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
    if a.numel() >= 2 ** 31 or b.numel() >= 2 ** 31:
        raise ValueError(f"{name}: operand too large for int32 indexing")
    va = None if valid_a is None else valid_a.view(torch.uint8)
    return a, b, valid_b.view(torch.uint8), va


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed "
                           f"(cudaError {err})")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch_eps_count(name, a, b, vb, va, eps, stop_at, slots, rows_per_slot,
                      rows_total, C, b_stride, vb_stride, out_shape):
    out = torch.empty(out_shape, dtype=torch.int32, device=a.device)
    if rows_total == 0:
        return out
    with torch.cuda.device(a.device):
        err = _lib().grit_eps_count_batch(
            a.data_ptr(), b.data_ptr(), vb.data_ptr(),
            None if va is None else va.data_ptr(), out.data_ptr(),
            slots, rows_per_slot, rows_total, C, a.shape[-1], b_stride,
            vb_stride, _eps2(eps), 0 if stop_at is None else int(stop_at),
            _stream(a.device))
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out


def _launch_row_min(name, a, b, vb, slots, rows_per_slot, rows_total, C,
                    b_stride, vb_stride, out_shape):
    mins = torch.empty(out_shape, dtype=torch.float32, device=a.device)
    args = torch.empty(out_shape, dtype=torch.int32, device=a.device)
    if rows_total == 0:
        return mins, args
    with torch.cuda.device(a.device):
        err = _lib().grit_row_min_batch(
            a.data_ptr(), b.data_ptr(), vb.data_ptr(), mins.data_ptr(),
            args.data_ptr(), slots, rows_per_slot, rows_total, C,
            a.shape[-1], b_stride, vb_stride, _stream(a.device))
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return mins, args


# --------------------------------------------------------------------------
# public wrappers
# --------------------------------------------------------------------------

def eps_count_batch(a: torch.Tensor, b: torch.Tensor, eps,
                    valid_b: Optional[torch.Tensor] = None,
                    valid_a: Optional[torch.Tensor] = None,
                    *, stop_at: Optional[int] = None) -> torch.Tensor:
    """Batched eps-counts: a [B, M, d], b [B, N, d], valid_b [B, N].

    Returns [B, M] int32 counts of valid b-rows of batch slot g within
    ``eps`` of each a-row of slot g.  ``stop_at`` enables the saturating
    early-exit contract (module docstring); ``valid_a`` only feeds that
    exit and lets the kernel skip masked rows."""
    if not a.is_cuda:
        return eps_count_batch_plain(a.to(torch.float32),
                                     b.to(torch.float32), eps, valid_b)
    name = "eps_count_batch"
    a, b, vb, va = _check(name, a, b, valid_b, valid_a, batched=True)
    B, M, d = a.shape
    N = b.shape[1]
    return _launch_eps_count(name, a, b, vb, va, eps, stop_at, B, M, B * M,
                             N, N * d, N, (B, M))


def row_min_batch(a: torch.Tensor, b: torch.Tensor,
                  valid_b: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched :func:`row_min`: a [B, M, d], b [B, N, d], valid_b [B, N].

    Returns ([B, M] f32 min squared distance, [B, M] int32 first argmin
    into slot g's b-rows); a row with no valid candidate reports
    ``(inf, -1)``."""
    if not a.is_cuda:
        return row_min_batch_plain(a.to(torch.float32), b.to(torch.float32),
                                   valid_b)
    name = "row_min_batch"
    a, b, vb, _ = _check(name, a, b, valid_b, None, batched=True)
    B, M, d = a.shape
    N = b.shape[1]
    return _launch_row_min(name, a, b, vb, B, M, B * M, N, N * d, N, (B, M))


def eps_count_band_batch(a: torch.Tensor, b: torch.Tensor, eps_lo, eps_hi,
                         valid_b: Optional[torch.Tensor] = None,
                         stop_row: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-threshold batched eps-counts (a [B, M, d], b [B, N, d]).

    Returns ``(count_lo, count_hi)`` [B, M] int32: hits at
    ``d2 <= eps_lo**2`` and at ``d2 <= eps_hi**2`` (each threshold
    squared in float32) from one sweep over the candidates.
    ``stop_row`` ([B, M] int32) is the per-row saturating bar on the lo
    count (module docstring)."""
    if not a.is_cuda:
        return eps_count_band_batch_plain(a.to(torch.float32),
                                          b.to(torch.float32), eps_lo,
                                          eps_hi, valid_b)
    name = "eps_count_band_batch"
    a, b, vb, _ = _check(name, a, b, valid_b, None, batched=True)
    B, M, d = a.shape
    N = b.shape[1]
    if stop_row is not None:
        if stop_row.dtype != torch.int32 or tuple(stop_row.shape) != (B, M) \
                or stop_row.device != a.device \
                or not stop_row.is_contiguous():
            raise ValueError(f"{name}: stop_row must be a contiguous int32 "
                             f"{(B, M)} tensor on {a.device}, got "
                             f"{stop_row.dtype} {tuple(stop_row.shape)} on "
                             f"{stop_row.device}")
    lo = torch.empty((B, M), dtype=torch.int32, device=a.device)
    hi = torch.empty((B, M), dtype=torch.int32, device=a.device)
    if B * M == 0:
        return lo, hi
    with torch.cuda.device(a.device):
        err = _lib().grit_eps_count_band_batch(
            a.data_ptr(), b.data_ptr(), vb.data_ptr(),
            None if stop_row is None else stop_row.data_ptr(),
            lo.data_ptr(), hi.data_ptr(), B, M, N, d, _eps2(eps_lo),
            _eps2(eps_hi), _stream(a.device))
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return lo, hi


def row_min2_batch(a: torch.Tensor, b: torch.Tensor,
                   valid_b: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched (min, runner-up, first argmin) squared distances: a
    [B, M, d], b [B, N, d], valid_b [B, N] -> ([B, M] f32, [B, M] f32,
    [B, M] int32).  ``min2 - min`` lower-bounds the argmin's margin, the
    guard band's argmin-certainty test (module docstring for the
    no-candidate and tie rules)."""
    if not a.is_cuda:
        return row_min2_batch_plain(a.to(torch.float32), b.to(torch.float32),
                                    valid_b)
    name = "row_min2_batch"
    a, b, vb, _ = _check(name, a, b, valid_b, None, batched=True)
    B, M, d = a.shape
    N = b.shape[1]
    mins = torch.empty((B, M), dtype=torch.float32, device=a.device)
    mins2 = torch.empty((B, M), dtype=torch.float32, device=a.device)
    args = torch.empty((B, M), dtype=torch.int32, device=a.device)
    if B * M == 0:
        return mins, mins2, args
    with torch.cuda.device(a.device):
        err = _lib().grit_row_min2_batch(
            a.data_ptr(), b.data_ptr(), vb.data_ptr(), mins.data_ptr(),
            mins2.data_ptr(), args.data_ptr(), B, M, N, d,
            _stream(a.device))
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return mins, mins2, args


def eps_count(a: torch.Tensor, b: torch.Tensor, eps,
              valid_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Count of b-points within ``eps`` of each a-point: a [M, d],
    b [N, d], valid_b [N] -> [M] int32."""
    if not a.is_cuda:
        vb = None if valid_b is None else valid_b[None]
        return eps_count_batch_plain(a.to(torch.float32)[None],
                                     b.to(torch.float32)[None], eps, vb)[0]
    name = "eps_count"
    a, b, vb, _ = _check(name, a, b, valid_b, None, batched=False)
    M, N = a.shape[0], b.shape[0]
    slots = (M + ROWS_PER_SLOT - 1) // ROWS_PER_SLOT
    return _launch_eps_count(name, a, b, vb, None, eps, None, slots,
                             ROWS_PER_SLOT, M, N, 0, 0, (M,))


def row_min(a: torch.Tensor, b: torch.Tensor,
            valid_b: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (min squared distance, first argmin) into b: a [M, d],
    b [N, d], valid_b [N] -> ([M] f32, [M] int32); ``(inf, -1)`` for a
    row with no valid candidate."""
    if not a.is_cuda:
        vb = None if valid_b is None else valid_b[None]
        mins, args = row_min_batch_plain(a.to(torch.float32)[None],
                                         b.to(torch.float32)[None], vb)
        return mins[0], args[0]
    name = "row_min"
    a, b, vb, _ = _check(name, a, b, valid_b, None, batched=False)
    M, N = a.shape[0], b.shape[0]
    slots = (M + ROWS_PER_SLOT - 1) // ROWS_PER_SLOT
    return _launch_row_min(name, a, b, vb, slots, ROWS_PER_SLOT, M, N, 0, 0,
                           (M,))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Blocked attention. q: [B, H, Sq, D]; k/v: [B, H_kv, Sk, D] with
    ``H % H_kv == 0`` (query head h reads KV head h // (H // H_kv), in
    place on the card) -> [B, H, Sq, D] in q's dtype.

    Query row i is aligned to key position ``i + Sk - Sq``; ``window``
    masks keys with ``q_pos - k_pos >= window``; ``softcap`` is the tanh
    logit soft-cap; ``scale`` defaults to ``D ** -0.5``.  Any Sq and Sk
    (the kernel masks the ragged key tile itself).  On the card: float32
    or bfloat16, all three alike, contiguous, 16-byte aligned, D in
    ``FLASH_HEAD_DIMS``; :func:`flash_route` names the route each type
    takes."""
    name = "flash_attention"
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape) \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] \
            or k.shape[1] < 1 or q.shape[1] % k.shape[1]:
        raise ValueError(f"{name}: expected q [B, H, Sq, D] and k, v "
                         f"[B, H_kv, Sk, D] with H % H_kv == 0, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale)
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    for tname, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name}: {tname} is {t.dtype} on {t.device}, "
                             f"q is {q.dtype} on {q.device}")
    if q.dtype not in _FLASH_DTYPES:
        raise ValueError(f"{name}: the kernel takes float32 or bfloat16, "
                         f"got {q.dtype}")
    if D not in FLASH_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {D} is not one of "
                         f"{FLASH_HEAD_DIMS}")
    for tname, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {tname} must be contiguous and "
                             f"16-byte aligned")
        if t.numel() >= 2 ** 31:
            raise ValueError(f"{name}: {tname} too large for one launch")
    if B * H > 65535:
        raise ValueError(f"{name}: B * H = {B * H} exceeds the grid's 65535")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"{name}: softcap must be > 0, got {softcap}")
    if scale is None:
        scale = D ** -0.5
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    if Sk == 0:
        return out.zero_()            # no live key: the plain version's 0
    with torch.cuda.device(q.device):
        err = _flash_lib().grit_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            k.shape[1], Sq, Sk, D, Sk, Sk - Sq, float(scale),
            int(bool(causal)),
            0 if window is None else int(window),
            0.0 if softcap is None else float(softcap),
            _FLASH_DTYPES[q.dtype], _stream(q.device))
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out
