#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--n 1000000] [--seed 0] [--baseline-pairwise PATH]

Needs one CUDA device and ``nvcc``; imports nothing of JAX.  Prints one
JSON object per line, one per phase, and fails (non-zero exit, no
result line) as soon as a phase fails:

  env      torch / CUDA versions, the card's name and power limit
  build    compiles the CUDA kernels of ``repro_torch/kernels/csrc``
  fit      ``cluster(points, eps, min_pts, engine="device-kernels")`` on
           the blobs-3d generator at ``--n`` integer-rounded points
           (MinPts 64, eps by the catalogue's scaling rule): the host
           cap estimate timed alone, the counted main-path run (cold),
           a warm run on the final caps, and a
           run with per-stage timing during which the largest kernel
           call of every candidate width is captured
  kernels  every kernel wrapper against its plain PyTorch version on the
           card: on the captured main-path inputs, on ragged shapes, on
           integer lattices (counts and argmins must be equal) and on
           random reals (d2 within rtol 1e-6), and on the edge shapes of
           the warp-per-slot distance kernels (rows around the lane
           counts, unaligned slabs, 50,000 slots, dead slots between live
           ones, rows saturating stop_at at different candidates, ties
           across phase boundaries, ragged unbatched slots, d = 7);
           eager times (CUDA events around wrapper calls) beside the
           least time the card could take for the same work (with
           stop_at, the work the exit leaves) and, for the
           distance kernels, device times of CUDA-graph replays over
           copies of the operands that exceed the L2 cache
           (``graph_ms``) and an instruction-count estimate of the
           issue-rate floor of their exact arithmetic (``floor_ms``); the
           staging route of each case and the registers and spills of
           every kind of the distance kernel (it fails on a spill at
           d = 3); with ``--baseline-pairwise PATH`` that build of
           ``pairwise.cu`` timed both ways beside this one, in turns
           (``parent_ms``, ``parent_graph_ms``)
  check    (a) engine "device" (plain plane) gives equal labels and core
           flags; (b) core flags and the nearest-core rule recomputed in
           float64 for sampled points against all points; (c) the same
           generator at n = 20,000 conformant to the port's brute engine
  serve    the fitted index on the same data: ``cluster(...,
           return_index=True)`` (fit and attach timed apart), eight
           batches of 2,048 mixed queries in each predict mode (device
           equal to host bit for bit, kernel equal to host on every
           decidable query, host held to the nearest-core rule in float64
           on the card), four steps of 85 % predict / 10 % insert / 5 %
           delete on a host-serving index and a device-resident twin
           (equal after every step) and a fifth with the resident stages'
           gates at 0, each stage's flat-gather and host-twin runs
           counted, and a snapshot round trip
  server   the serve phase's index through ``snapshot()``, restored
           twice, behind two ``ClusterServer``s (8 slots of 2,048
           queries) on one scripted stream from ``--seed``: 96 predict
           requests of log-uniform 1 - 2,048 ``_queries_mixed`` queries,
           two inserts of 204 points and a delete of 104 live arrival
           ids at fixed positions.  A serves in device mode on a
           resident state, B in kernel mode from a read replica that
           catches up from B's mutation log (B must launch
           ``row_min_batch``; its largest call is held against the plain
           version).  Tracing is on for that run: the labels of every
           predict request equal between A and B, the replica's state
           equal to its primary's and the two planes equal, the
           ``serve.step.*`` and ``delta.*`` spans recorded, and per
           server the steps, latency percentiles, queries/s, slot fill,
           the step log's kernel / pack seconds, the growth events and
           the attribution of ``serve.step`` to its children; the Chrome
           trace goes to ``build/chip_smoke_server_trace.json``.  Then
           the stream's predicts again on A with tracing off (no event
           recorded) and on, their median step seconds side by side
  guard_band  the two guard-band kernels (the same warp-per-task kernel
           as the distance kernels, kinds band and min2) against their
           plain versions on the largest kernel-mode predict call, on the
           fit's captured ``eps_count_batch`` inputs with the served
           index's band thresholds (with and without the per-row MinPts
           bar), on integer lattices and on the edge shapes of phase
           ``kernels`` with and without bars (equal), and on random
           reals (a row whose bar is <= 0 must count 0); at the predict
           call and at every fit width (with and without the bar)
           ``ms``, ``graph_ms`` and ``floor_ms`` as in phase
           ``kernels``, bound and floor with the bar counting the (row,
           candidate) pairs each row needs to reach it (``pairs``), and
           with ``--baseline-pairwise`` that build's ``parent_ms`` /
           ``parent_graph_ms``
  flash    the flash-attention kernel against its plain version (float32
           within 2e-4; bfloat16 within 2^-7·|want| + 1e-4 elementwise,
           one bf16 ulp of the output; both with a mean error under 1e-3
           of the mean |want|) at the LM path's shapes
           (qwen2-1.5b prefill with its 2 KV heads read in place and
           after a broadcast to 12, 8,192-token prefill, gemma2's
           windowed soft-capped layer) and at ragged, non-causal, decode,
           chunked-prefix and small-head shapes; each case's route
           (``wgmma`` for bf16, ``scalar`` for float32) as the library
           reports it; CUDA-event times beside the bound and, where one
           call computes the same function,
           ``F.scaled_dot_product_attention`` (``vs_library`` = ms over
           its ms); the bf16 head-dim-128 kernel's registers and spills
           as ptxas reported them and its HGMMA count in the SASS
  lm       qwen2-1.5b at full width (float32 params from a seeded
           generator, bfloat16 activations) served through
           ``launch.serve.serve_requests`` with the flash kernel: (a) the
           reference CLI's traffic (8 requests of 4 - 16 tokens, 4 slots,
           16 new tokens), (b) 4 prompts of 1,500 - 2,048 tokens and one
           of 8,192; 28 flash launches per prefill; then one prefill of
           (b) again with the plain attention path (last-position logits
           within 3e-2 of the largest logit in bfloat16, 1e-3 in float32
           at 4 layers), the flash prefill making no broadcast copy of
           the KV heads; last, (b)'s two batches prefilled again warm, three
           timed calls and one under ``torch.profiler`` (device ms of all
           kernels and of the flash kernel, the device's idle share)

Each phase that drives a path of the port sets the kernels' launch
counts to 0 just before it and reads them just after; the summary's
``launches`` is the sum over the fit's cold run, the serve phase, the
server phase and the lm phase.

The line before the last but one is the kernels' summary object, the
line before the last is the card's name and power limit as nvidia-smi
prints them, and the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s,
# float32 operations/s outside the tensor cores, bf16 tensor-core rate
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
PEAK_BF16_OPS_S = 989e12
# instruction issue of the card's CUDA cores: 132 SMs x 128 lanes at the
# H100 SXM's 1.98 GHz boost clock, lane-instructions per second (an
# assumption: the clock under load is not read); its L2 cache, bytes
PEAK_ISSUE_S = 132 * 128 * 1.98e9
L2_BYTES = 50 * 2 ** 20
MIN_PTS = 64
PAIRWISE_SOURCE = "src/repro_torch/kernels/csrc/pairwise.cu"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
REPLACES = {
    "eps_count_batch": "src/repro/kernels/pairwise.py:164",
    "row_min_batch": "src/repro/kernels/pairwise.py:317",
    "eps_count": "src/repro/kernels/pairwise.py:76",
    "row_min": "src/repro/kernels/pairwise.py:120",
    "eps_count_band_batch": "src/repro/kernels/pairwise.py:208",
    "row_min2_batch": "src/repro/kernels/pairwise.py:270",
    "flash_attention": "src/repro/kernels/flash_attention.py:120",
}
# serving traffic: batches of the serve bench's size, and its mix per
# mutation step (85 % predict, 10 % insert, 5 % delete)
SERVE_BATCH = 2048
SERVE_BATCHES = 8
MUTATION_STEPS = 4
# phase server: the scripted stream and the servers' admission shape
SERVER_PREDICTS = 96
SERVER_INSERT = 204
SERVER_DELETE = 104
SERVER_SLOTS = 8
SERVER_QUERY_CAP = 2048


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` by CUDA events after a warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fns, reps: int = 20, replays: int = 3) -> float:
    """Mean device milliseconds of one call: ``reps`` calls captured in a
    CUDA graph (so no host time lies between the launches), taking the
    closures of ``fns`` in turn, the graph replayed ``replays`` times
    between CUDA events after a warm-up."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * reps)


def distance_call(lib, name, a, b, vb, *rest):
    """``fn()`` that launches ``lib``'s C entry of a distance kernel on
    these operands into outputs allocated once: the same launch as the
    wrapper's, without its host-side checks, so that two builds of
    ``pairwise.cu`` are timed alike.  ``rest`` holds the kernel's own
    operands: ``eps_count_batch`` (valid_a, eps, stop_at),
    ``eps_count_band_batch`` (stop_row, eps_lo, eps_hi), none for
    ``row_min_batch`` and ``row_min2_batch``.  2-d operands (a [M, d],
    b [N, d]) take the unbatched functions' launch: slots of
    ``ROWS_PER_SLOT`` rows sharing b."""
    from repro_torch.kernels.ops import ROWS_PER_SLOT, _eps2
    if a.dim() == 2:
        M, d = a.shape
        C = b.shape[0]
        B, P, rows, b_stride, vb_stride = ((M + ROWS_PER_SLOT - 1)
                                           // ROWS_PER_SLOT, ROWS_PER_SLOT,
                                           M, 0, 0)
    else:
        B, P, d = a.shape
        C = b.shape[1]
        rows, b_stride, vb_stride = B * P, C * d, C
    vbu = vb.view(torch.uint8)
    ptr = lambda x: None if x is None else x.data_ptr()
    stream = lambda: torch.cuda.current_stream().cuda_stream
    new = lambda dtype: torch.empty((rows,), dtype=dtype, device=a.device)

    def checked(launch):
        def fn():
            err = launch()
            require(err == 0, f"{name}: launch failed ({err})")
        return fn

    if name == "eps_count_batch":
        va, eps, stop_at = rest
        vau = None if va is None else va.view(torch.uint8)
        out, eps2 = new(torch.int32), _eps2(eps)
        return checked(lambda: lib.grit_eps_count_batch(
            a.data_ptr(), b.data_ptr(), vbu.data_ptr(), ptr(vau),
            out.data_ptr(), B, P, rows, C, d, b_stride, vb_stride, eps2,
            0 if stop_at is None else int(stop_at), stream()))
    if name == "eps_count_band_batch":
        stop_row, eps_lo, eps_hi = rest
        lo, hi = new(torch.int32), new(torch.int32)
        lo2, hi2 = _eps2(eps_lo), _eps2(eps_hi)
        return checked(lambda: lib.grit_eps_count_band_batch(
            a.data_ptr(), b.data_ptr(), vbu.data_ptr(), ptr(stop_row),
            lo.data_ptr(), hi.data_ptr(), B, P, C, d, lo2, hi2, stream()))
    mins, args = new(torch.float32), new(torch.int32)
    if name == "row_min2_batch":
        mins2 = new(torch.float32)
        return checked(lambda: lib.grit_row_min2_batch(
            a.data_ptr(), b.data_ptr(), vbu.data_ptr(), mins.data_ptr(),
            mins2.data_ptr(), args.data_ptr(), B, P, C, d, stream()))
    return checked(lambda: lib.grit_row_min_batch(
        a.data_ptr(), b.data_ptr(), vbu.data_ptr(), mins.data_ptr(),
        args.data_ptr(), B, P, rows, C, d, b_stride, vb_stride, stream()))


def rotation(args):
    """Copies of a distance call's tensor operands (scalars shared) that
    together touch three times the card's L2 cache, so that launches
    taking them in turn read device memory as the main path does, not the
    previous launch's bytes from L2.  Touched bytes: every tensor operand
    but the candidates (rows, masks, bars), and the coordinates of the
    valid candidates."""
    a, b, vb = args[:3]
    d = a.shape[-1]
    touched = (sum(x.numel() * x.element_size() for x in args
                   if isinstance(x, torch.Tensor) and x is not b)
               + 4 * d * int(vb.sum()))
    k = max(1, min(16, -(-3 * L2_BYTES // max(touched, 1))))
    clone = lambda x: x.clone() if isinstance(x, torch.Tensor) else x
    return [args] + [tuple(clone(x) for x in args) for _ in range(k - 1)]


@contextlib.contextmanager
def pairwise_lib(lib):
    """The distance wrappers of ``kernels.ops`` launching ``lib`` (another
    build of ``pairwise.cu``) instead of the port's library."""
    from repro_torch.kernels import ops
    saved = ops._lib()
    ops._LIB = lib
    try:
        yield
    finally:
        ops._LIB = saved


def time_distance(lib, baseline, name, args, wrapper):
    """Times of one distance call on ``args`` (``distance_call``'s
    operands): ``ms``, the eager ``wrapper()`` by CUDA events (host work
    included; the time this script reports for every kernel), and
    ``graph_ms``, the C entry of ``lib`` launched back to back in a CUDA
    graph over the operands' ``rotation``.  With a ``baseline`` build also
    ``parent_ms`` and ``parent_graph_ms`` the same ways, the two builds
    timed in turns (new, parent, new, parent) and averaged."""
    rot = rotation(args)
    new = [distance_call(lib, name, *x) for x in rot]
    if baseline is None:
        return {"ms": cuda_ms(wrapper), "graph_ms": graph_ms(new)}
    old = [distance_call(baseline, name, *x) for x in rot]
    t = {"ms": [], "graph_ms": [], "parent_ms": [], "parent_graph_ms": []}
    for _ in range(2):
        t["ms"].append(cuda_ms(wrapper))
        t["graph_ms"].append(graph_ms(new))
        with pairwise_lib(baseline):
            t["parent_ms"].append(cuda_ms(wrapper))
        t["parent_graph_ms"].append(graph_ms(old))
    return {k: float(np.mean(v)) for k, v in t.items()}


# instructions of a (row, candidate) pair's decision, per kernel kind
DECISION_INSTR = {"eps_count": 2, "row_min": 3, "eps_count_band": 4,
                  "row_min2": 5}


def floor_ms(name: str, pairs: float, d: int, P: int) -> float:
    """An estimate, from an instruction count, of the issue-rate floor of
    the exact distance form: ``pairs`` (live row, valid candidate) pairs
    at 3d - 1 f32 instructions each (d subtractions, d multiplies, d - 1
    adds: no fused multiply-add, so each term is rounded as in the plain
    version) plus the decision (``DECISION_INSTR``: eps_count a hit test
    and its add, eps_count_band two of each, row_min a compare and two
    selects, row_min2 those and a min and a max) plus a share of the
    broadcast candidate load (1/2 where a lane holds two of a slot's
    P > 32 rows, else 1): 11.5 instructions a pair for row_min_batch at
    d = 3, over ``PEAK_ISSUE_S`` lane-instructions a second, which
    assumes the boost clock (the SM clock under load is not read)."""
    per_pair = (3 * d - 1 + DECISION_INSTR[name.removesuffix("_batch")]
                + (0.5 if P > 32 else 1.0))
    return pairs * per_pair / PEAK_ISSUE_S * 1e3


# the kinds of ``dist_kernel<K, D>`` in the order of ``pairwise.cu``'s
# ``enum Kind``
PAIRWISE_KINDS = ("eps_count", "row_min", "eps_count_band", "row_min2")


def pairwise_build_report():
    """The distance kernels as built: per instantiation of
    ``dist_kernel<K, D>`` (kind K of ``PAIRWISE_KINDS``, D = 0 the
    generic d > 5 one) its registers, stack and spill bytes from the
    ptxas report that the build keeps beside the library."""
    from repro_torch.kernels import build
    rep = {}
    lines = build.log_path("pairwise").read_text().splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '\S*dist_kernelILi(\d)ELi(\d)E",
                      line)
        if not m:
            continue
        key = f"{PAIRWISE_KINDS[int(m.group(1))]}_d{m.group(2)}"
        row = {}
        for nxt in lines[i + 1:i + 4]:
            s = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", nxt)
            if s:
                row.update(stack_bytes=int(s.group(1)),
                           spill_store_bytes=int(s.group(2)),
                           spill_load_bytes=int(s.group(3)))
            r = re.search(r"Used (\d+) registers", nxt)
            if r:
                row["registers"] = int(r.group(1))
        rep[key] = row
    for key in (f"{kind}_d3" for kind in PAIRWISE_KINDS):
        require(key in rep and "registers" in rep[key],
                f"no ptxas report of {key} in the build log")
        require(rep[key]["spill_store_bytes"] == 0
                and rep[key]["spill_load_bytes"] == 0,
                f"the d = 3 {key} kernel spills registers: {rep[key]}")
    return rep


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

def make_points(n: int, seed: int):
    """blobs-3d at ``n`` points on the integer domain [0, 1e5]^3, eps by
    the catalogue's occupancy-preserving rule eps * (n_ref / n)^(1/d)."""
    from repro_torch.data.scenarios import get_scenario
    sc = get_scenario("blobs-3d")
    eps = sc.eps * (sc.n / n) ** (1.0 / sc.d)
    eps = math.floor(eps) + 0.5          # 150.9 -> 150.5 at n = 1e6
    pts = np.rint(sc.points(seed=seed, n=n))
    return pts, float(eps)


# --------------------------------------------------------------------------
# kernels vs their plain versions
# --------------------------------------------------------------------------

def _needed_work(a_rows_live, n_valid, B, P, C, d, with_va):
    """(bytes, f32 operations) the function needs on these inputs: every
    input read once, every output written once; distances only between
    live rows and valid candidates."""
    pairs = float((a_rows_live * n_valid).sum())
    nbytes = (4.0 * d * float(a_rows_live.sum()) + 4.0 * d * float(n_valid.sum())
              + B * C + (B * P if with_va else 0) + 4.0 * B * P)
    return nbytes, 3.0 * d * pairs


def _work_to_bars(a, b, vb, eps, bar, row_bytes, n_out, slots=256):
    """(bound ms, by, pairs) of a count kernel that ends a row's scan at
    a per-row bar on its count at ``eps`` (``eps_count_batch``'s stop_at
    on the rows that valid_a marks, the band's stop_row): the work these
    inputs need.  A row needs its valid candidates in ascending order up
    to the one at which its count reaches its bar (all of them if it
    never does, none if its bar is <= 0); a slot needs the mask bytes and
    the candidates' coordinates up to the last candidate any of its rows
    needs; ``row_bytes`` a row are read for every row (valid_a or the
    bar), the coordinates of the rows with a bar above 0, and ``n_out``
    int32 outputs are written a row."""
    from repro_torch.kernels.ops import _eps2, sq_dists_direct
    B, P, d = a.shape
    C = b.shape[1]
    e2 = _eps2(eps)
    pairs = cand = mask = 0.0
    for s in range(0, B, slots):
        vs = vb[s:s + slots]
        bs = bar[s:s + slots].to(torch.int64)
        hit = (sq_dists_direct(a[s:s + slots], b[s:s + slots]) <= e2) \
            & vs[:, None, :]
        reach = hit.cumsum(-1) >= bs[..., None]
        last = torch.where(reach.any(-1), reach.int().argmax(-1), C - 1)
        last = torch.where(bs > 0, last, -1)         # no bar: nothing
        vcum = torch.nn.functional.pad(vs.to(torch.int64).cumsum(-1), (1, 0))
        pairs += float(vcum.gather(1, last + 1).sum().item())
        span = last.max(dim=1).values + 1            # positions per slot
        cand += float(vcum.gather(1, span[:, None]).sum().item())
        mask += float(span.sum().item())
    rows = float((bar > 0).sum().item())
    nbytes = 4.0 * d * rows + 4.0 * d * cand + mask \
        + (row_bytes + 4.0 * n_out) * B * P
    return (*_bound(nbytes, 3.0 * d * pairs), pairs)


def _bound(nbytes: float, ops: float):
    tb, to = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_OPS_S * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def compare_eps_count(ops_mod, a, b, eps, vb, va, stop_at, batched):
    """Launch the wrapper, hold it against the plain version (both
    saturated at ``stop_at``).  Returns the max abs count difference on
    live rows."""
    from repro_torch.kernels.ops import eps_count_batch_plain
    if batched:
        got = ops_mod.eps_count_batch(a, b, eps, vb, va, stop_at=stop_at)
        a3, b3, vb3 = a, b, vb
    else:
        got = ops_mod.eps_count(a, b, eps, vb)[None]
        a3, b3, vb3 = a[None], b[None], None if vb is None else vb[None]
    torch.cuda.synchronize()
    want = eps_count_batch_plain(a3, b3, eps, vb3)
    live = torch.ones_like(want, dtype=torch.bool) if va is None else va
    if stop_at is not None:
        got, want = got.clamp(max=stop_at), want.clamp(max=stop_at)
    diff = ((got - want).abs() * live).max().item() if want.numel() else 0
    return int(diff)


def compare_row_min(ops_mod, a, b, vb, batched):
    from repro_torch.kernels.ops import row_min_batch_plain
    if batched:
        gm, gi = ops_mod.row_min_batch(a, b, vb)
        a3, b3, vb3 = a, b, vb
    else:
        gm, gi = ops_mod.row_min(a, b, vb)
        gm, gi = gm[None], gi[None]
        a3, b3, vb3 = a[None], b[None], None if vb is None else vb[None]
    torch.cuda.synchronize()
    wm, wi = row_min_batch_plain(a3, b3, vb3)
    require(bool((torch.isinf(gm) == torch.isinf(wm)).all()),
            "row_min: (inf, -1) rows differ from the plain version")
    fin = ~torch.isinf(wm)
    err = ((gm - wm).abs() * fin).nan_to_num(0.0).max().item() \
        if wm.numel() else 0.0
    rel_ok = bool((((gm - wm).abs() <= 1e-6 * wm.abs()) | ~fin).all())
    arg_mismatch = int((gi != wi).sum().item())
    return err, rel_ok, arg_mismatch


def lattice_inputs(B, P, C, d, seed, dev, dup=False, dead_every=0,
                   pair_dups=False):
    """Integer coordinates (float32-exact distances), random masks, one
    all-masked slot when B > 1, optional duplicated candidates (the
    second half repeating the first; with ``pair_dups`` also each odd
    candidate repeating the even one before it, so a tie straddles every
    phase boundary), and with ``dead_every`` = k every k-th slot without
    a live row and every k-th (shifted by one) without a valid candidate,
    interleaved with live ones."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-40, 40, size=(B, P, d)).astype(np.float32)
    b = rng.integers(-40, 40, size=(B, C, d)).astype(np.float32)
    if dup and C > 1:
        b[:, C // 2:] = b[:, :C - C // 2]
    if pair_dups and C > 1:
        b[:, 1::2] = b[:, 0:C - 1:2]
    vb = rng.uniform(size=(B, C)) > 0.3
    va = rng.uniform(size=(B, P)) > 0.2
    if B > 1:
        vb[0] = False
    if dead_every:
        va[::dead_every] = False
        vb[1::dead_every] = False
    t = lambda x: torch.as_tensor(x).to(dev)
    return t(a), t(b), t(vb), t(va)


# edge shapes of the warp-per-slot design: (B, P, C, d, dead_every,
# pair_dups); rows per slot around the lane counts (8: rows x phases,
# 31 / 32 / 33: one or two rows a lane, 63 / 127 / 200: several 64-row
# tasks), candidate widths that leave every slot's slab unaligned (37,
# 513), more slots than resident warps, d = 7 (planes, generic route)
EDGE_SHAPES = [(6, 8, 301, 3, 2, True), (6, 31, 300, 3, 3, True),
               (6, 32, 513, 3, 2, False), (6, 33, 37, 3, 2, True),
               (5, 63, 1029, 3, 2, True), (4, 127, 600, 3, 2, False),
               (3, 200, 700, 3, 0, True), (50_000, 8, 37, 3, 2, True),
               (4, 40, 301, 7, 2, True), (3, 5, 1100, 7, 0, True),
               (4, 63, 777, 4, 2, True), (4, 33, 515, 5, 2, True)]


def stop_lattice(dev):
    """Rows that reach stop_at at different candidates and in different
    slots (so different warps): 1-d candidates 0 .. C-1, slot g's rows
    spread along the line with an offset of its own."""
    B, P, C = 64, 40, 1500
    b = np.broadcast_to(np.arange(C, dtype=np.float32)[None, :, None],
                        (B, C, 1)).copy()
    rng = np.random.default_rng(11)
    a = (rng.integers(0, C, size=(B, P, 1))).astype(np.float32)
    vb = np.ones((B, C), bool)
    va = rng.uniform(size=(B, P)) > 0.1
    t = lambda x: torch.as_tensor(x).to(dev)
    return t(a), t(b), t(vb), t(va)


def kernels_phase(captured, dev, baseline=None):
    from repro_torch.kernels import ops
    from repro_torch.kernels.ops import (eps_count_batch_plain,
                                         row_min_batch_plain)
    shapes = [(1, 1, 1, 1), (3, 5, 7, 2), (2, 17, 130, 3), (4, 127, 129, 4),
              (2, 64, 1300, 5), (3, 63, 600, 3), (2, 9, 260, 7)]
    cases = 0
    routes = {}
    # 1. integer lattices: everything equal, whatever the thread layout
    for i, (B, P, C, d) in enumerate(shapes):
        routes[f"{B}x{P}x{C}x{d}"] = ops.pairwise_route(d)
        for dup in (False, True):
            a, b, vb, va = lattice_inputs(B, P, C, d, 100 + i, dev, dup)
            eps = 17.0
            for stop_at in (None, 1, 5):
                diff = compare_eps_count(ops, a, b, eps, vb, va, stop_at,
                                         True)
                require(diff == 0, f"eps_count_batch differs on lattice "
                        f"{(B, P, C, d)} stop_at={stop_at}: {diff}")
            err, _, mism = compare_row_min(ops, a, b, vb, True)
            require(err == 0.0 and mism == 0, f"row_min_batch differs on "
                    f"lattice {(B, P, C, d)} dup={dup}: err={err} "
                    f"argmin mismatches={mism}")
            diff = compare_eps_count(ops, a[-1], b[-1], eps, vb[-1], None,
                                     None, False)
            require(diff == 0, f"eps_count differs on lattice {(P, C, d)}")
            err, _, mism = compare_row_min(ops, a[-1], b[-1], vb[-1], False)
            require(err == 0.0 and mism == 0,
                    f"row_min differs on lattice {(P, C, d)}")
            cases += 4
    # 1b. the edge shapes of the warp-per-slot design, on lattices
    for i, (B, P, C, d, dead, pairs) in enumerate(EDGE_SHAPES):
        routes[f"{B}x{P}x{C}x{d}"] = ops.pairwise_route(d)
        a, b, vb, va = lattice_inputs(B, P, C, d, 300 + i, dev, True, dead,
                                      pairs)
        for stop_at in (None, 1, 5, 40):
            diff = compare_eps_count(ops, a, b, 17.0, vb, va, stop_at, True)
            require(diff == 0, f"eps_count_batch differs on edge lattice "
                    f"{(B, P, C, d)} stop_at={stop_at}: {diff}")
        err, _, mism = compare_row_min(ops, a, b, vb, True)
        require(err == 0.0 and mism == 0, f"row_min_batch differs on edge "
                f"lattice {(B, P, C, d)}: err={err} argmin={mism}")
        cases += 5
    a, b, vb, va = stop_lattice(dev)
    for stop_at in (1, 3, 7, 20):
        diff = compare_eps_count(ops, a, b, 6.0, vb, va, stop_at, True)
        require(diff == 0, f"eps_count_batch differs where rows saturate "
                f"at different candidates, stop_at={stop_at}: {diff}")
        cases += 1
    for M in (33, 1000):                # the unbatched pair, ragged slots
        a, b, vb, _ = lattice_inputs(1, M, 777, 3, 400 + M, dev, True, 0,
                                     True)
        diff = compare_eps_count(ops, a[0], b[0], 17.0, vb[0], None, None,
                                 False)
        err, _, mism = compare_row_min(ops, a[0], b[0], vb[0], False)
        require(diff == 0 and err == 0.0 and mism == 0,
                f"unbatched pair differs at M = {M}: count {diff}, "
                f"d2 {err}, argmin {mism}")
        cases += 2
    # 2. the exact-eps tie lattice: d2 == eps2 counts as a hit, and the
    # nearest candidate at exactly eps is found
    n = 700
    bl = torch.zeros((n, 2), device=dev)
    bl[:, 0] = torch.arange(n, device=dev, dtype=torch.float32)
    al = torch.zeros((2, 2), device=dev)
    al[0, 0], al[1, 0] = 6.0, 515.0
    want = ((al[:, None, 0] - bl[None, :, 0]) ** 2 <= 36.0).sum(1).to(torch.int32)
    require(torch.equal(ops.eps_count(al, bl, 6.0), want)
            and torch.equal(ops.eps_count_batch(al[None], bl[None], 6.0)[0],
                            want), "exact-eps ties are not counted as hits")
    only = (torch.arange(n, device=dev) == 521)
    m, i = ops.row_min_batch(al[None], bl[None], only[None])
    require(float(m[0, 1]) == 36.0 and int(i[0, 1]) == 521,
            "row_min_batch misses the candidate at exactly eps")
    cases += 3
    # thresholds that the kernels' integer hit test takes only as the C
    # entries map them: a NaN eps counts nothing, eps 0 the d2 == 0 hits
    from repro_torch.kernels.ops import eps_count_band_batch_plain
    nan = float("nan")
    require(torch.equal(ops.eps_count_batch(al[None], bl[None], nan),
                        eps_count_batch_plain(al[None], bl[None], nan))
            and torch.equal(ops.eps_count_batch(al[None], bl[None], 0.0),
                            eps_count_batch_plain(al[None], bl[None], 0.0)),
            "eps_count_batch differs from its plain version at eps NaN or 0")
    got = ops.eps_count_band_batch(al[None], bl[None], nan, 0.0)
    want = eps_count_band_batch_plain(al[None], bl[None], nan, 0.0)
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            "eps_count_band_batch differs from its plain version at "
            "thresholds NaN and 0")
    cases += 3
    # 3. random reals: d2 within rtol 1e-6; count differences only on
    # rows that hold a candidate within that band of eps^2
    band_rows = 0
    for i, (B, P, C, d) in enumerate(shapes):
        rng = np.random.default_rng(200 + i)
        a = torch.as_tensor(rng.normal(size=(B, P, d)) * 10,
                            dtype=torch.float32).to(dev)
        b = torch.as_tensor(rng.normal(size=(B, C, d)) * 10,
                            dtype=torch.float32).to(dev)
        vb = torch.as_tensor(rng.uniform(size=(B, C)) > 0.3).to(dev)
        eps = 6.0
        got = ops.eps_count_batch(a, b, eps, vb)
        want = eps_count_batch_plain(a, b, eps, vb)
        d2 = ops.sq_dists_direct(a, b)
        near = ((d2 - 36.0).abs() <= 36.0 * 1e-6) & vb[:, None, :]
        in_band = near.any(dim=2)
        band_rows += int(in_band.sum().item())
        require(bool(((got == want) | in_band).all()),
                f"eps_count_batch differs outside the eps band {(B, P, C, d)}")
        err, rel_ok, mism = compare_row_min(ops, a, b, vb, True)
        require(rel_ok, f"row_min_batch d2 beyond rtol 1e-6 {(B, P, C, d)}")
        cases += 2

    # 4. main-path inputs (the largest call of every candidate width the
    # fit swept, captured from it) and the unbatched pair at a size of
    # its own: compare, then time (``time_distance``: ms eager as for
    # every kernel, graph_ms device time over rotated copies, parent_*
    # beside them when a baseline build is given).  floor_ms is an
    # instruction-count estimate (``floor_ms``), not a measurement.  The
    # summary row of a batched kernel is the width the fit called most
    # often (the widest among equals); main_path sums calls x each time
    # over the widths.
    lib = ops._lib()
    rows, tiers = [], {"eps_count_batch": [], "row_min_batch": []}

    def timed(name, args, wrapper, plain, row):
        row.update(time_distance(lib, baseline, name, args, wrapper))
        row["plain_ms"] = cuda_ms(plain, reps=2, warmup=1)
        return row

    for C in sorted(captured["eps_count_batch"]):
        (a, b, vb, va, eps, stop_at), calls = captured["eps_count_batch"][C]
        B, P, d = a.shape
        diff = compare_eps_count(ops, a, b, eps, vb, va, stop_at, True)
        require(diff == 0, f"eps_count_batch differs from its plain version "
                f"on the main path's inputs at width {C}: {diff}")
        if stop_at:     # the work the exit at stop_at leaves
            bound, by, pairs = _work_to_bars(
                a, b, vb, eps, torch.where(va, int(stop_at), 0), 1, 1)
        else:
            live, valid = va.sum(1).double(), vb.sum(1).double()
            bound, by = _bound(*_needed_work(live, valid, B, P, C, d, True))
            pairs = float((live * valid).sum())
        tiers["eps_count_batch"].append(timed(
            "eps_count_batch", (a, b, vb, va, eps, stop_at),
            lambda: ops.eps_count_batch(a, b, eps, vb, va, stop_at=stop_at),
            lambda: eps_count_batch_plain(a, b, eps, vb),
            dict(name="eps_count_batch", shape=[B, P, C, d], calls=calls,
                 kernel_route=ops.pairwise_route(d), max_abs_err=float(diff),
                 bound_ms=bound, bound_by=by,
                 floor_ms=floor_ms("eps_count_batch", pairs, d, P))))
    for C in sorted(captured["row_min_batch"]):
        (a, b, vb), calls = captured["row_min_batch"][C]
        B, P, d = a.shape
        err, rel_ok, mism = compare_row_min(ops, a, b, vb, True)
        require(err == 0.0 and mism == 0, f"row_min_batch differs from its "
                f"plain version on the main path's inputs at width {C}: "
                f"err={err} argmin={mism}")
        valid = vb.sum(1).double()
        nbytes, nops = _needed_work(
            torch.full((B,), float(P), device=dev).double(), valid, B, P, C,
            d, False)
        bound, by = _bound(nbytes + 4.0 * B * P, nops)    # second output
        tiers["row_min_batch"].append(timed(
            "row_min_batch", (a, b, vb),
            lambda: ops.row_min_batch(a, b, vb),
            lambda: row_min_batch_plain(a, b, vb),
            dict(name="row_min_batch", shape=[B, P, C, d], calls=calls,
                 kernel_route=ops.pairwise_route(d), max_abs_err=float(err),
                 bound_ms=bound, bound_by=by,
                 floor_ms=floor_ms("row_min_batch",
                                   float(P * valid.sum()), d, P))))
    main_path = {}
    for name in ("eps_count_batch", "row_min_batch"):
        rows.append(dict(max(tiers[name],
                             key=lambda r: (r["calls"], r["shape"][2]))))
        main_path[name] = {key: sum(t["calls"] * t[key] for t in tiers[name])
                           for key in ("ms", "graph_ms", "parent_ms",
                                       "parent_graph_ms", "bound_ms",
                                       "floor_ms")
                           if key in tiers[name][0]}

    M, N, d = 65536, 4096, 3
    rng = np.random.default_rng(7)
    a = torch.as_tensor(rng.integers(0, 4000, size=(M, d)).astype(np.float32)).to(dev)
    b = torch.as_tensor(rng.integers(0, 4000, size=(N, d)).astype(np.float32)).to(dev)
    vb = torch.as_tensor(rng.uniform(size=N) > 0.2).to(dev)
    eps = 300.5
    diff = compare_eps_count(ops, a, b, eps, vb, None, None, False)
    require(diff == 0, f"eps_count differs from its plain version: {diff}")
    live = torch.full((1,), float(M), device=dev).double()
    nbytes, nops = _needed_work(live, vb.sum().double()[None], 1, M, N, d, False)
    bound, by = _bound(nbytes, nops)
    pairs = float(M * vb.sum())
    rows.append(dict(
        name="eps_count", shape=[M, N, d], max_abs_err=float(diff),
        **time_distance(lib, baseline, "eps_count_batch",
                        (a, b, vb, None, eps, None),
                        lambda: ops.eps_count(a, b, eps, vb)),
        plain_ms=cuda_ms(lambda: eps_count_batch_plain(a[None], b[None], eps,
                                                       vb[None]),
                         reps=2, warmup=1),
        bound_ms=bound, bound_by=by,
        floor_ms=floor_ms("eps_count", pairs, d, ops.ROWS_PER_SLOT)))
    err, rel_ok, mism = compare_row_min(ops, a, b, vb, False)
    require(err == 0.0 and mism == 0,
            f"row_min differs from its plain version: err={err} argmin={mism}")
    rows.append(dict(
        name="row_min", shape=[M, N, d], max_abs_err=float(err),
        **time_distance(lib, baseline, "row_min_batch", (a, b, vb),
                        lambda: ops.row_min(a, b, vb)),
        plain_ms=cuda_ms(lambda: row_min_batch_plain(a[None], b[None],
                                                     vb[None]),
                         reps=2, warmup=1),
        bound_ms=_bound(nbytes + 4.0 * M, nops)[0],
        bound_by=_bound(nbytes + 4.0 * M, nops)[1],
        floor_ms=floor_ms("row_min", pairs, d, ops.ROWS_PER_SLOT)))
    return rows, tiers, main_path, cases, band_rows, routes


# --------------------------------------------------------------------------
# float64 recomputation on the card
# --------------------------------------------------------------------------

def check_sampled(pts64, labels, core, eps, seed, dev, n_sample=2000):
    """Recompute, in float64 against all points, the core flag of
    ``n_sample`` sampled points and the nearest-core rule of
    ``n_sample`` sampled non-core points."""
    n = pts64.shape[0]
    eps2 = eps * eps
    gen = torch.Generator(device="cpu").manual_seed(seed)
    idx = torch.randperm(n, generator=gen)[:n_sample].to(dev)
    bad_core = 0
    for s in range(0, idx.numel(), 64):
        q = pts64[idx[s:s + 64]]
        d2 = ((q[:, None, :] - pts64[None, :, :]) ** 2).sum(-1)
        want = (d2 <= eps2).sum(1) >= MIN_PTS
        bad_core += int((want != core[idx[s:s + 64]]).sum().item())
    require(bad_core == 0, f"{bad_core} sampled core flags differ from the "
            f"float64 recomputation")

    noncore = torch.nonzero(~core)[:, 0]
    pick = noncore[torch.randperm(noncore.numel(), generator=gen)[:n_sample]
                   .to(dev)]
    cpts, clab = pts64[core], labels[core]
    bad_border, ties = 0, 0
    for s in range(0, pick.numel(), 64):
        rows = pick[s:s + 64]
        d2 = ((pts64[rows][:, None, :] - cpts[None, :, :]) ** 2).sum(-1)
        dmin = d2.min(dim=1).values
        at_min = d2 == dmin[:, None]
        lab = labels[rows]
        # clusters that own a core point at the minimum distance
        lo = torch.where(at_min, clab[None, :], torch.iinfo(clab.dtype).max
                         ).min(dim=1).values
        hi = torch.where(at_min, clab[None, :], -1).max(dim=1).values
        tie = lo != hi
        ties += int(tie.sum().item())
        reach = dmin <= eps2
        member = (at_min & (clab[None, :] == lab[:, None])).any(dim=1)
        ok = torch.where(reach, member, lab == -1)
        bad_border += int((~ok).sum().item())
    require(bad_border == 0, f"{bad_border} sampled non-core points break "
            f"the nearest-core rule")
    return dict(core_sampled=int(idx.numel()),
                noncore_sampled=int(pick.numel()), cluster_ties=ties)


# --------------------------------------------------------------------------
# serve: the fitted index
# --------------------------------------------------------------------------

def nearest_cores(q64: np.ndarray, cpts: torch.Tensor, clab: torch.Tensor,
                  chunk: int = 256):
    """float64 on the card, against every core point: per query the
    least squared distance and the least / greatest label among the
    cores within a relative 1e-12 (exact ties) and 1e-5 (ties a float32
    kernel may resolve either way) of it."""
    big = torch.iinfo(torch.int64).max
    out = {k: [] for k in ("dmin", "lo", "hi", "lo5", "hi5")}
    for s in range(0, len(q64), chunk):
        qq = torch.as_tensor(q64[s:s + chunk], device=cpts.device)
        d2 = (qq[:, None, 0] - cpts[None, :, 0]) ** 2
        for k in range(1, cpts.shape[1]):
            d2 += (qq[:, None, k] - cpts[None, :, k]) ** 2
        dmin = d2.min(dim=1).values
        out["dmin"].append(dmin)
        for tag, rel in (("", 1e-12), ("5", 1e-5)):
            near = d2 <= dmin[:, None] * (1.0 + rel)
            out["lo" + tag].append(
                torch.where(near, clab[None, :], big).min(dim=1).values)
            out["hi" + tag].append(
                torch.where(near, clab[None, :], -1).max(dim=1).values)
        del d2
    return {k: torch.cat(v).cpu().numpy() for k, v in out.items()}


def check_host_rule(q64, host, near, cpts_np, clab_np, eps2):
    """The oracle rule for host-mode labels: noise exactly where no core
    lies within eps, else the label of a core at the least distance.  A
    query whose card distance is within the exact-tie window of eps^2 or
    of another cluster's core is decided again on the host with the
    host's own float64 expression."""
    dmin = near["dmin"]
    amb = (near["lo"] != near["hi"]) | (np.abs(dmin - eps2) <= 1e-12 * eps2)
    clear = ~amb
    bad = int(((host[clear] == -1) != (dmin[clear] > eps2)).sum())
    inside = clear & (dmin <= eps2)
    bad += int((host[inside] != near["lo"][inside]).sum())
    for i in np.flatnonzero(amb):
        d2 = ((cpts_np - q64[i]) ** 2).sum(axis=1)
        dm = d2.min()
        ok = (host[i] == -1) if dm > eps2 else \
            (host[i] in set(clab_np[d2 == dm].tolist()))
        bad += int(not ok)
    return bad, int(amb.sum())


def mutation_step(plane, ds, step, forced, rng, pts, sc, n_ins, n_del,
                  n_pred, drift, step_s, split):
    """One step of the serve bench's mix on both planes: insert, delete,
    predict; the planes' stats, states, answers and the resident mirror
    must be equal afterwards.  Appends the step's seconds and split;
    returns the mirror check."""
    from repro_torch.data.scenarios import _insert_drift, _queries_mixed
    nonsemantic = {"dist_evals", "t_total", "t_pack", "t_kernel",
                   "band_fallback"}
    ins = _insert_drift(rng, pts, sc, n_ins, drift, MUTATION_STEPS)
    kill = rng.choice(plane["host"].arrival_live(), n_del, replace=False)
    q = _queries_mixed(rng, pts, sc, n_pred)
    got = {}
    for name, ix in plane.items():
        runs0 = copy.deepcopy(ds.stage_runs)
        secs0 = copy.deepcopy(ds.stage_s)
        t0 = time.perf_counter()
        si = ix.insert(ins)
        sd = ix.delete(kill)
        lab, d2 = ix.predict(q, mode=name, return_d2=True)
        torch.cuda.synchronize()
        step_s[name].append(time.perf_counter() - t0)
        got[name] = (si, sd, lab, d2)
        row = dict(
            gates="0" if forced else "default",
            insert_s=si["t_total"], delete_s=sd["t_total"],
            affected_grids=si["affected_grids"] + sd["affected_grids"],
            band_fallback=si["band_fallback"] + sd["band_fallback"])
        if name == "device":
            row["routes"] = {
                st: {r: dict(runs=ds.stage_runs[st][r] - runs0[st][r],
                             s=ds.stage_s[st][r] - secs0[st][r])
                     for r in ("flat", "host_twin")}
                for st in ds.stage_runs}
        split[name].append(row)
    h, d = plane["host"], plane["device"]
    for k in (0, 1):
        for key in set(got["host"][k]) - nonsemantic:
            require(np.array_equal(got["host"][k][key],
                                   got["device"][k][key]),
                    f"step {step}: stats {key} differ between planes")
    require(np.array_equal(h.labels_arrival(), d.labels_arrival())
            and np.array_equal(h.core_arrival(), d.core_arrival())
            and np.array_equal(h.merge_edges, d.merge_edges),
            f"step {step}: the planes' states differ")
    require(np.array_equal(got["host"][2], got["device"][2])
            and np.array_equal(got["host"][3], got["device"][3]),
            f"step {step}: the planes' answers differ")
    mm = d.device_state.mirror_matches(d)
    require(all(mm.values()), f"step {step}: resident mirror {mm}")
    return mm


def serve_phase(pts, eps, caps, fit_labels, seed, dev):
    """Fit with the index, predict in three modes, the mutation stream
    on two planes, a snapshot round trip.  Returns (summary, launches
    of this path, the largest kernel-mode predict call, the index)."""
    from repro_torch.data.scenarios import _queries_mixed, get_scenario
    from repro_torch.engine import cluster, registry
    from repro_torch.index import GritIndex, device_state
    from repro_torch.kernels import ops

    n = len(pts)
    sc = dataclasses.replace(get_scenario("blobs-3d"), eps=eps, n=n)
    rng = np.random.default_rng(seed + 30_000)
    batches = [_queries_mixed(rng, pts, sc, SERVE_BATCH)
               for _ in range(SERVE_BATCHES)]
    n_pred = int(0.85 * SERVE_BATCH)
    n_ins = int(0.10 * SERVE_BATCH)
    n_del = SERVE_BATCH - n_pred - n_ins

    captured = []                        # the largest kernel-mode call
    real_min = ops.row_min_batch

    def keep_min(a, b, valid_b=None):
        if not captured or b.numel() > captured[0][1].numel():
            captured[:] = [(a, b, valid_b)]
        return real_min(a, b, valid_b)

    attach_s = []
    real_attach = registry._attach_index

    def timed_attach(*a, **k):
        t0 = time.perf_counter()
        out = real_attach(*a, **k)
        attach_s.append(time.perf_counter() - t0)
        return out

    ops.reset_launches()
    registry._attach_index = timed_attach
    try:
        t0 = time.perf_counter()
        res = cluster(pts, eps, MIN_PTS, engine="device-kernels", caps=caps,
                      return_index=True)
        fit_attach_s = time.perf_counter() - t0
    finally:
        registry._attach_index = real_attach
    fit_launches = dict(ops.LAUNCHES)
    idx = res.index
    require(np.array_equal(res.labels, fit_labels)
            and np.array_equal(idx.labels_arrival(), fit_labels),
            "the fit with the index gave other labels")
    require(np.array_equal(idx.core_arrival(), res.core),
            "the index holds other core flags than the fit")

    # ---- predict in three modes ----------------------------------------
    out = {m: [] for m in ("host", "kernel", "device")}
    secs = {m: [] for m in out}
    stats = {m: [] for m in out}

    def run(mode):
        for q in batches:
            st = {}
            t0 = time.perf_counter()
            lab, d2 = idx.predict(q, mode=mode, return_d2=True, stats=st)
            torch.cuda.synchronize()
            secs[mode].append(time.perf_counter() - t0)
            out[mode].append((lab, d2))
            stats[mode].append(st)

    run("host")
    ops.row_min_batch = keep_min
    try:
        run("kernel")
    finally:
        ops.row_min_batch = real_min
    t0 = time.perf_counter()
    idx.ensure_merge_graph()
    merge_graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.ensure_device_state()
    torch.cuda.synchronize()
    attach_device_s = time.perf_counter() - t0
    run("device")

    q_all = np.concatenate(batches)
    host = np.concatenate([o[0] for o in out["host"]])
    host_d2 = np.concatenate([o[1] for o in out["host"]])
    dev_lab = np.concatenate([o[0] for o in out["device"]])
    dev_d2 = np.concatenate([o[1] for o in out["device"]])
    require(np.array_equal(dev_lab, host) and np.array_equal(dev_d2, host_d2),
            f"device-mode predict differs from host mode on "
            f"{int((dev_lab != host).sum())} labels / "
            f"{int((dev_d2 != host_d2).sum())} distances")
    core = idx.core_arrival()
    cpts_np = pts[core]
    clab_np = idx.labels_arrival()[core]
    near = nearest_cores(q_all, torch.as_tensor(cpts_np, device=dev),
                         torch.as_tensor(clab_np, device=dev))
    eps2 = eps * eps
    bad_rule, ambiguous = check_host_rule(q_all, host, near, cpts_np,
                                          clab_np, eps2)
    require(bad_rule == 0, f"{bad_rule} host-mode labels break the "
            f"nearest-core rule")
    kern = np.concatenate([o[0] for o in out["kernel"]])
    dmin = np.sqrt(near["dmin"])
    decidable = (np.abs(dmin - eps) > 1e-5 * eps) & (near["lo5"] == near["hi5"])
    mism = int((kern[decidable] != host[decidable]).sum())
    require(mism == 0, f"kernel-mode predict differs from host mode on "
            f"{mism} decidable queries")

    def per_mode(mode):
        med = float(np.median(secs[mode]))
        return dict(median_s=med, queries_per_s=SERVE_BATCH / med,
                    batch_s=secs[mode],
                    candidates=[s.get("candidates") for s in stats[mode]])

    predict = {m: per_mode(m) for m in out}
    predict["kernel"]["caps"] = dataclasses.asdict(idx.predict_caps)
    predict["kernel"]["groups"] = [s["groups"] for s in stats["kernel"]]
    predict["device"]["uncertain"] = [s["uncertain"] for s in stats["device"]]
    # host packing + upload + enqueue, then block + host reduce + band
    # fallback (predict_device_async's own split of each batch)
    predict["device"]["pack_s"] = [s["t_pack"] for s in stats["device"]]
    predict["device"]["resolve_s"] = [s["t_kernel"] for s in stats["device"]]
    predict["device"]["flat_dispatches"] = \
        idx.device_state.stage_runs["predict"]["flat"]
    require(predict["device"]["flat_dispatches"] > 0,
            "device-mode predict never enqueued its flat gather")
    # share of the packed [group_cap, cand_cap] candidate slots that are
    # padding, per batch
    predict["kernel"]["padded_share"] = [
        1.0 - s["candidates"] / (s["caps"]["group_cap"] * s["caps"]["cand_cap"])
        for s in stats["kernel"]]
    predict_launches = dict(ops.LAUNCHES)

    # ---- mutation stream: host-serving index vs device-resident twin ----
    plane = {"host": GritIndex.restore(idx.snapshot()), "device": idx}
    require(plane["host"].device_state is None, "the host plane has a "
            "resident state")
    step_s = {"host": [], "device": []}
    # per step and plane: where the mutation time went (the stats' own
    # wall times); on the device plane also, per stage, how many runs
    # enqueued a flat gather on the card and how many the gates sent to
    # the host float64 twin, with the seconds of each route
    split = {"host": [], "device": []}
    ds = idx.device_state
    mirror = []
    # the four steps of the mix under the default gates, then one more
    # with the gates at 0, so that every write-half stage of the resident
    # plane runs its flat gather on the card at least once
    plan = [(s, False) for s in range(MUTATION_STEPS)] + [(0, True)]
    gates = (device_state.MIN_FLAT_T, device_state.EDGE_MIN_FLAT_T)
    try:
        for step, (drift, forced) in enumerate(plan):
            if forced:
                device_state.MIN_FLAT_T = device_state.EDGE_MIN_FLAT_T = 0
            mirror.append(mutation_step(plane, ds, step, forced, rng, pts, sc,
                                        n_ins, n_del, n_pred, drift, step_s,
                                        split))
    finally:
        device_state.MIN_FLAT_T, device_state.EDGE_MIN_FLAT_T = gates
    for st in ("cores", "edges", "border"):
        require(ds.stage_runs[st]["flat"] > 0, f"the resident plane never "
                f"ran the {st} stage's flat gather on the card")
    launches = {k: v for k, v in ops.LAUNCHES.items()}

    # ---- snapshot round trip -------------------------------------------
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "index.npz")
        t0 = time.perf_counter()
        plane["host"].save(path)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        t0 = time.perf_counter()
        back = GritIndex.load(path)
        load_s = time.perf_counter() - t0
    require(not os.path.exists(path), "the snapshot file was not removed")
    sa, sb = plane["host"].snapshot(), back.snapshot()
    require(set(sa) == set(sb) and all(np.array_equal(sa[k], sb[k])
                                       for k in sa),
            "the snapshot does not round-trip")
    lb, db = back.predict(batches[0], mode="host", return_d2=True)
    la, da = plane["host"].predict(batches[0], mode="host", return_d2=True)
    require(np.array_equal(la, lb) and np.array_equal(da, db),
            "the loaded snapshot answers otherwise")

    summary = dict(
        n=n, fit_attach_s=fit_attach_s, attach_s=attach_s[0],
        fit_s=fit_attach_s - attach_s[0], grids=int(idx.num_grids),
        queries=int(len(q_all)), predict=predict,
        row_min_batch_launches_predict=(predict_launches["row_min_batch"]
                                        - fit_launches["row_min_batch"]),
        device_state_attach_s=attach_device_s,
        oracle=dict(rule_violations=bad_rule, decided_on_host=ambiguous,
                    kernel_decidable=int(decidable.sum()),
                    kernel_mismatches=mism,
                    noise=int((host == -1).sum())),
        mutation=dict(steps=len(plan), steps_gates_0=1, predict=n_pred,
                      insert=n_ins, delete=n_del, merge_graph_s=merge_graph_s,
                      merge_edges=int(len(idx.merge_edges)),
                      step_s=step_s, step_split=split, planes_equal=True,
                      mirror_matches=all(all(m.values()) for m in mirror)),
        snapshot=dict(bytes=nbytes, save_s=save_s, load_s=load_s,
                      roundtrip=True))
    return summary, launches, captured[0], idx


# --------------------------------------------------------------------------
# server: the continuous-batching ClusterServer with a read replica
# --------------------------------------------------------------------------

def server_script(pts, sc, live, rng):
    """The scripted stream of phase ``server``: ``SERVER_PREDICTS``
    predict requests of log-uniform 1 - 2,048 queries from
    ``_queries_mixed``, two inserts of ``SERVER_INSERT`` points and one
    delete of ``SERVER_DELETE`` live arrival ids at fixed positions."""
    from repro_torch.data.scenarios import _insert_drift, _queries_mixed
    sizes = np.clip(np.rint(np.exp(rng.uniform(
        0.0, math.log(SERVER_QUERY_CAP), SERVER_PREDICTS))), 1,
        SERVER_QUERY_CAP).astype(int)
    mutations = {
        SERVER_PREDICTS // 4: ("insert", _insert_drift(
            rng, pts, sc, SERVER_INSERT, 0, 2)),
        SERVER_PREDICTS // 2: ("delete", rng.choice(
            live, SERVER_DELETE, replace=False)),
        3 * SERVER_PREDICTS // 4: ("insert", _insert_drift(
            rng, pts, sc, SERVER_INSERT, 1, 2)),
    }
    script = []
    for i, m in enumerate(sizes):
        if i in mutations:
            script.append(mutations[i])
        script.append(("predict", _queries_mixed(rng, pts, sc, int(m))))
    return script


def serve_script(srv, script):
    """Submit the stream, drain it; returns the requests by id."""
    for kind, payload in script:
        {"predict": srv.submit, "insert": srv.submit_insert,
         "delete": srv.submit_delete}[kind](payload)
    srv.run()
    torch.cuda.synchronize()
    return sorted(srv.done, key=lambda r: r.rid)


def server_readings(srv, events):
    """Per server: the summary's numbers, the step log's sums, and the
    attribution of ``serve.step`` to its children and of the delta
    stages (from the run's own span events)."""
    from repro_torch.obs import view
    s = srv.summary()
    att = view.attribution(events, root="serve.step")
    agg = view.span_aggregates(events)
    wall = att["wall_us"]
    return dict(
        steps=s["steps"], requests=s["requests"], queries=s["queries"],
        inserted=s["inserted"], deleted=s["deleted"],
        rejected=s["rejected"],
        latency_ms_p50=s["latency_ms_p50"], latency_ms_p95=s["latency_ms_p95"],
        latency_ms_p99=s["latency_ms_p99"],
        queries_per_s=s["queries_per_s"],
        mean_slot_fill=s["mean_slot_fill"],
        kernel_s=sum(st["kernel_s"] for st in srv.step_log),
        pack_s=sum(st["pack_s"] for st in srv.step_log),
        step_s=[st["seconds"] for st in srv.step_log],
        growth_events=s["growth_events"],
        attribution=dict(
            root="serve.step", wall_ms=wall / 1e3,
            self_ms=agg.get("serve.step", {}).get("self_us", 0.0) / 1e3,
            coverage=att["coverage"],
            children={k: dict(ms=v / 1e3, share=v / wall if wall else 0.0)
                      for k, v in sorted(att["children"].items(),
                                         key=lambda kv: -kv[1])}),
        delta_ms={k: dict(count=int(a["count"]), ms=a["total_us"] / 1e3)
                  for k, a in sorted(agg.items()) if k.startswith("delta.")})


def server_phase(index, pts, eps, seed, smi):
    """Two ``ClusterServer``s over restores of the served index's
    snapshot, on one scripted stream: A in device mode on a resident
    state, B in kernel mode answering from a read replica.  Tracing on
    for that run (Chrome trace to ``build/``), then the stream's
    predicts again on A with tracing off and on.  Returns (the phase
    line's fields, launches of the server path, the largest
    ``row_min_batch`` call of B)."""
    from repro_torch import obs
    from repro_torch.data.scenarios import get_scenario
    from repro_torch.index import GritIndex
    from repro_torch.kernels import ops
    from repro_torch.serve import ClusterServer

    t_phase = time.perf_counter()
    n = len(pts)
    sc = dataclasses.replace(get_scenario("blobs-3d"), eps=eps, n=n)
    rng = np.random.default_rng(seed + 40_000)
    snap = index.snapshot()
    script = server_script(pts, sc, index.arrival_live(), rng)
    n_pred = sum(k == "predict" for k, _ in script)
    kw = dict(slots=SERVER_SLOTS, query_cap=SERVER_QUERY_CAP)

    captured = []                        # B's largest kernel-mode call
    real_min = ops.row_min_batch

    def keep_min(a, b, valid_b=None):
        if not captured or b.numel() > captured[0][1].numel():
            captured[:] = [(a, b, valid_b)]
        return real_min(a, b, valid_b)

    t0 = time.perf_counter()
    # each restore gets its own arrays: a snapshot holds the index's own,
    # which a delete updates in place
    idx_a, idx_b = (GritIndex.restore({k: v.copy() for k, v in snap.items()})
                    for _ in range(2))
    idx_b.enable_mutation_log()
    restore_s = time.perf_counter() - t0
    reg = obs.registry()
    ctr0 = reg.snapshot()
    was = obs.enabled()
    tracer = obs.enable(clear=True)
    ops.reset_launches()
    try:
        t0 = time.perf_counter()
        srv_a = ClusterServer(idx_a, mode="device", device_state=True, **kw)
        torch.cuda.synchronize()
        attach_a_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        done_a = serve_script(srv_a, script)
        run_a_s = time.perf_counter() - t0
        n_a = len(tracer.snapshot_events())
        launches_a = dict(ops.LAUNCHES)
        t0 = time.perf_counter()
        srv_b = ClusterServer(idx_b, mode="kernel", replicas=1, **kw)
        replica_s = time.perf_counter() - t0
        ops.row_min_batch = keep_min
        try:
            t0 = time.perf_counter()
            done_b = serve_script(srv_b, script)
            run_b_s = time.perf_counter() - t0
        finally:
            ops.row_min_batch = real_min
        events = tracer.snapshot_events()   # one timeline: A, then B
        ev_a, ev_b = events[:n_a], events[n_a:]
        launches = dict(ops.LAUNCHES)
    finally:
        frozen = obs.disable()
    ctr1 = reg.snapshot()
    trace_path = os.path.join("build", "chip_smoke_server_trace.json")
    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    obs.export.write_chrome_trace(os.path.join(root, trace_path), events,
                                  metrics=ctr1, meta=obs.bench_meta())

    # ---- checks ----------------------------------------------------------
    require(len(done_a) == len(done_b) == len(script),
            "the servers did not answer every request")
    diff = [r.rid for r, q in zip(done_a, done_b) if r.kind == "predict"
            and not np.array_equal(r.labels, q.labels)]
    require(not diff, f"servers A and B differ on predict requests {diff}")
    rep = srv_b.replicas[0]
    require(np.array_equal(rep.labels_arrival(), idx_b.labels_arrival())
            and np.array_equal(rep.core_arrival(), idx_b.core_arrival()),
            "the replica's state differs from its primary's")
    require(np.array_equal(idx_a.labels_arrival(), idx_b.labels_arrival())
            and np.array_equal(idx_a.core_arrival(), idx_b.core_arrival()),
            "the device plane and the host plane differ after the stream")
    sa, sb = srv_a.summary(), srv_b.summary()
    require(sa["rejected"] == sb["rejected"], "rejected counts differ")
    b_launches = launches["row_min_batch"] - launches_a["row_min_batch"]
    require(b_launches > 0, "server B never launched row_min_batch")
    require(srv_b._rr == sum(1 for st in srv_b.step_log if st["queries"]),
            "a predict batch of B was not answered by the replica")
    names_a = {e["name"] for e in ev_a}
    names_b = {e["name"] for e in ev_b}
    steps = {f"serve.step.{k}" for k in
             ("mutate", "dispatch", "admit_next", "resolve")}
    delta = {f"delta.{d}.{k}" for d, ks in (
        ("insert", ("identifiers", "splice", "cores", "merge_repair",
                    "reconcile")),
        ("delete", ("tombstone", "demotions", "merge_repair", "components",
                    "compaction"))) for k in ks}
    for tag, names in (("A", names_a), ("B", names_b)):
        require(steps | delta <= names, f"server {tag}'s trace lacks "
                f"{sorted((steps | delta) - names)}")

    # ---- predict-only reruns: tracing off, on, on, off --------------------
    preds = [(k, p) for k, p in script if k == "predict"]
    n_frozen = len(frozen.snapshot_events())
    step_s = {"off": [], "on": []}
    first, n_on = None, []
    for on in (False, True, True, False):
        if on:
            obs.enable(clear=True)
        try:
            srv = ClusterServer(idx_a, mode="device", **kw)
            done = serve_script(srv, preds)
            step_s["on" if on else "off"] += [st["seconds"]
                                              for st in srv.step_log]
            if on:
                n_on.append(len(obs.get_tracer().snapshot_events()))
            else:
                require(obs.get_tracer() is None
                        and len(frozen.snapshot_events()) == n_frozen,
                        "a tracing-off rerun recorded span events")
        finally:
            obs.disable()
        first = first or [r.labels for r in done]
        require(len(done) == len(preds) and all(
            np.array_equal(r.labels, w) for r, w in zip(done, first)),
            "the predict-only reruns answered otherwise")
    if was:
        obs.enable()
    fields = dict(
        n=n, card=smi, slots=SERVER_SLOTS, query_cap=SERVER_QUERY_CAP,
        predicts=n_pred, queries=int(sum(len(p) for _, p in preds)),
        inserts=[SERVER_INSERT, SERVER_INSERT], delete=SERVER_DELETE,
        restore_s=restore_s, attach_device_state_s=attach_a_s,
        make_replica_s=replica_s, run_s={"A": run_a_s, "B": run_b_s},
        A=server_readings(srv_a, ev_a), B=server_readings(srv_b, ev_b),
        row_min_batch_launches_B=b_launches,
        counters={k: v - ctr0.get(k, 0) for k, v in ctr1.items()
                  if isinstance(v, int) and v != ctr0.get(k, 0)},
        labels_equal=True, replica_equal=True,
        rerun_median_step_s={k: float(np.median(v))
                             for k, v in step_s.items()},
        rerun_steps=len(step_s["on"]) // 2, rerun_events_off=0,
        rerun_events_on=n_on, trace=trace_path,
        phase_s=time.perf_counter() - t_phase)
    return fields, launches, captured[0]


# --------------------------------------------------------------------------
# guard-band kernels vs their plain versions
# --------------------------------------------------------------------------

def compare_band(ops_mod, a, b, lo, hi, vb, stop):
    """Launch ``eps_count_band_batch``, hold it against the plain
    version's full counts: equal where the row's lo count is below its
    bar (every row without a bar), 0 where the bar is <= 0 (an exempt
    row), never above elsewhere."""
    from repro_torch.kernels.ops import eps_count_band_batch_plain
    glo, ghi = ops_mod.eps_count_band_batch(a, b, lo, hi, vb, stop)
    torch.cuda.synchronize()
    wlo, whi = eps_count_band_batch_plain(a, b, lo, hi, vb)
    done = torch.ones_like(glo, dtype=torch.bool) if stop is None \
        else glo < stop
    exempt = torch.zeros_like(done) if stop is None else stop <= 0
    diff = max(int(((glo - wlo).abs() * done).max().item()),
               int(((ghi - whi).abs() * done).max().item()),
               int(((glo.abs() + ghi.abs()) * exempt).max().item())) \
        if glo.numel() else 0
    over = bool((glo > wlo).any() or (ghi > whi).any())
    return diff, over


def compare_min2(ops_mod, a, b, vb):
    """(max abs error of min and runner-up on finite rows, rtol-1e-6
    ok, argmin mismatches, inf pattern ok)."""
    from repro_torch.kernels.ops import row_min2_batch_plain
    gm, gm2, gi = ops_mod.row_min2_batch(a, b, vb)
    torch.cuda.synchronize()
    wm, wm2, wi = row_min2_batch_plain(a, b, vb)
    err, rel_ok, inf_ok = 0.0, True, True
    for g, w in ((gm, wm), (gm2, wm2)):
        inf_ok &= bool((torch.isinf(g) == torch.isinf(w)).all())
        fin = ~torch.isinf(w)
        if w.numel():
            err = max(err, float(((g - w).abs() * fin).nan_to_num(0.0)
                                 .max().item()))
        rel_ok &= bool((((g - w).abs() <= 1e-6 * w.abs()) | ~fin).all())
    return err, rel_ok, int((gi != wi).sum().item()), inf_ok


def _band_work(vb, B, P, C, d, n_out):
    """(bound ms, by, pairs) of a guard-band call that scans every (row,
    valid candidate) pair."""
    pairs = float(P) * float(vb.sum().item())
    nbytes = (4.0 * d * B * P + 4.0 * d * float(vb.sum().item()) + B * C
              + 4.0 * n_out * B * P)
    return (*_bound(nbytes, 3.0 * d * pairs), pairs)


def edge_bars(va, seed, k=5):
    """Per-row bars in [0, k] for the band kernel on an edge lattice, 0
    (exempt) on the rows that ``va`` marks dead, as the fit's padded rows
    are."""
    rng = np.random.default_rng(seed)
    bar = torch.as_tensor(rng.integers(0, k + 1, tuple(va.shape))
                          .astype(np.int32)).to(va.device)
    return torch.where(va, bar, 0).to(torch.int32).contiguous()


def guard_band_phase(captured_fit, predict_call, eps_lo, eps_hi, dev,
                     baseline=None):
    from repro_torch.kernels import ops
    from repro_torch.kernels.ops import (eps_count_band_batch_plain,
                                         row_min2_batch_plain)
    cases = 0
    # 1. integer lattices (duplicated candidates, one valid candidate in
    # a slot, an all-masked slot): everything equal
    shapes = [(1, 1, 1, 1), (3, 5, 7, 2), (2, 17, 130, 3), (4, 127, 129, 4),
              (2, 64, 1300, 5), (3, 63, 600, 3), (2, 9, 260, 7),
              (5, 63, 2048, 3)]
    for i, (B, P, C, d) in enumerate(shapes):
        for dup in (False, True):
            a, b, vb, _ = lattice_inputs(B, P, C, d, 300 + i, dev, dup)
            if B > 2:
                vb[1] = False
                vb[1, C // 3] = True
            rng = np.random.default_rng(400 + i)
            for bar in (None, 0, 2, 5, 1000):
                stop = None if bar is None else torch.as_tensor(
                    rng.integers(0, bar + 1, (B, P)).astype(np.int32)).to(dev)
                diff, over = compare_band(ops, a, b, 15.0, 17.0, vb, stop)
                require(diff == 0 and not over, f"eps_count_band_batch "
                        f"differs on lattice {(B, P, C, d)} dup={dup} "
                        f"bar={bar}: {diff}")
            err, _, mism, inf_ok = compare_min2(ops, a, b, vb)
            require(err == 0.0 and mism == 0 and inf_ok, f"row_min2_batch "
                    f"differs on lattice {(B, P, C, d)} dup={dup}: "
                    f"err={err} argmin={mism}")
            cases += 6
    # 1b. the edge shapes of the warp-per-task design (50,000 slots, rows
    # around the lane counts, dead slots between live ones, ties across
    # phase and split boundaries, d = 7), with and without bars
    for i, (B, P, C, d, dead, pairs) in enumerate(EDGE_SHAPES):
        a, b, vb, va = lattice_inputs(B, P, C, d, 600 + i, dev, True, dead,
                                      pairs)
        for stop in (None, edge_bars(va, 700 + i),
                     edge_bars(va, 800 + i, 1000)):
            diff, over = compare_band(ops, a, b, 15.0, 17.0, vb, stop)
            require(diff == 0 and not over, f"eps_count_band_batch differs "
                    f"on edge lattice {(B, P, C, d)} (bars: "
                    f"{stop is not None}): {diff}")
        err, _, mism, inf_ok = compare_min2(ops, a, b, vb)
        require(err == 0.0 and mism == 0 and inf_ok, f"row_min2_batch "
                f"differs on edge lattice {(B, P, C, d)}: err={err} "
                f"argmin={mism}")
        cases += 4
    # 2. random reals: d2 within rtol 1e-6, counts equal outside the
    # rows with a candidate inside that band of either threshold
    band_rows = 0
    for i, (B, P, C, d) in enumerate(shapes):
        rng = np.random.default_rng(500 + i)
        a = torch.as_tensor(rng.normal(size=(B, P, d)) * 10,
                            dtype=torch.float32).to(dev)
        b = torch.as_tensor(rng.normal(size=(B, C, d)) * 10,
                            dtype=torch.float32).to(dev)
        vb = torch.as_tensor(rng.uniform(size=(B, C)) > 0.3).to(dev)
        glo, ghi = ops.eps_count_band_batch(a, b, 5.5, 6.5, vb)
        wlo, whi = eps_count_band_batch_plain(a, b, 5.5, 6.5, vb)
        d2 = ops.sq_dists_direct(a, b)
        in_band = torch.zeros_like(glo, dtype=torch.bool)
        for t2 in (5.5 ** 2, 6.5 ** 2):
            in_band |= (((d2 - t2).abs() <= t2 * 1e-6) & vb[:, None, :]
                        ).any(dim=2)
        band_rows += int(in_band.sum().item())
        require(bool((((glo == wlo) & (ghi == whi)) | in_band).all()),
                f"eps_count_band_batch differs outside the band "
                f"{(B, P, C, d)}")
        err, rel_ok, _, inf_ok = compare_min2(ops, a, b, vb)
        require(rel_ok and inf_ok, f"row_min2_batch beyond rtol 1e-6 "
                f"{(B, P, C, d)}")
        cases += 2

    # 3. the largest kernel-mode predict call: both kernels, timed (the
    # summary rows; ``time_distance``: ms eager, graph_ms device time over
    # rotated copies, parent_* beside them when a baseline build is
    # given), the band at the served index's thresholds
    lib = ops._lib()
    a, b, vb = predict_call
    B, P, d = a.shape
    C = b.shape[1]
    err, rel_ok, mism, inf_ok = compare_min2(ops, a, b, vb)
    require(err == 0.0 and mism == 0 and inf_ok, f"row_min2_batch differs "
            f"from its plain version on the predict call: err={err} "
            f"argmin={mism}")
    bound, by, pairs = _band_work(vb, B, P, C, d, 3)
    rows = [dict(name="row_min2_batch", shape=[B, P, C, d],
                 kernel_route=ops.pairwise_route(d), max_abs_err=float(err),
                 **time_distance(lib, baseline, "row_min2_batch", (a, b, vb),
                                 lambda: ops.row_min2_batch(a, b, vb)),
                 plain_ms=cuda_ms(lambda: row_min2_batch_plain(a, b, vb),
                                  reps=2, warmup=1),
                 bound_ms=bound, bound_by=by,
                 floor_ms=floor_ms("row_min2_batch", pairs, d, P))]
    diff, over = compare_band(ops, a, b, eps_lo, eps_hi, vb, None)
    require(diff == 0 and not over, f"eps_count_band_batch differs from its "
            f"plain version on the predict call: {diff}")
    bound, by, pairs = _band_work(vb, B, P, C, d, 2)
    rows.append(dict(
        name="eps_count_band_batch", shape=[B, P, C, d],
        kernel_route=ops.pairwise_route(d), max_abs_err=float(diff),
        **time_distance(lib, baseline, "eps_count_band_batch",
                        (a, b, vb, None, eps_lo, eps_hi),
                        lambda: ops.eps_count_band_batch(a, b, eps_lo,
                                                         eps_hi, vb)),
        plain_ms=cuda_ms(lambda: eps_count_band_batch_plain(
            a, b, eps_lo, eps_hi, vb), reps=2, warmup=1),
        bound_ms=bound, bound_by=by,
        floor_ms=floor_ms("eps_count_band_batch", pairs, d, P)))
    cases += 2

    # 4. the fit's captured eps_count_batch inputs at every width, band
    # thresholds of the served index, with the MinPts bar on live rows
    # (0 on padded rows) and without a bar; timed as the predict call;
    # with the bar, bound and floor count the pairs the bar leaves
    tiers = []
    for C in sorted(captured_fit):
        (a, b, vb, va, _, _), _ = captured_fit[C]
        B, P, d = a.shape
        stop = torch.where(va, MIN_PTS, 0).to(torch.int32).contiguous()
        for bar in (stop, None):
            diff, over = compare_band(ops, a, b, eps_lo, eps_hi, vb, bar)
            require(diff == 0 and not over, f"eps_count_band_batch differs "
                    f"on the fit's inputs at width {C} (bar: "
                    f"{bar is not None}): {diff}")
            bound, by, pairs = (_band_work(vb, B, P, C, d, 2) if bar is None
                                else _work_to_bars(a, b, vb, eps_lo, bar, 4,
                                                   2))
            tiers.append(dict(
                shape=[B, P, C, d], stop_row=bar is not None, pairs=pairs,
                max_abs_err=float(diff),
                **time_distance(lib, baseline, "eps_count_band_batch",
                                (a, b, vb, bar, eps_lo, eps_hi),
                                lambda: ops.eps_count_band_batch(
                                    a, b, eps_lo, eps_hi, vb, bar)),
                plain_ms=cuda_ms(lambda: eps_count_band_batch_plain(
                    a, b, eps_lo, eps_hi, vb), reps=2, warmup=1),
                bound_ms=bound, bound_by=by,
                floor_ms=floor_ms("eps_count_band_batch", pairs, d, P)))
            cases += 1
    return rows, tiers, cases, band_rows


# --------------------------------------------------------------------------
# flash attention vs its plain version
# --------------------------------------------------------------------------

# (case, B, H, H_kv, Sq, Sk, D, dtype, causal, window, softcap); the first
# is the lm path's prefill call (qwen2-1.5b: 12 query heads, 2 KV heads)
FLASH_CASES = [
    ("qwen2_prefill_gqa", 4, 12, 2, 2048, 2048, 128, "bfloat16", True, None,
     None),
    ("qwen2_prefill", 4, 12, 12, 2048, 2048, 128, "bfloat16", True, None,
     None),
    ("prefill_8192", 1, 12, 12, 8192, 8192, 128, "bfloat16", True, None, None),
    ("gemma2_local", 1, 32, 32, 8192, 8192, 128, "bfloat16", True, 4096,
     50.0),
    ("noncausal", 2, 8, 8, 1500, 1500, 64, "float32", False, None, None),
    ("decode", 4, 12, 12, 1, 4100, 128, "bfloat16", True, None, None),
    ("chunked_prefix", 2, 12, 12, 64, 192, 128, "bfloat16", True, None, None),
    ("unaligned", 2, 12, 12, 100, 100, 128, "float32", True, None, None),
    ("head_dim_16", 2, 8, 8, 1000, 1000, 16, "float32", True, 256, None),
    ("head_dim_32", 2, 8, 8, 1000, 1000, 32, "bfloat16", True, None, 30.0),
    ("head_dim_80", 1, 32, 32, 2048, 2048, 80, "bfloat16", True, None, None),
]
# the kernel against its plain version, elementwise |got - want| <=
# rtol·|want| + atol, and mean |got - want| <= FLASH_MEAN_REL·mean |want|.
# float32: the reference's flash tolerance.  bfloat16: both sides round
# the same float32 function to bf16, so they may differ by one bf16 ulp
# of the output (at most 2^-7 of it) plus the float32 rounding of the sums
FLASH_TOL = {"float32": (0.0, 2e-4), "bfloat16": (2.0 ** -7, 1e-4)}
FLASH_MEAN_REL = 1e-3


def live_pairs(Sq: int, Sk: int, causal: bool, window) -> int:
    """Unmasked (query, key) pairs of one head, queries right-aligned."""
    qpos = np.arange(Sq, dtype=np.int64) + (Sk - Sq)
    hi = np.minimum(Sk - 1, qpos) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros(Sq, np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def sdpa_call(q, k, v, causal, window, softcap):
    """One ``F.scaled_dot_product_attention`` call computing the same
    function (timed as a yardstick only; the port never calls it), or
    None where none does (the tanh soft-cap)."""
    import torch.nn.functional as F
    if softcap is not None:
        return None
    Sq, Sk = q.shape[2], k.shape[2]
    if k.shape[1] != q.shape[1]:
        if not (causal and window is None and Sq == Sk):
            return None
        return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                      enable_gqa=True)
    if causal and window is None and Sq == Sk:
        return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    if bool(mask.all()):
        return lambda: F.scaled_dot_product_attention(q, k, v)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def flash_build_report():
    """The bf16 head-dim-128 kernel (``flash_wgmma_kernel<128>``) as built:
    registers, stack and spill bytes from the ptxas report that the build
    keeps beside the library, and its count of HGMMA (tensor-core)
    instructions in the SASS, or of ``wgmma.mma_async`` in the PTX where
    the toolkit has no ``cuobjdump``."""
    from repro_torch.kernels import build
    tag = "flash_wgmma_kernelILi128E"
    lines = build.log_path("flash_attention").read_text().splitlines()
    rep = {}
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and tag in line:
            for nxt in lines[i + 1:i + 4]:
                m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores, (\d+) bytes spill loads", nxt)
                if m:
                    rep.update(stack_bytes=int(m.group(1)),
                               spill_store_bytes=int(m.group(2)),
                               spill_load_bytes=int(m.group(3)))
                m = re.search(r"Used (\d+) registers", nxt)
                if m:
                    rep["registers"] = int(m.group(1))
    lib = build._target("flash_attention")[1]
    cuda_bin = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin")
    cuobjdump = shutil.which("cuobjdump") or shutil.which(
        "cuobjdump", path=cuda_bin)
    if cuobjdump:
        sass = subprocess.run([cuobjdump, "-sass", str(lib)],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout
        body = [f for f in re.split(r"\n\s*Function : ", sass)
                if f.split("\n", 1)[0].find(tag) >= 0]
        rep.update(tensor_instr="HGMMA in SASS",
                   tensor_instr_count=sum(f.count("HGMMA") for f in body))
    else:
        ptx = lib.with_suffix(".ptx")
        subprocess.run([shutil.which("nvcc") or os.path.join(cuda_bin, "nvcc"),
                        *build.flags("flash_attention")[:4], "-ptx", "-o",
                        str(ptx), str(build.CSRC / "flash_attention.cu")],
                       capture_output=True, timeout=300, check=True)
        rep.update(tensor_instr="wgmma.mma_async in PTX",
                   tensor_instr_count=ptx.read_text().count("wgmma.mma_async"))
    require({"registers", "spill_store_bytes"} <= rep.keys(),
            f"no ptxas report of {tag} in the build log")
    require(rep["spill_store_bytes"] == 0 and rep["spill_load_bytes"] == 0,
            f"the bf16 flash kernel spills registers: {rep}")
    require(rep["tensor_instr_count"] > 0,
            f"the bf16 flash kernel has no tensor-core instruction: {rep}")
    return rep


def flash_phase(dev, seed):
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(seed + 40_000)
    rows = []
    for name, B, H, Hkv, Sq, Sk, D, dt, causal, window, cap in FLASH_CASES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn((B, h, n, D), generator=gen, device=dev)
                   .to(dtype) for h, n in ((H, Sq), (Hkv, Sk), (Hkv, Sk)))
        kw = dict(causal=causal, window=window, softcap=cap)
        route = ops.flash_route(dtype, D)
        require(route == ("wgmma" if dt == "bfloat16" else "scalar"),
                f"flash_attention {name}: route {route} for {dt}")
        got = ops.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = ops.flash_attention_plain(q, k, v, **kw)
        require(got.dtype == dtype and bool(torch.isfinite(got).all()),
                f"flash_attention {name}: wrong dtype or non-finite output")
        rtol, atol = FLASH_TOL[dt]
        diff = (got.float() - want.float()).abs()
        mag = want.float().abs()
        err = float(diff.max().item())
        # the largest error as a share of its element's bound (<= 1 passes)
        worst = float((diff / (rtol * mag + atol)).max().item())
        mean_rel = float((diff.mean() / mag.mean()).item())
        require(worst <= 1.0 and mean_rel <= FLASH_MEAN_REL,
                f"flash_attention differs from its plain version on {name}: "
                f"max abs {err}, {worst} of the elementwise bound, mean "
                f"{mean_rel} of mean |want|")
        del got, want, diff, mag
        esize = q.element_size()
        nbytes = esize * 2.0 * B * (H * Sq + Hkv * Sk) * D
        nops = 4.0 * D * B * H * live_pairs(Sq, Sk, causal, window)
        peak = PEAK_BF16_OPS_S if dt == "bfloat16" else PEAK_F32_OPS_S
        tb, to = nbytes / PEAK_BYTES_S * 1e3, nops / peak * 1e3
        lib = sdpa_call(q, k, v, causal, window, cap)
        ms = cuda_ms(lambda: ops.flash_attention(q, k, v, **kw))
        library_ms = None if lib is None else cuda_ms(lib)
        rows.append(dict(
            case=name, shape=[B, H, Sq, Sk, D], kv_heads=Hkv, dtype=dt,
            causal=causal, window=window, softcap=cap, route=route,
            max_abs_err=err, bound_share=worst, mean_rel_err=mean_rel,
            tolerance=dict(rtol=rtol, atol=atol, mean_rel=FLASH_MEAN_REL),
            ms=ms,
            plain_ms=cuda_ms(lambda: ops.flash_attention_plain(q, k, v, **kw),
                             reps=2, warmup=1),
            bound_ms=max(tb, to), bound_by="bytes" if tb >= to else "operations",
            library_ms=library_ms,
            vs_library=None if library_ms is None else ms / library_ms))
        del q, k, v
        torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------------------
# lm: qwen2-1.5b served through the flash kernel
# --------------------------------------------------------------------------

LM_ARCH = "qwen2-1.5b"
LM_NEW = 16


def _first_groups(tree, n):
    if isinstance(tree, dict):
        return {k: _first_groups(v, n) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_first_groups(v, n) for v in tree)
    return tree[:n]


def _serve_part(cfg, params, reqs, slots, max_len, dev):
    """Serve ``reqs`` with the launch counts at 0; returns the part's
    readings and its flash launches."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_requests
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    stats = {}
    t0 = time.perf_counter()
    done = serve_requests(cfg, params, reqs, batch_slots=slots,
                          max_len=max_len, device=dev, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    n_prefill = len(stats["prefill_s"])
    per_layer = cfg.num_layers
    require(launches["flash_attention"] == per_layer * n_prefill,
            f"lm: {launches['flash_attention']} flash_attention launches for "
            f"{n_prefill} prefill calls of {per_layer} layers")
    tokens = sum(len(r.out) for r in done)
    require(all(len(r.out) == r.max_new for r in done)
            and all(0 <= t < cfg.vocab_size for r in done for t in r.out),
            "lm: a request got the wrong number of tokens or an id out of "
            "the vocabulary")
    dec = stats["decode_s"]
    return dict(
        requests=len(done), slots=slots, max_len=max_len,
        prompt_lens=[len(r.prompt) for r in done],
        prefill_len=stats["prefill_len"],
        prefill_ms=[1e3 * x for x in stats["prefill_s"]],
        decode_ms_median=1e3 * float(np.median(dec)),
        decode_ms_mean=1e3 * float(np.mean(dec)), decode_steps=len(dec),
        tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        flash_launches=launches["flash_attention"],
        flash_launches_per_prefill=launches["flash_attention"] / n_prefill,
        first_out=done[0].out[:8]), launches


def _compare_prefill(cfg, params, toks, dev):
    """Last-position logits of one prefill with the flash kernel and with
    the plain attention path: (max |diff| / max |logit|, greedy-token
    agreement).  The flash prefill must make no broadcast copy of the KV
    heads (the kernel reads them in place); the plain one makes two per
    layer."""
    from repro_torch.models import init_cache, layers, prefill
    out = {}
    real_copy = layers._broadcast_kv
    for flash in (True, False):
        c = cfg.with_overrides(use_flash_kernel=flash)
        cache = init_cache(c, toks.shape[0], toks.shape[1] + LM_NEW, dev)
        copies = []

        def counted(k, group):
            copies.append(group)
            return real_copy(k, group)

        layers._broadcast_kv = counted
        try:
            out[flash], _ = prefill(c, params, {"tokens": toks}, cache)
        finally:
            layers._broadcast_kv = real_copy
        want = 0 if flash else 2 * c.num_layers
        require(len(copies) == want,
                f"lm: {len(copies)} KV broadcast copies in a prefill with "
                f"use_flash_kernel={flash}, expected {want}")
        del cache
        torch.cuda.empty_cache()
    f, p = out[True], out[False]
    require(bool(torch.isfinite(f).all()), "lm: non-finite logits")
    rel = float((f - p).abs().max().item() / p.abs().max().item())
    agree = float((f.argmax(-1) == p.argmax(-1)).float().mean().item())
    return rel, agree


def _warm_prefill(cfg, params, toks, dev, reps=3):
    """Prefill of ``toks`` at a shape already served: host ms of ``reps``
    synchronised calls, then one call under ``torch.profiler``: the device
    ms of every kernel and of the flash kernel, and the share of that
    call's wall time (profiler overhead included) with no kernel running."""
    from repro_torch.models import init_cache, prefill

    def once():
        cache = init_cache(cfg, toks.shape[0], toks.shape[1] + LM_NEW, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(cfg, params, {"tokens": toks}, cache)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    host_ms = [once() for _ in range(reps)]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    # the trace must hold every launch of the call: a trace that lost a
    # kernel record (seen once in a run of this script) is taken again,
    # once; the launch counts of ops.LAUNCHES must match either way
    shown = []
    for _ in range(2):
        from repro_torch.kernels import ops
        before = ops.LAUNCHES["flash_attention"]
        cache = init_cache(cfg, toks.shape[0], toks.shape[1] + LM_NEW, dev)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            prefill(cfg, params, {"tokens": toks}, cache)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        del cache
        require(ops.LAUNCHES["flash_attention"] - before == cfg.num_layers,
                "lm: the profiled prefill did not launch flash once a layer")
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "Command Buffer" not in e.name]
        flash = [e for e in kern if "flash_wgmma_kernel" in e.name]
        shown.append(len(flash))
        if len(flash) == cfg.num_layers:
            break
    require(len(flash) == cfg.num_layers,
            f"lm: the profiled prefills show {shown} flash kernels")
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    return dict(batch=list(toks.shape), host_ms=host_ms,
                profiled_wall_ms=wall, kernel_ms=busy,
                flash_kernel_ms=sum(e.time_range.elapsed_us()
                                    for e in flash) / 1e3,
                flash_kernels=len(flash), flash_kernels_traced=shown,
                idle_share=max(0.0, 1.0 - busy / wall))


def lm_phase(dev, seed):
    """Returns (summary, per-kernel launches of the served parts)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (Request, _pow2_at_least,
                                          cli_requests)
    from repro_torch.models import count_params, init_params
    cfg = get_config(LM_ARCH).with_overrides(use_flash_kernel=True)
    require((cfg.num_layers, cfg.d_model, cfg.vocab_size, cfg.num_heads,
             cfg.num_kv_heads, cfg.head_dim) == (28, 1536, 151936, 12, 2, 128),
            f"lm: {LM_ARCH} is not at its published width")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = count_params(cfg)
    params_bytes = torch.cuda.max_memory_allocated()

    parts = {}
    # (a) the reference CLI's traffic
    parts["cli"], la = _serve_part(cfg, params, cli_requests(cfg, 8, LM_NEW),
                                   4, 128, dev)
    rng = np.random.default_rng(seed + 50_000)
    long_reqs = [Request(i, rng.integers(0, cfg.vocab_size,
                                         size=int(n)).tolist(), LM_NEW)
                 for i, n in enumerate(rng.integers(1500, 2049, size=4))]
    require(_pow2_at_least(max(len(r.prompt) for r in long_reqs)) == 2048,
            "lm: the long prompts do not bucket to 2,048")
    # (b) four long prompts in one batch, then one of 8,192 tokens
    parts["long_2048"], lb = _serve_part(cfg, params, long_reqs, 4,
                                         2048 + LM_NEW, dev)
    req_8k = [Request(4, rng.integers(0, cfg.vocab_size, size=8192).tolist(),
                      LM_NEW)]
    parts["long_8192"], lc = _serve_part(cfg, params, req_8k, 1,
                                         8192 + LM_NEW, dev)
    launches = {k: la[k] + lb[k] + lc[k] for k in la}
    # the batch of (b), left-padded to its bucket as the serve loop pads it
    toks = np.zeros((4, 2048), np.int64)
    for i, r in enumerate(long_reqs):
        toks[i, 2048 - len(r.prompt):] = r.prompt
    toks = torch.from_numpy(toks).to(dev)
    warm = [_warm_prefill(cfg, params, toks, dev),
            _warm_prefill(cfg, params,
                          torch.tensor([req_8k[0].prompt], device=dev), dev)]

    # the batch of (b) again: flash against the plain attention path, in
    # bfloat16 at full depth and in float32 at 4 layers
    rel_bf16, agree_bf16 = _compare_prefill(cfg, params, toks, dev)
    require(rel_bf16 <= 3e-2, f"lm: flash and plain prefill logits differ "
            f"by {rel_bf16} of the largest logit (bfloat16)")
    cfg4 = cfg.with_overrides(num_layers=4, dtype="float32")
    params4 = dict(params, blocks=_first_groups(params["blocks"], 4))
    rel_f32, agree_f32 = _compare_prefill(cfg4, params4, toks, dev)
    require(rel_f32 <= 1e-3, f"lm: flash and plain prefill logits differ "
            f"by {rel_f32} of the largest logit (float32, 4 layers)")
    del params, params4
    torch.cuda.empty_cache()
    summary = dict(
        arch=LM_ARCH, layers=cfg.num_layers, d_model=cfg.d_model,
        heads=[cfg.num_heads, cfg.num_kv_heads, cfg.head_dim],
        vocab=cfg.vocab_size, params=n_params, param_dtype=cfg.param_dtype,
        dtype=cfg.dtype, init_s=init_s, params_bytes=params_bytes,
        parts=parts, warm_prefill=warm,
        flash_vs_plain=dict(
            bf16_rel=rel_bf16, bf16_tol=3e-2, bf16_greedy_agree=agree_bf16,
            f32_4layers_rel=rel_f32, f32_tol=1e-3,
            f32_greedy_agree=agree_f32, batch=[4, 2048]))
    return summary, launches


# --------------------------------------------------------------------------
# main
# --------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline-pairwise", metavar="PATH", default=None,
                    help="another version of kernels/csrc/pairwise.cu, built "
                         "beside this one and timed against it at every "
                         "captured width (phase kernels, parent_ms)")
    args = ap.parse_args()
    t_script = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, card=smi,
         device_name=torch.cuda.get_device_name(0))

    from repro_torch.core import sync
    from repro_torch.core.device_dbscan import GritCaps
    from repro_torch.core.validate import assert_labels_conformant
    from repro_torch.engine import cluster, estimate_caps
    from repro_torch.kernels import build, ops

    t0 = time.perf_counter()
    libs = build.build_all()
    baseline = None
    if args.baseline_pairwise:
        baseline = ops.declare_distance(build.load_source(
            args.baseline_pairwise, "pairwise_baseline", "pairwise"))
    emit("build", seconds=time.perf_counter() - t0,
         libraries=sorted(p.name for p in libs.values()),
         baseline_pairwise=args.baseline_pairwise)

    # ---- fit ------------------------------------------------------------
    t0 = time.perf_counter()
    pts, eps = make_points(args.n, args.seed)
    t_data = time.perf_counter() - t0
    # the host part of a cold fit, timed on its own (the cold fit below
    # repeats it: cluster() estimates its own caps)
    t0 = time.perf_counter()
    estimate_caps(pts, eps, MIN_PTS, use_kernels=True)
    estimate_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    sync.READS["count"] = 0
    t0 = time.perf_counter()
    res = cluster(pts, eps, MIN_PTS, engine="device-kernels")
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    cold_reads = sync.READS["count"]
    peak_bytes = torch.cuda.max_memory_allocated()
    for k in ("eps_count_batch", "row_min_batch"):
        require(launches[k] > 0, f"the main path never launched {k}")
    require(res.overflow == (), f"unresolved overflow {res.overflow}")
    require(res.labels.shape == (args.n,) and res.core.shape == (args.n,),
            "labels / core have the wrong shape")
    require(res.n_clusters >= 1, "the fit found no cluster")
    caps = GritCaps(**res.attempts[-1]["caps"])

    sync.READS["count"] = 0
    t0 = time.perf_counter()
    warm = cluster(pts, eps, MIN_PTS, engine="device-kernels", caps=caps)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_reads = sync.READS["count"]
    require(np.array_equal(warm.labels, res.labels)
            and np.array_equal(warm.core, res.core),
            "a second fit gave other labels")

    # per-stage times; the largest call of each batched kernel is kept
    captured = {"eps_count_batch": {}, "row_min_batch": {}}
    real_count, real_min = ops.eps_count_batch, ops.row_min_batch

    def keep(name, args):
        """Per candidate width: the largest call's operands, and the
        number of calls."""
        slot = captured[name].setdefault(args[1].shape[1], [args, 0])
        if args[1].numel() > slot[0][1].numel():
            slot[0] = args
        slot[1] += 1

    def keep_count(a, b, eps_, valid_b=None, valid_a=None, *, stop_at=None):
        keep("eps_count_batch", (a, b, valid_b, valid_a, eps_, stop_at))
        return real_count(a, b, eps_, valid_b, valid_a, stop_at=stop_at)

    def keep_min(a, b, valid_b=None):
        keep("row_min_batch", (a, b, valid_b))
        return real_min(a, b, valid_b)

    ops.eps_count_batch, ops.row_min_batch = keep_count, keep_min
    sync.TIMING["on"] = True
    sync.STAGES.clear()
    try:
        staged = cluster(pts, eps, MIN_PTS, engine="device-kernels", caps=caps)
    finally:
        sync.TIMING["on"] = False
        ops.eps_count_batch, ops.row_min_batch = real_count, real_min
    require(np.array_equal(staged.labels, res.labels), "staged fit differs")
    emit("fit", n=args.n, d=int(pts.shape[1]), eps=eps, min_pts=MIN_PTS,
         data_s=t_data, estimate_caps_s=estimate_s, cold_s=cold_s,
         warm_s=warm_s,
         attempts=[list(a["overflow"]) for a in res.attempts],
         caps=dataclasses.asdict(caps), clusters=res.n_clusters,
         noise=res.noise_count, core=int(res.core.sum()),
         launches=launches, host_reads_cold=cold_reads,
         host_reads_warm=warm_reads,
         stage_s={k: round(v, 6) for k, v in sync.STAGES.items()},
         max_memory_allocated=peak_bytes)

    # ---- kernels --------------------------------------------------------
    pairwise_build = pairwise_build_report()
    rows, tiers, main_path, cases, band_rows, routes = kernels_phase(
        captured, dev, baseline)
    emit("kernels", comparisons=cases, rows_in_eps_band=band_rows,
         tolerance="integer outputs equal; d2 rtol 1e-6 (equal on lattices)",
         shapes={r["name"]: r["shape"] for r in rows}, routes=routes,
         pairwise_build=pairwise_build, main_path_widths=tiers,
         main_path=main_path,
         floor_ms_is="an instruction-count estimate at the 1.98 GHz boost "
                     "clock, not a measurement",
         unbatched=[r for r in rows if r["name"] in ("eps_count", "row_min")])

    # ---- check ----------------------------------------------------------
    t0 = time.perf_counter()
    plain = cluster(pts, eps, MIN_PTS, engine="device", caps=caps)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    require(np.array_equal(plain.labels, res.labels),
            "engine 'device' (plain plane) gives other labels")
    require(np.array_equal(plain.core, res.core),
            "engine 'device' (plain plane) gives other core flags")
    sampled = check_sampled(
        torch.as_tensor(pts, dtype=torch.float64).to(dev),
        torch.as_tensor(res.labels).to(dev), torch.as_tensor(res.core).to(dev),
        eps, args.seed, dev)
    t0 = time.perf_counter()
    small, small_eps = make_points(20_000, args.seed + 1)
    got = cluster(small, small_eps, MIN_PTS, engine="device-kernels")
    ref = cluster(small, small_eps, MIN_PTS, engine="brute")
    assert_labels_conformant(small, small_eps, MIN_PTS, ref.labels,
                             got.labels, core=ref.core)
    require(np.array_equal(got.core, ref.core),
            "core flags differ from brute at n = 20,000")
    emit("check", plain_plane_equal=True, plain_plane_s=plain_s, **sampled,
         brute_n=20_000, brute_eps=small_eps, brute_clusters=ref.n_clusters,
         brute_s=time.perf_counter() - t0)

    # ---- serve ----------------------------------------------------------
    before_serve = dict(ops.LAUNCHES)    # serve_phase resets the counts
    serve, serve_launches, predict_call, index = serve_phase(
        pts, eps, caps, res.labels, args.seed, dev)
    require(serve_launches["row_min_batch"] > 0,
            "kernel-mode predict never launched row_min_batch")
    # the largest kernel-mode predict call: row_min_batch against its
    # plain version, timed (beside the baseline build when one is given)
    pa, pb, pvb = predict_call
    err, _, mism = compare_row_min(ops, pa, pb, pvb, True)
    require(err == 0.0 and mism == 0, f"row_min_batch differs from its "
            f"plain version on the predict call: err={err} argmin={mism}")
    predict_row_min = dict(shape=[*pa.shape[:2], pb.shape[1], pa.shape[2]],
                           kernel_route=ops.pairwise_route(pa.shape[2]),
                           **time_distance(ops._lib(), baseline,
                                           "row_min_batch", (pa, pb, pvb),
                                           lambda: ops.row_min_batch(pa, pb,
                                                                     pvb)))
    emit("serve", **serve, launches=serve_launches,
         predict_row_min=predict_row_min)

    # ---- server ---------------------------------------------------------
    before_server = dict(ops.LAUNCHES)  # server_phase resets the counts
    server, server_launches, server_call = server_phase(
        index, pts, eps, args.seed, smi)
    # server B's largest kernel-mode predict call against the plain version
    sa_, sb_, svb_ = server_call
    err, _, mism = compare_row_min(ops, sa_, sb_, svb_, True)
    require(err == 0.0 and mism == 0, f"row_min_batch differs from its "
            f"plain version on server B's call: err={err} argmin={mism}")
    emit("server", **server, launches=server_launches,
         row_min_batch_call=dict(shape=[*sa_.shape[:2], sb_.shape[1],
                                        sa_.shape[2]],
                                 max_abs_err=err, argmin_mismatches=mism),
         script_s=time.perf_counter() - t_script)
    del server_call, sa_, sb_, svb_

    # ---- guard-band kernels ---------------------------------------------
    _, lo2, hi2 = index.device_state.thresholds(index)
    eps_lo, eps_hi = math.sqrt(lo2), math.sqrt(hi2)
    band_rows_, band_tiers, band_cases, band_in = guard_band_phase(
        captured["eps_count_batch"], predict_call, eps_lo, eps_hi, dev,
        baseline)
    captured.clear()
    emit("guard_band", comparisons=band_cases, rows_in_band=band_in,
         eps_lo=eps_lo, eps_hi=eps_hi,
         tolerance="integer outputs and argmins equal; min and runner-up "
                   "equal on lattices and on the predict call, rtol 1e-6 "
                   "on random reals",
         predict_call=band_rows_, fit_widths=band_tiers,
         floor_ms_is="an instruction-count estimate at the 1.98 GHz boost "
                     "clock, not a measurement",
         script_s=time.perf_counter() - t_script)
    after_band = dict(ops.LAUNCHES)
    del index, predict_call, band_tiers, pts, res, warm, staged, plain
    torch.cuda.empty_cache()

    # ---- flash attention ------------------------------------------------
    flash_build = flash_build_report()
    flash_rows = flash_phase(dev, args.seed)
    emit("flash", cases=flash_rows, wgmma_build=flash_build,
         script_s=time.perf_counter() - t_script)
    flash_compare = ops.LAUNCHES["flash_attention"]
    torch.cuda.empty_cache()

    # ---- lm -------------------------------------------------------------
    lm, lm_launches = lm_phase(dev, args.seed)
    emit("lm", **lm, script_s=time.perf_counter() - t_script)
    torch.cuda.empty_cache()

    # launches on the four driven paths (the cold fit, the serve phase,
    # the server phase, the lm phase's served parts), each counted on its
    # own run; the distance kernels have no place on the lm path and
    # flash none on the other three; launches_script also counts the
    # comparison launches
    by_path = {name: {"fit": launches[name], "serve": serve_launches[name],
                      "server": server_launches[name],
                      "lm": lm_launches[name]} for name in REPLACES}
    for name, paths in by_path.items():
        off = (("fit", "serve", "server") if name == "flash_attention"
               else ("lm",))
        require(all(paths[p] == 0 for p in off),
                f"{name} launched on a path it has no place on: {paths}")
    extra = ("kernel_route", "graph_ms", "parent_ms", "parent_graph_ms")
    kernels = [dict(name=r["name"], route="cuda", source=PAIRWISE_SOURCE,
                    replaces=REPLACES[r["name"]],
                    launches=sum(by_path[r["name"]].values()),
                    launches_by_path=by_path[r["name"]],
                    launches_script=(before_serve[r["name"]]
                                     + before_server[r["name"]]
                                     + after_band[r["name"]]
                                     + lm_launches[r["name"]]),
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=None,
                    **{k: r[k] for k in extra if k in r})
               for r in rows + band_rows_]
    fr = flash_rows[0]                  # the lm path's prefill call
    kernels.append(dict(
        name="flash_attention", route="cuda", source=FLASH_SOURCE,
        kernel_route=fr["route"], kv_heads=fr["kv_heads"],
        replaces=REPLACES["flash_attention"],
        launches=sum(by_path["flash_attention"].values()),
        launches_by_path=by_path["flash_attention"],
        launches_script=(before_serve["flash_attention"]
                         + before_server["flash_attention"]
                         + flash_compare + lm_launches["flash_attention"]),
        shape=fr["shape"], dtype=fr["dtype"], max_abs_err=fr["max_abs_err"],
        ms=fr["ms"], plain_ms=fr["plain_ms"], bound_ms=fr["bound_ms"],
        bound_by=fr["bound_by"], library_ms=fr["library_ms"]))
    require(len(kernels) == 7, f"{len(kernels)} kernels in the summary")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
