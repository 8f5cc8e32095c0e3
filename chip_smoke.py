#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--n 1000000] [--seed 0]

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
           random reals (d2 within rtol 1e-6); CUDA-event times beside
           the least time the card could take for the same work
  check    (a) engine "device" (plain plane) gives equal labels and core
           flags; (b) core flags and the nearest-core rule recomputed in
           float64 for sampled points against all points; (c) the same
           generator at n = 20,000 conformant to the port's brute engine

The line before the last but one is the kernels' summary object, the
line before the last is the card's name and power limit as nvidia-smi
prints them, and the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
MIN_PTS = 64
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/pairwise.cu"
REPLACES = {
    "eps_count_batch": "src/repro/kernels/pairwise.py:164",
    "row_min_batch": "src/repro/kernels/pairwise.py:317",
    "eps_count": "src/repro/kernels/pairwise.py:76",
    "row_min": "src/repro/kernels/pairwise.py:120",
}


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


def lattice_inputs(B, P, C, d, seed, dev, dup=False):
    """Integer coordinates (float32-exact distances), random masks, one
    all-masked slot when B > 1, optional duplicated candidates."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-40, 40, size=(B, P, d)).astype(np.float32)
    b = rng.integers(-40, 40, size=(B, C, d)).astype(np.float32)
    if dup and C > 1:
        b[:, C // 2:] = b[:, :C - C // 2]
    vb = rng.uniform(size=(B, C)) > 0.3
    va = rng.uniform(size=(B, P)) > 0.2
    if B > 1:
        vb[0] = False
    t = lambda x: torch.as_tensor(x).to(dev)
    return t(a), t(b), t(vb), t(va)


def kernels_phase(captured, dev):
    from repro_torch.kernels import ops
    from repro_torch.kernels.ops import (eps_count_batch_plain,
                                         row_min_batch_plain)
    shapes = [(1, 1, 1, 1), (3, 5, 7, 2), (2, 17, 130, 3), (4, 127, 129, 4),
              (2, 64, 1300, 5), (3, 63, 600, 3), (2, 9, 260, 7)]
    cases = 0
    # 1. integer lattices: everything equal, whatever the thread layout
    for i, (B, P, C, d) in enumerate(shapes):
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
    # its own: compare, then time.  The summary row of a batched kernel
    # is the width the fit called most often (the widest among equals).
    rows, tiers = [], {"eps_count_batch": [], "row_min_batch": []}
    for C in sorted(captured["eps_count_batch"]):
        (a, b, vb, va, eps, stop_at), calls = captured["eps_count_batch"][C]
        B, P, d = a.shape
        diff = compare_eps_count(ops, a, b, eps, vb, va, stop_at, True)
        require(diff == 0, f"eps_count_batch differs from its plain version "
                f"on the main path's inputs at width {C}: {diff}")
        nbytes, nops = _needed_work(va.sum(1).double(), vb.sum(1).double(),
                                    B, P, C, d, True)
        bound, by = _bound(nbytes, nops)
        tiers["eps_count_batch"].append(dict(
            name="eps_count_batch", shape=[B, P, C, d], calls=calls,
            max_abs_err=float(diff),
            ms=cuda_ms(lambda: ops.eps_count_batch(a, b, eps, vb, va,
                                                   stop_at=stop_at)),
            plain_ms=cuda_ms(lambda: eps_count_batch_plain(a, b, eps, vb),
                             reps=2, warmup=1),
            bound_ms=bound, bound_by=by))
    for C in sorted(captured["row_min_batch"]):
        (a, b, vb), calls = captured["row_min_batch"][C]
        B, P, d = a.shape
        err, rel_ok, mism = compare_row_min(ops, a, b, vb, True)
        require(err == 0.0 and mism == 0, f"row_min_batch differs from its "
                f"plain version on the main path's inputs at width {C}: "
                f"err={err} argmin={mism}")
        nbytes, nops = _needed_work(
            torch.full((B,), float(P), device=dev).double(),
            vb.sum(1).double(), B, P, C, d, False)
        bound, by = _bound(nbytes + 4.0 * B * P, nops)    # second output
        tiers["row_min_batch"].append(dict(
            name="row_min_batch", shape=[B, P, C, d], calls=calls,
            max_abs_err=float(err),
            ms=cuda_ms(lambda: ops.row_min_batch(a, b, vb)),
            plain_ms=cuda_ms(lambda: row_min_batch_plain(a, b, vb),
                             reps=2, warmup=1),
            bound_ms=bound, bound_by=by))
    for name in ("eps_count_batch", "row_min_batch"):
        rows.append(max(tiers[name], key=lambda r: (r["calls"], r["shape"][2])))

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
    rows.append(dict(
        name="eps_count", shape=[M, N, d], max_abs_err=float(diff),
        ms=cuda_ms(lambda: ops.eps_count(a, b, eps, vb)),
        plain_ms=cuda_ms(lambda: eps_count_batch_plain(a[None], b[None], eps,
                                                       vb[None]),
                         reps=2, warmup=1),
        bound_ms=bound, bound_by=by))
    err, rel_ok, mism = compare_row_min(ops, a, b, vb, False)
    require(err == 0.0 and mism == 0,
            f"row_min differs from its plain version: err={err} argmin={mism}")
    rows.append(dict(
        name="row_min", shape=[M, N, d], max_abs_err=float(err),
        ms=cuda_ms(lambda: ops.row_min(a, b, vb)),
        plain_ms=cuda_ms(lambda: row_min_batch_plain(a[None], b[None],
                                                     vb[None]),
                         reps=2, warmup=1),
        bound_ms=_bound(nbytes + 4.0 * M, nops)[0],
        bound_by=_bound(nbytes + 4.0 * M, nops)[1]))
    return rows, tiers, cases, band_rows


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
# main
# --------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=0)
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
    emit("build", seconds=time.perf_counter() - t0,
         libraries=sorted(p.name for p in libs.values()))

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
    rows, tiers, cases, band_rows = kernels_phase(captured, dev)
    captured.clear()
    kernels = [dict(name=r["name"], route="cuda", source=KERNEL_SOURCE,
                    replaces=REPLACES[r["name"]],
                    launches=launches[r["name"]],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=None)
               for r in rows]
    emit("kernels", comparisons=cases, rows_in_eps_band=band_rows,
         tolerance="integer outputs equal; d2 rtol 1e-6 (equal on lattices)",
         shapes={r["name"]: r["shape"] for r in rows}, main_path_widths=tiers)

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
         brute_s=time.perf_counter() - t0,
         script_s=time.perf_counter() - t_script)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
