"""Quickstart: exact GriT-DBSCAN through the PyTorch/CUDA port's engine API.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The twin of ``examples/quickstart.py`` through ``repro_torch`` only.  One
entry point (``repro_torch.engine.cluster``) drives every backend: the
paper-faithful host pipeline, the LDF variant, the device pipeline with
adaptive static caps on the plain distance plane and on the hand-written
CUDA kernels, and the slab-sharded distributed pipeline.  All are
verified equivalent to the O(n^2) oracle, and the kernel fit is checked
point for point by the chunked float64 brute check on the device.  The
last sections show the fit-once / serve-many path: ``return_index=True``
keeps the fitted ``GritIndex``, which snapshots to flat arrays, restores
in another process, and serves the full mutation plane -- point queries,
micro-batch inserts, exact deletes and compaction -- without ever
refitting; and the sharded variant (``fit_sharded`` ->
``ShardedGritIndex``): a distributed fit kept as per-slab index shards
plus a global label map, serving slab-routed predicts and cross-shard
inserts/deletes the same way.  Without ``--device`` it runs on the CUDA
device and raises when there is none.
"""

import argparse
import io
import time

import numpy as np

from repro_torch.core.validate import (assert_dbscan_equivalent,
                                       check_conformant_brute)
from repro_torch.data.seed_spreader import seed_spreader
from repro_torch.engine import (available_engines, cluster,
                                engine_descriptions, resolve_device)
from repro_torch.index import GritIndex, ShardedGritIndex, fit_sharded


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    dev = resolve_device(ap.parse_args(argv).device)
    summary = {"device": str(dev), "engines": {}}

    n, d = 4000, 3
    eps, min_pts = 3500.0, 10
    print(f"generating {n} points in {d}-D (seed-spreader, varden)...")
    pts = seed_spreader(n, d, variant="varden", restarts=6, seed=0)

    print("registered engines:")
    for name, desc in engine_descriptions().items():
        print(f"  {name:14s} {desc.splitlines()[0]}")

    print("\nGriT-DBSCAN (paper Algorithm 6, grid tree + FastMerging):")
    r = cluster(pts, eps, min_pts, engine="grit", device=dev)
    s = r.stats
    print(f"  clusters={r.n_clusters}  grids={s['num_grids']}  "
          f"kappa_max={s.get('merge_max_iters', 0)}  "
          f"merge dist evals={s.get('merge_dist_evals', 0):,}")
    print(f"  time: partition {s['t_partition']*1e3:.1f}ms  "
          f"neighbors {s['t_neighbors']*1e3:.1f}ms  "
          f"cores {s['t_cores']*1e3:.1f}ms  merge {s['t_merge']*1e3:.1f}ms  "
          f"assign {s['t_assign']*1e3:.1f}ms")

    print("GriT-DBSCAN-LDF (union-find, low-density-first):")
    r_ldf = cluster(pts, eps, min_pts, engine="grit-ldf", device=dev)
    print(f"  clusters={r_ldf.n_clusters}  "
          f"merge checks={r_ldf.stats['merge_checks']} "
          f"(vs {s['merge_checks']} for BFS order)")

    runs = {"grit": r, "grit-ldf": r_ldf}
    for name, what in (("device", "plain distance plane"),
                       ("device-kernels", "hand-written CUDA kernels"),
                       ("distributed", "4 slab shards on one device")):
        print(f"device pipeline ({name}: {what}, adaptive caps):")
        opts = {"n_shards": 4} if name == "distributed" else {}
        t0 = time.perf_counter()
        runs[name] = res = cluster(pts, eps, min_pts, engine=name,
                                   device=dev, **opts)
        trail = " -> ".join(str(a["overflow"] or "ok")
                            for a in res.attempts)
        print(f"  clusters={res.n_clusters}  cap attempts: {trail}  "
              f"{(time.perf_counter() - t0) * 1e3:.1f}ms  "
              f"(caps estimated from grid stats, no hand tuning)")

    print(f"validating all {len(available_engines()) - 1} against the "
          f"O(n^2) oracle...")
    ref = runs["brute"] = cluster(pts, eps, min_pts, engine="brute",
                                  device=dev)
    for name in available_engines():
        assert_dbscan_equivalent(pts, eps, min_pts, ref.labels,
                                 runs[name].labels)
        summary["engines"][name] = (runs[name].n_clusters,
                                    runs[name].noise_count)
    print("all equivalent.")
    # the same check at any n: chunked float64 sweeps on the device,
    # nothing of the code under test (core flags, core partition, noise,
    # borders, labels on every uncontested point)
    rep = check_conformant_brute(pts, eps, min_pts,
                                 runs["device-kernels"].labels,
                                 runs["device-kernels"].core, device=dev)
    print(f"  float64 brute check of device-kernels on {rep['device']}: "
          f"{rep['cores']} cores, {rep['clusters']} clusters, "
          f"{rep['contested']} contested borders, {rep['noise']} noise, "
          f"{rep['pairs_total']:,} pairs in "
          f"{rep['seconds']['total'] * 1e3:.1f}ms")
    summary["brute_check"] = {k: rep[k] for k in
                              ("cores", "clusters", "contested", "noise")}

    print("\nfit once, serve many (the GritIndex serving plane):")
    fitted = cluster(pts, eps, min_pts, engine="grit", return_index=True,
                     device=dev)
    buf = io.BytesIO()
    fitted.index.save(buf)                # flat arrays: ships anywhere
    buf.seek(0)
    idx = GritIndex.load(buf)             # e.g. in another process
    rng = np.random.default_rng(1)
    queries = pts[rng.integers(0, n, 500)] + rng.normal(
        scale=0.2 * eps, size=(500, d))
    t0 = time.perf_counter()
    labels = idx.predict(queries, device=dev)  # nearest-core-within-eps
    t_pred = time.perf_counter() - t0
    print(f"  snapshot {buf.getbuffer().nbytes / 1e3:.0f}kB -> restore -> "
          f"predict 500 queries in {t_pred * 1e3:.1f}ms "
          f"({int((labels >= 0).sum())} assigned, "
          f"{int((labels < 0).sum())} noise) -- no refit")
    summary["predict"] = (int((labels >= 0).sum()), int((labels < 0).sum()))
    st = idx.insert(queries[:64])         # micro-batch incremental update
    print(f"  insert 64 points: {st['newly_core']} newly core, "
          f"{st['affected_grids']} grids recomputed, "
          f"{st['t_total'] * 1e3:.1f}ms")
    # the full mutation plane: fit -> insert -> delete -> compact.
    # deletes are by arrival id (fit points are 0..n-1, inserts append;
    # ids are never reused) and are exact even where DBSCAN is
    # non-monotone -- cutting a bridge splits the cluster, and the
    # persistent merge graph makes the component recompute cheap.
    # unknown ids are rejected, not raised (TTL races are normal).
    st = idx.delete(np.arange(n, n + 32))  # drop half the insert above
    print(f"  delete 32 points: {st['demoted']} cores demoted, "
          f"{st['changed_grids']} grids re-decided, "
          f"{st['rejected']} ids rejected, {st['t_total'] * 1e3:.1f}ms")
    st = idx.compact()                    # re-pack tombstoned rows now
    print(f"  compact: {st['removed']} rows re-packed "
          f"({idx.n_live} live); deletes also auto-compact past "
          f"{idx.compact_threshold:.0%} dead")
    summary["compact"] = (st["removed"], idx.n_live)

    print("\ndevice-resident serving (same answers, kernel hot path):")
    # keep the serving-hot arrays resident as tensors on the device:
    # predict and the delta engine's hot stages run through guard-banded
    # float32 kernels, with every uncertain case re-decided by the same
    # host float64 code -- outputs stay bit-identical to host serving
    # (pinned by tests/test_torch_device_serving.py), it is purely a
    # faster route on large batches.  drop_device_state() returns to
    # host-only.
    idx.ensure_device_state(dev)
    stats = {}
    labels_dev = idx.predict(queries, mode="device", stats=stats)
    assert np.array_equal(labels_dev, idx.predict(queries, mode="host"))
    print(f"  predict {len(queries)} queries on the resident state: "
          f"pack {stats['t_pack'] * 1e3:.1f}ms + kernel "
          f"{stats['t_kernel'] * 1e3:.1f}ms, {stats['uncertain']} "
          f"band-uncertain queries re-decided in float64 -- labels "
          f"bit-identical to host")
    st = idx.insert(queries[64:128])      # mutations keep buffers fresh
    print(f"  insert 64 more: flag updates scattered on the device + "
          f"mirror re-ship, {st['t_total'] * 1e3:.1f}ms")
    idx.drop_device_state()

    print("\ndistributed fit -> snapshot -> predict (the sharded plane):")
    # with several cards pass devices=[...] (one fit shard each); on one
    # device the distributed engine runs the 4 slabs there
    sidx = fit_sharded(pts, eps, min_pts, n_shards=4, engine="distributed",
                       device=dev)
    print(f"  {sidx.num_shards} slab shards, cuts at "
          f"{np.round(sidx.cuts, 0).tolist()} (dim-0 grid lines)")
    buf = io.BytesIO()
    sidx.save(buf)                        # per-shard snapshots, one file
    buf.seek(0)
    sidx = ShardedGritIndex.load(buf)     # e.g. on the serving host
    stats = {}
    t0 = time.perf_counter()
    labels = sidx.predict(queries, stats=stats, device=dev)  # slab-routed
    t_pred = time.perf_counter() - t0
    print(f"  snapshot {buf.getbuffer().nbytes / 1e3:.0f}kB -> restore -> "
          f"predict {len(queries)} queries in {t_pred * 1e3:.1f}ms "
          f"({stats['multi_routed']} cut-band queries consulted both "
          f"neighbor shards)")
    st = sidx.insert(queries[:64])        # touched shards + reconcile
    print(f"  insert 64 points: shards {st['shards_touched']} touched, "
          f"{st['newly_core']} newly core, "
          f"{st['reconcile_unions']} cross-shard label unions, "
          f"{st['t_total'] * 1e3:.1f}ms")
    st = sidx.delete(np.arange(n, n + 32))  # owner + ghost copies go
    print(f"  delete 32 points: shards {st['shards_touched']} touched, "
          f"label map rebuilt from {st['reconcile_unions']} witness "
          f"unions, {st['t_total'] * 1e3:.1f}ms")
    summary["sharded"] = sidx.num_shards
    print("done.")
    return summary


if __name__ == "__main__":
    main()
