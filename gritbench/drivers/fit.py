"""Traffic kind ``fit``: whole ``repro_torch.engine.cluster`` calls back
to back, each from host points to host labels and core flags, with no
caps passed, as a user clusters a new snapshot of a table.

Set-up runs ``warmup_fits`` whole fits on row orders of their own, then
makes a fixed store of ``input_orders`` inputs, the configuration's
points in as many further row orders drawn from the seed.  The window's
i-th fit gets input ``i % input_orders``, so consecutive fits differ in
row order and the store, and with it set-up, does not grow as fits get
faster.  The window ends with the last fit started before ``--seconds``
ran out; ``fit_s`` is the window's time over the fits it completed.
Every fit of the run is judged, its rows put back with the order it got,
against the float64 brute DBSCAN of the points.
"""

from __future__ import annotations

import time

import numpy as np
from torch.profiler import record_function

from gritbench import data, roofline
from gritbench.harness import SPAN_PREFIX, kernel_seconds, say
from gritbench.reference import brute

#: the batched distance kernels' device name (``csrc/pairwise.cu``)
DIST_KERNEL = "dist_kernel"
#: a trace covers the window's first fits: reducing a trace of every fit
#: takes longer than a traced run may last (360 s)
TRACE_FITS = 2
#: the harness's range around the window's i-th fit is SPAN + str(i)
SPAN = SPAN_PREFIX + "fit."
#: calls into the program's layers named in a traced window
SPANS = (("repro_torch.engine.adaptive", "estimate_caps"),
         ("repro_torch.engine.adaptive", "device_dbscan"),
         ("repro_torch.engine.registry", "_attach_index"))


class Driver:
    def __init__(self, run):
        self.run = run
        self.cfg = run.cell.config
        self.traffic = run.cell.traffic
        self.eps = float(self.cfg["eps"])
        self.min_pts = int(self.cfg["min_pts"])
        self.fits = []            # (row order index, labels, core)

    def _order(self, k: int) -> np.ndarray:
        if k not in self.orders:
            self.orders[k] = data.row_order(self.run.seed, k, len(self.pts))
        return self.orders[k]

    def _fit(self, k: int, x=None):
        if x is None:
            x = self.pts[self._order(k)]
        res = self.cluster(x, self.eps,
                           self.min_pts, engine=self.traffic["engine"],
                           device=self.run.device)
        self.fits.append((k, res.labels, res.core))
        return res

    def setup(self) -> None:
        from repro_torch.core import sync
        from repro_torch.engine import cluster
        self.cluster, self.sync = cluster, sync
        self.pts = data.cell_points(self.cfg, self.run.seed)
        self.orders = {}
        warm = int(self.traffic.get("warmup_fits", 1))
        say(f"points {self.pts.shape}, eps {self.eps}, min_pts {self.min_pts}")
        for k in range(warm):
            t0 = time.perf_counter()
            res = self._fit(k)
            say(f"warm-up fit {k}: {time.perf_counter() - t0:.3f} s, "
                f"{res.n_clusters} clusters, {len(res.attempts)} attempts "
                f"{[list(a['overflow']) for a in res.attempts]}")
        self.first = warm
        # every input of the window is made here: one made in the window
        # would add its permutation (0.1 - 0.2 s at 10^6 points) to a fit
        self.inputs = [self.pts[self._order(self.first + s)]
                       for s in range(int(self.traffic["input_orders"]))]
        say(f"store of {len(self.inputs)} window inputs made")

    def window(self, trace) -> dict:
        """The fits of the window, cycling over the store of inputs; a
        trace (``--trace 1``) covers the first ``TRACE_FITS`` of them."""
        sync = self.sync
        per_fit = []
        deadline = time.perf_counter() + self.run.seconds
        t0 = time.perf_counter()
        i = 0
        while i == 0 or time.perf_counter() < deadline:
            s = i % len(self.inputs)
            sync.READS["count"] = 0
            t_fit = time.perf_counter()
            with record_function(f"{SPAN}{i}"):
                res = self._fit(self.first + s, self.inputs[s])
            say(f"fit {i}: {time.perf_counter() - t_fit:.3f} s")
            per_fit.append({"attempts": len(res.attempts),
                            "host_reads": sync.READS["count"]})
            i += 1
            if trace is not None and i == TRACE_FITS:
                trace.stop()
        t1 = time.perf_counter()
        self.window_fits = i
        self.run.ctx["fits"] = per_fit
        return {"fit_s": (t1 - t0) / i}

    def traced_extras(self) -> None:
        """Readings that need the program alive and a fit of their own:
        the host cap estimate timed alone, the per-stage times of one fit
        (every stage boundary waits for the device), and the distance
        kernels' least time over the window's first fit."""
        from repro_torch.engine import estimate_caps
        from repro_torch.kernels import ops
        ctx, sync = self.run.ctx, self.sync
        x = self.inputs[0]
        t0 = time.perf_counter()
        estimate_caps(x, self.eps, self.min_pts, use_kernels=True)
        ctx["estimate_caps_s"] = time.perf_counter() - t0

        sync.STAGES.clear()
        sync.TIMING["on"] = True
        try:
            self._fit(self.first, x)
        finally:
            sync.TIMING["on"] = False
        ctx["stages_s"] = dict(sync.STAGES)

        # the least time of every distance call of the window's first fit,
        # computed beside a fit of the same row order outside the trace;
        # its device time is that fit's in the window's trace
        real_count, real_min = ops.eps_count_batch, ops.row_min_batch
        bound_ms = [0.0]

        def count(a, b, eps, valid_b=None, valid_a=None, *, stop_at=None):
            out = real_count(a, b, eps, valid_b, valid_a, stop_at=stop_at)
            bound_ms[0] += roofline.eps_count_batch_ms(
                a, b, eps, valid_b, valid_a, stop_at)
            return out

        def row_min(a, b, valid_b=None):
            out = real_min(a, b, valid_b)
            bound_ms[0] += roofline.row_min_batch_ms(a, b, valid_b)
            return out

        ops.eps_count_batch, ops.row_min_batch = count, row_min
        try:
            self._fit(self.first, x)
        finally:
            ops.eps_count_batch, ops.row_min_batch = real_count, real_min
        ctx["dist_bound_s"] = bound_ms[0] * 1e-3
        say(f"traced extras: estimate_caps {ctx['estimate_caps_s']:.3f} s, "
            f"stages {ctx['stages_s']}, distance bound {bound_ms[0]:.3f} ms")

    def read_trace(self, summary: dict) -> None:
        first = summary["spans"].get(f"{SPAN}0", {})
        self.run.ctx["dist_kernel_s"] = kernel_seconds(first, DIST_KERNEL)

    def close(self) -> None:
        self.inputs = None
        self.cluster = None

    def judge(self):
        ref = brute.dbscan(self.pts, self.eps, self.min_pts,
                           device=self.run.device)
        n = len(self.pts)
        core_err = label_err = failed = 0
        for j, (k, labels, core) in enumerate(self.fits):
            order = self._order(k)
            lab = np.empty(n, np.int64)
            lab[order] = labels
            cor = np.empty(n, bool)
            cor[order] = core
            got = brute.judge_fit(ref, lab, cor)
            core_err += got["core_flag_errors"]
            label_err += got["label_errors"]
            in_window = self.first <= j < self.first + self.window_fits
            if in_window and (got["core_flag_errors"] or got["label_errors"]):
                failed += 1
        checks = {
            "core_flag_errors": {"value": core_err, "limit": 0},
            "label_errors": {"value": label_err, "limit": 0},
        }
        correct = core_err == 0 and label_err == 0 and len(self.fits) >= 1
        return correct, self.window_fits, failed, checks
