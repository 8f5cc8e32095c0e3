"""The reference against a naive O(n^2) DBSCAN, its judgments against
planted faults, the control's failure, the generators' determinism, the
roofline formulas on hand-computed shapes, and the imports."""

import ast
import sys
from collections import deque
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT),
                 str(ROOT / "gritbench" / "tests")]

from gritbench import data, harness, roofline  # noqa: E402
from gritbench.gen.seed_spreader import seed_spreader  # noqa: E402
from gritbench.reference import brute  # noqa: E402


def naive_dbscan(pts, eps, min_pts):
    """Textbook DBSCAN: a BFS from each unvisited core over the full
    float64 distance matrix."""
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    nb = d2 <= eps * eps
    core = nb.sum(1) >= min_pts
    lab = np.full(len(pts), -1)
    k = 0
    for i in np.flatnonzero(core):
        if lab[i] >= 0:
            continue
        lab[i] = k
        todo = deque([i])
        while todo:
            j = todo.popleft()
            for t in np.flatnonzero(nb[j]):
                if lab[t] < 0:
                    lab[t] = k
                    if core[t]:
                        todo.append(t)
        k += 1
    return lab, core, d2


def sample(n, d, variant, seed, scale=0.02):
    """Seed-spreader points squeezed into a small box, so that n <= 2,000
    holds cores, borders, noise and several clusters at eps 200."""
    pts = seed_spreader(n, d, variant=variant, restarts=4, c_reset=50,
                        seed=seed)
    return np.rint(pts * scale)


CASES = [(1500, 3, "varden", 1, 30.0, 8), (2000, 5, "simden", 2, 60.0, 6),
         (1200, 2, "varden", 3, 20.0, 5)]


@pytest.mark.parametrize("n,d,variant,seed,eps,min_pts", CASES)
def test_reference_equals_naive_dbscan(n, d, variant, seed, eps, min_pts):
    pts = sample(n, d, variant, seed)
    lab, core, d2 = naive_dbscan(pts, eps, min_pts)
    ref = brute.dbscan(pts, eps, min_pts, device="cpu", budget_bytes=1 << 20)
    assert np.array_equal(ref.core, core)
    assert 0 < core.sum() < n and (lab == -1).any()
    got = brute.judge_fit(ref, lab, core)
    assert got["core_flag_errors"] == 0 and got["label_errors"] == 0
    # the reference's own labelling is one the naive DBSCAN could give
    mine = brute.labels_of(ref)
    assert (mine[core] >= 0).all() and ((mine == -1) == (lab == -1)).all()
    pairs = {(a, b) for a, b in zip(mine[core], lab[core])}
    assert len(pairs) == len({a for a, _ in pairs}) == len({b for _, b in pairs})


@pytest.mark.parametrize("n,d,variant,seed,eps,min_pts", CASES)
def test_judge_fit_counts_planted_faults(n, d, variant, seed, eps, min_pts):
    pts = sample(n, d, variant, seed)
    lab, core, _ = naive_dbscan(pts, eps, min_pts)
    ref = brute.dbscan(pts, eps, min_pts, device="cpu")
    c = np.flatnonzero(core)[0]
    bad = lab.copy()
    bad[c] = lab.max() + 7                     # a core outside its cluster
    assert brute.judge_fit(ref, bad, core)["label_errors"] == 1
    noise = np.flatnonzero(lab == -1)[0]
    bad = lab.copy()
    bad[noise] = lab[c]                        # noise put in a cluster
    assert brute.judge_fit(ref, bad, core)["label_errors"] == 1
    flipped = core.copy()
    flipped[c] = False
    assert brute.judge_fit(ref, lab, flipped)["core_flag_errors"] == 1
    relabelled = np.where(lab >= 0, 100 + 3 * lab, -1)
    assert brute.judge_fit(ref, relabelled, core)["label_errors"] == 0


def test_the_control_is_not_correct_at_a_small_size():
    from gritbench import control
    cell = harness.find_cell("fit.ss-varden-3d")
    cell.config = dict(cell.config, n=6000, eps=300.0, min_pts=100)
    nums = control.control_numbers(cell, 5, "cpu")
    assert nums["core_flag_errors"] + nums["label_errors"] > 0


def test_generators_are_deterministic_in_the_seed():
    a = seed_spreader(3000, 3, variant="varden", seed=9)
    assert np.array_equal(a, seed_spreader(3000, 3, variant="varden", seed=9))
    assert not np.array_equal(a, seed_spreader(3000, 3, variant="varden",
                                               seed=10))
    cfg = dict(harness.find_cell("fit.ss-simden-5d").config, n=4000)
    big = 2 ** 31 + 12345
    p1, p2 = data.cell_points(cfg, big), data.cell_points(cfg, big)
    assert np.array_equal(p1, p2)
    p3 = data.cell_points(cfg, big + 1)
    assert not np.array_equal(p1, p3)
    assert np.array_equal(data.row_order(big, 2, 100),
                          data.row_order(big, 2, 100))


def test_every_seed_gets_the_same_distances():
    cfg = dict(harness.find_cell("fit.ss-varden-3d").config, n=800)
    a, b = data.cell_points(cfg, 1), data.cell_points(cfg, 2)
    da = np.sort(((a[:, None] - a[None]) ** 2).sum(-1).ravel())
    db = np.sort(((b[:, None] - b[None]) ** 2).sum(-1).ravel())
    assert np.array_equal(da, db)
    assert (a == np.rint(a)).all() and a.min() >= 0 and a.max() <= 1e5


def test_the_exact_product_equals_the_sum_of_differences():
    g = np.random.default_rng(3)
    q = g.integers(0, 100_001, size=(300, 5)).astype(np.float64)
    # partners at squared distance eps^2 - 1, eps^2 and eps^2 + 1, eps 5,000
    step = np.array([[4999.0, 99, 14, 1, 0], [3000, 4000, 0, 0, 0],
                     [5000, 1, 0, 0, 0]])
    c = np.concatenate([q[i * 100:(i + 1) * 100] + step[i] for i in range(3)])
    assert brute.exact_int(q) and brute.exact_int(c)
    assert not brute.exact_int(q + 0.5)
    qt, ct = torch.as_tensor(q), torch.as_tensor(c)
    a = brute.sq_dist(qt, ct, "float64")
    b = brute.sq_dist(qt, ct, "float64-int")
    assert torch.equal(a, b)
    eps2 = 5000.0 ** 2
    diag = torch.diagonal(a)
    assert diag.tolist() == [eps2 - 1] * 100 + [eps2] * 100 + [eps2 + 1] * 100


def test_roofline_on_hand_computed_shapes():
    # 2 slots, 3 rows, 4 candidates, d = 2: 5 live rows x 6 valid pairs
    va = torch.tensor([[1, 1, 0], [1, 1, 1]], dtype=torch.bool)
    vb = torch.tensor([[1, 1, 1, 0], [1, 1, 1, 1]], dtype=torch.bool)
    nbytes, ops = roofline.needed_work(va.sum(1).double(), vb.sum(1).double(),
                                       2, 3, 4, 2, True)
    assert ops == 3 * 2 * (2 * 3 + 3 * 4)
    assert nbytes == 4 * 2 * 5 + 4 * 2 * 7 + 2 * 4 + 2 * 3 + 4 * 2 * 3
    ms, by = roofline.bound(nbytes, ops)
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    ms, by = roofline.bound(1.0, 67e12)
    assert by == "operations" and ms == pytest.approx(1e3)
    # a bar of 2 on one row: its first two candidates are within eps
    a = torch.zeros((1, 1, 1))
    b = torch.tensor([[[0.0], [1.0], [0.5], [9.0]]])
    vb = torch.ones((1, 4), dtype=torch.bool)
    _, _, pairs = roofline.work_to_bars(a, b, vb, 1.0,
                                        torch.tensor([[2]]), 1, 1)
    assert pairs == 2
    _, _, pairs = roofline.work_to_bars(a, b, vb, 1.0,
                                        torch.tensor([[5]]), 1, 1)
    assert pairs == 4                          # never reached: all of them


def _roots(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", sorted((ROOT / "gritbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    roots = set(_roots(path))
    assert not roots & {"jax", "jaxlib", "flax", "repro"}, roots
    if "reference" in path.relative_to(ROOT).parts:
        assert "repro_torch" not in roots
