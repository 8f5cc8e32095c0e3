"""Port FastMerging and component labelling vs the JAX package: merge
decisions **and** the iteration count (the paper's kappa) equal per
pair, component labels equal; decisions also equal to the host
Algorithm 5 and to the brute MinDist oracle."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import labels as jlabels, merging as jmerging
from repro_torch.core import labels as tlabels, merging as tmerging
from repro_torch.data.scenarios import get_scenario


def _pairs(seed, n_pairs, m, d, eps):
    """Padded point-set pairs at separations around eps: clearly apart,
    clearly touching, and in between; random masks, some sets empty."""
    rng = np.random.default_rng(seed)
    si = rng.uniform(0, eps, size=(n_pairs, m, d))
    gap = rng.choice([0.3, 0.9, 1.05, 1.4, 2.5], size=(n_pairs, 1, 1)) * eps
    shift = np.zeros((n_pairs, 1, d))
    shift[:, 0, 0] = 1.0
    sj = rng.uniform(0, eps, size=(n_pairs, m, d)) + (eps + gap) * shift
    vi = rng.uniform(size=(n_pairs, m)) > 0.3
    vj = rng.uniform(size=(n_pairs, m)) > 0.3
    vi[0] = False                       # empty s_i
    vj[1] = False                       # empty s_j
    vi[2, 1:] = False                   # singleton sets
    vi[2, 0] = True
    return (si.astype(np.float32), vi, sj.astype(np.float32), vj)


@pytest.mark.parametrize("d", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("max_iters", [2, 64])
def test_fast_merging_batch_equal(d, max_iters):
    eps = 100.0
    si, vi, sj, vj = _pairs(10 + d, 96, 12, d, eps)
    want, want_it = jmerging.fast_merging_batch(
        jnp.asarray(si), jnp.asarray(vi), jnp.asarray(sj), jnp.asarray(vj),
        eps, max_iters=max_iters)
    got, got_it = tmerging.fast_merging_batch(
        torch.as_tensor(si), torch.as_tensor(vi), torch.as_tensor(sj),
        torch.as_tensor(vj), eps, max_iters=max_iters)
    assert got.dtype == torch.bool and got_it.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_it.numpy(), np.asarray(want_it))
    if max_iters == 64:
        assert int(got_it.max()) < 64
        for k in range(len(si)):
            a, b = si[k][vi[k]], sj[k][vj[k]]
            exact = len(a) > 0 and len(b) > 0 and \
                tmerging.brute_min_dist(a.astype(np.float64),
                                        b.astype(np.float64)) <= eps
            assert bool(got[k]) == exact, f"pair {k}"
            assert tmerging.fast_merging(a, b, eps) == exact
            if len(a) and len(b):
                assert tmerging.center_prune_merge(a, b, eps) == exact


@pytest.mark.parametrize("name", ["blobs-2d", "blobs-3d", "cross-slab-2d",
                                  "simden-5d"])
def test_fast_merging_equal_on_scenario_grids(name):
    """Pairs of neighbouring grids of a catalogue scenario (all points
    taken as core), the sets the pipeline's merge stage sees."""
    from repro_torch.core.grid_tree import GridTree
    from repro_torch.core.grids import build_grids
    sc = get_scenario(name)
    pts = sc.points()
    gi = build_grids(pts, sc.eps)
    indptr, nbr, _ = GridTree.build(gi.ids).query(gi.ids, include_self=False)
    m = int(gi.counts.max())
    pairs = [(g, h) for g in range(gi.num_grids)
             for h in nbr[indptr[g]:indptr[g + 1]] if h > g][:400]
    si = np.zeros((len(pairs), m, sc.d), np.float32)
    sj = np.zeros_like(si)
    vi = np.zeros((len(pairs), m), bool)
    vj = np.zeros_like(vi)
    for k, (g, h) in enumerate(pairs):
        a = pts[gi.order[gi.starts[g]:gi.starts[g] + gi.counts[g]]]
        b = pts[gi.order[gi.starts[h]:gi.starts[h] + gi.counts[h]]]
        # re-centred as float32 keeps the sets at stencil scale
        si[k, :len(a)], vi[k, :len(a)] = a - pts.min(0), True
        sj[k, :len(b)], vj[k, :len(b)] = b - pts.min(0), True
    want, want_it = jmerging.fast_merging_batch(
        jnp.asarray(si), jnp.asarray(vi), jnp.asarray(sj), jnp.asarray(vj),
        sc.eps, max_iters=2 * m + 4)
    got, got_it = tmerging.fast_merging_batch(
        torch.as_tensor(si), torch.as_tensor(vi), torch.as_tensor(sj),
        torch.as_tensor(vj), sc.eps, max_iters=2 * m + 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_it.numpy(), np.asarray(want_it))
    assert len(pairs) > 0 and got.any()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_label_propagation_equal(seed):
    rng = np.random.default_rng(seed)
    n, e = 200, 260
    edges = rng.integers(0, n, size=(e, 2)).astype(np.int32)
    edge_valid = rng.uniform(size=e) > 0.4
    edges[~edge_valid] = rng.integers(-5, 10 * n, size=((~edge_valid).sum(), 2))
    node_valid = rng.uniform(size=n) > 0.1
    if seed == 3:                       # one long path: many rounds
        edges[:, 0] = np.arange(e) % (n - 1)
        edges[:, 1] = edges[:, 0] + 1
        edge_valid[:] = True
    want = jlabels.label_propagation(n, jnp.asarray(edges),
                                     jnp.asarray(edge_valid),
                                     jnp.asarray(node_valid))
    got = tlabels.label_propagation(n, torch.as_tensor(edges),
                                    torch.as_tensor(edge_valid),
                                    torch.as_tensor(node_valid))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # same components as the host union-find
    uf = tlabels.UnionFind(n)
    for (u, v), ok in zip(edges, edge_valid):
        if ok:
            uf.union(int(u), int(v))
    roots = uf.labels()
    lab = got.numpy()
    for i in np.flatnonzero(node_valid):
        members = roots == roots[i]
        assert lab[i] == np.flatnonzero(members).min()
    assert (lab[~node_valid] == n).all()


@pytest.mark.parametrize("n,seed", [(64, 0), (4096, 1), (4096, 2)])
def test_label_propagation_reaches_the_fixpoint_on_a_shuffled_path(n, seed):
    """A path over the nodes in shuffled order is one component.  Labels
    that move one hop a round (the reference's rule, capped at
    log2(n) + 2 rounds) stop far short of it: 123 components at n =
    4,096; hooking roots and jumping pointers runs to the fixpoint."""
    perm = np.random.default_rng(seed).permutation(n)
    edges = np.stack([perm[:-1], perm[1:]], 1).astype(np.int32)
    got = tlabels.label_propagation(n, torch.as_tensor(edges),
                                    torch.ones(n - 1, dtype=torch.bool),
                                    torch.ones(n, dtype=torch.bool))
    assert (got == 0).all()
    if n == 4096:
        ref = np.asarray(jlabels.label_propagation(
            n, jnp.asarray(edges), jnp.ones(n - 1, bool), jnp.ones(n, bool)))
        assert len(np.unique(ref)) > 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_label_propagation_is_the_union_find_on_random_graphs(seed):
    """Sparse random graphs with many components, invalid edges and
    invalid nodes: every valid node gets the least node of its
    union-find component, every invalid one ``n``."""
    rng = np.random.default_rng(seed)
    n = 3000
    e = int(n * rng.uniform(0.4, 1.1))
    edges = rng.integers(0, n, size=(e, 2)).astype(np.int32)
    edge_valid = rng.uniform(size=e) > 0.2
    node_valid = rng.uniform(size=n) > 0.05
    got = tlabels.label_propagation(n, torch.as_tensor(edges),
                                    torch.as_tensor(edge_valid),
                                    torch.as_tensor(node_valid)).numpy()
    uf = tlabels.UnionFind(n)
    for (u, v), ok in zip(edges, edge_valid):
        if ok:
            uf.union(int(u), int(v))
    roots = uf.labels()
    least = {}
    for i in range(n):
        least.setdefault(roots[i], i)
    want = np.array([least[roots[i]] for i in range(n)])
    np.testing.assert_array_equal(got[node_valid], want[node_valid])
    assert (got[~node_valid] == n).all()
