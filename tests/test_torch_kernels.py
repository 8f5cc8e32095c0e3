"""Port kernels plane vs the JAX package: the plain PyTorch versions of
``eps_count[_batch]`` / ``row_min[_batch]`` against ``repro.kernels.ops``
(default dispatch and the Pallas kernels under the interpreter) and
``repro.kernels.ref``, on the same numpy inputs.

Tolerances: integer outputs equal; float32 distances ``rtol=1e-5,
atol=1e-4`` (summation order and, against the ``aa + bb - 2ab`` oracle,
the form of the contraction).  The CUDA kernels themselves are held
against these plain versions on the card by ``chip_smoke.py``.
"""

import zlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import ops as jops, ref as jref
from repro_torch.kernels import ops as tops, ref as tref

TOL = dict(rtol=1e-5, atol=1e-4)


def _rng(*key) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _batch(key, bsz, m, n, d):
    rng = _rng(*key)
    a = (rng.normal(size=(bsz, m, d)) * 10).astype(np.float32)
    b = (rng.normal(size=(bsz, n, d)) * 10).astype(np.float32)
    vb = rng.uniform(size=(bsz, n)) > 0.3
    if bsz > 1:
        vb[0] = False          # one slot with no valid candidate at all
    return a, b, vb


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _assert_argmin(got_i, want_i, d2, vb):
    """Equal argmins, or a legitimate distance tie (the matmul-form
    oracle may round a tie the other way)."""
    got_i, want_i = np.asarray(got_i), np.asarray(want_i)
    for bb, mm in zip(*np.nonzero(got_i != want_i)):
        gi, wi = got_i[bb, mm], want_i[bb, mm]
        assert gi >= 0 and vb[bb, gi], f"[{bb},{mm}]: argmin {gi} invalid"
        np.testing.assert_allclose(d2[bb, mm, gi], d2[bb, mm, wi], **TOL)


# M, N deliberately unaligned; d sweeps the supported 1..5
BATCH_SHAPES = [(1, 1, 1, 1), (3, 5, 7, 2), (2, 17, 130, 3), (2, 9, 40, 4),
                (2, 6, 33, 5)]


@pytest.mark.parametrize("bsz,m,n,d", BATCH_SHAPES)
@pytest.mark.parametrize("dispatch", ["default", "interpret", "ref"])
def test_eps_count_batch_matches_reference(bsz, m, n, d, dispatch):
    a, b, vb = _batch(("eps_count_batch", bsz, m, n, d), bsz, m, n, d)
    got = tops.eps_count_batch(_t(a), _t(b), 6.0, _t(vb))
    aj, bj, vj = jnp.asarray(a), jnp.asarray(b), jnp.asarray(vb)
    want = {"default": lambda: jops.eps_count_batch(aj, bj, 6.0, vj),
            "interpret": lambda: jops.eps_count_batch(aj, bj, 6.0, vj,
                                                      interpret=True),
            "ref": lambda: jref.eps_count_batch(aj, bj, 6.0, vj)}[dispatch]()
    assert got.dtype == torch.int32 and tuple(got.shape) == (bsz, m)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bsz,m,n,d", BATCH_SHAPES)
@pytest.mark.parametrize("dispatch", ["default", "interpret", "ref"])
def test_row_min_batch_matches_reference(bsz, m, n, d, dispatch):
    a, b, vb = _batch(("row_min_batch", bsz, m, n, d), bsz, m, n, d)
    got_m, got_i = tops.row_min_batch(_t(a), _t(b), _t(vb))
    aj, bj, vj = jnp.asarray(a), jnp.asarray(b), jnp.asarray(vb)
    want_m, want_i = {
        "default": lambda: jops.row_min_batch(aj, bj, vj),
        "interpret": lambda: jops.row_min_batch(aj, bj, vj, interpret=True),
        "ref": lambda: jref.row_min_batch(aj, bj, vj)}[dispatch]()
    assert got_m.dtype == torch.float32 and got_i.dtype == torch.int32
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), **TOL)
    if dispatch == "default":
        # same direct-difference form on both sides: equal, not just tied
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    else:
        _assert_argmin(got_i.numpy(), want_i,
                       np.asarray(jref.sq_dists_batch(aj, bj)), vb)
    if bsz > 1:   # the all-masked slot obeys the (inf, -1) contract
        assert np.isinf(got_m[0].numpy()).all()
        assert (got_i[0].numpy() == -1).all()


@pytest.mark.parametrize("m,n,d", [(1, 1, 1), (5, 7, 2), (130, 257, 3)])
def test_unbatched_wrappers_match_reference(m, n, d):
    rng = _rng("unbatched", m, n, d)
    a = (rng.normal(size=(m, d)) * 10).astype(np.float32)
    b = (rng.normal(size=(n, d)) * 10).astype(np.float32)
    vb = rng.uniform(size=n) > 0.25
    aj, bj, vj = jnp.asarray(a), jnp.asarray(b), jnp.asarray(vb)
    got = tops.eps_count(_t(a), _t(b), 6.0, _t(vb))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jops.eps_count(aj, bj, 6.0, vj)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jref.eps_count(aj, bj, 6.0, vj)))
    got_m, got_i = tops.row_min(_t(a), _t(b), _t(vb))
    want_m, want_i = jops.row_min(aj, bj, vj)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), **TOL)
    _assert_argmin(got_i.numpy()[None], np.asarray(want_i)[None],
                   np.asarray(jref.sq_dists(aj, bj))[None], vb[None])
    assert tuple(got.shape) == (m,) and tuple(got_i.shape) == (m,)
    # no valid_b at all: every candidate counts
    np.testing.assert_array_equal(
        tops.eps_count(_t(a), _t(b), 6.0).numpy(),
        np.asarray(jref.eps_count(aj, bj, 6.0)))


@pytest.mark.parametrize("d", [1, 2, 3, 4, 5])
def test_torch_oracle_matches_jax_oracle(d):
    """``repro_torch.kernels.ref`` is the same aa + bb - 2ab oracle."""
    a, b, vb = _batch(("oracle", d), 3, 11, 29, d)
    aj, bj, vj = jnp.asarray(a), jnp.asarray(b), jnp.asarray(vb)
    np.testing.assert_allclose(
        tref.sq_dists_batch(_t(a), _t(b)).numpy(),
        np.asarray(jref.sq_dists_batch(aj, bj)), **TOL)
    np.testing.assert_allclose(
        tref.sq_dists(_t(a[1]), _t(b[1])).numpy(),
        np.asarray(jref.sq_dists(aj[1], bj[1])), **TOL)
    np.testing.assert_array_equal(
        tref.eps_count_batch(_t(a), _t(b), 6.0, _t(vb)).numpy(),
        np.asarray(jref.eps_count_batch(aj, bj, 6.0, vj)))
    np.testing.assert_array_equal(
        tref.eps_count(_t(a[1]), _t(b[1]), 6.0, _t(vb[1])).numpy(),
        np.asarray(jref.eps_count(aj[1], bj[1], 6.0, vj[1])))
    tm, ti = tref.row_min_batch(_t(a), _t(b), _t(vb))
    jm, ji = jref.row_min_batch(aj, bj, vj)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **TOL)
    _assert_argmin(ti.numpy(), ji, np.asarray(jref.sq_dists_batch(aj, bj)),
                   vb)
    tm, ti = tref.row_min(_t(a[0]), _t(b[0]), _t(vb[0]))
    assert np.isinf(tm.numpy()).all() and (ti.numpy() == -1).all()


_CPU_WRAPPERS = {
    "eps_count_batch": (lambda a, b, vb: tops.eps_count_batch(a, b, 6.0, vb),
                        lambda a, b, vb: tops.eps_count_batch_plain(
                            a, b, 6.0, vb)),
    "row_min_batch": (tops.row_min_batch, tops.row_min_batch_plain),
    "eps_count_band_batch": (
        lambda a, b, vb: tops.eps_count_band_batch(a, b, 5.5, 6.5, vb),
        lambda a, b, vb: tops.eps_count_band_batch_plain(a, b, 5.5, 6.5, vb)),
    "row_min2_batch": (tops.row_min2_batch, tops.row_min2_batch_plain),
    "eps_count": (lambda a, b, vb: tops.eps_count(a[1], b[1], 6.0, vb[1]),
                  lambda a, b, vb: tops.eps_count_batch_plain(
                      a[1:2], b[1:2], 6.0, vb[1:2])[0]),
    "row_min": (lambda a, b, vb: tops.row_min(a[1], b[1], vb[1]),
                lambda a, b, vb: tuple(
                    x[0] for x in tops.row_min_batch_plain(a[1:2], b[1:2],
                                                          vb[1:2]))),
}


@pytest.mark.parametrize("name", sorted(_CPU_WRAPPERS))
def test_cpu_wrapper_takes_the_plain_version(name, monkeypatch):
    """On CPU tensors every wrapper returns its plain version's result and
    never reaches the ``aa + bb - 2ab`` oracles (only tests call them)."""
    for fn in ("sq_dists", "sq_dists_batch", "eps_count", "row_min",
               "eps_count_batch", "row_min_batch", "eps_count_band_batch",
               "row_min2_batch"):
        monkeypatch.setattr(tref, fn, lambda *x, **k: pytest.fail(
            "a wrapper called the oracle"))
    a, b, vb = _batch(("cpu_wrapper", name), 3, 7, 19, 3)
    wrapper, plain = _CPU_WRAPPERS[name]
    got, want = wrapper(_t(a), _t(b), _t(vb)), plain(_t(a), _t(b), _t(vb))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("stop_at", [1, 3, 8, 1000])
def test_eps_count_stop_at_contract(stop_at):
    """min(count, k) == min(exact, k) on live rows, for the port and for
    the reference's early-exit loop alike, so thresholding at >= k
    agrees everywhere."""
    bsz, m, n, d = 3, 9, 260, 2
    a, b, vb = _batch(("stop_at", bsz, m, n, d), bsz, m, n, d)
    va = _rng("stop_at_va", stop_at).uniform(size=(bsz, m)) > 0.2
    exact = np.asarray(jref.eps_count_batch(jnp.asarray(a), jnp.asarray(b),
                                            6.0, jnp.asarray(vb)))
    got = tops.eps_count_batch(_t(a), _t(b), 6.0, _t(vb), _t(va),
                               stop_at=stop_at).numpy()
    jgot = np.asarray(jops.eps_count_batch(
        jnp.asarray(a), jnp.asarray(b), 6.0, jnp.asarray(vb),
        jnp.asarray(va), stop_at=stop_at))
    np.testing.assert_array_equal(np.minimum(got, stop_at)[va],
                                  np.minimum(exact, stop_at)[va])
    np.testing.assert_array_equal((got >= stop_at)[va],
                                  (jgot >= stop_at)[va])
    assert (got[va] <= exact[va]).all()


def test_no_valid_candidate_contract():
    """Every b-row masked -> (inf, -1), batched and not, plain version
    and oracle; zero candidates behave the same."""
    rng = _rng("row_min_contract")
    a = _t((rng.normal(size=(5, 3)) * 10).astype(np.float32))
    b = _t((rng.normal(size=(9, 3)) * 10).astype(np.float32))
    none = torch.zeros((9,), dtype=torch.bool)
    for m, i in [tops.row_min(a, b, none), tref.row_min(a, b, none),
                 tops.row_min_batch(a[None], b[None], none[None]),
                 tref.row_min_batch(a[None], b[None], none[None]),
                 tops.row_min_batch(a[None], b[None, :0], none[None, :0])]:
        assert np.isinf(m.numpy()).all()
        assert (i.numpy() == -1).all()
    assert (tops.eps_count_batch(a[None], b[None], 6.0, none[None]) == 0).all()
    assert (tops.eps_count_batch(a[None], b[None, :0], 6.0) == 0).all()


def test_eps_exactly_on_the_threshold_counts_as_a_hit():
    """d2 == eps2 exactly (integer lattice, float32-exact) is a hit in the
    port as in the reference, and the nearest candidate at exactly eps is
    found."""
    n, d = 130, 2
    b = np.zeros((n, d), np.float32)
    b[:, 0] = np.arange(n, dtype=np.float32)
    a = np.zeros((2, d), np.float32)
    a[0, 0], a[1, 0] = 6.0, 121.0
    eps = 6.0
    want = ((a[:, None, 0] - b[None, :, 0]) ** 2 <= eps ** 2).sum(1)
    aj, bj = jnp.asarray(a), jnp.asarray(b)
    for got in [tops.eps_count(_t(a), _t(b), eps),
                tref.eps_count(_t(a), _t(b), eps),
                tops.eps_count_batch(_t(a)[None], _t(b)[None], eps)[0],
                tref.eps_count_batch(_t(a)[None], _t(b)[None], eps)[0]]:
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(jops.eps_count_batch(aj[None], bj[None], eps,
                                        interpret=True)[0]), want)
    only = _t(np.arange(n) == 127)[None]
    m, i = tops.row_min_batch(_t(a)[None], _t(b)[None], only)
    assert float(m[0, 1]) == eps ** 2 and int(i[0, 1]) == 127


def test_duplicated_points_resolve_to_the_first_argmin():
    """Ties (exact duplicates, symmetric lattice) go to the lowest valid
    candidate index, as ``jnp.argmin`` does."""
    b = np.array([[3., 0.], [0., 3.], [3., 0.], [-3., 0.], [0., 3.]],
                 np.float32)
    a = np.zeros((2, 2), np.float32)
    a[1] = [3., 0.]
    for vb, want in [(np.ones(5, bool), [0, 0]),
                     (np.array([0, 1, 1, 1, 1], bool), [1, 2])]:
        m, i = tops.row_min(_t(a), _t(b), _t(vb))
        jm, ji = jref.row_min(jnp.asarray(a), jnp.asarray(b), jnp.asarray(vb))
        assert i.tolist() == want == np.asarray(ji).tolist()
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    # chunked candidate axis: the first minimum survives a chunk boundary
    big = np.tile(b, (40, 1))
    old = tops.PLAIN_CHUNK_ELEMS
    try:
        tops.PLAIN_CHUNK_ELEMS = 2 * 7       # 7 candidates per chunk
        m, i = tops.row_min(_t(a), _t(big))
        c = tops.eps_count(_t(a), _t(big), 3.0)
    finally:
        tops.PLAIN_CHUNK_ELEMS = old
    assert i.tolist() == [0, 0]
    np.testing.assert_array_equal(
        c.numpy(), np.asarray(jref.eps_count(jnp.asarray(a),
                                             jnp.asarray(big), 3.0)))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """Operand validation of the launch path (it runs before anything
    touches the device, so it is testable on CPU tensors)."""
    a = torch.zeros((2, 3, 2))
    b = torch.zeros((2, 5, 2))
    vb = torch.ones((2, 5), dtype=torch.bool)
    out = tops._check("k", a, b, vb, None, batched=True)
    assert out[2].dtype == torch.uint8 and out[3] is None
    with pytest.raises(ValueError, match="3-D"):
        tops._check("k", a[0], b, vb, None, batched=True)
    with pytest.raises(ValueError, match="feature dims"):
        tops._check("k", a, torch.zeros((2, 5, 3)), vb, None, batched=True)
    with pytest.raises(ValueError, match="batch sizes"):
        tops._check("k", a, b[:1], vb[:1], None, batched=True)
    with pytest.raises(ValueError, match="valid_b must be bool"):
        tops._check("k", a, b, vb.to(torch.uint8), None, batched=True)
    with pytest.raises(ValueError, match="valid_a must be bool"):
        tops._check("k", a, b, vb, torch.ones((2, 4), dtype=torch.bool),
                    batched=True)
    with pytest.raises(ValueError, match="contiguous"):
        tops._check("k", a.transpose(0, 1).contiguous().transpose(0, 1),
                    b, vb, None, batched=True)


def test_cpu_tensors_never_launch_a_kernel():
    a, b, vb = _batch(("launches",), 2, 4, 9, 3)
    before = dict(tops.LAUNCHES)
    tops.eps_count_batch(_t(a), _t(b), 6.0, _t(vb))
    tops.row_min_batch(_t(a), _t(b), _t(vb))
    tops.eps_count(_t(a[0]), _t(b[0]), 6.0)
    tops.row_min(_t(a[0]), _t(b[0]))
    assert tops.LAUNCHES == before


# --------------------------------------------------------------------------
# guard-band kernels: two-threshold counts and (min, runner-up, argmin)
# --------------------------------------------------------------------------

BAND_DISPATCH = {
    "default": lambda f, *x, **k: f(*x, **k),
    "interpret": lambda f, *x, **k: f(*x, interpret=True, **k)}


@pytest.mark.parametrize("bsz,m,n,d", BATCH_SHAPES)
@pytest.mark.parametrize("dispatch", ["default", "interpret", "ref"])
def test_eps_count_band_batch_matches_reference(bsz, m, n, d, dispatch):
    a, b, vb = _batch(("band", bsz, m, n, d), bsz, m, n, d)
    got_lo, got_hi = tops.eps_count_band_batch(_t(a), _t(b), 5.7, 6.3, _t(vb))
    aj, bj, vj = jnp.asarray(a), jnp.asarray(b), jnp.asarray(vb)
    if dispatch == "ref":
        want = jref.eps_count_band_batch(aj, bj, 5.7, 6.3, vj)
    else:
        want = BAND_DISPATCH[dispatch](jops.eps_count_band_batch, aj, bj,
                                       5.7, 6.3, vj)
    assert got_lo.dtype == torch.int32 and tuple(got_lo.shape) == (bsz, m)
    np.testing.assert_array_equal(got_lo.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got_hi.numpy(), np.asarray(want[1]))
    assert (got_lo <= got_hi).all()
    # the port's own oracle gives the same counts
    for g, w in zip((got_lo, got_hi), tref.eps_count_band_batch(
            _t(a), _t(b), 5.7, 6.3, _t(vb))):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("bsz,m,n,d", BATCH_SHAPES)
@pytest.mark.parametrize("dispatch", ["default", "interpret", "ref"])
def test_row_min2_batch_matches_reference(bsz, m, n, d, dispatch):
    a, b, vb = _batch(("min2", bsz, m, n, d), bsz, m, n, d)
    got_m, got_m2, got_i = tops.row_min2_batch(_t(a), _t(b), _t(vb))
    aj, bj, vj = jnp.asarray(a), jnp.asarray(b), jnp.asarray(vb)
    if dispatch == "ref":
        want_m, want_m2, want_i = jref.row_min2_batch(aj, bj, vj)
    else:
        want_m, want_m2, want_i = BAND_DISPATCH[dispatch](
            jops.row_min2_batch, aj, bj, vj)
    assert got_m2.dtype == torch.float32 and got_i.dtype == torch.int32
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), **TOL)
    np.testing.assert_allclose(got_m2.numpy(), np.asarray(want_m2), **TOL)
    if dispatch == "default":
        # same direct-difference form on both sides: the same argmin
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    else:
        _assert_argmin(got_i.numpy(), want_i,
                       np.asarray(jref.sq_dists_batch(aj, bj)), vb)
    tm, tm2, ti = tref.row_min2_batch(_t(a), _t(b), _t(vb))
    np.testing.assert_allclose(got_m2.numpy(), tm2.numpy(), **TOL)
    if bsz > 1:   # the all-masked slot obeys the (inf, inf, -1) contract
        assert np.isinf(got_m[0].numpy()).all()
        assert np.isinf(got_m2[0].numpy()).all()
        assert (got_i[0].numpy() == -1).all()


def test_row_min2_single_candidate_and_duplicate_contract():
    """One valid candidate -> (d2, inf, idx); a duplicate of the minimum
    makes the runner-up equal to it (the second order statistic of the
    distance multiset), also across a chunk boundary of the plain
    version; the reference agrees."""
    rng = _rng("min2_single")
    a = (rng.normal(size=(1, 4, 3)) * 10).astype(np.float32)
    b = (rng.normal(size=(1, 9, 3)) * 10).astype(np.float32)
    vb = (np.arange(9) == 5)[None]
    m, m2, i = tops.row_min2_batch(_t(a), _t(b), _t(vb))
    jm, jm2, ji = jops.row_min2_batch(jnp.asarray(a), jnp.asarray(b),
                                      jnp.asarray(vb))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    assert np.isinf(m2.numpy()).all() and (i.numpy() == 5).all()
    assert (np.asarray(ji) == 5).all()
    # integer lattice with every candidate duplicated far apart
    lat = np.rint(b[0] / 3.0).astype(np.float32)
    big = np.concatenate([lat, lat[::-1]])[None]
    q = np.rint(a / 3.0).astype(np.float32)
    for chunk in (None, 2 * 4 * 5):          # 5 candidates per chunk
        old = tops.PLAIN_CHUNK_ELEMS
        try:
            if chunk:
                tops.PLAIN_CHUNK_ELEMS = chunk
            m, m2, i = tops.row_min2_batch(_t(q), _t(big))
        finally:
            tops.PLAIN_CHUNK_ELEMS = old
        np.testing.assert_array_equal(m.numpy(), m2.numpy())
        jm, jm2, ji = jops.row_min2_batch(jnp.asarray(q), jnp.asarray(big))
        np.testing.assert_array_equal(m2.numpy(), np.asarray(jm2))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        assert (i.numpy() < 9).all()             # the first copy wins


@pytest.mark.parametrize("bar", [0, 2, 5, 1000])
def test_eps_count_band_stop_row_contract(bar):
    """A row whose lo count is below its bar has scanned every valid
    candidate; the plain version returns full counts, which satisfy the
    contract for every bar, and so does the reference's tiled loop."""
    bsz, m, n, d = 3, 9, 260, 2
    a, b, vb = _batch(("band_stop", bsz, m, n, d), bsz, m, n, d)
    rows = _rng("band_stop_bars", bar).integers(0, max(bar, 1) + 1,
                                                size=(bsz, m))
    exact_lo = np.asarray(jref.eps_count_batch(jnp.asarray(a), jnp.asarray(b),
                                               5.7, jnp.asarray(vb)))
    exact_hi = np.asarray(jref.eps_count_batch(jnp.asarray(a), jnp.asarray(b),
                                               6.3, jnp.asarray(vb)))
    got_lo, got_hi = (x.numpy() for x in tops.eps_count_band_batch(
        _t(a), _t(b), 5.7, 6.3, _t(vb),
        stop_row=_t(rows.astype(np.int32))))
    jlo, jhi = (np.asarray(x) for x in jops.eps_count_band_batch(
        jnp.asarray(a), jnp.asarray(b), 5.7, 6.3, jnp.asarray(vb),
        stop_row=jnp.asarray(rows, jnp.int32)))
    for lo, hi in ((got_lo, got_hi), (jlo, jhi)):
        assert (lo <= exact_lo).all() and (hi <= exact_hi).all()
        done = lo < rows
        np.testing.assert_array_equal(lo[done], exact_lo[done])
        np.testing.assert_array_equal(hi[done], exact_hi[done])
    np.testing.assert_array_equal(got_lo, exact_lo)


def test_flat_gathers_match_reference():
    """``pairwise_d2_flat`` / ``_res`` against the reference's jnp ops on
    the same ragged indices (float32; the feature sum may differ in the
    last bit)."""
    rng = _rng("flat")
    d = 3
    pts = (rng.normal(size=(50, d)) * 10).astype(np.float32)
    qa = (rng.normal(size=(7, d)) * 3).astype(np.float32)
    rr = rng.integers(0, 50, 90)
    qo = np.sort(rng.integers(0, 7, 90))
    av = (rng.normal(size=(90, d)) * 2).astype(np.float32)
    got = tops.pairwise_d2_flat(_t(pts), _t(qa), _t(rr), _t(qo), _t(av))
    want = jops.pairwise_d2_flat(jnp.asarray(pts), jnp.asarray(qa),
                                 jnp.asarray(rr.astype(np.int32)),
                                 jnp.asarray(qo.astype(np.int32)),
                                 jnp.asarray(av))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    rb = rng.integers(0, 50, 90)
    got = tops.pairwise_d2_flat_res(_t(pts), _t(rr), _t(rb), _t(av))
    want = jops.pairwise_d2_flat_res(jnp.asarray(pts),
                                     jnp.asarray(rr.astype(np.int32)),
                                     jnp.asarray(rb.astype(np.int32)),
                                     jnp.asarray(av))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert got.dtype == torch.float32 and tuple(got.shape) == (90,)


def test_guard_band_wrappers_never_launch_on_cpu_tensors():
    a, b, vb = _batch(("band_launches",), 2, 4, 9, 3)
    before = dict(tops.LAUNCHES)
    assert {"eps_count_band_batch", "row_min2_batch"} <= set(before)
    tops.eps_count_band_batch(_t(a), _t(b), 5.0, 6.0, _t(vb))
    tops.row_min2_batch(_t(a), _t(b), _t(vb))
    assert tops.LAUNCHES == before


@pytest.mark.gpu
def test_cuda_guard_band_kernels_match_plain_versions_on_the_card():
    """The two guard-band kernels against their plain versions on an
    integer lattice with duplicated candidates (equal, not close)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    a, b, vb = _batch(("cuda_band",), 3, 63, 700, 3)
    a, b = np.rint(a), np.rint(b)
    b[:, 350:] = b[:, :350]
    ac, bc, vc = (_t(x).cuda() for x in (a, b, vb))
    before = dict(tops.LAUNCHES)
    lo, hi = tops.eps_count_band_batch(ac, bc, 5.5, 6.5, vc)
    m, m2, i = tops.row_min2_batch(ac, bc, vc)
    assert tops.LAUNCHES["eps_count_band_batch"] == \
        before["eps_count_band_batch"] + 1
    assert tops.LAUNCHES["row_min2_batch"] == before["row_min2_batch"] + 1
    wlo, whi = tops.eps_count_band_batch_plain(_t(a), _t(b), 5.5, 6.5, _t(vb))
    wm, wm2, wi = tops.row_min2_batch_plain(_t(a), _t(b), _t(vb))
    for g, w in ((lo, wlo), (hi, whi), (m, wm), (m2, wm2), (i, wi)):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions_on_the_card():
    """The hand-written kernels against their plain versions, on a CUDA
    device (skipped where there is none; ``chip_smoke.py`` runs the
    fuller comparison)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    a, b, vb = _batch(("cuda",), 3, 63, 700, 3)
    a, b = np.rint(a), np.rint(b)
    ac, bc, vc = (_t(x).cuda() for x in (a, b, vb))
    before = tops.LAUNCHES["eps_count_batch"]
    got = tops.eps_count_batch(ac, bc, 6.0, vc)
    assert tops.LAUNCHES["eps_count_batch"] == before + 1
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        tops.eps_count_batch_plain(_t(a), _t(b), 6.0, _t(vb)).numpy())
    gm, gi = tops.row_min_batch(ac, bc, vc)
    wm, wi = tops.row_min_batch_plain(_t(a), _t(b), _t(vb))
    np.testing.assert_array_equal(gi.cpu().numpy(), wi.numpy())
    np.testing.assert_array_equal(gm.cpu().numpy(), wm.numpy())
