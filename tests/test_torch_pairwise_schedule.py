"""The schedule of the CUDA distance kernels (``eps_count_batch``,
``row_min_batch``, ``eps_count_band_batch``, ``row_min2_batch``: one
kernel, ``dist_kernel<kind, D>``), emulated in numpy on the CPU and held
against the plain PyTorch versions and ``repro.kernels.ref``.

The kernel (``csrc/pairwise.cu``) gives each slot to one warp, or a
slot of at most 32 rows whose candidates span several chunks of
``kChunk`` positions to up to ``kWarpsPerBlock`` warps, each taking a
range of the chunks (a split).  Per warp, the slot's live rows are
compacted into lane slots (two rows a lane above 32 live rows, else rows
x phases with phase = compacted candidate mod phases); the valid
candidates are compacted in ascending order, 32 positions a round, into
items of at most ``kCap`` (``kCapPlanes`` for d > 3), ``kCapStop`` for a
task that may end early (a round that would overflow the item starts the
next one; the end of the warp's range closes its item); each lane scans
its candidates of an item in ascending order with strict ``<`` (keeping
the runner-up for ``row_min2``) or counts hits (at two thresholds for the
band); counts stop once every live row's first count has reached its bar
(``stop_at``, or the band's per-row ``stop_row``), checked every 32
compacted candidates of an item; a band row whose bar is <= 0 is exempt,
not live, so neither scanned nor counted; the phases merge in a
butterfly at the end: counts add, ``(d2, index)`` lexicographically, the
runner-up as the smaller of both runners-up and the larger of both
minima; the splits merge the same way in split order.  :func:`emulate`
does the same steps with the same float32 arithmetic (``sum_k (a_k -
b_k)^2``, each operation rounded), so a fault in the schedule's logic --
a tie resolved to the wrong index, a runner-up lost across a phase, a
stop taken too early, a row lost in the compaction -- shows here, without
the card.

Tolerances: none; integer lattices make every distance exact, so
counts, minima, runners-up and argmins must be equal.
"""

import re
import zlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import ref as jref
from repro_torch.kernels import build, ops as tops


def _kernel_constant(name: str) -> int:
    src = (build.CSRC / "pairwise.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _rng(*key) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def layout(n_live: int):
    """(two rows a lane, rows per phase, phases) for a task's live rows,
    the kernel's rule."""
    if n_live > 32:
        return True, 32, 1
    span = 1
    while span < n_live:
        span <<= 1
    return False, span, 32 // span


def _d2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[r, d] x [n, d] -> [r, n] float32, terms added in k order."""
    acc = None
    for k in range(a.shape[1]):
        t = (a[:, None, k] - b[None, :, k]).astype(np.float32)
        t = (t * t).astype(np.float32)
        acc = t if acc is None else (acc + t).astype(np.float32)
    return acc


def items_of(valid: np.ndarray, cap: int):
    """The kernel's items of one task: its valid candidates (ascending),
    32 positions a round, a round that would overflow ``cap`` starting
    the next item."""
    pos = np.flatnonzero(valid)
    items, cur = [], []
    for r0 in range(0, len(valid), 32):
        rnd = pos[(pos >= r0) & (pos < r0 + 32)]
        if len(cur) + len(rnd) > cap:
            items.append(np.array(cur, np.int64))
            cur = []
        cur.extend(rnd.tolist())
    if cur:
        items.append(np.array(cur, np.int64))
    return items


def split_count(P: int, C: int) -> int:
    """Warps that share one slot's candidates, the kernel's rule: up to
    ``kWarpsPerBlock`` for a slot of at most 32 rows, one per chunk."""
    chunks = -(-C // _kernel_constant("kChunk"))
    return max(1, min(_kernel_constant("kWarpsPerBlock"), chunks)) \
        if P <= 32 else 1


def split_ranges(C: int, splits: int):
    """Candidate positions [lo, hi) of each split: ranges of whole chunks,
    ``ceil(chunks / splits)`` each, the last ones possibly empty."""
    chunk = _kernel_constant("kChunk")
    chunks = max(1, -(-C // chunk))
    per = -(-chunks // splits)
    out = []
    for s in range(splits):
        c0 = min(chunks, s * per)
        c1 = min(chunks, c0 + per)
        out.append((min(C, c0 * chunk), min(C, c1 * chunk)))
    return out


def emulate(a, b, vb, va, eps2, stop_at, kind, phases=None, cap=None,
            group=None, splits=None, eps2_hi=None, bar=None):
    """One launch of the kernel's schedule: a [B, P, d], b [B, C, d],
    vb [B, C], va [B, P] or None.  ``phases`` forces the phase count and
    ``splits`` the warps per slot; None takes the kernel's rule.  Returns
    per ``kind``: ``"count"`` counts [B, P]; ``"min"`` (min, argmin);
    ``"band"`` (hits at ``eps2``, hits at ``eps2_hi``), with ``bar``
    [B, P] or None the per-row bar on the first count; ``"min2"`` (min,
    runner-up, argmin)."""
    stopping = (kind == "count" and bool(stop_at)) or \
        (kind == "band" and bar is not None)
    cap = cap or _kernel_constant(
        "kCapStop" if stopping else "kCap" if a.shape[2] <= 3 else "kCapPlanes")
    group = group or _kernel_constant("kGroup")
    B, P, _ = a.shape
    C = b.shape[1]
    cnt_out = np.zeros((B, P), np.int64)
    cnt2_out = np.zeros((B, P), np.int64)
    min_out = np.full((B, P), np.inf, np.float32)
    sec_out = np.full((B, P), np.inf, np.float32)
    arg_out = np.full((B, P), -1, np.int64)
    group_rows = min(P, group)
    ranges = split_ranges(C, split_count(P, C) if splits is None else splits)
    for g in range(B):
        for r0 in range(0, P, group_rows):
            rows = np.arange(r0, min(P, r0 + group_rows))
            live = rows if va is None else rows[va[g, rows]]
            if kind == "band" and bar is not None:
                live = live[bar[g, live] > 0]    # exempt rows are not live
            if len(live) == 0:
                continue
            ph = layout(len(live))[2] if phases is None else phases
            need = None
            if kind == "count" and stop_at:
                need = np.full(len(live), stop_at, np.int64)
            if kind == "band" and bar is not None:
                need = bar[g, live]
            parts = [_scan_range(a[g, live], b[g], vb[g], lo, hi, eps2, eps2_hi,
                                 need, kind, ph, cap) for lo, hi in ranges]
            acc = parts[0]                       # the splits merge in order
            for part in parts[1:]:
                acc = _merge(acc, part)
            cnt, cnt2, best, sec, arg = acc
            cnt_out[g, live] = cnt
            cnt2_out[g, live] = cnt2
            min_out[g, live] = best
            sec_out[g, live] = sec
            arg_out[g, live] = np.where(np.isinf(best), -1, arg)
    if kind == "count":
        return cnt_out
    if kind == "band":
        return cnt_out, cnt2_out
    if kind == "min":
        return min_out, arg_out
    return min_out, sec_out, arg_out


def _merge(x, y):
    """Two partial results of the same rows, merged as the kernel merges
    phases and splits: counts add; (d2, index) lexicographically; the
    runner-up is the smaller of both runners-up and the larger of both
    minima."""
    cnt, cnt2, best, sec, arg = x
    c2, h2, b2, s2, a2 = y
    take = (b2 < best) | ((b2 == best) & (a2 < arg))
    sec = np.minimum(np.minimum(sec, s2), np.maximum(best, b2))
    return (cnt + c2, cnt2 + h2, np.where(take, b2, best), sec,
            np.where(take, a2, arg))


def _scan_range(a_live, b, vb, lo, hi, eps2, eps2_hi, need, kind, ph, cap):
    """One warp: live rows ``a_live`` against the valid candidates of
    positions [lo, hi) (``lo`` a chunk boundary, so rounds of 32 stay
    aligned), ``ph`` phases, items of at most ``cap``.  ``need`` (count
    and band kinds; None: no exit) is each row's bar on its first count:
    the warp ends once every row has reached it, checked every 32
    compacted candidates of an item.  Returns per row (count, second
    count, min, runner-up, argmin) after the phases' butterfly."""
    n_live = len(a_live)
    cnt = np.zeros((n_live, ph), np.int64)
    cnt2 = np.zeros((n_live, ph), np.int64)
    best = np.full((n_live, ph), np.inf, np.float32)
    sec = np.full((n_live, ph), np.inf, np.float32)
    arg = np.full((n_live, ph), np.iinfo(np.int32).max, np.int64)
    stopping = need is not None
    done = False
    for comp in items_of(vb[lo:hi], cap):        # ascending: the compaction
        if done:
            break
        comp = comp + lo
        d2 = _d2(a_live, b[comp])
        n = len(comp)
        blk = 32 if stopping else n
        for jb in range(0, n, max(blk, 1)):
            je = min(n, jb + blk)
            for f in range(ph):
                js = np.arange(jb + f, je, ph)
                if len(js) == 0:
                    continue
                if kind in ("min", "min2"):
                    for j in js:                 # ascending, strict <
                        if kind == "min2":
                            sec[:, f] = np.minimum(sec[:, f],
                                                   np.maximum(best[:, f], d2[:, j]))
                        better = d2[:, j] < best[:, f]
                        best[better, f] = d2[better, j]
                        arg[better, f] = comp[j]
                else:
                    cnt[:, f] += (d2[:, js] <= eps2).sum(axis=1)
                    if kind == "band":
                        cnt2[:, f] += (d2[:, js] <= eps2_hi).sum(axis=1)
            if stopping and (cnt.sum(axis=1) >= need).all():
                done = True
                break
    # butterfly over the phases
    acc = (cnt, cnt2, best, sec, arg)
    o = 1
    while o < ph:
        other = np.arange(ph) ^ o
        acc = _merge(acc, tuple(x[:, other] for x in acc))
        o <<= 1
    return tuple(x[:, 0] for x in acc)


def _lattice(key, B, P, C, d):
    """Duplicate-heavy integer lattice: candidates drawn from a small
    pool (many exact ties), queries on the same lattice, masks with an
    all-dead slot and a slot without valid candidates."""
    rng = _rng(*key)
    pool = rng.integers(-6, 7, size=(max(4, C // 6), d))
    b = pool[rng.integers(0, len(pool), size=(B, C))].astype(np.float32)
    a = rng.integers(-6, 7, size=(B, P, d)).astype(np.float32)
    vb = rng.uniform(size=(B, C)) > 0.35
    va = rng.uniform(size=(B, P)) > 0.3
    if B > 2:
        vb[0] = False
        va[1] = False
    return a, b, vb, va


PS = [1, 8, 31, 32, 33, 63, 127]
PHASES = [1, 2, 4, 8, 32]


@pytest.mark.parametrize("phases", PHASES + [None])
@pytest.mark.parametrize("P", PS)
def test_schedule_row_min_matches_plain_and_reference(P, phases):
    a, b, vb, va = _lattice(("min", P, phases), 3, P, 600, 3)
    got_m, got_i = emulate(a, b, vb, None, 0.0, None, "min", phases)
    wm, wi = tops.row_min_batch_plain(torch.as_tensor(a), torch.as_tensor(b),
                                      torch.as_tensor(vb))
    np.testing.assert_array_equal(got_m, wm.numpy())
    np.testing.assert_array_equal(got_i, wi.numpy())
    jm, ji = jref.row_min_batch(jnp.asarray(a), jnp.asarray(b),
                                jnp.asarray(vb))
    np.testing.assert_array_equal(got_m, np.asarray(jm))
    np.testing.assert_array_equal(got_i, np.asarray(ji))


@pytest.mark.parametrize("phases", PHASES + [None])
@pytest.mark.parametrize("P", PS)
def test_schedule_eps_count_matches_plain_and_reference(P, phases):
    a, b, vb, va = _lattice(("count", P, phases), 3, P, 600, 3)
    eps = 3.0
    want = tops.eps_count_batch_plain(torch.as_tensor(a), torch.as_tensor(b),
                                      eps, torch.as_tensor(vb)).numpy()
    np.testing.assert_array_equal(
        want, np.asarray(jref.eps_count_batch(jnp.asarray(a), jnp.asarray(b),
                                              eps, jnp.asarray(vb))))
    full = emulate(a, b, vb, va, 9.0, None, "count", phases)
    np.testing.assert_array_equal(full[va], want[va])
    assert (full[~va] == 0).all()
    for k in (1, 5, 40):
        got = emulate(a, b, vb, va, 9.0, k, "count", phases)
        np.testing.assert_array_equal(np.minimum(got, k)[va],
                                      np.minimum(want, k)[va])


def test_stop_at_ends_the_scan_early_and_only_when_every_live_row_is_done():
    """Rows that saturate at different candidates: the per-warp exit
    waits for the last live row, and then scans no further."""
    C, d = 900, 1
    b = np.zeros((1, C, d), np.float32)
    b[0, :, 0] = np.arange(C)
    a = np.zeros((1, 3, d), np.float32)
    a[0, :, 0] = [0.0, 300.0, 870.0]
    vb = np.ones((1, C), bool)
    va = np.ones((1, 3), bool)
    eps2 = 4.0                                   # hits: 3, 5, 5
    got = emulate(a, b, vb, va, eps2, 3, "count")
    assert got.tolist() == [[3, 5, 5]]           # row 0 stopped at 3 hits
    # row 2's hits lie in the last chunk: nothing stops before it
    va[0, 2] = False
    got = emulate(a, b, vb, va, eps2, 3, "count")
    assert got[0, 0] == 3 and got[0, 1] >= 3 and got[0, 2] == 0


def test_ties_across_a_phase_boundary_go_to_the_lowest_index():
    """The same point at compacted positions 0 and 1 (two phases) and
    again in a later item: every layout reports index 0."""
    cap = _kernel_constant("kCap")
    C = 2 * cap + 5
    b = np.full((1, C, 2), 50.0, np.float32)
    b[0, [0, 1, cap + 2]] = [1.0, 1.0]
    a = np.ones((1, 8, 2), np.float32)
    vb = np.ones((1, C), bool)
    for phases in PHASES + [None]:
        m, i = emulate(a, b, vb, None, 0.0, None, "min", phases)
        assert (i == 0).all() and (m == 0).all()
    vb[0, 0] = False
    for phases in PHASES + [None]:
        _, i = emulate(a, b, vb, None, 0.0, None, "min", phases)
        assert (i == 1).all()


SPLITS = [1, 2, 3, 4]


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("P", [1, 8, 31, 32])
def test_split_slots_match_plain_and_reference(P, splits):
    """A small slot's candidates over several warps (5 chunks and a
    ragged sixth): minima, argmins and saturated counts equal the plain
    versions' and ``repro.kernels.ref``'s whatever the split count."""
    C = 5 * _kernel_constant("kChunk") + 77
    a, b, vb, va = _lattice(("split", P, splits), 3, P, C, 3)
    got_m, got_i = emulate(a, b, vb, None, 0.0, None, "min", splits=splits)
    wm, wi = tops.row_min_batch_plain(torch.as_tensor(a), torch.as_tensor(b),
                                      torch.as_tensor(vb))
    np.testing.assert_array_equal(got_m, wm.numpy())
    np.testing.assert_array_equal(got_i, wi.numpy())
    jm, ji = jref.row_min_batch(jnp.asarray(a), jnp.asarray(b),
                                jnp.asarray(vb))
    np.testing.assert_array_equal(got_i, np.asarray(ji))
    want = tops.eps_count_batch_plain(torch.as_tensor(a), torch.as_tensor(b),
                                      3.0, torch.as_tensor(vb)).numpy()
    for k in (None, 1, 40):
        got = emulate(a, b, vb, va, 9.0, k, "count", splits=splits)
        cap = want.max() + 1 if k is None else k
        np.testing.assert_array_equal(np.minimum(got, cap)[va],
                                      np.minimum(want, cap)[va])
        assert (got[~va] == 0).all()


def test_ties_across_a_split_boundary_go_to_the_lowest_index():
    """The same point as the last candidate of one split's range and the
    first of the next: the merge in split order keeps the first."""
    chunk = _kernel_constant("kChunk")
    C = 4 * chunk
    b = np.full((1, C, 2), 50.0, np.float32)
    b[0, [chunk - 1, chunk, 3 * chunk]] = [1.0, 1.0]
    a = np.ones((1, 8, 2), np.float32)
    vb = np.ones((1, C), bool)
    for splits in SPLITS:
        m, i = emulate(a, b, vb, None, 0.0, None, "min", splits=splits)
        assert (i == chunk - 1).all() and (m == 0).all()
    c = emulate(a, b, vb, None, 0.0, None, "count")
    assert (c == 3).all()


@pytest.mark.parametrize("P,C,want", [(8, 2048, 4), (8, 512, 1), (8, 513, 2),
                                      (32, 4096, 4), (33, 4096, 1),
                                      (63, 2048, 1), (1, 1, 1), (5, 0, 1)])
def test_split_rule(P, C, want):
    """Slots of at most 32 rows spread their chunks over up to four
    warps; larger slots keep one warp a 64-row task."""
    assert split_count(P, C) == want
    ranges = split_ranges(C, want)
    assert ranges[0][0] == 0 and ranges[-1][1] == C
    assert all(lo <= hi for lo, hi in ranges)
    assert all(r[1] == nxt[0] for r, nxt in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("M", [1, 31, 32, 33, 100])
def test_unbatched_slots_of_rows_per_slot(M):
    """The unbatched pair deals M rows to slots of ``ROWS_PER_SLOT``
    (the last slot ragged) over one shared candidate set."""
    rng = _rng("unbatched", M)
    a = rng.integers(-9, 10, size=(M, 3)).astype(np.float32)
    b = rng.integers(-9, 10, size=(300, 3)).astype(np.float32)
    vb = rng.uniform(size=300) > 0.3
    R = tops.ROWS_PER_SLOT
    slots = (M + R - 1) // R
    pad = np.zeros((slots * R, 3), np.float32)
    pad[:M] = a
    va = np.arange(slots * R) < M
    m, i = emulate(pad.reshape(slots, R, 3), np.broadcast_to(b, (slots,) + b.shape),
                   np.broadcast_to(vb, (slots, 300)), None, 0.0, None, "min")
    c = emulate(pad.reshape(slots, R, 3), np.broadcast_to(b, (slots,) + b.shape),
                np.broadcast_to(vb, (slots, 300)), va.reshape(slots, R), 16.0,
                None, "count")
    wm, wi = tops.row_min(torch.as_tensor(a), torch.as_tensor(b),
                          torch.as_tensor(vb))
    wc = tops.eps_count(torch.as_tensor(a), torch.as_tensor(b), 4.0,
                        torch.as_tensor(vb))
    np.testing.assert_array_equal(m.reshape(-1)[:M], wm.numpy())
    np.testing.assert_array_equal(i.reshape(-1)[:M], wi.numpy())
    np.testing.assert_array_equal(c.reshape(-1)[:M], wc.numpy())


@pytest.mark.parametrize("n_live,want", [(1, (False, 1, 32)), (8, (False, 8, 4)),
                                         (9, (False, 16, 2)), (32, (False, 32, 1)),
                                         (33, (True, 32, 1)), (64, (True, 32, 1))])
def test_layout_rule(n_live, want):
    assert layout(n_live) == want


def test_emulation_mirrors_the_kernel_constants():
    """The emulation reads its item and group sizes from the kernel
    source.  Rounds of 32 positions must tile a staged chunk, and an item
    must take a whole round."""
    assert _kernel_constant("kChunk") % 32 == 0
    assert _kernel_constant("kCap") >= 32
    assert _kernel_constant("kGroup") == 64
    assert 32 <= _kernel_constant("kCapStop") <= _kernel_constant("kCapPlanes") \
        <= _kernel_constant("kCap")
    src = (build.CSRC / "pairwise.cu").read_text()
    assert "cp.async" in src and "__ballot_sync" in src


@pytest.mark.parametrize("cap", [32, 64, 128, 256])
def test_items_take_whole_rounds_in_order(cap):
    """Items hold every valid candidate once, in ascending order, none
    more than ``cap``, and split only between rounds of 32 positions."""
    rng = _rng("items", cap)
    valid = rng.uniform(size=1500) > 0.3
    items = items_of(valid, cap)
    flat = np.concatenate(items)
    np.testing.assert_array_equal(flat, np.flatnonzero(valid))
    assert all(0 < len(it) <= cap for it in items)
    for left, right in zip(items, items[1:]):
        assert left[-1] // 32 < right[0] // 32


def append_chunk(span: bytes, off: int, length: int, n: int, r: int,
                 cap: int):
    """The kernel's step 2 on one staged mask span (16-byte aligned, the
    chunk's bytes at [off, off + length), other slots' bytes around
    them): a span of zeros is skipped whole; else from round r, lane i
    takes position 32 r + i, the ballot of the valid lanes places each at
    n + popc(ballot & lanes below), and a round that would take n past
    ``cap`` is left for the next item.  Returns (placed (position,
    candidate) pairs, n, r), r = rounds when the chunk is done."""
    rounds = (length + 31) // 32
    mask = np.frombuffer(span, np.uint8)
    placed = []
    if r == 0 and not mask[:(off + length + 15) // 16 * 16].any():
        return placed, n, rounds
    while r < rounds:
        lanes = [32 * r + i < length and mask[off + 32 * r + i] != 0
                 for i in range(32)]
        ballot = sum(1 << i for i, v in enumerate(lanes) if v)
        if n + bin(ballot).count("1") > cap:
            break
        for i, v in enumerate(lanes):
            if v:
                below = ballot & ((1 << i) - 1)
                placed.append((n + bin(below).count("1"), 32 * r + i))
        n += bin(ballot).count("1")
        r += 1
    return placed, n, r


@pytest.mark.parametrize("off", [0, 1, 7, 15])
@pytest.mark.parametrize("length", [1, 5, 200, 512])
def test_chunk_compaction_keeps_ascending_order(off, length):
    """The round-by-round compaction places exactly the chunk's valid
    candidates, in ascending order, whatever the span's alignment, and
    resumes where a full item stopped it; bytes of the span outside the
    chunk (other slots' masks) are never taken."""
    rng = _rng("compact", off, length)
    span = rng.integers(0, 2, size=16 * 34).astype(np.uint8).tobytes()
    want = np.flatnonzero(np.frombuffer(span, np.uint8)[off:off + length])
    got, r, n = [], 0, 0
    rounds = (length + 31) // 32
    while True:
        placed, n, r = append_chunk(span, off, length, n, r, 64)
        got.extend(j for _, j in placed)
        assert [p for p, _ in placed] == list(range(n - len(placed), n))
        assert n <= 64
        if r == rounds:
            break
        n = 0                            # the next item
    assert got == want.tolist()


# --------------------------------------------------------------------------
# the guard-band kinds: two-threshold counts with a per-row bar, and
# (min, runner-up, argmin)
# --------------------------------------------------------------------------

EPS_LO, EPS_HI = 3.0, 3.5             # squared exactly in float32: 9, 12.25


def _band_contract(got, want, bar):
    """The ``stop_row`` contract: a row whose lo count is below its bar
    has both counts complete; every other row has reached its bar and
    counts no hit it did not see."""
    (glo, ghi), (wlo, whi) = got, want
    below = glo < bar
    np.testing.assert_array_equal(glo[below], wlo[below])
    np.testing.assert_array_equal(ghi[below], whi[below])
    assert (glo <= wlo).all() and (ghi <= whi).all()


def _want_min2(a, b, vb):
    """(min, runner-up, argmin) of the plain version, checked against
    ``repro.kernels.ref`` on the way."""
    wm, wm2, wi = (x.numpy() for x in tops.row_min2_batch_plain(
        torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(vb)))
    jm, jm2, ji = (np.asarray(x) for x in jref.row_min2_batch(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(vb)))
    np.testing.assert_array_equal(wm, jm)
    np.testing.assert_array_equal(wm2, jm2)
    np.testing.assert_array_equal(wi, ji)
    return wm, wm2, wi


def _want_band(a, b, vb):
    want = tuple(x.numpy() for x in tops.eps_count_band_batch_plain(
        torch.as_tensor(a), torch.as_tensor(b), EPS_LO, EPS_HI,
        torch.as_tensor(vb)))
    ref = jref.eps_count_band_batch(jnp.asarray(a), jnp.asarray(b), EPS_LO,
                                    EPS_HI, jnp.asarray(vb))
    for w, r in zip(want, ref):
        np.testing.assert_array_equal(w, np.asarray(r))
    return want


def _bars(key, B, P, k):
    """Random per-row bars in [-1, k] (negative and 0 exempt a row)."""
    return _rng("bars", *key).integers(-1, k + 1, size=(B, P))


@pytest.mark.parametrize("phases", PHASES + [None])
@pytest.mark.parametrize("P", PS)
def test_schedule_row_min2_matches_plain_and_reference(P, phases):
    a, b, vb, _ = _lattice(("min2", P, phases), 3, P, 600, 3)
    got = emulate(a, b, vb, None, 0.0, None, "min2", phases)
    for g, w in zip(got, _want_min2(a, b, vb)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("phases", PHASES + [None])
@pytest.mark.parametrize("P", PS)
def test_schedule_eps_count_band_matches_plain_and_reference(P, phases):
    a, b, vb, _ = _lattice(("band", P, phases), 3, P, 600, 3)
    want = _want_band(a, b, vb)
    full = emulate(a, b, vb, None, 9.0, None, "band", phases, eps2_hi=12.25)
    for g, w in zip(full, want):
        np.testing.assert_array_equal(g, w)
    for k in (1, 5, 40):
        bar = _bars(("band", P, phases, k), 3, P, k)
        got = emulate(a, b, vb, None, 9.0, None, "band", phases,
                      eps2_hi=12.25, bar=bar)
        _band_contract(got, want, bar)


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("P", [1, 8, 31, 32])
def test_split_slots_band_and_min2_match_plain_and_reference(P, splits):
    """The guard-band kinds over a small slot's candidates split over
    several warps (5 chunks and a ragged sixth): runners-up equal and
    the bar contract holds whatever the split count."""
    C = 5 * _kernel_constant("kChunk") + 77
    a, b, vb, _ = _lattice(("split2", P, splits), 3, P, C, 3)
    got = emulate(a, b, vb, None, 0.0, None, "min2", splits=splits)
    for g, w in zip(got, _want_min2(a, b, vb)):
        np.testing.assert_array_equal(g, w)
    want = _want_band(a, b, vb)
    for k in (None, 1, 40):
        bar = None if k is None else _bars(("split2", P, splits, k), 3, P, k)
        got = emulate(a, b, vb, None, 9.0, None, "band", splits=splits,
                      eps2_hi=12.25, bar=bar)
        if bar is None:
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        else:
            _band_contract(got, want, bar)


def test_min2_duplicate_minimum_across_phase_and_split_boundaries():
    """The nearest point twice, at compacted positions 0 and 1 (two
    phases) or on both sides of a split boundary: the runner-up is the
    minimum and the argmin the first copy, in every layout; with one copy
    masked the runner-up is the next distance."""
    chunk = _kernel_constant("kChunk")
    C = 4 * chunk
    a = np.ones((1, 8, 2), np.float32)
    far = np.float32(2 * 49.0 ** 2)
    for pair, layouts in (((0, 1), [dict(phases=f) for f in PHASES + [None]]),
                          ((2 * chunk - 1, 2 * chunk),
                           [dict(splits=s) for s in SPLITS])):
        b = np.full((1, C, 2), 50.0, np.float32)
        b[0, list(pair)] = [1.0, 1.0]
        vb = np.ones((1, C), bool)
        for kw in layouts:
            m, m2, i = emulate(a, b, vb, None, 0.0, None, "min2", **kw)
            assert (m == 0).all() and (m2 == 0).all() and (i == pair[0]).all()
        np.testing.assert_array_equal(
            np.stack(emulate(a, b, vb, None, 0.0, None, "min2")),
            np.stack(_want_min2(a, b, vb)))
        vb[0, pair[0]] = False
        for kw in layouts:
            m, m2, i = emulate(a, b, vb, None, 0.0, None, "min2", **kw)
            assert (m == 0).all() and (m2 == far).all() and (i == pair[1]).all()


@pytest.mark.parametrize("layout_kw", [dict(phases=1), dict(phases=32),
                                       dict(splits=4), {}])
def test_min2_one_valid_candidate(layout_kw):
    """A slot with one valid candidate reports (d2, inf, index); a slot
    with none (inf, inf, -1)."""
    chunk = _kernel_constant("kChunk")
    rng = _rng("one", repr(layout_kw))
    a = rng.integers(-5, 6, size=(2, 5, 3)).astype(np.float32)
    b = rng.integers(-5, 6, size=(2, 3 * chunk, 3)).astype(np.float32)
    vb = np.zeros((2, 3 * chunk), bool)
    vb[0, chunk + 7] = True
    m, m2, i = emulate(a, b, vb, None, 0.0, None, "min2", **layout_kw)
    np.testing.assert_array_equal(m[0], _d2(a[0], b[0, [chunk + 7]])[:, 0])
    assert np.isinf(m2).all() and (i[0] == chunk + 7).all()
    assert np.isinf(m[1]).all() and (i[1] == -1).all()
    for g, w in zip((m, m2, i), _want_min2(a, b, vb)):
        np.testing.assert_array_equal(g, w)


def test_band_bars_reached_at_different_candidates_in_one_split_only():
    """1-d candidates 0 .. C-1 over four splits.  Rows 0 and 1 reach
    their bars in split 0, at candidates 10 and 302 (row 0 has one more
    hit later in split 0, at 400); rows 2 and 3 are exempt, so neither
    scanned nor counted (row 2's hits lie in splits 0 and 3).  Split 0
    ends after the round of 32 that holds 302, so it never sees 400; the
    other splits, where rows 0 and 1 have no hit, scan everything.  In
    one warp the whole slot ends there."""
    chunk = _kernel_constant("kChunk")
    C = 4 * chunk
    b = np.arange(C, dtype=np.float32)[None, :, None].copy()
    b[0, 400, 0] = 10.0                          # row 0's late hit
    b[0, 1800, 0] = 700.0                        # row 2's hit in split 3
    a = np.array([[[10.0], [300.0], [700.0], [1500.0]]], np.float32)
    vb = np.ones((1, C), bool)
    bar = np.array([[3, 5, 0, -2]])
    want = tuple(x.numpy() for x in tops.eps_count_band_batch_plain(
        torch.as_tensor(a), torch.as_tensor(b), 2.0, 3.0,
        torch.as_tensor(vb)))
    assert want[0].tolist() == [[6, 5, 6, 5]] and want[1].tolist() == [[8, 7, 8, 7]]
    for splits in (4, 1):
        lo, hi = emulate(a, b, vb, None, 4.0, None, "band", splits=splits,
                         eps2_hi=9.0, bar=bar)
        assert lo.tolist() == [[5, 5, 0, 0]] and hi.tolist() == [[7, 7, 0, 0]]
        _band_contract((lo, hi), want, bar)
    # a bar the row does not reach: every split scans everything for it
    lo, hi = emulate(a, b, vb, None, 4.0, None, "band", splits=4,
                     eps2_hi=9.0, bar=np.array([[7, 0, 0, 0]]))
    assert lo.tolist() == [[6, 0, 0, 0]] and hi.tolist() == [[8, 0, 0, 0]]


@pytest.mark.parametrize("P", [8, 33, 63])
def test_band_all_exempt_bars_scan_nothing(P):
    """A task whose rows are all exempt (bars 0 or below) has no live row
    and counts nothing, which the contract allows; one row with a bar
    above its count makes its task scan, for that row alone."""
    a, b, vb, _ = _lattice(("exempt", P), 3, P, 900, 3)
    want = _want_band(a, b, vb)
    bar = _rng("exempt_bars", P).integers(-3, 1, size=(3, P))
    lo, hi = emulate(a, b, vb, None, 9.0, None, "band", eps2_hi=12.25, bar=bar)
    assert (lo == 0).all() and (hi == 0).all()
    _band_contract((lo, hi), want, bar)
    bar[2, 0] = want[0][2, 0] + 1
    lo, hi = emulate(a, b, vb, None, 9.0, None, "band", eps2_hi=12.25, bar=bar)
    assert lo[2, 0] == want[0][2, 0] and hi[2, 0] == want[1][2, 0]
    lo[2, 0] = hi[2, 0] = 0
    assert (lo == 0).all() and (hi == 0).all()


@pytest.mark.parametrize("k", [1, 1000])
@pytest.mark.parametrize("P", PS)
def test_band_exempt_rows_are_neither_scanned_nor_counted(P, k):
    """Bars of -1, 0 (exempt) or k mixed in every slot, over 5 chunks and
    a ragged sixth (a split slot for P <= 32): the exempt rows count 0,
    every other row keeps the contract, and with a bar no row reaches
    (k = 1000) its counts are the full ones."""
    C = 5 * _kernel_constant("kChunk") + 77
    a, b, vb, _ = _lattice(("exempt_rows", P, k), 3, P, C, 3)
    want = _want_band(a, b, vb)
    bar = _rng("exempt_rows", P, k).choice([-1, 0, k], size=(3, P))
    lo, hi = emulate(a, b, vb, None, 9.0, None, "band", eps2_hi=12.25, bar=bar)
    exempt = bar <= 0
    assert (lo[exempt] == 0).all() and (hi[exempt] == 0).all()
    _band_contract((lo, hi), want, bar)
    if k == 1000:
        np.testing.assert_array_equal(lo[~exempt], want[0][~exempt])
        np.testing.assert_array_equal(hi[~exempt], want[1][~exempt])


def test_every_batched_entry_launches_the_one_kernel():
    """The distance plane is one design: each batched C entry dispatches
    the warp-per-task kernel with its own kind, and the source holds no
    other kernel."""
    src = (build.CSRC / "pairwise.cu").read_text()
    assert src.count("__global__") == 1
    kinds = {"grit_eps_count_batch": "kCount", "grit_row_min_batch": "kMin",
             "grit_eps_count_band_batch": "kBand",
             "grit_row_min2_batch": "kMin2"}
    for entry, kind in kinds.items():
        body = src.split(f'extern "C" int {entry}(', 1)[1]
        body = body.split('extern "C"', 1)[0]
        assert f"dispatch_dist<{kind}>" in body, entry


def _hit_threshold(t) -> np.float32:
    """The C entries' ``hit_threshold(t)``: t (-0 as +0), or the all-ones
    bit pattern for a NaN or negative t."""
    t = np.float32(t)
    if t >= 0:
        return np.float32(0.0) if t == 0 else t
    return np.array([0xFFFFFFFF], np.uint32).view(np.float32)[0]


def _hit(d2: np.ndarray, t: np.float32) -> np.ndarray:
    """The kernels' ``hit(d2, t)``: the sign bit of bits(d2) - bits(t) - 1
    in 32-bit integers."""
    x = d2.astype(np.float32).view(np.uint32).astype(np.int64)
    y = int(np.array(t, np.float32).view(np.uint32))
    return (((x - y - 1) & 0xFFFFFFFF) >> 31).astype(np.int64)


@pytest.mark.parametrize("t", [0.0, -0.0, 1e-45, 1.17549435e-38, 0.5, 1.0,
                               9.0, 22650.25, 3.4028235e38, np.inf, np.nan,
                               -1.0])
def test_hit_is_the_float_compare_on_bit_patterns(t):
    """For a non-negative d2 (denormals, 0, inf and the card's NaN
    included) and any threshold as ``hit_threshold`` passes it on (NaN,
    negative and -0 included), the integer test equals ``d2 <= t``."""
    t = np.float32(t)
    rng = _rng("hit", float(t))
    scale = np.float32(t if np.isfinite(t) and t > 0 else 1.0)
    with np.errstate(over="ignore", invalid="ignore"):
        d2 = np.concatenate([
            np.abs(rng.normal(size=4000)).astype(np.float32) * scale,
            rng.uniform(0, 2, size=2000).astype(np.float32) * scale,
            np.array([0.0, 1e-45, 1e-40, 1.17549435e-38, 3.4028235e38, np.inf],
                     np.float32),
            np.nextafter(t, np.float32(np.inf), dtype=np.float32)[None],
            np.nextafter(t, np.float32(0), dtype=np.float32)[None], t[None]])
        d2 = np.abs(d2[~np.isnan(d2)])
        want = (d2 <= t).astype(np.int64)
    np.testing.assert_array_equal(_hit(d2, _hit_threshold(t)), want)
    nan = np.array([0x7FFFFFFF], np.int32).view(np.float32)   # the card's NaN
    assert _hit(nan, _hit_threshold(t))[0] == 0


def test_every_threshold_reaches_the_kernel_through_hit_threshold():
    """The C entries pass every squared threshold through
    ``hit_threshold``, so a NaN eps counts nothing on the card, as in
    the plain versions."""
    src = (build.CSRC / "pairwise.cu").read_text()
    assert "p.eps2 = hit_threshold(eps2);" in src
    assert "p.eps2 = hit_threshold(lo2);" in src
    assert "p.eps2_hi = hit_threshold(hi2);" in src
    assert src.count("p.eps2 =") == 2 and src.count("p.eps2_hi =") == 1
    a = torch.zeros(2, 3, 3)
    b = torch.zeros(2, 5, 3)
    vb = torch.ones(2, 5, dtype=torch.bool)
    nan = float("nan")
    assert (tops.eps_count_batch_plain(a, b, nan, vb) == 0).all()
    assert all((c == 0).all() for c in tops.eps_count_band_batch_plain(
        a, b, nan, nan, vb))
