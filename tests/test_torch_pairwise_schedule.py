"""The schedule of the CUDA ``eps_count_batch`` / ``row_min_batch``
kernels, emulated in numpy on the CPU and held against the plain
PyTorch versions and ``repro.kernels.ref``.

The kernels (``csrc/pairwise.cu``) give each slot to one warp, or a
slot of at most 32 rows whose candidates span several chunks of
``kChunk`` positions to up to ``kWarpsPerBlock`` warps, each taking a
range of the chunks (a split).  Per warp, the slot's live rows are
compacted into lane slots (two rows a lane above 32 live rows, else rows
x phases with phase = compacted candidate mod phases); the valid
candidates are compacted in ascending order, 32 positions a round, into
items of at most ``kCap`` (a round that would overflow the item starts
the next one; the end of the warp's range closes its item); each lane
scans its candidates of an item in ascending order with strict ``<`` (or
counts hits), eps counts stop once every live row has ``stop_at`` hits
(checked every 32 compacted candidates of an item), and the phases merge
``(d2, index)`` lexicographically in a butterfly at the end; the splits
merge the same way in split order, their counts added.
:func:`emulate` does the
same steps with the same float32 arithmetic (``sum_k (a_k - b_k)^2``,
each operation rounded), so a fault in the schedule's logic -- a tie
resolved to the wrong index, a stop taken too early, a row lost in the
compaction -- shows here, without the card.

Tolerances: none; integer lattices make every distance exact, so
counts, minima and argmins must be equal.
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
            group=None, splits=None):
    """One launch of the kernel's schedule: a [B, P, d], b [B, C, d],
    vb [B, C], va [B, P] or None.  ``phases`` forces the phase count and
    ``splits`` the warps per slot; None takes the kernel's rule.  Returns
    counts [B, P] (``kind="count"``) or (min [B, P], argmin [B, P])."""
    cap = cap or _kernel_constant("kCap")
    group = group or _kernel_constant("kGroup")
    B, P, _ = a.shape
    C = b.shape[1]
    cnt_out = np.zeros((B, P), np.int64)
    min_out = np.full((B, P), np.inf, np.float32)
    arg_out = np.full((B, P), -1, np.int64)
    group_rows = min(P, group)
    ranges = split_ranges(C, split_count(P, C) if splits is None else splits)
    for g in range(B):
        for r0 in range(0, P, group_rows):
            rows = np.arange(r0, min(P, r0 + group_rows))
            live = rows if va is None else rows[va[g, rows]]
            if len(live) == 0:
                continue
            ph = layout(len(live))[2] if phases is None else phases
            parts = [_scan_range(a[g, live], b[g], vb[g], lo, hi, eps2,
                                 stop_at, kind, ph, cap) for lo, hi in ranges]
            # the splits merge in order: (d2, index) lexicographically
            cnt, best, arg = parts[0]
            for c2, b2, a2 in parts[1:]:
                take = (b2 < best) | ((b2 == best) & (a2 < arg))
                best, arg = np.where(take, b2, best), np.where(take, a2, arg)
                cnt = cnt + c2
            cnt_out[g, live] = cnt
            min_out[g, live] = best
            arg_out[g, live] = np.where(np.isinf(best), -1, arg)
    if kind == "count":
        return cnt_out
    return min_out, arg_out


def _scan_range(a_live, b, vb, lo, hi, eps2, stop_at, kind, ph, cap):
    """One warp: live rows ``a_live`` against the valid candidates of
    positions [lo, hi) (``lo`` a chunk boundary, so rounds of 32 stay
    aligned), ``ph`` phases.  Returns per row (count, min, argmin) after
    the phases' butterfly."""
    n_live = len(a_live)
    cnt = np.zeros((n_live, ph), np.int64)
    best = np.full((n_live, ph), np.inf, np.float32)
    arg = np.full((n_live, ph), np.iinfo(np.int32).max, np.int64)
    done = False
    for comp in items_of(vb[lo:hi], cap):        # ascending: the compaction
        if done:
            break
        comp = comp + lo
        d2 = _d2(a_live, b[comp])
        n = len(comp)
        blk = n if (kind == "min" or not stop_at) else 32
        for jb in range(0, n, max(blk, 1)):
            je = min(n, jb + blk)
            for f in range(ph):
                js = np.arange(jb + f, je, ph)
                if len(js) == 0:
                    continue
                if kind == "min":
                    for j in js:                 # ascending, strict <
                        better = d2[:, j] < best[:, f]
                        best[better, f] = d2[better, j]
                        arg[better, f] = comp[j]
                else:
                    cnt[:, f] += (d2[:, js] <= eps2).sum(axis=1)
            if kind == "count" and stop_at and \
                    (cnt.sum(axis=1) >= stop_at).all():
                done = True
                break
    # butterfly over the phases: lexicographic (d2, index)
    o = 1
    while o < ph:
        other = np.arange(ph) ^ o
        ob, oa = best[:, other], arg[:, other]
        take = (ob < best) | ((ob == best) & (oa < arg))
        best, arg = np.where(take, ob, best), np.where(take, oa, arg)
        cnt = cnt + cnt[:, other]
        o <<= 1
    return cnt[:, 0], best[:, 0], arg[:, 0]


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
