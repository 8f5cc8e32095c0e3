// Batched pairwise-distance kernels for the DBSCAN distance plane (sm_90a).
//
//   eps_count_batch       replaces  repro/kernels/pairwise.py::eps_count_batch_pallas
//                         (and, with a shared candidate set, ::eps_count_pallas)
//   row_min_batch         replaces  ::row_min_batch_pallas
//                         (and, with a shared candidate set, ::row_min_pallas)
//   eps_count_band_batch  replaces  ::eps_count_band_batch_pallas
//   row_min2_batch        replaces  ::row_min2_batch_pallas
//
// All four are one kernel, dist_kernel<K, D>, whose kind K is what it keeps
// per row:
//   kCount  hits at d2 <= eps2; with stop_at > 0 the task ends once every
//           live row has stop_at hits;
//   kMin    the least d2 and its first index;
//   kBand   hits at d2 <= eps2 and at d2 <= eps2_hi; with a stop_row, a
//           per-row bar on the first count: a row whose bar is <= 0 is
//           exempt, neither scanned nor counted (its counts are 0), and
//           the task ends once every other row has reached its bar, so a
//           row whose first count is below its bar has scanned every
//           valid candidate;
//   kMin2   the least d2, its first index and the runner-up, the second
//           order statistic of the row's distance multiset (a duplicate of
//           the minimum is the runner-up).
//
// Operands: a [B, P, d] f32 query rows, b [B, C, d] f32 candidates,
// valid_b [B, C] u8 candidate mask, optional valid_a [B, P] u8 row mask.
// Slot g of the batch is one grid of the DBSCAN pipeline: its own points
// against the points of its neighbouring grids.  The unbatched functions
// are the same device code with one candidate set shared by every slot
// (slot stride 0) and the M query rows dealt to slots of P rows each, the
// last slot ragged (rows_total = M).
//
// The TPU kernels form aa + bb - 2ab on the matrix unit over 128-wide
// feature lanes.  Here d is a handful (the paper's data sets have d = 2,
// 3, 5 and 7; dispatch_dist instantiates the kernel for d <= 5 and runs
// any other d <= kMaxRegD on the instance that reads d at run time), so
// the distance is sum_k (a_k - b_k)^2 in f32 registers: no cancellation, no
// tensor core, no feature padding (built with -fmad=false, so each term
// is a rounded multiply followed by a rounded add, in the order k = 0..d-1,
// which is the arithmetic of the plain PyTorch version).  Validity is a
// mask read by the kernel, not FAR-folded coordinates.  On the tensor
// cores (TF32 or bf16) the same form would change counts at exactly eps.
//
// What bounds it: the function must move 4*B*(P+C)*d + B*C + 4*B*P bytes
// (per output) and does 3*d*B*P*C f32 operations, i.e. about 3*P/4
// operations per byte for C >> P: operation bound at the main path's
// P = MinPts-1 = 63 on dense slots, byte bound (the masks) on sparse ones.
// Exactness costs issue slots: without fused multiply-adds a (row,
// candidate) pair is 3d-1 arithmetic instructions plus the kind's decision
// (kCount a hit test and its add, see hit(); kBand two of each; kMin a
// compare and two selects; kMin2 those and a min and a max), against the
// 3d "operations" of the bound.
//
// The schedule: a warp per task, no block barrier in its scan.  A task is
// one slot's rows (at most 64: a slot of more rows is several tasks)
// against all of its candidates; a slot of at most 32 rows whose
// candidates span several chunks is split instead over up to four warps
// of one block, each taking a range of its chunks.  The grid has a warp
// for every task (split), and the warps resident on an SM keep each
// other's bytes in flight.  Per warp:
//   1. lane 0 puts the task's first kStages mask chunks of kChunk
//      positions in flight by bulk copies (cp.async.bulk), each completing
//      on the mbarrier of its stage, and puts the next chunk into a stage
//      once the warp has read it; meanwhile the lanes read valid_a and
//      compact the task's live rows into lanes: two a lane above 32 live
//      rows, else rows x phases;
//   2. each chunk's valid candidates are compacted, in ascending index,
//      32 positions a round with ballot + popc, and their coordinates
//      gathered by cp.async into an item (packed float4 {x, y, z, index}
//      of kCap candidates for d <= 3, planes of kCapPlanes otherwise);
//      kCapStop for a task that may end early, whose gathers past the
//      exit are wasted;
//   3. when the next round would overflow the item, and at the end, the
//      lanes scan it with the rows in registers, loaded at the first
//      item, so a task without a valid candidate reads none:
//      each candidate is one broadcast shared load for all of a lane's
//      rows, with no mask test; lane phase f of a row takes the item's
//      candidates f, f + phases, ... in ascending index with strict <.
//      kCount and kBand check every 32 candidates, across the warp,
//      whether each live row's first count has reached its bar, and then
//      end the task (the stages already in flight are still waited for).
// At the end the phases merge in a butterfly: counts add; (d2, index)
// lexicographically, so the lowest index wins a tie; the runner-up is the
// smaller of both runners-up and the larger of both minima.  The warps of
// a split slot leave their partial results in shared memory, and after
// the block's one barrier warp 0 merges them the same way in split order.
// Rows that valid_a masks, and kBand's exempt rows, are neither scanned
// nor counted (their counts are 0).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

#include "sm90.cuh"

namespace {

// What a kernel keeps per row (see the top of the file).
enum Kind { kCount, kMin, kBand, kMin2 };

__host__ __device__ constexpr bool keeps_min(int K) { return K == kMin || K == kMin2; }

constexpr int kMaxRegD = 8;        // feature dims held in registers per row
constexpr int kWarpsPerBlock = 4;
constexpr int kChunk = 512;        // candidate positions per staged mask chunk
constexpr int kCap = 256;          // compacted candidates per item, packed
constexpr int kCapPlanes = 128;    // per item on the planes (d > 3)
constexpr int kCapStop = 128;      // per item of a task that may end early
constexpr int kGroup = 64;         // rows per task, two a lane
constexpr int kStages = 4;         // mask chunks in flight per warp
constexpr int kNone = 0x7fffffff;
constexpr size_t kMaxSmem = 232448;   // dynamic shared memory of one block
static_assert(kCapStop <= kCapPlanes && kCapPlanes <= kCap, "an item fits its buffer");

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// Shared memory of one warp, in bytes: an mbarrier per stage; kStages mask
// chunks, each sized for the 16-byte-aligned span that holds its bytes;
// the item of compacted candidates (float4 {x, y, z, index} for d <= 3,
// else d coordinate planes and an index plane); the map from lane slots to
// the task's live rows; the warp's partial results of a split slot (three
// words a row).
struct WarpSmem {
    int stage_off, stage_bytes, comp_off, comp_bytes, rmap_off, part_off, total;
};

__host__ __device__ constexpr WarpSmem warp_smem(int d) {
    WarpSmem w{};
    w.stage_off = round16(kStages * 8);
    w.stage_bytes = kChunk + 32;
    w.comp_off = w.stage_off + kStages * w.stage_bytes;
    w.comp_bytes = d <= 3 ? kCap * 16 : kCapPlanes * 4 * (d + 1);
    w.rmap_off = w.comp_off + w.comp_bytes;
    w.part_off = w.rmap_off + kGroup;
    w.total = w.part_off + 32 * 12;
    return w;
}

struct DistArgs {
    const float* a;
    const float* b;
    const uint8_t* valid_b;
    const uint8_t* valid_a;
    const int* stop_row;       // kBand: per-row bar on the first count, or null
    int* out_cnt;              // kCount, kBand: hits at eps2
    int* out_cnt2;             // kBand: hits at eps2_hi
    float* out_min;            // kMin, kMin2
    float* out_min2;           // kMin2: the runner-up
    int* out_arg;              // kMin, kMin2
    int B, P, rows_total, C, d;
    long long b_stride, vb_stride;
    float eps2, eps2_hi;       // as hit_threshold() gives them
    int stop_at;               // kCount
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ int span_offset(const void* p) {
    return (int)(reinterpret_cast<uintptr_t>(p) & 15);
}

// Where a task's rows are: slot, first row of the task in the slot's
// numbering of all rows (slot * P + group * kGroup), and its row count
// (0 for a group past the ragged last slot's rows).
struct Task {
    int slot, row0, rows;
};

__device__ __forceinline__ Task task_of(const DistArgs& p, int t, int n_groups,
                                        int group_rows) {
    Task k;
    k.slot = n_groups == 1 ? t : t / n_groups;
    const int in_slot = (t - k.slot * n_groups) * group_rows;
    k.row0 = k.slot * p.P + in_slot;
    k.rows = max(0, min(group_rows, min(p.P, p.rows_total - k.slot * p.P) - in_slot));
    return k;
}

// d2 of one row against one candidate, sum over k in order, -fmad=false.
template <int D>
__device__ __forceinline__ float dist_packed(const float* av, float4 c) {
    float t = av[0] - c.x;
    float acc = t * t;
    if (D > 1) {
        t = av[1] - c.y;
        acc = acc + t * t;
    }
    if (D > 2) {
        t = av[2] - c.z;
        acc = acc + t * t;
    }
    return acc;
}

// Planes: D = 4 or 5, or D = 0 for a runtime d <= kMaxRegD.
template <int D>
__device__ __forceinline__ float dist_planes(const float* av, const float* pl, int j,
                                             int d) {
    float t = av[0] - pl[j];
    float acc = t * t;
#pragma unroll
    for (int k = 1; k < (D > 0 ? D : kMaxRegD); ++k) {
        if (D > 0 || k < d) {
            t = av[k] - pl[k * kCapPlanes + j];
            acc = acc + t * t;
        }
    }
    return acc;
}

// Planes with the row read from device memory (d > kMaxRegD).
__device__ __forceinline__ float dist_wide(const float* arow, const float* pl, int j,
                                           int d) {
    float t = __ldg(arow) - pl[j];
    float acc = t * t;
    for (int k = 1; k < d; ++k) {
        t = __ldg(arow + k) - pl[k * kCapPlanes + j];
        acc = acc + t * t;
    }
    return acc;
}

// A lane's running results for its rows (at most two); each kind uses its
// own fields: hits at eps2 and at eps2_hi, or the least d2, its index and
// the runner-up.
struct Acc {
    int cnt[2], cnt2[2];
    float best[2], second[2];
    int arg[2];
};

// 1 when d2 <= t.  d2 is a sum of squares: a non-negative float, or the
// card's NaN 0x7fffffff.  t comes from hit_threshold(): a non-negative
// float other than -0, whose bit pattern orders as its value, or the
// all-ones pattern, under which no d2 is a hit.  So the test is the sign
// bit of one integer subtraction, which the add takes in the same
// instruction: fewer issue slots than a float compare and a select.  It
// equals the float compare d2 <= t for every such d2 and every threshold
// hit_threshold() was given, NaN included.
__device__ __forceinline__ int hit(float d2, float t) {
    return (int)((__float_as_uint(d2) - __float_as_uint(t) - 1u) >> 31);
}

// Row q of the lane against candidate idx at d2.  A lane takes its
// candidates in ascending idx, so strict < keeps the first minimum, and a
// later duplicate of the minimum becomes the runner-up.
template <int K>
__device__ __forceinline__ void take(Acc& r, int q, float d2, int idx, float eps2,
                                     float eps2_hi) {
    if (K == kCount || K == kBand) r.cnt[q] += hit(d2, eps2);
    if (K == kBand) r.cnt2[q] += hit(d2, eps2_hi);
    if (K == kMin2) r.second[q] = fminf(r.second[q], fmaxf(r.best[q], d2));
    if (keeps_min(K) && d2 < r.best[q]) {
        r.best[q] = d2;
        r.arg[q] = idx;
    }
}

// Merge a partial result (ob, os, oa) of the same row into (best, second,
// arg): (d2, index) lexicographically, and for kMin2 the runner-up is the
// smaller of both runners-up and the larger of both minima, so it stays
// the second order statistic whatever the lane layout or split.
template <int K>
__device__ __forceinline__ void merge_min(float& best, float& second, int& arg, float ob,
                                          float os, int oa) {
    if (K == kMin2) second = fminf(fminf(second, os), fmaxf(best, ob));
    if (ob < best || (ob == best && oa < arg)) {
        best = ob;
        arg = oa;
    }
}

// Whether, across the warp, every live row's first count (summed over the
// row's phases, lanes `span` apart) has reached its bar.
template <int R>
__device__ __forceinline__ bool saturated(const Acc& r, const int (&need)[2],
                                          const bool (&live)[2], int span) {
    bool sat = true;
#pragma unroll
    for (int q = 0; q < R; ++q) {
        int tot = r.cnt[q];
        for (int o = span; o < 32; o <<= 1) tot += __shfl_xor_sync(0xffffffffu, tot, o);
        sat = sat && (!live[q] || tot >= need[q]);
    }
    return __all_sync(0xffffffffu, sat);
}

// Scan compacted candidates [0, n) of one item: lane phase `phase` of
// `ph` takes j = phase, phase + ph, ... in ascending order, for its R
// rows.  With `stopping` (kCount, kBand) the warp checks every 32
// candidates whether each live row's first count has reached its bar
// `need`, and returns true when the task may end.  kMode: 0 packed, 1
// planes with the rows in registers, 2 planes with the rows read from
// device memory.
template <int K, int D, int R, int kMode, int kRegD>
__device__ __forceinline__ bool scan_item(const unsigned char* cb, int n, int phase,
                                          int ph, int span, int d, float eps2,
                                          float eps2_hi, bool stopping,
                                          const int (&need)[2], float (&ax)[2][kRegD],
                                          const float* (&arow)[2], const bool (&live)[2],
                                          Acc& acc) {
    const float4* cp = reinterpret_cast<const float4*>(cb);
    const float* pl = reinterpret_cast<const float*>(cb);
    const int* pidx = reinterpret_cast<const int*>(cb) + d * kCapPlanes;
    stopping = stopping && !keeps_min(K);
    const int blk = stopping ? 32 : n;
    for (int jb = 0; jb < n; jb += blk) {
        const int je = min(n, jb + blk);
#pragma unroll 4
        for (int j = jb + phase; j < je; j += ph) {
            if (kMode == 0) {
                const float4 c = cp[j];
#pragma unroll
                for (int q = 0; q < R; ++q)
                    take<K>(acc, q, dist_packed<D>(ax[q], c), __float_as_int(c.w), eps2,
                            eps2_hi);
            } else {
#pragma unroll
                for (int q = 0; q < R; ++q) {
                    const float d2 = kMode == 1 ? dist_planes<D>(ax[q], pl, j, d)
                                                : dist_wide(arow[q], pl, j, d);
                    take<K>(acc, q, d2, pidx[j], eps2, eps2_hi);
                }
            }
        }
        if (stopping && saturated<R>(acc, need, live, span)) return true;
    }
    return false;
}

template <int K, int D, int kMode, int kRegD>
__device__ __forceinline__ bool scan_rows(bool two, const unsigned char* cb, int n,
                                          int phase, int ph, int span, int d, float eps2,
                                          float eps2_hi, bool stopping,
                                          const int (&need)[2], float (&ax)[2][kRegD],
                                          const float* (&arow)[2], const bool (&live)[2],
                                          Acc& acc) {
    if (two)
        return scan_item<K, D, 2, kMode>(cb, n, 0, 1, 32, d, eps2, eps2_hi, stopping,
                                         need, ax, arow, live, acc);
    return scan_item<K, D, 1, kMode>(cb, n, phase, ph, span, d, eps2, eps2_hi, stopping,
                                     need, ax, arow, live, acc);
}

// One row's results into the outputs of the kernel's kind.
template <int K>
__device__ __forceinline__ void put(const DistArgs& p, int row, int cnt, int cnt2,
                                    float best, float second, int arg) {
    if (keeps_min(K)) {
        p.out_min[row] = best;
        // no valid candidate (or only infinitely far ones)
        p.out_arg[row] = best == CUDART_INF_F ? -1 : arg;
        if (K == kMin2) p.out_min2[row] = second;
    } else {
        p.out_cnt[row] = cnt;
        if (K == kBand) p.out_cnt2[row] = cnt2;
    }
}

// Blocks of the kernel at feature dim D that fit an SM's shared memory
// (D = 0: the generic kernel, sized at kMaxRegD), at most 8 on the packed
// route (64 registers a thread, which every kind fits there without a
// spill) and 6 on the planes: the launch bound that lets ptxas use the
// registers that occupancy leaves.
constexpr int min_blocks(int D) {
    const int per_block = kWarpsPerBlock * warp_smem(D > 0 ? D : kMaxRegD).total;
    const int n = (int)(kMaxSmem / per_block);
    const int most = (D >= 1 && D <= 3) ? 8 : 6;
    return n < 1 ? 1 : (n > most ? most : n);
}

// One warp, one task: a slot's rows (at most kGroup) against its
// candidates, or with splits > 1 (a slot of at most 32 rows, the block's
// splits warps on one slot) against the warp's share of the candidate
// chunks.
template <int K, int D>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, min_blocks(D))
dist_kernel(const DistArgs p, int splits) {
    constexpr int kRegD = (D > 0) ? D : kMaxRegD;
    constexpr int kMode = (D >= 1 && D <= 3) ? 0 : 1;
    extern __shared__ __align__(16) unsigned char smem[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned below = (1u << lane) - 1u;
    const int d = (D > 0) ? D : p.d;
    const WarpSmem ws = warp_smem(d);
    unsigned char* wsm = smem + (size_t)warp * ws.total;
    uint64_t* bars = reinterpret_cast<uint64_t*>(wsm);

    const int group_rows = min(p.P, kGroup);
    const int n_groups = (p.P + group_rows - 1) / group_rows;
    const int t = splits > 1 ? blockIdx.x : blockIdx.x * (blockDim.x >> 5) + warp;
    Task k{0, 0, 0};
    if (t < p.B * n_groups) k = task_of(p, t, n_groups, group_rows);
    const int nch = max(1, (p.C + kChunk - 1) / kChunk);
    const int per = (nch + splits - 1) / splits;
    const int c0 = min(nch, (splits > 1 ? warp : 0) * per);
    const int nq = k.rows > 0 ? min(nch, c0 + per) - c0 : 0;   // the warp's chunks
    const uint8_t* vbs = p.valid_b + k.slot * p.vb_stride;

    // step 1: lane 0 puts mask chunk c0 + q in flight into stage q % kStages
    // by a bulk copy that completes the (q / kStages)-th phase of the stage's
    // mbarrier (armed with no bytes for a chunk past the candidates)
    if (lane == 0)
        for (int s = 0; s < kStages; ++s) sm90::mbar_init(bars + s, 1);
    sm90::mbar_init_fence();
    __syncwarp();
    auto stage = [&](int q) {
        if (lane != 0) return;
        const int s = q % kStages;
        const int j0 = (c0 + q) * kChunk;
        const int len = min(kChunk, p.C - j0);
        uint32_t bytes = 0;
        const uint8_t* src = vbs + j0;
        if (len > 0) {
            bytes = round16(span_offset(src) + len);
            src -= span_offset(src);
        }
        sm90::mbar_expect_tx(bars + s, bytes);
        if (bytes) sm90::bulk_load(wsm + ws.stage_off + s * ws.stage_bytes, src, bytes, bars + s);
    };
    int issued = min(nq, kStages);
    for (int q = 0; q < issued; ++q) stage(q);

    // the task's live rows (bit i of lo / hi is row i / 32 + i): those
    // that valid_a marks and, with kBand's bars, whose bar is above 0;
    // compacted into lane slots: two a lane above 32 live rows, else rows x
    // phases
    const bool barred = K == kBand && p.stop_row != nullptr;
    unsigned lo, hi;
    if (p.valid_a == nullptr && !barred) {
        lo = k.rows >= 32 ? 0xffffffffu : (1u << k.rows) - 1u;
        hi = k.rows >= 64 ? 0xffffffffu : k.rows > 32 ? (1u << (k.rows - 32)) - 1u : 0u;
    } else {
        auto is_live = [&](int i) {
            return i < k.rows && (p.valid_a == nullptr || p.valid_a[k.row0 + i] != 0) &&
                   (!barred || p.stop_row[k.row0 + i] > 0);
        };
        lo = __ballot_sync(0xffffffffu, is_live(lane));
        hi = __ballot_sync(0xffffffffu, is_live(lane + 32));
    }
    const int n_lo = __popc(lo);
    const int n_live = n_lo + __popc(hi);
    const bool two = n_live > 32;
    int span = 32;
    if (!two) {
        span = 1;
        while (span < n_live) span <<= 1;
    }
    const int ph = 32 / span;
    const int phase = two ? 0 : lane / span;
    const int slot0 = two ? lane : (lane & (span - 1));
    const bool dense = n_live == k.rows;          // live rows are 0 .. n_live - 1
    unsigned char* rmap = wsm + ws.rmap_off;      // live row of each lane slot
    if (!dense) {
        if (lo >> lane & 1u) rmap[__popc(lo & below)] = (unsigned char)lane;
        if (hi >> lane & 1u) rmap[n_lo + __popc(hi & below)] = (unsigned char)(lane + 32);
        __syncwarp();
    }
    const bool stopping = K == kCount ? p.stop_at > 0 : barred;
    const int cap = stopping ? kCapStop : (d <= 3 ? kCap : kCapPlanes);   // per item
    float ax[2][kRegD];
    const float* arow[2];
    bool live[2];
    int rowq[2];                    // the lane's rows within the task
    int need[2];                    // their bars on the first count
    Acc acc;
#pragma unroll
    for (int qq = 0; qq < 2; ++qq) {
        const int sl = slot0 + 32 * qq;
        live[qq] = sl < n_live;
        rowq[qq] = !live[qq] ? 0 : dense ? sl : rmap[sl];
        arow[qq] = p.a + (long long)(k.row0 + rowq[qq]) * d;
        need[qq] = barred && live[qq] ? p.stop_row[k.row0 + rowq[qq]] : p.stop_at;
        acc.cnt[qq] = 0;
        acc.cnt2[qq] = 0;
        acc.best[qq] = CUDART_INF_F;
        acc.second[qq] = CUDART_INF_F;
        acc.arg[qq] = kNone;
    }

    // step 2: each chunk's valid candidates, 32 positions a round, are
    // placed at their compacted positions in the item (ballot + popc) and
    // their coordinates gathered there by cp.async; step 3, when the next
    // round would take the item past its cap and at the end: the live rows
    // scan it, one broadcast shared load per candidate.  kCount and kBand
    // stop once every live row has reached its bar; the chunks already in
    // flight are still waited for.
    const float* bs = p.b + k.slot * p.b_stride;
    unsigned char* cb = wsm + ws.comp_off;
    int n = 0;
    bool stop = n_live == 0;
    bool rows_in = false;           // the rows are in registers
    auto scan = [&]() {
        if (!rows_in) {             // loaded while the first gathers land
#pragma unroll
            for (int qq = 0; qq < 2; ++qq)
#pragma unroll
                for (int kk = 0; kk < kRegD; ++kk)
                    ax[qq][kk] = (live[qq] && kk < d) ? __ldg(arow[qq] + kk) : 0.0f;
            rows_in = true;
        }
        cp_async_wait_all();
        __syncwarp();
        bool done;
        if (kMode == 0)
            done = scan_rows<K, D, 0>(two, cb, n, phase, ph, span, d, p.eps2, p.eps2_hi,
                                      stopping, need, ax, arow, live, acc);
        else if (D > 0 || d <= kMaxRegD)
            done = scan_rows<K, D, 1>(two, cb, n, phase, ph, span, d, p.eps2, p.eps2_hi,
                                      stopping, need, ax, arow, live, acc);
        else
            done = scan_rows<K, D, 2>(two, cb, n, phase, ph, span, d, p.eps2, p.eps2_hi,
                                      stopping, need, ax, arow, live, acc);
        stop = stop || done;
        n = 0;
        __syncwarp();               // the item is read before it is refilled
    };
    for (int q = 0; q < issued; ++q) {
        const int s = q % kStages;
        sm90::mbar_wait(bars + s, (q / kStages) & 1);
        const unsigned char* st = wsm + ws.stage_off + s * ws.stage_bytes;
        const int j0 = (c0 + q) * kChunk;
        const int len = min(kChunk, p.C - j0);
        const uint8_t* vb = vbs + j0;
        // a staged span of zeros holds no valid candidate
        bool any = false;
        for (int i = lane; !stop && i < (span_offset(vb) + len + 15) >> 4; i += 32) {
            const uint4 w = reinterpret_cast<const uint4*>(st)[i];
            any = any || (w.x | w.y | w.z | w.w) != 0;
        }
        if (__any_sync(0xffffffffu, any)) {
            const unsigned char* mk = st + span_offset(vb);
            for (int r = 0; 32 * r < len; ++r) {
                const int i = 32 * r + lane;
                const bool v = i < len && mk[i] != 0;
                const unsigned bits = __ballot_sync(0xffffffffu, v);
                if (n + __popc(bits) > cap) {
                    scan();
                    if (stop) break;
                }
                if (v) {
                    const int pos = n + __popc(bits & below);
                    const int j = j0 + i;
                    const float* src = bs + (long long)j * d;
                    if (kMode == 0) {
                        float4* dst = reinterpret_cast<float4*>(cb) + pos;
                        cp_async4(&dst->x, src);
                        if (D > 1) cp_async4(&dst->y, src + 1);
                        if (D > 2) cp_async4(&dst->z, src + 2);
                        dst->w = __int_as_float(j);
                    } else {
                        float* pl = reinterpret_cast<float*>(cb);
                        for (int kk = 0; kk < d; ++kk)
                            cp_async4(pl + kk * kCapPlanes + pos, src + kk);
                        reinterpret_cast<int*>(pl)[d * kCapPlanes + pos] = j;
                    }
                }
                n += __popc(bits);
            }
        }
        __syncwarp();               // every lane has read the stage
        if (!stop && issued < nq) stage(issued++);
    }
    if (n > 0 && !stop) scan();

    // the phases merge in a butterfly (see the top of the file)
    int tot[2], tot2[2];
#pragma unroll
    for (int qq = 0; qq < 2; ++qq) {
        tot[qq] = acc.cnt[qq];
        tot2[qq] = acc.cnt2[qq];
        if (!two && qq == 1) break;
        for (int o = span; o < 32; o <<= 1) {
            if (keeps_min(K)) {
                const float ob = __shfl_xor_sync(0xffffffffu, acc.best[qq], o);
                const float os = K == kMin2
                    ? __shfl_xor_sync(0xffffffffu, acc.second[qq], o) : CUDART_INF_F;
                const int oa = __shfl_xor_sync(0xffffffffu, acc.arg[qq], o);
                merge_min<K>(acc.best[qq], acc.second[qq], acc.arg[qq], ob, os, oa);
            } else {
                tot[qq] += __shfl_xor_sync(0xffffffffu, tot[qq], o);
                if (K == kBand) tot2[qq] += __shfl_xor_sync(0xffffffffu, tot2[qq], o);
            }
        }
    }
    if (splits == 1) {
        if (k.rows > 0) {
#pragma unroll
            for (int qq = 0; qq < 2; ++qq) {
                if (phase != 0 || !live[qq]) continue;
                put<K>(p, k.row0 + rowq[qq], tot[qq], tot2[qq], acc.best[qq],
                       acc.second[qq], acc.arg[qq]);
            }
            if (!keeps_min(K)) {    // rows that valid_a masks or the bar exempts: 0
                if (lane < k.rows && !(lo >> lane & 1u))
                    put<K>(p, k.row0 + lane, 0, 0, 0.0f, 0.0f, 0);
                if (lane + 32 < k.rows && !(hi >> lane & 1u))
                    put<K>(p, k.row0 + lane + 32, 0, 0, 0.0f, 0.0f, 0);
            }
        }
        return;
    }
    // a split slot (at most 32 rows, one a lane slot): each warp leaves its
    // partial result per row in its shared memory (the least d2 or the
    // first count, the index or the second count, the runner-up), and after
    // the block's one barrier warp 0 merges them in split order
    float* pb = reinterpret_cast<float*>(wsm + ws.part_off);
    int* pa = reinterpret_cast<int*>(pb + 32);
    float* ps = pb + 64;
    pb[lane] = keeps_min(K) ? CUDART_INF_F : __int_as_float(0);
    if (K != kCount) pa[lane] = keeps_min(K) ? kNone : 0;
    if (K == kMin2) ps[lane] = CUDART_INF_F;
    __syncwarp();
    if (phase == 0 && live[0]) {
        pb[rowq[0]] = keeps_min(K) ? acc.best[0] : __int_as_float(tot[0]);
        if (K != kCount) pa[rowq[0]] = keeps_min(K) ? acc.arg[0] : tot2[0];
        if (K == kMin2) ps[rowq[0]] = acc.second[0];
    }
    __syncthreads();
    if (warp == 0 && lane < k.rows) {
        float m = CUDART_INF_F, m2 = CUDART_INF_F;
        int am = kNone, c = 0, c2 = 0;
        for (int w = 0; w < splits; ++w) {
            const float* ob = reinterpret_cast<const float*>(smem + (size_t)w * ws.total +
                                                             ws.part_off);
            const float b = ob[lane];
            const int a = K == kCount ? 0 : reinterpret_cast<const int*>(ob + 32)[lane];
            if (keeps_min(K)) {
                merge_min<K>(m, m2, am, b, K == kMin2 ? ob[64 + lane] : CUDART_INF_F, a);
            } else {
                c += __float_as_int(b);
                c2 += a;
            }
        }
        put<K>(p, k.row0 + lane, c, c2, m, m2, am);
    }
}

// Lets `kernel` take `bytes` of dynamic shared memory (a call only above
// the default 48 KB, so the usual launch costs no attribute call).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
}

// Warps per block at feature dim d: kWarpsPerBlock, fewer where their
// shared memory would not fit, 0 where one warp's does not.
int warps_per_block(int d) {
    const size_t per_warp = (size_t)warp_smem(d).total;
    int wpb = kWarpsPerBlock;
    while (wpb > 0 && wpb * per_warp > kMaxSmem) --wpb;
    return wpb;
}

// A warp per task; a slot of at most 32 rows whose candidates span more
// than one chunk is split over up to kWarpsPerBlock warps of one block.
template <int K, int D>
cudaError_t launch_dist(const DistArgs& p, cudaStream_t stream) {
    auto kernel = dist_kernel<K, D>;
    const int wpb = warps_per_block(p.d);
    if (wpb == 0) return cudaErrorInvalidValue;
    const size_t per_warp = (size_t)warp_smem(p.d).total;
    const cudaError_t err = allow_smem(kernel, wpb * per_warp);
    if (err != cudaSuccess) return err;
    const int nch = (p.C + kChunk - 1) / kChunk;
    const int splits = p.P <= 32 ? max(1, min(wpb, nch)) : 1;
    const int group_rows = p.P < kGroup ? p.P : kGroup;
    const long long tasks = (long long)p.B * ((p.P + group_rows - 1) / group_rows);
    const int warps = splits > 1 ? splits : wpb;
    const long long grid = splits > 1 ? p.B : (tasks + wpb - 1) / wpb;
    kernel<<<(unsigned)grid, warps * 32, warps * per_warp, stream>>>(p, splits);
    return cudaGetLastError();
}

template <int K>
cudaError_t dispatch_dist(const DistArgs& p, cudaStream_t s) {
    switch (p.d) {
        case 1: return launch_dist<K, 1>(p, s);
        case 2: return launch_dist<K, 2>(p, s);
        case 3: return launch_dist<K, 3>(p, s);
        case 4: return launch_dist<K, 4>(p, s);
        case 5: return launch_dist<K, 5>(p, s);
        default: return launch_dist<K, 0>(p, s);
    }
}

// The threshold that hit() takes for a squared distance threshold t: t,
// with -0 as +0; for a NaN or negative t, under which no distance is a
// hit, the all-ones bit pattern.
float hit_threshold(float t) {
    if (t >= 0.0f) return t == 0.0f ? 0.0f : t;
    const uint32_t ones = 0xffffffffu;
    float f;
    memcpy(&f, &ones, sizeof f);
    return f;
}

// The operands every kind shares; the outputs, thresholds and bars are
// the caller's to set.
DistArgs dist_args(const void* a, const void* b, const void* valid_b, int B, int P,
                   int rows_total, int C, int d, long long b_stride, long long vb_stride) {
    DistArgs p{};
    p.a = (const float*)a;
    p.b = (const float*)b;
    p.valid_b = (const uint8_t*)valid_b;
    p.B = B;
    p.P = P;
    p.rows_total = rows_total;
    p.C = C;
    p.d = d;
    p.b_stride = b_stride;
    p.vb_stride = vb_stride;
    return p;
}

}  // namespace

// Every entry point enqueues one launch on `stream` and returns
// cudaGetLastError(); they allocate nothing and do not synchronise.
// B slots of P rows cover rows_total rows of `a` (and of the outputs and
// valid_a); slot g reads its candidates at b + g*b_stride floats and its
// mask at valid_b + g*vb_stride bytes.  stop_at <= 0 disables the exit.
extern "C" int grit_eps_count_batch(const void* a, const void* b, const void* valid_b,
                                    const void* valid_a, void* out, int B, int P,
                                    int rows_total, int C, int d, long long b_stride,
                                    long long vb_stride, float eps2, int stop_at,
                                    void* stream) {
    if (B <= 0 || P <= 0) return (int)cudaSuccess;
    DistArgs p = dist_args(a, b, valid_b, B, P, rows_total, C, d, b_stride, vb_stride);
    p.valid_a = (const uint8_t*)valid_a;
    p.out_cnt = (int*)out;
    p.eps2 = hit_threshold(eps2);
    p.stop_at = stop_at;
    return (int)dispatch_dist<kCount>(p, (cudaStream_t)stream);
}

extern "C" int grit_row_min_batch(const void* a, const void* b, const void* valid_b,
                                  void* out_min, void* out_arg, int B, int P,
                                  int rows_total, int C, int d, long long b_stride,
                                  long long vb_stride, void* stream) {
    if (B <= 0 || P <= 0) return (int)cudaSuccess;
    DistArgs p = dist_args(a, b, valid_b, B, P, rows_total, C, d, b_stride, vb_stride);
    p.out_min = (float*)out_min;
    p.out_arg = (int*)out_arg;
    return (int)dispatch_dist<kMin>(p, (cudaStream_t)stream);
}

// The guard-band entries take dense batches: slot g reads its P rows at
// a + g*P*d, its candidates at b + g*C*d and its mask at valid_b + g*C.
// stop_row may be null (no early exit).
extern "C" int grit_eps_count_band_batch(const void* a, const void* b,
                                         const void* valid_b, const void* stop_row,
                                         void* out_lo, void* out_hi, int B, int P,
                                         int C, int d, float lo2, float hi2,
                                         void* stream) {
    if (B <= 0 || P <= 0) return (int)cudaSuccess;
    DistArgs p = dist_args(a, b, valid_b, B, P, B * P, C, d, (long long)C * d, C);
    p.stop_row = (const int*)stop_row;
    p.out_cnt = (int*)out_lo;
    p.out_cnt2 = (int*)out_hi;
    p.eps2 = hit_threshold(lo2);
    p.eps2_hi = hit_threshold(hi2);
    return (int)dispatch_dist<kBand>(p, (cudaStream_t)stream);
}

extern "C" int grit_row_min2_batch(const void* a, const void* b, const void* valid_b,
                                   void* out_min, void* out_min2, void* out_arg,
                                   int B, int P, int C, int d, void* stream) {
    if (B <= 0 || P <= 0) return (int)cudaSuccess;
    DistArgs p = dist_args(a, b, valid_b, B, P, B * P, C, d, (long long)C * d, C);
    p.out_min = (float*)out_min;
    p.out_min2 = (float*)out_min2;
    p.out_arg = (int*)out_arg;
    return (int)dispatch_dist<kMin2>(p, (cudaStream_t)stream);
}

// The staging route of the distance kernels at feature dim d: 0 packed
// float4 candidates (d <= 3), 1 coordinate planes with the rows in
// registers (d <= 8), 2 planes with the rows read from device memory.
extern "C" int grit_pairwise_route(int d) {
    return d <= 3 ? 0 : (d <= kMaxRegD ? 1 : 2);
}
