// Batched pairwise-distance kernels for the DBSCAN distance plane (sm_90a).
//
//   eps_count_batch  replaces  repro/kernels/pairwise.py::eps_count_batch_pallas
//                    (and, with a shared candidate set, ::eps_count_pallas)
//   row_min_batch    replaces  repro/kernels/pairwise.py::row_min_batch_pallas
//                    (and, with a shared candidate set, ::row_min_pallas)
//   eps_count_band_batch  replaces  ::eps_count_band_batch_pallas
//   row_min2_batch        replaces  ::row_min2_batch_pallas
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
// feature lanes.  Here d <= 5 in every catalogue deployment, so the
// distance is sum_k (a_k - b_k)^2 in f32 registers: no cancellation, no
// tensor core, no feature padding (built with -fmad=false, so each term
// is a rounded multiply followed by a rounded add, in the order k = 0..d-1,
// which is the arithmetic of the plain PyTorch version).  Validity is a
// mask read by the kernel, not FAR-folded coordinates.  On the tensor
// cores (TF32 or bf16) the same form would change counts at exactly eps.
//
// What bounds it: the function must move 4*B*(P+C)*d + B*C + 4*B*P bytes
// and does 3*d*B*P*C f32 operations, i.e. about 3*P/4 operations per byte
// for C >> P: operation bound at the main path's P = MinPts-1 = 63 on
// dense slots, byte bound (the masks) on sparse ones.  Exactness costs
// issue slots: without fused multiply-adds a (row, candidate) pair of
// row_min is 3d-1 arithmetic instructions, a compare and two selects
// (11 at d = 3; eps_count 10), against the 3d "operations" of the bound.
//
// eps_count_batch / row_min_batch: a warp per task, no block barrier in
// its scan.  A task is one slot's rows (at most 64: a slot of more rows is
// several tasks) against all of its candidates; a slot of at most 32 rows
// whose candidates span several chunks is split instead over up to four
// warps of one block, each taking a range of its chunks.  The grid has a
// warp for every task (split), and the warps resident on an SM keep each
// other's bytes in flight.  Per warp:
//   1. lane 0 puts the task's first kStages mask chunks of kChunk
//      positions in flight by bulk copies (cp.async.bulk), each completing
//      on the mbarrier of its stage, and puts the next chunk into a stage
//      once the warp has read it; meanwhile the lanes read valid_a and
//      compact the task's live rows into lanes: two a lane above 32 live
//      rows, else rows x phases;
//   2. each chunk's valid candidates are compacted, in ascending index,
//      32 positions a round with ballot + popc, and their coordinates
//      gathered by cp.async into an item of kCap candidates (packed float4
//      {x, y, z, index} for d <= 3, planes otherwise);
//   3. when the next round would overflow the item, and at the end, the
//      lanes scan it with the rows in registers (loaded at the first item,
//      so a task without a valid candidate reads none): each candidate is
//      one broadcast shared load for all of a lane's rows, with no mask
//      test; lane phase f of a row takes the item's candidates f,
//      f + phases, ... in ascending index with strict <.  eps_count checks
//      every 32 candidates, across the warp, whether each live row has
//      stop_at hits, and then ends the task.
// At the end the phases merge (d2, index) lexicographically in a butterfly,
// so the lowest index wins a tie; the warps of a split slot leave their
// partial results in shared memory, and after the block's one barrier
// warp 0 merges them the same way in split order (counts add).  Rows
// masked by valid_a are neither scanned nor counted (their counts are 0).

// The two guard-band twins keep the first design: one block per slot,
// the slot's candidates staged tile by tile, rows dealt to warps and
// candidates to lanes.  eps_count_band_batch keeps two counters (hits at
// lo2 and at hi2) and stops a slot once every row's lo count has reached
// its own stop_row bar (bar 0 exempts a row); row_min2_batch keeps a
// (min, first index, runner-up) triple per lane and merges triples
// lexicographically on (min, index) with
// min2 = min(min2_a, min2_b, max(min_a, min_b)), so the runner-up is the
// second order statistic of the row's distance multiset (a duplicate of
// the minimum counts) whatever the lane layout.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

// guard-band kernels: one block per slot
constexpr int kThreads = 128;           // 4 warps per slot
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 512;              // candidates staged per step

// 1 + index of the slot's last valid candidate (0 when there is none):
// the tile loop never scans the all-padding tail of the candidate axis.
__device__ int last_valid(const uint8_t* __restrict__ vb, int C, int* s_red) {
    int last = 0;
    for (int j = threadIdx.x; j < C; j += kThreads)
        if (vb[j]) last = j + 1;                // ascending j: keeps the max
    for (int o = 16; o > 0; o >>= 1)
        last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
    if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = last;
    __syncthreads();
    int out = 0;
    for (int w = 0; w < kWarps; ++w) out = max(out, s_red[w]);
    __syncthreads();
    return out;
}

// Stage candidates [t0, t0+tn) of one slot, transposed to [d][kTile] so a
// warp's strided read of one coordinate is conflict free.
__device__ void stage_tile(const float* __restrict__ b, const uint8_t* __restrict__ vb,
                           int t0, int tn, int d, float* s_b, uint8_t* s_v) {
    const float* src = b + (size_t)t0 * d;
    for (int i = threadIdx.x; i < tn * d; i += kThreads) {
        int j = i / d, k = i - j * d;
        s_b[k * kTile + j] = src[i];
    }
    for (int j = threadIdx.x; j < tn; j += kThreads) s_v[j] = vb[t0 + j];
}

template <int D>
__device__ __forceinline__ float sq_dist(const float* __restrict__ av, const float* s_b,
                                         int j, int d) {
    float acc = 0.0f;
    if (D > 0) {
#pragma unroll
        for (int k = 0; k < D; ++k) {
            float t = av[k] - s_b[k * kTile + j];
            acc = acc + t * t;
        }
    } else {
        for (int k = 0; k < d; ++k) {
            float t = av[k] - s_b[k * kTile + j];
            acc = acc + t * t;
        }
    }
    return acc;
}

constexpr int kMaxRegD = 8;   // feature dims held in registers per row

// ---------------------------------------------------------------------------
// eps_count / row_min: a warp per task (see the top of the file)
// ---------------------------------------------------------------------------

constexpr int kWarpsPerBlock = 4;
constexpr int kChunk = 512;        // candidate positions per staged mask chunk
constexpr int kCap = 128;          // compacted candidates per item
constexpr int kGroup = 64;         // rows per task, two a lane
constexpr int kStages = 4;         // mask chunks in flight per warp
constexpr int kNone = 0x7fffffff;
constexpr size_t kMaxSmem = 232448;   // dynamic shared memory of one block

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// Shared memory of one warp, in bytes: an mbarrier per stage; kStages mask
// chunks, each sized for the 16-byte-aligned span that holds its bytes;
// the item of compacted candidates (float4 {x, y, z, index} for d <= 3,
// else d coordinate planes and an index plane); the map from lane slots to
// the task's live rows; the warp's partial results of a split slot.
struct WarpSmem {
    int stage_off, stage_bytes, comp_off, comp_bytes, rmap_off, part_off, total;
};

__host__ __device__ constexpr WarpSmem warp_smem(int d) {
    WarpSmem w{};
    w.stage_off = round16(kStages * 8);
    w.stage_bytes = kChunk + 32;
    w.comp_off = w.stage_off + kStages * w.stage_bytes;
    w.comp_bytes = d <= 3 ? kCap * 16 : kCap * 4 * (d + 1);
    w.rmap_off = w.comp_off + w.comp_bytes;
    w.part_off = w.rmap_off + kGroup;
    w.total = w.part_off + 32 * 8;
    return w;
}

struct DistArgs {
    const float* a;
    const float* b;
    const uint8_t* valid_b;
    const uint8_t* valid_a;
    int* out_cnt;
    float* out_min;
    int* out_arg;
    int B, P, rows_total, C, d;
    long long b_stride, vb_stride;
    float eps2;
    int stop_at;
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
            t = av[k] - pl[k * kCap + j];
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
        t = __ldg(arow + k) - pl[k * kCap + j];
        acc = acc + t * t;
    }
    return acc;
}

// Scan compacted candidates [0, n) of one item: lane phase `phase` of
// `ph` takes j = phase, phase + ph, ... in ascending order, for its R
// rows.  Returns true when eps_count may stop the task (every live row
// has stop_at hits).  kMode: 0 packed, 1 planes with the rows in
// registers, 2 planes with the rows read from device memory.
template <bool kMin, int D, int R, int kMode, int kRegD>
__device__ __forceinline__ bool scan_item(const unsigned char* cb, int n, int phase,
                                          int ph, int span, int d, float eps2,
                                          int stop_at, float (&ax)[2][kRegD],
                                          const float* (&arow)[2], const bool (&live)[2],
                                          int (&cnt)[2], float (&best)[2],
                                          int (&arg)[2]) {
    const float4* cp = reinterpret_cast<const float4*>(cb);
    const float* pl = reinterpret_cast<const float*>(cb);
    const int* pidx = reinterpret_cast<const int*>(cb) + d * kCap;
    const int blk = (kMin || stop_at <= 0) ? n : 32;
    for (int jb = 0; jb < n; jb += blk) {
        const int je = min(n, jb + blk);
#pragma unroll 4
        for (int j = jb + phase; j < je; j += ph) {
            if (kMode == 0) {
                const float4 c = cp[j];
#pragma unroll
                for (int q = 0; q < R; ++q) {
                    const float d2 = dist_packed<D>(ax[q], c);
                    if (kMin) {
                        if (d2 < best[q]) {
                            best[q] = d2;
                            arg[q] = __float_as_int(c.w);
                        }
                    } else {
                        cnt[q] += d2 <= eps2 ? 1 : 0;
                    }
                }
            } else {
#pragma unroll
                for (int q = 0; q < R; ++q) {
                    const float d2 = kMode == 1 ? dist_planes<D>(ax[q], pl, j, d)
                                                : dist_wide(arow[q], pl, j, d);
                    if (kMin) {
                        if (d2 < best[q]) {
                            best[q] = d2;
                            arg[q] = pidx[j];
                        }
                    } else {
                        cnt[q] += d2 <= eps2 ? 1 : 0;
                    }
                }
            }
        }
        if (!kMin && stop_at > 0) {
            bool sat = true;
#pragma unroll
            for (int q = 0; q < R; ++q) {
                int tot = cnt[q];
                for (int o = span; o < 32; o <<= 1)
                    tot += __shfl_xor_sync(0xffffffffu, tot, o);
                sat = sat && (!live[q] || tot >= stop_at);
            }
            if (__all_sync(0xffffffffu, sat)) return true;
        }
    }
    return false;
}

template <bool kMin, int D, int kMode, int kRegD>
__device__ __forceinline__ bool scan_rows(bool two, const unsigned char* cb, int n,
                                          int phase, int ph, int span, int d, float eps2,
                                          int stop_at, float (&ax)[2][kRegD],
                                          const float* (&arow)[2], const bool (&live)[2],
                                          int (&cnt)[2], float (&best)[2], int (&arg)[2]) {
    if (two)
        return scan_item<kMin, D, 2, kMode>(cb, n, 0, 1, 32, d, eps2, stop_at, ax, arow,
                                            live, cnt, best, arg);
    return scan_item<kMin, D, 1, kMode>(cb, n, phase, ph, span, d, eps2, stop_at, ax, arow,
                                        live, cnt, best, arg);
}

// Blocks of the kernel at feature dim D that fit an SM's shared memory
// (D = 0: the generic kernel, sized at kMaxRegD), at most 6: the launch
// bound that lets ptxas use the registers that occupancy leaves.
constexpr int min_blocks(int D) {
    const int per_block = kWarpsPerBlock * warp_smem(D > 0 ? D : kMaxRegD).total;
    const int n = (int)(kMaxSmem / per_block);
    return n < 1 ? 1 : (n > 6 ? 6 : n);
}

// One warp, one task: a slot's rows (at most kGroup) against its
// candidates, or with splits > 1 (a slot of at most 32 rows, the block's
// splits warps on one slot) against the warp's share of the candidate
// chunks.
template <bool kMin, int D>
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

    // the task's live rows (bit i of lo / hi is row i / 32 + i), compacted
    // into lane slots: two a lane above 32 live rows, else rows x phases
    unsigned lo, hi;
    if (p.valid_a == nullptr) {
        lo = k.rows >= 32 ? 0xffffffffu : (1u << k.rows) - 1u;
        hi = k.rows >= 64 ? 0xffffffffu : k.rows > 32 ? (1u << (k.rows - 32)) - 1u : 0u;
    } else {
        const uint8_t* va = p.valid_a + k.row0;
        lo = __ballot_sync(0xffffffffu, lane < k.rows && va[lane] != 0);
        hi = __ballot_sync(0xffffffffu, lane + 32 < k.rows && va[lane + 32] != 0);
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
    float ax[2][kRegD];
    const float* arow[2];
    bool live[2];
    int rowq[2];                    // the lane's rows within the task
    int cnt[2];
    float best[2];
    int arg[2];
#pragma unroll
    for (int qq = 0; qq < 2; ++qq) {
        const int sl = slot0 + 32 * qq;
        live[qq] = sl < n_live;
        rowq[qq] = !live[qq] ? 0 : dense ? sl : rmap[sl];
        arow[qq] = p.a + (long long)(k.row0 + rowq[qq]) * d;
        cnt[qq] = 0;
        best[qq] = CUDART_INF_F;
        arg[qq] = kNone;
    }

    // step 2: each chunk's valid candidates, 32 positions a round, are
    // placed at their compacted positions in the item (ballot + popc) and
    // their coordinates gathered there by cp.async; step 3, when the next
    // round would take the item past kCap and at the end: the live rows scan
    // it, one broadcast shared load per candidate.  eps_count stops once
    // every live row has stop_at hits; the chunks already in flight are
    // still waited for.
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
            done = scan_rows<kMin, D, 0>(two, cb, n, phase, ph, span, d, p.eps2, p.stop_at,
                                         ax, arow, live, cnt, best, arg);
        else if (D > 0 || d <= kMaxRegD)
            done = scan_rows<kMin, D, 1>(two, cb, n, phase, ph, span, d, p.eps2, p.stop_at,
                                         ax, arow, live, cnt, best, arg);
        else
            done = scan_rows<kMin, D, 2>(two, cb, n, phase, ph, span, d, p.eps2, p.stop_at,
                                         ax, arow, live, cnt, best, arg);
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
                if (n + __popc(bits) > kCap) {
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
                        for (int kk = 0; kk < d; ++kk) cp_async4(pl + kk * kCap + pos, src + kk);
                        reinterpret_cast<int*>(pl)[d * kCap + pos] = j;
                    }
                }
                n += __popc(bits);
            }
        }
        __syncwarp();               // every lane has read the stage
        if (!stop && issued < nq) stage(issued++);
    }
    if (n > 0 && !stop) scan();

    // the phases merge (d2, index) lexicographically, so the lowest index
    // wins a tie; counts add
    int tot[2];
#pragma unroll
    for (int qq = 0; qq < 2; ++qq) {
        tot[qq] = cnt[qq];
        if (!two && qq == 1) break;
        for (int o = span; o < 32; o <<= 1) {
            if (kMin) {
                const float ob = __shfl_xor_sync(0xffffffffu, best[qq], o);
                const int oa = __shfl_xor_sync(0xffffffffu, arg[qq], o);
                if (ob < best[qq] || (ob == best[qq] && oa < arg[qq])) {
                    best[qq] = ob;
                    arg[qq] = oa;
                }
            } else {
                tot[qq] += __shfl_xor_sync(0xffffffffu, tot[qq], o);
            }
        }
    }
    if (splits == 1) {
        if (k.rows > 0) {
#pragma unroll
            for (int qq = 0; qq < 2; ++qq) {
                if (phase != 0 || !live[qq]) continue;
                const int row = k.row0 + rowq[qq];
                if (kMin) {
                    p.out_min[row] = best[qq];
                    // no valid candidate (or only infinitely far ones)
                    p.out_arg[row] = best[qq] == CUDART_INF_F ? -1 : arg[qq];
                } else {
                    p.out_cnt[row] = tot[qq];
                }
            }
            if (!kMin) {            // rows that valid_a masks: count 0
                if (lane < k.rows && !(lo >> lane & 1u)) p.out_cnt[k.row0 + lane] = 0;
                if (lane + 32 < k.rows && !(hi >> lane & 1u))
                    p.out_cnt[k.row0 + lane + 32] = 0;
            }
        }
        return;
    }
    // a split slot (at most 32 rows, one a lane slot): each warp leaves its
    // partial result per row in its shared memory, and after the block's
    // one barrier warp 0 merges them in split order
    float* pb = reinterpret_cast<float*>(wsm + ws.part_off);
    int* pa = reinterpret_cast<int*>(pb + 32);
    pb[lane] = kMin ? CUDART_INF_F : __int_as_float(0);
    pa[lane] = kNone;
    __syncwarp();
    if (phase == 0 && live[0]) {
        pb[rowq[0]] = kMin ? best[0] : __int_as_float(tot[0]);
        pa[rowq[0]] = arg[0];
    }
    __syncthreads();
    if (warp == 0 && lane < k.rows) {
        float m = CUDART_INF_F;
        int am = kNone, c = 0;
        for (int w = 0; w < splits; ++w) {
            const float* ob = reinterpret_cast<const float*>(smem + (size_t)w * ws.total +
                                                             ws.part_off);
            const float b = ob[lane];
            const int a = reinterpret_cast<const int*>(ob + 32)[lane];
            if (kMin) {
                if (b < m || (b == m && a < am)) {
                    m = b;
                    am = a;
                }
            } else {
                c += __float_as_int(b);
            }
        }
        const int row = k.row0 + lane;
        if (kMin) {
            p.out_min[row] = m;
            p.out_arg[row] = m == CUDART_INF_F ? -1 : am;
        } else {
            p.out_cnt[row] = c;
        }
    }
}

// Lets `kernel` take `bytes` of dynamic shared memory (a call only above
// the default 48 KB, so the usual launch costs no attribute call).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
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
template <bool kMin, int D>
cudaError_t launch_dist(const DistArgs& p, cudaStream_t stream) {
    auto kernel = dist_kernel<kMin, D>;
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

template <bool kMin>
cudaError_t dispatch_dist(const DistArgs& p, cudaStream_t s) {
    switch (p.d) {
        case 1: return launch_dist<kMin, 1>(p, s);
        case 2: return launch_dist<kMin, 2>(p, s);
        case 3: return launch_dist<kMin, 3>(p, s);
        case 4: return launch_dist<kMin, 4>(p, s);
        case 5: return launch_dist<kMin, 5>(p, s);
        default: return launch_dist<kMin, 0>(p, s);
    }
}

// Two-threshold counts: hits at d2 <= lo2 and at d2 <= hi2 from one sweep.
// stop_row (optional, [B, P] int32) is a per-row bar on the lo count: the
// slot stops before its next tile once every row has lo >= its bar, which
// keeps the contract "a row whose lo count is below its bar has scanned
// every valid candidate" (checked before the first tile too, as the
// reference's tiled loop does).
template <int D>
__global__ void __launch_bounds__(kThreads)
eps_count_band_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      const uint8_t* __restrict__ valid_b,
                      const int* __restrict__ stop_row,
                      int* __restrict__ out_lo, int* __restrict__ out_hi,
                      int P, int C, int d, float lo2, float hi2) {
    extern __shared__ unsigned char smem[];
    float* s_b = reinterpret_cast<float*>(smem);                     // [d][kTile]
    int* s_lo = reinterpret_cast<int*>(s_b + (size_t)d * kTile);     // [P]
    int* s_hi = s_lo + P;                                            // [P]
    int* s_red = s_hi + P;                                           // [kWarps]
    uint8_t* s_v = reinterpret_cast<uint8_t*>(s_red + kWarps);       // [kTile]

    const int g = blockIdx.x;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const float* ag = a + (size_t)g * P * d;
    const float* bg = b + (size_t)g * C * d;
    const uint8_t* vbg = valid_b + (size_t)g * C;
    const int* stop = stop_row ? stop_row + (size_t)g * P : nullptr;

    for (int p = threadIdx.x; p < P; p += kThreads) {
        s_lo[p] = 0;
        s_hi[p] = 0;
    }
    __syncthreads();
    const int n_last = last_valid(vbg, C, s_red);

    for (int t0 = 0; t0 < n_last; t0 += kTile) {
        if (stop) {
            int saturated = 1;
            for (int p = threadIdx.x; p < P; p += kThreads)
                if (s_lo[p] < stop[p]) saturated = 0;
            if (__syncthreads_and(saturated)) break;
        }
        const int tn = min(kTile, n_last - t0);
        stage_tile(bg, vbg, t0, tn, d, s_b, s_v);
        __syncthreads();
        for (int p = warp; p < P; p += kWarps) {
            float av[kMaxRegD];
            const float* arow = ag + (size_t)p * d;
            if (D > 0) {
#pragma unroll
                for (int k = 0; k < D; ++k) av[k] = arow[k];
            }
            int lo = 0, hi = 0;
            for (int j = lane; j < tn; j += 32) {
                float d2 = (D > 0) ? sq_dist<D>(av, s_b, j, d)
                                   : sq_dist<0>(arow, s_b, j, d);
                if (s_v[j]) {
                    lo += (d2 <= lo2) ? 1 : 0;
                    hi += (d2 <= hi2) ? 1 : 0;
                }
            }
            for (int o = 16; o > 0; o >>= 1) {
                lo += __shfl_xor_sync(0xffffffffu, lo, o);
                hi += __shfl_xor_sync(0xffffffffu, hi, o);
            }
            if (lane == 0) {                  // row p belongs to this warp alone
                s_lo[p] += lo;
                s_hi[p] += hi;
            }
        }
        __syncthreads();                      // tile consumed, counts visible
    }
    int* olo = out_lo + (size_t)g * P;
    int* ohi = out_hi + (size_t)g * P;
    for (int p = threadIdx.x; p < P; p += kThreads) {
        olo[p] = s_lo[p];
        ohi[p] = s_hi[p];
    }
}

// (min, first index, runner-up) of the row's multiset of distances.
struct Min2 {
    float best, second;
    int arg;
};

// Merge two partial triples: (min, index) lexicographically, and the
// runner-up is the smaller of both runners-up and the larger of both mins.
__device__ __forceinline__ Min2 merge_min2(Min2 x, Min2 y) {
    Min2 r;
    const bool take_y = y.best < x.best || (y.best == x.best && y.arg < x.arg);
    r.best = take_y ? y.best : x.best;
    r.arg = take_y ? y.arg : x.arg;
    r.second = fminf(fminf(x.second, y.second), fmaxf(x.best, y.best));
    return r;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
row_min2_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const uint8_t* __restrict__ valid_b,
                float* __restrict__ out_min, float* __restrict__ out_min2,
                int* __restrict__ out_arg, int P, int C, int d) {
    extern __shared__ unsigned char smem[];
    float* s_b = reinterpret_cast<float*>(smem);                     // [d][kTile]
    float* s_min = s_b + (size_t)d * kTile;                          // [P]
    float* s_min2 = s_min + P;                                       // [P]
    int* s_arg = reinterpret_cast<int*>(s_min2 + P);                 // [P]
    int* s_red = s_arg + P;                                          // [kWarps]
    uint8_t* s_v = reinterpret_cast<uint8_t*>(s_red + kWarps);       // [kTile]

    const int g = blockIdx.x;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const float* ag = a + (size_t)g * P * d;
    const float* bg = b + (size_t)g * C * d;
    const uint8_t* vbg = valid_b + (size_t)g * C;
    const int kNone = 0x7fffffff;

    for (int p = threadIdx.x; p < P; p += kThreads) {
        s_min[p] = CUDART_INF_F;
        s_min2[p] = CUDART_INF_F;
        s_arg[p] = kNone;
    }
    __syncthreads();
    const int n_last = last_valid(vbg, C, s_red);

    for (int t0 = 0; t0 < n_last; t0 += kTile) {
        const int tn = min(kTile, n_last - t0);
        stage_tile(bg, vbg, t0, tn, d, s_b, s_v);
        __syncthreads();
        for (int p = warp; p < P; p += kWarps) {
            float av[kMaxRegD];
            const float* arow = ag + (size_t)p * d;
            if (D > 0) {
#pragma unroll
                for (int k = 0; k < D; ++k) av[k] = arow[k];
            }
            Min2 m = {CUDART_INF_F, CUDART_INF_F, kNone};
            for (int j = lane; j < tn; j += 32) {
                float d2 = (D > 0) ? sq_dist<D>(av, s_b, j, d)
                                   : sq_dist<0>(arow, s_b, j, d);
                if (!s_v[j]) continue;
                // ascending j within a lane: strict < keeps the first minimum;
                // a tie with the minimum becomes the runner-up
                if (d2 < m.best) {
                    m.second = m.best;
                    m.best = d2;
                    m.arg = t0 + j;
                } else if (d2 < m.second) {
                    m.second = d2;
                }
            }
            for (int o = 16; o > 0; o >>= 1) {
                Min2 other;
                other.best = __shfl_xor_sync(0xffffffffu, m.best, o);
                other.second = __shfl_xor_sync(0xffffffffu, m.second, o);
                other.arg = __shfl_xor_sync(0xffffffffu, m.arg, o);
                m = merge_min2(m, other);
            }
            if (lane == 0) {
                Min2 cur = {s_min[p], s_min2[p], s_arg[p]};
                cur = merge_min2(cur, m);
                s_min[p] = cur.best;
                s_min2[p] = cur.second;
                s_arg[p] = cur.arg;
            }
        }
        __syncthreads();
    }
    float* omin = out_min + (size_t)g * P;
    float* omin2 = out_min2 + (size_t)g * P;
    int* oarg = out_arg + (size_t)g * P;
    for (int p = threadIdx.x; p < P; p += kThreads) {
        float m = s_min[p];
        omin[p] = m;
        omin2[p] = s_min2[p];
        oarg[p] = (m == CUDART_INF_F) ? -1 : s_arg[p];
    }
}

size_t band_smem(int P, int d) {
    return (size_t)d * kTile * 4 + (size_t)P * 8 + kWarps * 4 + kTile;
}

size_t min2_smem(int P, int d) {
    return (size_t)d * kTile * 4 + (size_t)P * 12 + kWarps * 4 + kTile;
}

}  // namespace

#define DISPATCH_D(d, CALL)                  \
    switch (d) {                             \
        case 1: CALL(1); break;              \
        case 2: CALL(2); break;              \
        case 3: CALL(3); break;              \
        case 4: CALL(4); break;              \
        case 5: CALL(5); break;              \
        default: CALL(0); break;             \
    }

// Both entry points enqueue one launch on `stream` and return
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
    const DistArgs p{(const float*)a, (const float*)b, (const uint8_t*)valid_b,
                     (const uint8_t*)valid_a, (int*)out, nullptr, nullptr,
                     B, P, rows_total, C, d, b_stride, vb_stride, eps2, stop_at};
    return (int)dispatch_dist<false>(p, (cudaStream_t)stream);
}

// The guard-band twins take dense batches: slot g reads its P rows at
// a + g*P*d, its candidates at b + g*C*d and its mask at valid_b + g*C.
// stop_row may be null (no early exit).
extern "C" int grit_eps_count_band_batch(const void* a, const void* b,
                                         const void* valid_b, const void* stop_row,
                                         void* out_lo, void* out_hi, int B, int P,
                                         int C, int d, float lo2, float hi2,
                                         void* stream) {
    if (B <= 0 || P <= 0) return (int)cudaSuccess;
    size_t smem = band_smem(P, d);
    cudaError_t err = cudaSuccess;
#define CALL(DD)                                                                         \
    err = allow_smem(eps_count_band_kernel<DD>, smem);                                   \
    if (err == cudaSuccess)                                                              \
        eps_count_band_kernel<DD><<<B, kThreads, smem, (cudaStream_t)stream>>>(          \
            (const float*)a, (const float*)b, (const uint8_t*)valid_b,                   \
            (const int*)stop_row, (int*)out_lo, (int*)out_hi, P, C, d, lo2, hi2)
    DISPATCH_D(d, CALL)
#undef CALL
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

extern "C" int grit_row_min2_batch(const void* a, const void* b, const void* valid_b,
                                   void* out_min, void* out_min2, void* out_arg,
                                   int B, int P, int C, int d, void* stream) {
    if (B <= 0 || P <= 0) return (int)cudaSuccess;
    size_t smem = min2_smem(P, d);
    cudaError_t err = cudaSuccess;
#define CALL(DD)                                                                         \
    err = allow_smem(row_min2_kernel<DD>, smem);                                         \
    if (err == cudaSuccess)                                                              \
        row_min2_kernel<DD><<<B, kThreads, smem, (cudaStream_t)stream>>>(                \
            (const float*)a, (const float*)b, (const uint8_t*)valid_b,                   \
            (float*)out_min, (float*)out_min2, (int*)out_arg, P, C, d)
    DISPATCH_D(d, CALL)
#undef CALL
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

extern "C" int grit_row_min_batch(const void* a, const void* b, const void* valid_b,
                                  void* out_min, void* out_arg, int B, int P,
                                  int rows_total, int C, int d, long long b_stride,
                                  long long vb_stride, void* stream) {
    if (B <= 0 || P <= 0) return (int)cudaSuccess;
    const DistArgs p{(const float*)a, (const float*)b, (const uint8_t*)valid_b, nullptr,
                     nullptr, (float*)out_min, (int*)out_arg,
                     B, P, rows_total, C, d, b_stride, vb_stride, 0.0f, 0};
    return (int)dispatch_dist<true>(p, (cudaStream_t)stream);
}

// The staging route of eps_count_batch / row_min_batch at feature dim d:
// 0 packed float4 candidates (d <= 3), 1 coordinate planes with the rows
// in registers (d <= 8), 2 planes with the rows read from device memory.
extern "C" int grit_pairwise_route(int d) {
    return d <= 3 ? 0 : (d <= kMaxRegD ? 1 : 2);
}
