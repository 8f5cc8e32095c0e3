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
// mask read by the kernel, not FAR-folded coordinates.
//
// What bounds it: the function must move 4*B*(P+C)*d + B*C + 4*B*P bytes
// and does 3*d*B*P*C f32 operations, i.e. about 3*P/4 operations per byte
// for C >> P.  At the main path's P = MinPts-1 = 63 that is ~47 op/byte
// against the card's 67 TFLOP/s / 3.35 TB/s = 20 op/byte: operation bound
// on the full padded shape.  The design therefore cuts operations rather
// than bytes: one block per slot, the slot's candidates staged tile by
// tile through shared memory (read from device memory once, reused by
// all P rows), rows dealt round-robin to the block's warps, lanes strided
// over the tile's candidates.  Work that the data makes unnecessary is
// skipped per slot: the padding tail past the last valid candidate,
// rows masked by valid_a, whole slots without a live row, and (eps
// count) the remaining tiles once every live row has reached stop_at.
//
// The two guard-band twins are the same device code with more state per
// row: eps_count_band_batch keeps two counters (hits at lo2 and at hi2)
// and stops a slot once every row's lo count has reached its own
// stop_row bar (bar 0 exempts a row); row_min2_batch keeps a
// (min, first index, runner-up) triple per lane and merges triples
// lexicographically on (min, index) with
// min2 = min(min2_a, min2_b, max(min_a, min_b)), so the runner-up is the
// second order statistic of the row's distance multiset (a duplicate of
// the minimum counts) whatever the lane layout.  Same bounds as above:
// two comparisons or one more min per distance cost no extra bytes.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

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

template <int D>
__global__ void __launch_bounds__(kThreads)
eps_count_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const uint8_t* __restrict__ valid_b, const uint8_t* __restrict__ valid_a,
                 int* __restrict__ out, int P, int rows_total, int C, int d,
                 long long b_stride, long long vb_stride, float eps2, int stop_at) {
    extern __shared__ unsigned char smem[];
    float* s_b = reinterpret_cast<float*>(smem);                     // [d][kTile]
    int* s_cnt = reinterpret_cast<int*>(s_b + (size_t)d * kTile);    // [P]
    int* s_red = s_cnt + P;                                          // [kWarps]
    uint8_t* s_v = reinterpret_cast<uint8_t*>(s_red + kWarps);       // [kTile]

    const int g = blockIdx.x;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const float* ag = a + (size_t)g * P * d;
    const float* bg = b + (size_t)g * b_stride;
    const uint8_t* vbg = valid_b + (size_t)g * vb_stride;
    const uint8_t* vag = valid_a ? valid_a + (size_t)g * P : nullptr;
    int* og = out + (size_t)g * P;
    const int pn = min(P, rows_total - g * P);       // ragged last slot

    for (int p = threadIdx.x; p < pn; p += kThreads) s_cnt[p] = 0;
    int any_row = 0;
    for (int p = threadIdx.x; p < pn; p += kThreads)
        any_row |= vag ? (int)vag[p] : 1;
    // also orders the s_cnt zeroing before the first accumulation
    any_row = __syncthreads_or(any_row);
    const int n_last = any_row ? last_valid(vbg, C, s_red) : 0;

    for (int t0 = 0; t0 < n_last; t0 += kTile) {
        const int tn = min(kTile, n_last - t0);
        stage_tile(bg, vbg, t0, tn, d, s_b, s_v);
        __syncthreads();
        int saturated = 1;
        for (int p = warp; p < pn; p += kWarps) {
            if (vag && !vag[p]) continue;
            float av[kMaxRegD];
            const float* arow = ag + (size_t)p * d;
            if (D > 0) {
#pragma unroll
                for (int k = 0; k < D; ++k) av[k] = arow[k];
            }
            int cnt = 0;
            for (int j = lane; j < tn; j += 32) {
                float d2 = (D > 0) ? sq_dist<D>(av, s_b, j, d)
                                   : sq_dist<0>(arow, s_b, j, d);
                cnt += (s_v[j] && d2 <= eps2) ? 1 : 0;
            }
            for (int o = 16; o > 0; o >>= 1)
                cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
            int total = s_cnt[p] + cnt;       // row p belongs to this warp alone
            __syncwarp();                     // every lane has read before lane 0 writes
            if (lane == 0) s_cnt[p] = total;
            if (total < stop_at) saturated = 0;
        }
        // every live row has stop_at hits: min(count, k) == min(exact, k)
        // holds from here on, the remaining tiles cannot change a decision
        if (__syncthreads_and(saturated) && stop_at > 0) break;
    }
    __syncthreads();
    for (int p = threadIdx.x; p < pn; p += kThreads) og[p] = s_cnt[p];
}

template <int D>
__global__ void __launch_bounds__(kThreads)
row_min_kernel(const float* __restrict__ a, const float* __restrict__ b,
               const uint8_t* __restrict__ valid_b,
               float* __restrict__ out_min, int* __restrict__ out_arg,
               int P, int rows_total, int C, int d,
               long long b_stride, long long vb_stride) {
    extern __shared__ unsigned char smem[];
    float* s_b = reinterpret_cast<float*>(smem);                     // [d][kTile]
    float* s_min = s_b + (size_t)d * kTile;                          // [P]
    int* s_arg = reinterpret_cast<int*>(s_min + P);                  // [P]
    int* s_red = s_arg + P;                                          // [kWarps]
    uint8_t* s_v = reinterpret_cast<uint8_t*>(s_red + kWarps);       // [kTile]

    const int g = blockIdx.x;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const float* ag = a + (size_t)g * P * d;
    const float* bg = b + (size_t)g * b_stride;
    const uint8_t* vbg = valid_b + (size_t)g * vb_stride;
    const int kNone = 0x7fffffff;
    const int pn = min(P, rows_total - g * P);       // ragged last slot

    for (int p = threadIdx.x; p < pn; p += kThreads) {
        s_min[p] = CUDART_INF_F;
        s_arg[p] = kNone;
    }
    __syncthreads();
    const int n_last = last_valid(vbg, C, s_red);

    for (int t0 = 0; t0 < n_last; t0 += kTile) {
        const int tn = min(kTile, n_last - t0);
        stage_tile(bg, vbg, t0, tn, d, s_b, s_v);
        __syncthreads();
        for (int p = warp; p < pn; p += kWarps) {
            float av[kMaxRegD];
            const float* arow = ag + (size_t)p * d;
            if (D > 0) {
#pragma unroll
                for (int k = 0; k < D; ++k) av[k] = arow[k];
            }
            float best = CUDART_INF_F;
            int arg = kNone;
            for (int j = lane; j < tn; j += 32) {
                float d2 = (D > 0) ? sq_dist<D>(av, s_b, j, d)
                                   : sq_dist<0>(arow, s_b, j, d);
                // ascending j within a lane: strict < keeps the first minimum
                if (s_v[j] && d2 < best) { best = d2; arg = t0 + j; }
            }
            // lexicographic (d2, index) reduction: the lowest index wins a tie
            // whatever the lane layout
            for (int o = 16; o > 0; o >>= 1) {
                float ob = __shfl_xor_sync(0xffffffffu, best, o);
                int oa = __shfl_xor_sync(0xffffffffu, arg, o);
                if (ob < best || (ob == best && oa < arg)) { best = ob; arg = oa; }
            }
            if (lane == 0) {
                float cur = s_min[p];
                if (best < cur || (best == cur && arg < s_arg[p])) {
                    s_min[p] = best;
                    s_arg[p] = arg;
                }
            }
        }
        __syncthreads();
    }
    float* omin = out_min + (size_t)g * P;
    int* oarg = out_arg + (size_t)g * P;
    for (int p = threadIdx.x; p < pn; p += kThreads) {
        float m = s_min[p];
        omin[p] = m;
        // no valid candidate (or only infinitely far ones): (inf, -1)
        oarg[p] = (m == CUDART_INF_F) ? -1 : s_arg[p];
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

size_t count_smem(int P, int d) {
    return (size_t)d * kTile * 4 + (size_t)P * 4 + kWarps * 4 + kTile;
}

size_t min_smem(int P, int d) {
    return (size_t)d * kTile * 4 + (size_t)P * 8 + kWarps * 4 + kTile;
}

size_t band_smem(int P, int d) {
    return (size_t)d * kTile * 4 + (size_t)P * 8 + kWarps * 4 + kTile;
}

size_t min2_smem(int P, int d) {
    return (size_t)d * kTile * 4 + (size_t)P * 12 + kWarps * 4 + kTile;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
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
    size_t smem = count_smem(P, d);
    cudaError_t err = cudaSuccess;
#define CALL(DD)                                                                         \
    err = allow_smem(eps_count_kernel<DD>, smem);                                        \
    if (err == cudaSuccess)                                                              \
        eps_count_kernel<DD><<<B, kThreads, smem, (cudaStream_t)stream>>>(               \
            (const float*)a, (const float*)b, (const uint8_t*)valid_b,                   \
            (const uint8_t*)valid_a, (int*)out, P, rows_total, C, d, b_stride,           \
            vb_stride, eps2, stop_at)
    DISPATCH_D(d, CALL)
#undef CALL
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
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
    size_t smem = min_smem(P, d);
    cudaError_t err = cudaSuccess;
#define CALL(DD)                                                                         \
    err = allow_smem(row_min_kernel<DD>, smem);                                          \
    if (err == cudaSuccess)                                                              \
        row_min_kernel<DD><<<B, kThreads, smem, (cudaStream_t)stream>>>(                 \
            (const float*)a, (const float*)b, (const uint8_t*)valid_b,                   \
            (float*)out_min, (int*)out_arg, P, rows_total, C, d, b_stride, vb_stride)
    DISPATCH_D(d, CALL)
#undef CALL
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
