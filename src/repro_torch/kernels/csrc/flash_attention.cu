// Blocked online-softmax attention, forward only (sm_90a).
//
//   flash_attention  replaces  repro/kernels/flash_attention.py::flash_attention_pallas
//                              (body _flash_kernel)
//
// Operands: q [B, H, Sq, D], k / v [B, Hkv, Sk, D] with H % Hkv == 0 (query
// head h reads KV head h / (H / Hkv) in place: no broadcast copy), f32 or
// bf16, contiguous; out [B, H, Sq, D] in the input type.  Query row i sits
// at key position i + q_offset; key j is live when j < sk_actual,
// j <= i + q_offset (causal) and (i + q_offset) - j < window (window > 0).
// Per (row, key): logit = (q . k) * scale, then tanh(logit / softcap) *
// softcap (softcap > 0), then the mask.  Running max, denominator, p and
// the accumulator are f32; the row is finalised as acc / max(l, 1e-30).  A
// row that sees no live key at all (only possible when Sq > Sk under the
// causal mask) is written as 0; the reference's value there depends on its
// tiling.  The reference masks with a finite NEG_INF = -1e30, so a key tile
// fully masked for a row that has no live key yet gives p = exp(0) there,
// cancelled later by alpha = exp(-1e30 - m) = 0; the scalar kernel does
// exactly that, the tensor-core kernel masks with -inf and gives such keys
// p = 0 (and alpha = 0), which leaves every output the same.
//
// What bounds it.  The function reads q, k, v once and writes out once and
// does 4*D operations per live (row, key) pair.  At the prefill shapes
// (Sq = Sk >= 2048, D = 128) that is several hundred operations per byte:
// operation bound, at the bf16 tensor-core rate for bf16 inputs.
//
// bf16: the tensor-core route (flash_wgmma_kernel).  One block of two
// warpgroups per (bh, 128-row query tile), 64 query rows each.  Thread 0
// loads the block's Q tile once by TMA, and each 128-key K and V tile of the
// causal / window band by TMA (128-byte swizzle, zero fill past Sq / Sk and
// past D) into a ring of two stages guarded by full / empty mbarriers: at
// the top of tile t it issues tile t+1, so the load overlaps tile t's math.
// Per tile and warpgroup:
//   S = Q K^T   wgmma m64n128k16, both operands from shared memory, f32
//               accumulator (bf16 x bf16 products are exact in f32);
//   softmax     soft-cap, mask, running max, alpha rescale (skipped when no
//               row of the warp found a new maximum) and row sums on the
//               accumulator fragment in f32, row reductions by shuffles in
//               each 4-lane quad; p = 2^(s*c - max*c), one FFMA and one
//               ex2 (c = scale * log2 e); the soft-cap as cap - 2 cap /
//               (2^(s * 2 log2e * scale / cap) + 1) on the special-function
//               unit (absolute error about 1e-7 of cap);
//   O += P V    wgmma m64nDk16 with P from registers and V MN-major from
//               shared memory (transpose bit; D = 128 as one instruction
//               over two 64-column blocks).  P is kept to f32 precision as
//               two bf16 terms, P_hi = bf16(P) and P_lo = bf16(P - P_hi),
//               both multiplied into the one f32 accumulator: a single
//               bf16 rounding of P moves ~40 % of the bf16 outputs by an
//               ulp and fails the plain version's tolerance; the split
//               costs 6*D tensor operations per pair instead of 4*D.
// Head dims 16 and 32 run as 64, and 80 as 128: TMA fills the extra Q / K /
// V columns with zeros (exact zeros in Q K^T) and the extra output columns
// are not stored.  A warpgroup skips the products of a tile that its causal
// / window mask hides completely (same result: such a tile adds nothing).
// Query tiles are scheduled longest band first.  No warp is set aside as a
// producer: with a ninth warp one SM sub-partition holds three warps, which
// caps a thread at 168 registers, and the accumulators (64 f32 of O, 64 of
// S, 64 of P_hi / P_lo) then spill; two warpgroups alone get up to 255.
//
// f32: the scalar route (flash_fwd_kernel).  TF32 tensor cores would miss
// the reference's 2e-4 tolerance, so f32 stays on the CUDA cores: one block
// of 256 threads per (bh, 64-row query tile), 64-key tiles staged in shared
// memory (Q and K transposed, V row-major, P as a [64][68] tile), thread
// (tr, tc) owning the scores of rows 4tr..4tr+3 x keys 4tc..4tc+3 and the
// outputs of rows 4tr..4tr+3 x columns tc + 16j, the same band skip.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// f32: scalar CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 64;                 // keys per staged tile
constexpr int kThreads = 256;
constexpr int kPS = kBK + 4;            // row stride of the P tile (16-byte aligned)

// Columns 4c..4c+3 of row r of a [rows, D] slab, zeros past `rows`.
template <int D>
__device__ __forceinline__ float4 row_chunk(const float* __restrict__ base, int r, int rows, int c) {
    if (r >= rows) return make_float4(0.f, 0.f, 0.f, 0.f);
    return *reinterpret_cast<const float4*>(base + (size_t)r * D + 4 * c);
}

// Stage 64 rows of a [rows, D] slab transposed into dst[D][64].
template <int D>
__device__ __forceinline__ void stage_transposed(const float* __restrict__ src, int rows, float* dst) {
    constexpr int C4 = D / 4;
    for (int i = threadIdx.x; i < 64 * C4; i += kThreads) {
        int r = i % 64, c = i / 64;         // neighbouring lanes: neighbouring rows
        float4 x = row_chunk<D>(src, r, rows, c);
        dst[(4 * c + 0) * 64 + r] = x.x;
        dst[(4 * c + 1) * 64 + r] = x.y;
        dst[(4 * c + 2) * 64 + r] = x.z;
        dst[(4 * c + 3) * 64 + r] = x.w;
    }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int H, int Hkv,
                 int Sq, int Sk, int sk_actual, int q_offset, float scale, int causal,
                 int window, float softcap) {
    constexpr int C4 = D / 4;
    constexpr int NJ = D / 16;              // output columns per thread
    extern __shared__ float4 smem4[];
    float* Qt = reinterpret_cast<float*>(smem4);    // [D][kBQ]
    float* Kt = Qt + D * kBQ;                       // [D][kBK]
    float* Vs = Kt + D * kBK;                       // [kBK][D]
    float* Ps = Vs + kBK * D;                       // [kBQ][kPS]

    const int bh = blockIdx.y;
    const int kvh = (bh / H) * Hkv + (bh % H) / (H / Hkv);
    const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
    const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
    const float* kg = k + (size_t)kvh * Sk * D;
    const float* vg = v + (size_t)kvh * Sk * D;

    stage_transposed<D>(q + ((size_t)bh * Sq + q0) * D, min(kBQ, Sq - q0), Qt);

    // the key tiles inside the causal / window band of this query tile
    const int q_lo = q0 + q_offset, q_hi = q_lo + kBQ - 1;
    int k_end = min(Sk, sk_actual);
    if (causal) k_end = min(k_end, q_hi + 1);
    int k_begin = 0;
    if (window > 0) k_begin = max(0, q_lo - window + 1) / kBK * kBK;

    float m_i[4], l_i[4], acc[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m_i[i] = kNegInf;
        l_i[i] = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
    }

    for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
        const int krows = min(kBK, Sk - k0);
        stage_transposed<D>(kg + (size_t)k0 * D, krows, Kt);
        for (int i = tid; i < kBK * C4; i += kThreads) {
            int r = i / C4, c = i % C4;
            *reinterpret_cast<float4*>(Vs + r * D + 4 * c) =
                row_chunk<D>(vg + (size_t)k0 * D, r, krows, c);
        }
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
            float4 qa = *reinterpret_cast<const float4*>(Qt + d * kBQ + 4 * tr);
            float4 kb = *reinterpret_cast<const float4*>(Kt + d * kBK + 4 * tc);
            const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
            const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int qpos = q_lo + 4 * tr + i;
            float rmax = kNegInf;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int kpos = k0 + 4 * tc + j;
                float x = s[i][j] * scale;
                if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
                bool live = kpos < sk_actual;
                if (causal) live = live && kpos <= qpos;
                if (window > 0) live = live && (qpos - kpos) < window;
                x = live ? x : kNegInf;
                s[i][j] = x;
                rmax = fmaxf(rmax, x);
            }
            // the 16 threads of one row are the lanes of one half-warp
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
            const float m_new = fmaxf(m_i[i], rmax);
            float rsum = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                s[i][j] = expf(s[i][j] - m_new);
                rsum += s[i][j];
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
            const float alpha = expf(m_i[i] - m_new);
            l_i[i] = l_i[i] * alpha + rsum;
            m_i[i] = m_new;
#pragma unroll
            for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
            *reinterpret_cast<float4*>(Ps + (4 * tr + i) * kPS + 4 * tc) =
                make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
        }
        __syncthreads();

#pragma unroll 2
        for (int kk = 0; kk < kBK; kk += 4) {
            float p[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                float4 p4 = *reinterpret_cast<const float4*>(Ps + (4 * tr + i) * kPS + kk);
                p[i][0] = p4.x; p[i][1] = p4.y; p[i][2] = p4.z; p[i][3] = p4.w;
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
#pragma unroll
                for (int j = 0; j < NJ; ++j) {
                    const float vv = Vs[(kk + e) * D + tc + 16 * j];
#pragma unroll
                    for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i][e], vv, acc[i][j]);
                }
            }
        }
        __syncthreads();        // the next tile overwrites Kt, Vs and Ps
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = q0 + 4 * tr + i;
        if (row >= Sq) continue;
        const bool none = m_i[i] == kNegInf;
        const float l = fmaxf(l_i[i], 1e-30f);
        float* dst = o + ((size_t)bh * Sq + row) * D;
#pragma unroll
        for (int j = 0; j < NJ; ++j) dst[tc + 16 * j] = none ? 0.f : acc[i][j] / l;
    }
}

template <int D>
cudaError_t launch_scalar(const void* q, const void* k, const void* v, void* o, int B,
                          int H, int Hkv, int Sq, int Sk, int sk_actual, int q_offset,
                          float scale, int causal, int window, float softcap,
                          cudaStream_t stream) {
    auto kern = flash_fwd_kernel<D>;
    const int smem = (int)(sizeof(float) * (2 * D * 64 + 64 * D + kBQ * kPS));
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
    kern<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), H, Hkv, Sq, Sk, sk_actual,
        q_offset, scale, causal, window, softcap);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel (wgmma, TMA)
// ---------------------------------------------------------------------------

constexpr int kWQ = 64;                 // query rows per warpgroup
constexpr int kWBQ = 2 * kWQ;           // query rows per block
constexpr int kWBK = 128;               // keys per staged tile
constexpr int kStages = 2;              // K / V ring depth
constexpr int kWThreads = 256;          // two warpgroups of 64 query rows
constexpr int kRowBytes = 128;          // one swizzled row: 64 bf16
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of the DP-wide instantiation (DP = padded head dim, 64 or
// 128), in 1024-byte aligned tiles of 64-column blocks:
//   Q   [2 warpgroups][DP / 64][64 rows][128 B]
//   K   [kStages][DP / 64][kWBK rows][128 B], V the same
// then the mbarriers: full[kStages], empty[kStages], q.
template <int DP>
struct WSmem {
    static constexpr int kBlocks = DP / 64;
    static constexpr int kQ = kWBQ * DP * 2;
    static constexpr int kTile = kWBK * DP * 2;
    static constexpr int kBars = 2 * kStages + 1;
    static constexpr int kBytes = 1024 + kQ + 2 * kStages * kTile + 8 * kBars;
};

template <int DP>
__global__ void __launch_bounds__(kWThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                   int H, int Hkv, int Sq, int Sk, int D, int sk_actual, int q_offset,
                   float scale, int causal, int window, float softcap) {
    using L = WSmem<DP>;
    constexpr int NB = L::kBlocks;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* base = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    uint8_t* sQ = base;
    uint8_t* sK = sQ + L::kQ;
    uint8_t* sV = sK + kStages * L::kTile;
    uint64_t* full = reinterpret_cast<uint64_t*>(sV + kStages * L::kTile);
    uint64_t* empty = full + kStages;
    uint64_t* qbar = empty + kStages;

    const int bh = blockIdx.y;
    const int kvh = (bh / H) * Hkv + (bh % H) / (H / Hkv);
    const int q0 = (gridDim.x - 1 - blockIdx.x) * kWBQ;     // longest band first
    const int q_lo = q0 + q_offset, q_hi = q_lo + kWBQ - 1;
    int k_end = min(Sk, sk_actual);
    if (causal) k_end = min(k_end, q_hi + 1);
    int k_begin = 0;
    if (window > 0) k_begin = max(0, q_lo - window + 1) / kWBK * kWBK;
    const int n_tiles = k_end > k_begin ? (k_end - k_begin + kWBK - 1) / kWBK : 0;

    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s) {
            sm90::mbar_init(&full[s], 1);
            sm90::mbar_init(&empty[s], 8);          // one arrival per warp
        }
        sm90::mbar_init(qbar, 1);
        sm90::mbar_init_fence();
    }
    __syncthreads();

    // thread 0 issues every TMA load: Q once, then K / V tile t into stage
    // t % kStages once both warpgroups have released that stage's last tile
    auto load_kv = [&](int t) {
        const int stage = t % kStages;
        const int k0 = k_begin + t * kWBK;
        sm90::mbar_wait(&empty[stage], ((t / kStages) & 1) ^ 1);
        sm90::mbar_expect_tx(&full[stage], 2 * L::kTile);
        for (int c = 0; c < NB; ++c) {
            const int off = (stage * NB + c) * kWBK * kRowBytes;
            sm90::tma_load_3d(sK + off, &tm_k, &full[stage], 64 * c, k0, kvh);
            sm90::tma_load_3d(sV + off, &tm_v, &full[stage], 64 * c, k0, kvh);
        }
    };
    if (threadIdx.x == 0) {
        sm90::mbar_expect_tx(qbar, L::kQ);
        for (int g = 0; g < 2; ++g)
            for (int c = 0; c < NB; ++c)
                sm90::tma_load_3d(sQ + (g * NB + c) * kWQ * kRowBytes, &tm_q, qbar,
                                  64 * c, q0 + kWQ * g, bh);
        if (n_tiles > 0) load_kv(0);
    }

    // each warpgroup: 64 query rows
    const int wg = threadIdx.x / 128;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int r0 = warp * 16 + (lane >> 2);     // rows r0 and r0 + 8 of the 64
    const int c0 = 2 * (lane & 3);              // column pair in each 8-column chunk
    const int wq_lo = q_lo + kWQ * wg, wq_hi = wq_lo + kWQ - 1;
    const int qpos0 = wq_lo + r0, qpos1 = qpos0 + 8;
    const uint32_t q_addr = sm90::smem_addr(sQ + wg * NB * kWQ * kRowBytes);
    const uint32_t k_addr = sm90::smem_addr(sK), v_addr = sm90::smem_addr(sV);
    // the softmax works on t = q.k (or its soft-capped logit) and takes
    // p = 2^(t*c - max*c): one fused multiply-add before the exponential
    const float c = softcap > 0.f ? kLog2e : scale * kLog2e;
    const float tk = softcap > 0.f ? 2.f * kLog2e * scale / softcap : 0.f;

    // accumulator fragment of an m64nN tile: register 4n + 2i + j holds
    // row r0 + 8i, column 8n + c0 + j
    float acc[NB * 32];
#pragma unroll
    for (int e = 0; e < NB * 32; ++e) acc[e] = 0.f;
    // running max of t (-inf: no live key yet) and per-thread row sums
    float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};

    sm90::mbar_wait(qbar, 0);
    for (int t = 0; t < n_tiles; ++t) {
        // tile t + 1 streams in while tile t is computed
        if (threadIdx.x == 0 && t + 1 < n_tiles) load_kv(t + 1);
        const int stage = t % kStages;
        const int k0 = k_begin + t * kWBK;
        sm90::mbar_wait(&full[stage], (t / kStages) & 1);
        const bool hidden = (causal && k0 > wq_hi)
            || (window > 0 && wq_lo - (k0 + kWBK - 1) >= window);
        if (!hidden) {
            // S = Q K^T over the (padded) head dim, 16 columns a step
            const uint64_t dq = sm90::desc_sw128_at(sm90::opaque(q_addr), 16, 1024);
            const uint64_t dk = sm90::desc_sw128_at(
                sm90::opaque(k_addr + stage * L::kTile), 16, 1024);
            float s[64];
            sm90::wgmma_fence();
#pragma unroll
            for (int kc = 0; kc < DP / 16; ++kc) {
                const int blk = kc / 4, off = (kc % 4) * 32;
                sm90::wgmma_m64n128k16_ss(s, dq + ((blk * kWQ * kRowBytes + off) >> 4),
                                          dk + ((blk * kWBK * kRowBytes + off) >> 4), kc > 0);
            }
            sm90::wgmma_commit();
            sm90::wgmma_wait_all();
            sm90::fence_regs(s);

            // soft-cap and mask (-inf: p = 0); the new running max
            const bool edge = k0 + kWBK > sk_actual
                || (causal && k0 + kWBK - 1 > wq_lo)
                || (window > 0 && wq_hi - k0 >= window);
            float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
            for (int n = 0; n < 16; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float x = s[4 * n + e];
                    // cap * tanh(x * scale / cap) = cap - 2 cap / (e^(2 x scale / cap) + 1),
                // absolute error about 1e-7 of cap (overflow to inf gives +cap)
                if (softcap > 0.f) x = fmaf(-2.f * softcap, sm90::rcp(sm90::ex2(x * tk) + 1.f), softcap);
                    if (edge) {
                        const int kpos = k0 + 8 * n + c0 + (e & 1);
                        const int qpos = e < 2 ? qpos0 : qpos1;
                        bool live = kpos < sk_actual;
                        if (causal) live = live && kpos <= qpos;
                        if (window > 0) live = live && (qpos - kpos) < window;
                        x = live ? x : -INFINITY;
                    }
                    s[4 * n + e] = x;
                    mx[e >> 1] = fmaxf(mx[e >> 1], x);
                }
            }
            float alpha[2], mc[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
                mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
                // a row with no live key so far keeps p = 0 and alpha = 0
                const float m_use = mx[i] == -INFINITY ? 0.f : mx[i];
                alpha[i] = sm90::ex2((m_i[i] - m_use) * c);
                mc[i] = m_use * c;
                m_i[i] = mx[i];
            }

            // p in f32, split into the register A fragments of P_hi and
            // P_lo: slice kk (keys 16kk..16kk+15) is chunks 2kk, 2kk+1
            uint32_t ph[8][4], pl[8][4];
            float rs[2] = {0.f, 0.f};
#pragma unroll
            for (int n = 0; n < 16; ++n) {
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const float p0 = sm90::ex2(fmaf(s[4 * n + 2 * i], c, -mc[i]));
                    const float p1 = sm90::ex2(fmaf(s[4 * n + 2 * i + 1], c, -mc[i]));
                    rs[i] += p0 + p1;
                    const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
                    const float2 hf = __bfloat1622float2(hi);
                    const __nv_bfloat162 lo = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
                    ph[n / 2][(n % 2) * 2 + i] = *reinterpret_cast<const uint32_t*>(&hi);
                    pl[n / 2][(n % 2) * 2 + i] = *reinterpret_cast<const uint32_t*>(&lo);
                }
            }
#pragma unroll
            for (int i = 0; i < 2; ++i) l_i[i] = l_i[i] * alpha[i] + rs[i];
            // rescale only when a row of the warp found a new maximum
            if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f))
#pragma unroll
            for (int e = 0; e < NB * 32; ++e) acc[e] *= alpha[(e >> 1) & 1];

            // O += P_hi V + P_lo V, 16 keys a step, every output column
            // in one instruction (two 64-column blocks of V, LBO apart)
            const uint64_t dv = sm90::desc_sw128_at(
                sm90::opaque(v_addr + stage * L::kTile), kWBK * kRowBytes, 1024);
            sm90::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kWBK / 16; ++kk) {
                const uint64_t db = dv + ((kk * 16 * kRowBytes) >> 4);
                if constexpr (NB == 2) {
                    sm90::wgmma_m64n128k16_rs(acc, ph[kk], db);
                    sm90::wgmma_m64n128k16_rs(acc, pl[kk], db);
                } else {
                    sm90::wgmma_m64n64k16_rs(acc, ph[kk], db);
                    sm90::wgmma_m64n64k16_rs(acc, pl[kk], db);
                }
            }
            sm90::wgmma_commit();
            sm90::wgmma_wait_all();
            sm90::fence_regs(acc);
        }
        if (lane == 0) sm90::mbar_arrive(&empty[stage]);
    }

    // finalise: the row sums were kept per thread, one quad per row
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 1);
        l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 2);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int row = q0 + kWQ * wg + r0 + 8 * i;
        if (row >= Sq) continue;
        const bool none = m_i[i] == -INFINITY;
        const float l = fmaxf(l_i[i], 1e-30f);
        __nv_bfloat16* dst = o + ((size_t)bh * Sq + row) * D;
#pragma unroll
        for (int n = 0; n < NB * 8; ++n) {
            const int col = 8 * n + c0;
            if (col >= D) continue;
            const float x0 = none ? 0.f : acc[4 * n + 2 * i] / l;
            const float x1 = none ? 0.f : acc[4 * n + 2 * i + 1] / l;
            *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(x0, x1);
        }
    }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime so
// that the library needs no link against libcuda.
EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
        fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// [N, S, D] bf16 as a 3-d tensor map of boxes (64 columns, `rows` rows, 1),
// 128-byte swizzle; columns past D and rows past S arrive as zeros.
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int N, int S, int D,
              int rows) {
    const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)N};
    const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
    const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
    const cuuint32_t estride[3] = {1, 1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
               strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                         int H, int Hkv, int Sq, int Sk, int D, int sk_actual,
                         int q_offset, float scale, int causal, int window, float softcap,
                         cudaStream_t stream) {
    EncodeTiled enc = encode_tiled();
    if (enc == nullptr) return cudaErrorNotSupported;
    CUtensorMap tq, tk, tv;
    if (!make_map(enc, &tq, q, B * H, Sq, D, kWQ) || !make_map(enc, &tk, k, B * Hkv, Sk, D, kWBK)
            || !make_map(enc, &tv, v, B * Hkv, Sk, D, kWBK))
        return cudaErrorInvalidValue;
    auto kern = flash_wgmma_kernel<DP>;
    constexpr int smem = WSmem<DP>::kBytes;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((Sq + kWBQ - 1) / kWBQ, B * H);
    kern<<<grid, kWThreads, smem, stream>>>(
        tq, tk, tv, static_cast<__nv_bfloat16*>(o), H, Hkv, Sq, Sk, D, sk_actual, q_offset,
        scale, causal, window, softcap);
    return cudaGetLastError();
}

}  // namespace

// The route grit_flash_attention takes for (dtype, D): 1 = tensor cores
// (wgmma; dtype 1 = bfloat16), 0 = CUDA cores (scalar; dtype 0 = float32),
// -1 = not supported.
extern "C" int grit_flash_route(int dtype, int D) {
    const bool dim_ok = D == 16 || D == 32 || D == 64 || D == 80 || D == 128;
    if (!dim_ok || (dtype != 0 && dtype != 1)) return -1;
    return dtype;
}

// window <= 0: no window; softcap <= 0: no soft-cap.  Returns the launch's
// cudaGetLastError(), or the error that kept it from launching.
extern "C" int grit_flash_attention(const void* q, const void* k, const void* v, void* o,
                                    int B, int H, int Hkv, int Sq, int Sk, int D,
                                    int sk_actual, int q_offset, float scale, int causal,
                                    int window, float softcap, int dtype, void* stream) {
    const int route = grit_flash_route(dtype, D);
    if (route < 0 || B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Sq <= 0 || Sk <= 0
            || B * H > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (route == 1)
        return (int)(D <= 64 ? launch_wgmma<64>(q, k, v, o, B, H, Hkv, Sq, Sk, D, sk_actual,
                                                q_offset, scale, causal, window, softcap, s)
                             : launch_wgmma<128>(q, k, v, o, B, H, Hkv, Sq, Sk, D, sk_actual,
                                                 q_offset, scale, causal, window, softcap, s));
#define GRIT_SCALAR(DD) launch_scalar<DD>(q, k, v, o, B, H, Hkv, Sq, Sk, sk_actual, q_offset, \
                                          scale, causal, window, softcap, s)
    switch (D) {
        case 16: return (int)GRIT_SCALAR(16);
        case 32: return (int)GRIT_SCALAR(32);
        case 64: return (int)GRIT_SCALAR(64);
        case 80: return (int)GRIT_SCALAR(80);
        default: return (int)GRIT_SCALAR(128);
    }
#undef GRIT_SCALAR
}
