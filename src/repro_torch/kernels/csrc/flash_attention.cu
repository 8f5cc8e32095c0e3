// Blocked online-softmax attention, forward only (sm_90a).
//
//   flash_attention  replaces  repro/kernels/flash_attention.py::flash_attention_pallas
//                              (body _flash_kernel)
//
// Operands: q [BH, Sq, D], k / v [BH, Sk, D], f32 or bf16, contiguous;
// out [BH, Sq, D] in the input type.  Query row i sits at key position
// i + q_offset; key j is live when j < sk_actual, j <= i + q_offset
// (causal) and (i + q_offset) - j < window (window > 0).  Per (row, key):
// logit = (q . k) * scale, then tanh(logit / softcap) * softcap
// (softcap > 0), then the mask with the reference's finite NEG_INF =
// -1e30 (not -inf: a key tile that is fully masked for one row gives that
// row p = exp(0) there, cancelled later by alpha = exp(-1e30 - m) = 0,
// exactly as in the reference).  Running max, denominator and accumulator
// are f32; the row is finalised as acc / max(l, 1e-30).  A row that sees
// no live key at all (only possible when Sq > Sk under the causal mask,
// its aligned position being negative) is written as 0; the reference's
// value there depends on its 128-key tiling.
//
// Design.  One block of 256 threads per (bh, 64-row query tile), a loop
// over 64-key tiles staged in shared memory as f32: Q and K transposed
// ([D][64], so a thread's 4 rows or 4 keys at one d are one 16-byte load),
// V row-major, P as a [64][68] tile.  Thread (tr, tc) = (tid / 16, tid % 16)
// owns the scores of rows 4tr..4tr+3 x keys 4tc..4tc+3 and the outputs of
// rows 4tr..4tr+3 x columns tc + 16j, so the row max and row sum are
// 16-lane shuffles inside one half-warp and alpha rescales registers the
// thread already holds.  The key loop runs only over the tiles inside the
// causal / window band of the query tile (the reference's block-level skip
// of flash_attention.py:48-59, at this tile size); query tiles are scheduled
// longest-band first.  All arithmetic is scalar f32 on the CUDA cores
// (bf16 inputs are widened when staged), built without -fmad=false so the
// dot products are fused multiply-adds.
//
// What bounds it.  The function must read q, k, v once and write out once
// (2 or 4 bytes an element) and does 4*D operations per live (row, key)
// pair.  At the prefill shapes (Sq = Sk >= 2048, D = 128) that is several
// hundred operations per byte: operation bound.  This kernel does them on
// the CUDA cores (67 TFLOP/s f32 peak on an H100 SXM), not on the tensor
// cores that the bf16 bound assumes (989 TFLOP/s), so for bf16 inputs it
// stays an order of magnitude above the bound by construction; the band
// skip halves the causal work and cuts a windowed layer's to O(S * window).
// Tensor-core tiles (wgmma) and TMA staging are the next step, not this
// one.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 64;                 // keys per staged tile
constexpr int kThreads = 256;
constexpr int kPS = kBK + 4;            // row stride of the P tile (16-byte aligned)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    uint2 raw = *reinterpret_cast<const uint2*>(p);
    __nv_bfloat162 lo = *reinterpret_cast<__nv_bfloat162*>(&raw.x);
    __nv_bfloat162 hi = *reinterpret_cast<__nv_bfloat162*>(&raw.y);
    float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
    return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Columns 4c..4c+3 of row r of a [rows, D] slab as f32, zeros past `rows`.
template <typename T, int D>
__device__ __forceinline__ float4 row_chunk(const T* __restrict__ base, int r, int rows, int c) {
    if (r >= rows) return make_float4(0.f, 0.f, 0.f, 0.f);
    return load4(base + (size_t)r * D + 4 * c);
}

// Stage 64 rows of a [rows, D] slab transposed into dst[D][64].
template <typename T, int D>
__device__ __forceinline__ void stage_transposed(const T* __restrict__ src, int rows, float* dst) {
    constexpr int C4 = D / 4;
    for (int i = threadIdx.x; i < 64 * C4; i += kThreads) {
        int r = i % 64, c = i / 64;         // neighbouring lanes: neighbouring rows
        float4 x = row_chunk<T, D>(src, r, rows, c);
        dst[(4 * c + 0) * 64 + r] = x.x;
        dst[(4 * c + 1) * 64 + r] = x.y;
        dst[(4 * c + 2) * 64 + r] = x.z;
        dst[(4 * c + 3) * 64 + r] = x.w;
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int Sq, int Sk, int sk_actual, int q_offset,
                 float scale, int causal, int window, float softcap) {
    constexpr int C4 = D / 4;
    constexpr int NJ = D / 16;              // output columns per thread
    extern __shared__ float4 smem4[];
    float* Qt = reinterpret_cast<float*>(smem4);    // [D][kBQ]
    float* Kt = Qt + D * kBQ;                       // [D][kBK]
    float* Vs = Kt + D * kBK;                       // [kBK][D]
    float* Ps = Vs + kBK * D;                       // [kBQ][kPS]

    const int bh = blockIdx.y;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
    const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
    const T* kg = k + (size_t)bh * Sk * D;
    const T* vg = v + (size_t)bh * Sk * D;

    stage_transposed<T, D>(q + ((size_t)bh * Sq + q0) * D, min(kBQ, Sq - q0), Qt);

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
        stage_transposed<T, D>(kg + (size_t)k0 * D, krows, Kt);
        for (int i = tid; i < kBK * C4; i += kThreads) {
            int r = i / C4, c = i % C4;
            *reinterpret_cast<float4*>(Vs + r * D + 4 * c) =
                row_chunk<T, D>(vg + (size_t)k0 * D, r, krows, c);
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
        T* dst = o + ((size_t)bh * Sq + row) * D;
#pragma unroll
        for (int j = 0; j < NJ; ++j) store1(dst + tc + 16 * j, none ? 0.f : acc[i][j] / l);
    }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int BH, int Sq,
                   int Sk, int sk_actual, int q_offset, float scale, int causal,
                   int window, float softcap, cudaStream_t stream) {
    auto kern = flash_fwd_kernel<T, D>;
    const int smem = (int)(sizeof(float) * (2 * D * 64 + 64 * D + kBQ * kPS));
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((Sq + kBQ - 1) / kBQ, BH);
    kern<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), Sq, Sk, sk_actual, q_offset, scale, causal, window, softcap);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, int BH, int Sq,
                     int Sk, int D, int sk_actual, int q_offset, float scale, int causal,
                     int window, float softcap, cudaStream_t stream) {
    switch (D) {
        case 16: return launch<T, 16>(q, k, v, o, BH, Sq, Sk, sk_actual, q_offset, scale, causal, window, softcap, stream);
        case 32: return launch<T, 32>(q, k, v, o, BH, Sq, Sk, sk_actual, q_offset, scale, causal, window, softcap, stream);
        case 64: return launch<T, 64>(q, k, v, o, BH, Sq, Sk, sk_actual, q_offset, scale, causal, window, softcap, stream);
        case 80: return launch<T, 80>(q, k, v, o, BH, Sq, Sk, sk_actual, q_offset, scale, causal, window, softcap, stream);
        case 128: return launch<T, 128>(q, k, v, o, BH, Sq, Sk, sk_actual, q_offset, scale, causal, window, softcap, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0: no window; softcap <= 0:
// no soft-cap.  Returns the launch's cudaGetLastError().
extern "C" int grit_flash_attention(const void* q, const void* k, const void* v, void* o,
                                    int BH, int Sq, int Sk, int D, int sk_actual,
                                    int q_offset, float scale, int causal, int window,
                                    float softcap, int dtype, void* stream) {
    if (BH <= 0 || Sq <= 0 || BH > 65535) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return (int)launch_d<float>(q, k, v, o, BH, Sq, Sk, D, sk_actual, q_offset, scale,
                                    causal, window, softcap, s);
    if (dtype == 1)
        return (int)launch_d<__nv_bfloat16>(q, k, v, o, BH, Sq, Sk, D, sk_actual, q_offset,
                                            scale, causal, window, softcap, s);
    return (int)cudaErrorInvalidValue;
}
