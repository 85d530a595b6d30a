// K1: Transformer-XL relative attention forward with an online softmax, for
// Hopper (sm_90a).  Replaces the Pallas TPU kernel
// musicnlp_tpu/ops/pallas/flash_attention.py::_make_fwd (called through
// _fwd_call / flash_rel_attn / fused_rel_attn).
//
// What it computes, per (batch*head) row bn, query q in [0, T), key k in [0, S):
//   d      = M + q - k                      (relative distance)
//   score  = (rw[q].k[k] + rr[q].G[u]) * scale,   u = T - 1 - q + k
//   masked : d < 0, d >= window (window > 0), k < M - mem_valid  -> -1e30
//   ctx[q] = softmax(score[q]) @ v,   lse[q] = max + log(sum)   (f32)
// G [N, T+S, H] is the distance-ordered positional table built outside the
// kernel (row u holds W_r^T R(min(max(d, 0), clamp_len))), so the clamp is
// exact and costs nothing here.  rw = q + r_w_bias, rr = q + r_r_bias.
//
// Design (right and simple first): one block of 256 threads per (bn, 64-row
// q tile); a loop over 64-key tiles with the running max / sum / context in
// registers (flash attention).  Per key tile the block stages K, V and the
// 127 rows of G that the tile pair touches in shared memory (f32, rows padded
// to H+1 floats against bank conflicts); BD reads G at row (63 - qi + ki), the
// TPU kernel's strided-roll skew done as an index.  Tiles fully in the
// future, fully behind the window, or fully inside the empty memory slots are
// skipped.  p is rounded to v's dtype before the PV product, and l is held
// at >= 1e-30, as on the TPU.  Products are plain f32 FMAs from shared memory.
//
// Bound on the H100: at the base shape (BN 96, T = S = 1024, H 64, bf16,
// causal) the work is ~19.3 GFLOP (three H-long products per visible pair)
// and ~66 MB of inputs and outputs: 0.0196 ms at 989 TFLOP/s, 0.0198 ms at
// 3.35 TB/s -- operations and bytes bound it about equally.  This version runs
// on the FP32 pipes and is limited by shared-memory reads (per h step a warp
// issues ~19 shared-memory wavefronts for 32 FMAs); mma/wgmma tiles are the
// next step.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int NT = 256;         // threads: a 16 x 16 grid, 4 x 4 scores each
constexpr int RQ = BQ / 16;     // query rows per thread
constexpr int CK = BK / 16;     // key columns per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

// p as the PV product sees it: rounded to v's dtype
template <typename T> __device__ __forceinline__ float round_to(float x) {
    return to_f(from_f<T>(x));
}

template <int H>
constexpr size_t smem_floats() {
    // sQw, sQr, sK, sV: [64][H+1] each; sG: [BQ+BK][H+1], reused as P [BQ][BK+1]
    return 4 * (size_t)BQ * (H + 1)
        + ((size_t)(BQ + BK) * (H + 1) > (size_t)BQ * (BK + 1)
               ? (size_t)(BQ + BK) * (H + 1) : (size_t)BQ * (BK + 1));
}

template <typename T, int H>
__global__ void __launch_bounds__(NT, 2)
flash_rel_attn_fwd_kernel(const T* __restrict__ rw, const T* __restrict__ rr,
                          const T* __restrict__ kk, const T* __restrict__ vv,
                          const T* __restrict__ g, T* __restrict__ out,
                          float* __restrict__ lse, const int* __restrict__ mv_ptr,
                          int mv_const, int N, int T_, int S, int M, float scale,
                          int window) {
    constexpr int HP = H + 1;
    constexpr int CH = H / 16;          // context columns per thread
    constexpr int PS = BK + 1;          // P row stride
    extern __shared__ float smem[];
    float* sQw = smem;
    float* sQr = sQw + BQ * HP;
    float* sK = sQr + BQ * HP;
    float* sV = sK + BK * HP;
    float* sG = sV + BK * HP;
    float* sP = sG;                     // P overwrites G once the scores are done

    const int bn = blockIdx.y;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest rows first
    const int head = bn % N;
    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int mv = mv_ptr ? *mv_ptr : mv_const;

    const T* rw_b = rw + (size_t)bn * T_ * H;
    const T* rr_b = rr + (size_t)bn * T_ * H;
    const T* k_b = kk + (size_t)bn * S * H;
    const T* v_b = vv + (size_t)bn * S * H;
    const T* g_h = g + (size_t)head * (T_ + S) * H;

    for (int e = tid; e < BQ * H; e += NT) {
        const int r = e / H, c = e % H, q = q0 + r;
        sQw[r * HP + c] = q < T_ ? to_f(rw_b[(size_t)q * H + c]) : 0.f;
        sQr[r * HP + c] = q < T_ ? to_f(rr_b[(size_t)q * H + c]) : 0.f;
    }

    float m_i[RQ], l_i[RQ], acc[RQ][CH];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
        m_i[i] = kNegInf;
        l_i[i] = 0.f;
#pragma unroll
        for (int c = 0; c < CH; ++c) acc[i][c] = 0.f;
    }

    // keys any row of this tile can see
    const int q_last = min(q0 + BQ, T_) - 1;
    const int k_hi = min(S, M + q_last + 1);            // exclusive
    int k_lo = max(0, M - mv);
    if (window > 0) k_lo = max(k_lo, M + q0 - window + 1);
    const int kt_begin = k_lo / BK, kt_end = (k_hi + BK - 1) / BK;

    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k0 = kt * BK;
        const int u_lo = T_ - q0 - BQ + k0;             // G row of (qi=63, ki=0)
        __syncthreads();                                 // previous tile's P / V reads done
        for (int e = tid; e < BK * H; e += NT) {
            const int r = e / H, c = e % H, k = k0 + r;
            sK[r * HP + c] = k < S ? to_f(k_b[(size_t)k * H + c]) : 0.f;
            sV[r * HP + c] = k < S ? to_f(v_b[(size_t)k * H + c]) : 0.f;
        }
        for (int e = tid; e < (BQ + BK - 1) * H; e += NT) {
            const int r = e / H, c = e % H, u = u_lo + r;
            sG[r * HP + c] = (u >= 0 && u < T_ + S) ? to_f(g_h[(size_t)u * H + c]) : 0.f;
        }
        __syncthreads();

        // scores: row qi = ty + 16 i, column ki = tx + 16 j, G row 63 - qi + ki
        float s[RQ][CK];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
            for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
        const int g_base = (BQ - 1) - ty + tx;
#pragma unroll 4
        for (int h = 0; h < H; ++h) {
            float a[RQ], b[RQ], kv[CK], gv[RQ + CK - 1];
#pragma unroll
            for (int i = 0; i < RQ; ++i) {
                a[i] = sQw[(ty + 16 * i) * HP + h];
                b[i] = sQr[(ty + 16 * i) * HP + h];
            }
#pragma unroll
            for (int j = 0; j < CK; ++j) kv[j] = sK[(tx + 16 * j) * HP + h];
#pragma unroll
            for (int dd = 0; dd < RQ + CK - 1; ++dd)
                gv[dd] = sG[(g_base + 16 * (dd - (RQ - 1))) * HP + h];
#pragma unroll
            for (int i = 0; i < RQ; ++i)
#pragma unroll
                for (int j = 0; j < CK; ++j)
                    s[i][j] = fmaf(a[i], kv[j], fmaf(b[i], gv[j - i + RQ - 1], s[i][j]));
        }
        __syncthreads();                                 // all G reads done: P may overwrite it

#pragma unroll
        for (int i = 0; i < RQ; ++i) {
            const int q = q0 + ty + 16 * i;
            float mx = kNegInf;
#pragma unroll
            for (int j = 0; j < CK; ++j) {
                const int k = k0 + tx + 16 * j;
                const int d = M + q - k;
                const bool ok = d >= 0 && k < S && k >= M - mv && (window <= 0 || d < window);
                s[i][j] = ok ? s[i][j] * scale : kNegInf;
                mx = fmaxf(mx, s[i][j]);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m_i[i], mx);
            const float alpha = expf(m_i[i] - m_new);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < CK; ++j) {
                const float p = expf(s[i][j] - m_new);
                sum += p;
                sP[(ty + 16 * i) * PS + tx + 16 * j] = round_to<T>(p);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            l_i[i] = l_i[i] * alpha + sum;
            m_i[i] = m_new;
#pragma unroll
            for (int c = 0; c < CH; ++c) acc[i][c] *= alpha;
        }
        __syncthreads();

#pragma unroll 4
        for (int kx = 0; kx < BK; ++kx) {
            float vk[CH];
#pragma unroll
            for (int c = 0; c < CH; ++c) vk[c] = sV[kx * HP + tx + 16 * c];
#pragma unroll
            for (int i = 0; i < RQ; ++i) {
                const float p = sP[(ty + 16 * i) * PS + kx];
#pragma unroll
                for (int c = 0; c < CH; ++c) acc[i][c] = fmaf(p, vk[c], acc[i][c]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
        const int q = q0 + ty + 16 * i;
        if (q >= T_) continue;
        const float l = fmaxf(l_i[i], 1e-30f);
        T* o = out + ((size_t)bn * T_ + q) * H;
#pragma unroll
        for (int c = 0; c < CH; ++c) o[tx + 16 * c] = from_f<T>(acc[i][c] / l);
        if (tx == 0) lse[(size_t)bn * T_ + q] = m_i[i] + logf(l);
    }
}

template <typename T, int H>
cudaError_t launch(const void* rw, const void* rr, const void* k, const void* v,
                   const void* g, void* out, float* lse, const int* mv_ptr, int mv_const,
                   int BN, int N, int T_, int S, int M, float scale, int window,
                   cudaStream_t stream) {
    const size_t smem = smem_floats<H>() * sizeof(float);
    auto kern = flash_rel_attn_fwd_kernel<T, H>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((T_ + BQ - 1) / BQ, BN);
    kern<<<grid, NT, smem, stream>>>(
        (const T*)rw, (const T*)rr, (const T*)k, (const T*)v, (const T*)g, (T*)out, lse,
        mv_ptr, mv_const, N, T_, S, M, scale, window);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_h(int H, const void* rw, const void* rr, const void* k, const void* v,
                     const void* g, void* out, float* lse, const int* mv_ptr, int mv_const,
                     int BN, int N, int T_, int S, int M, float scale, int window,
                     cudaStream_t st) {
    switch (H) {
        case 16: return launch<T, 16>(rw, rr, k, v, g, out, lse, mv_ptr, mv_const,
                                      BN, N, T_, S, M, scale, window, st);
        case 32: return launch<T, 32>(rw, rr, k, v, g, out, lse, mv_ptr, mv_const,
                                      BN, N, T_, S, M, scale, window, st);
        case 64: return launch<T, 64>(rw, rr, k, v, g, out, lse, mv_ptr, mv_const,
                                      BN, N, T_, S, M, scale, window, st);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// rw/rr [BN, T, H], k/v [BN, S, H], g [N, T+S, H] (dtype 0 = f32, 1 = bf16);
// out [BN, T, H] in that dtype, lse [BN, T] f32.  mem_valid is read from the
// device int32 at mv_ptr, or is mv_const when mv_ptr is null.  window <= 0 is
// no window.  Launches on `stream`; returns cudaGetLastError() of the launch.
extern "C" int flash_rel_attn_fwd(const void* rw, const void* rr, const void* k,
                                  const void* v, const void* g, void* out, void* lse,
                                  const void* mv_ptr, int mv_const, int BN, int N,
                                  int T, int S, int M, int H, int dtype, float scale,
                                  int window, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    float* l = (float*)lse;
    const int* mv = (const int*)mv_ptr;
    if (dtype == 0)
        return (int)launch_h<float>(H, rw, rr, k, v, g, out, l, mv, mv_const, BN, N, T, S,
                                    M, scale, window, st);
    if (dtype == 1)
        return (int)launch_h<__nv_bfloat16>(H, rw, rr, k, v, g, out, l, mv, mv_const, BN, N,
                                            T, S, M, scale, window, st);
    return (int)cudaErrorInvalidValue;
}
