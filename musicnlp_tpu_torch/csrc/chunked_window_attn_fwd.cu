// K3: chunked-window causal attention forward (the Reformer's local and LSH
// layers), for Hopper (sm_90a).  Replaces the Pallas TPU kernel
// musicnlp_tpu/ops/pallas/chunked_attention_kernel.py::_make_fwd (called
// through _fwd_call / chunked_window_attn).
//
// What it computes, per row g of G and query chunk i (chunk C, head dim D):
// the window is the C keys of chunk i-1 (none before chunk 0: zeros, masked)
// followed by the C keys of chunk i, and for each query q of chunk i
//   s[q, w]  = (q . k[w]) * scale
//   masked   : kpos[w] > qpos[q]                   -> -1e9 (finite, as on the TPU)
//   self     : kpos[w] == qpos[q]                  -> s + self_bias
//   ctx[q]   = sum_w round(p[q, w]) v[w] / l,  p = exp(s - max), l = max(sum p, 1e-30)
//   lse[q]   = max + log(l)                        (f32, its own [G, T] tensor)
// Padding arrives as kpos = T; LSH layers pass sorted (permuted) positions.
//
// Design (right and simple first): one block of 256 threads (a 16 x 16 grid)
// per (g, chunk).  The block stages the query chunk and the 2C-key window in
// shared memory as f32 (rows padded to D+1 floats against bank conflicts),
// computes the [C, 2C] scores with f32 FMAs, masks them from the staged
// positions, takes the row softmax with 16-lane shuffles, writes p (rounded
// to v's dtype, as the TPU kernel does) over the key buffer, and runs PV.
// The TPU version's blocking (m chunks per program, lse packed into lane
// padding) is layout, not semantics, and is not carried over.
//
// Bound on the H100: at the 22-04 LSH shape (G 768, T 2048, D 64, C 64,
// bf16) the call moves ~0.82 GB (q, k, v and both positions read once, ctx
// and lse written once) for ~52 GFLOP: 0.25 ms at 3.35 TB/s against 0.05 ms
// at 989 TFLOP/s -- bytes bound it.  This version reads k and v twice (each
// chunk is in two windows) and runs its products on the FP32 pipes from
// shared memory; mma/wgmma tiles and one pass over k/v are the next steps.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads: a 16 x 16 grid
constexpr float kNegInf = -1e9f;

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

template <int C, int D>
struct Fwd {
    static constexpr int W = 2 * C;                       // window keys
    static constexpr int DP = D + 1;                      // padded row
    static constexpr int PS = W + 1;                      // P row stride
    static constexpr int KBUF = (W * DP > C * PS) ? W * DP : C * PS;   // K, then P
    static constexpr size_t smem_bytes() {
        return (size_t)(C * DP + KBUF + W * DP) * sizeof(float) + (size_t)(C + W) * sizeof(int);
    }
};

template <typename T, int C, int D>
__global__ void __launch_bounds__(NT, 2)
chunked_window_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const int* __restrict__ qpos,
                               const int* __restrict__ kpos, T* __restrict__ out,
                               float* __restrict__ lse, int T_, float scale, float self_bias) {
    using F = Fwd<C, D>;
    constexpr int W = F::W, DP = F::DP, PS = F::PS;
    constexpr int RQ = C / 16;          // query rows per thread
    constexpr int CK = W / 16;          // window columns per thread
    constexpr int CD = D / 16;          // context columns per thread
    extern __shared__ float smem[];
    float* sQ = smem;                   // [C][DP]
    float* sK = sQ + C * DP;            // [W][DP], then P [C][PS]
    float* sV = sK + F::KBUF;           // [W][DP]
    int* sQp = (int*)(sV + W * DP);     // [C]
    int* sKp = sQp + C;                 // [W]
    float* sP = sK;

    const int g = blockIdx.y;
    const int r0 = blockIdx.x * C;      // first query row of the chunk
    const int w0 = r0 - C;              // first row of the window (the look-back)
    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const size_t base = (size_t)g * T_;

    for (int e = tid; e < C * D; e += NT) {
        const int r = e / D, c = e % D;
        sQ[r * DP + c] = to_f(q[(base + r0 + r) * D + c]);
    }
    for (int e = tid; e < W * D; e += NT) {
        const int r = e / D, c = e % D, row = w0 + r;
        const bool ok = row >= 0;
        sK[r * DP + c] = ok ? to_f(k[(base + row) * D + c]) : 0.f;
        sV[r * DP + c] = ok ? to_f(v[(base + row) * D + c]) : 0.f;
    }
    for (int e = tid; e < C; e += NT) sQp[e] = qpos[base + r0 + e];
    for (int e = tid; e < W; e += NT) {
        const int row = w0 + e;
        sKp[e] = row >= 0 ? kpos[base + row] : INT_MAX;  // no look-back: never visible
    }
    __syncthreads();

    // scores: query row ty + 16 i, window column tx + 16 j
    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int h = 0; h < D; ++h) {
        float a[RQ], b[CK];
#pragma unroll
        for (int i = 0; i < RQ; ++i) a[i] = sQ[(ty + 16 * i) * DP + h];
#pragma unroll
        for (int j = 0; j < CK; ++j) b[j] = sK[(tx + 16 * j) * DP + h];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
            for (int j = 0; j < CK; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
    __syncthreads();                     // every K read done: P may overwrite it

    float l_i[RQ], lse_i[RQ];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
        const int qr = ty + 16 * i;
        const int qp = sQp[qr];
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < CK; ++j) {
            const int kp = sKp[tx + 16 * j];
            float x = s[i][j] * scale;
            if (kp <= qp) {
                if (kp == qp) x += self_bias;
            } else {
                x = kNegInf;
            }
            s[i][j] = x;
            mx = fmaxf(mx, x);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < CK; ++j) {
            const float p = expf(s[i][j] - mx);
            sum += p;
            sP[qr * PS + tx + 16 * j] = round_to<T>(p);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
        l_i[i] = fmaxf(sum, 1e-30f);
        lse_i[i] = mx + logf(l_i[i]);
    }
    __syncthreads();

    float acc[RQ][CD];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
#pragma unroll 4
    for (int w = 0; w < W; ++w) {
        float vw[CD];
#pragma unroll
        for (int c = 0; c < CD; ++c) vw[c] = sV[w * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
            const float p = sP[(ty + 16 * i) * PS + w];
#pragma unroll
            for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(p, vw[c], acc[i][c]);
        }
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
        const size_t row = base + r0 + ty + 16 * i;
#pragma unroll
        for (int c = 0; c < CD; ++c) out[row * D + tx + 16 * c] = from_f<T>(acc[i][c] / l_i[i]);
        if (tx == 0) lse[row] = lse_i[i];
    }
}

template <typename T, int C, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* qpos,
                   const int* kpos, void* out, float* lse, int G, int T_, float scale,
                   float self_bias, cudaStream_t stream) {
    const size_t smem = Fwd<C, D>::smem_bytes();
    auto kern = chunked_window_attn_fwd_kernel<T, C, D>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid(T_ / C, G);
    kern<<<grid, NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, qpos, kpos,
                                     (T*)out, lse, T_, scale, self_bias);
    return cudaGetLastError();
}

template <typename T, int C>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, const int* qpos,
                     const int* kpos, void* out, float* lse, int G, int T_, float scale,
                     float self_bias, cudaStream_t st) {
    switch (D) {
        case 16: return launch<T, C, 16>(q, k, v, qpos, kpos, out, lse, G, T_, scale,
                                         self_bias, st);
        case 32: return launch<T, C, 32>(q, k, v, qpos, kpos, out, lse, G, T_, scale,
                                         self_bias, st);
        case 64: return launch<T, C, 64>(q, k, v, qpos, kpos, out, lse, G, T_, scale,
                                         self_bias, st);
        default: return cudaErrorInvalidValue;
    }
}

template <typename T>
cudaError_t launch_c(int C, int D, const void* q, const void* k, const void* v,
                     const int* qpos, const int* kpos, void* out, float* lse, int G, int T_,
                     float scale, float self_bias, cudaStream_t st) {
    switch (C) {
        case 32: return launch_d<T, 32>(D, q, k, v, qpos, kpos, out, lse, G, T_, scale,
                                        self_bias, st);
        case 64: return launch_d<T, 64>(D, q, k, v, qpos, kpos, out, lse, G, T_, scale,
                                        self_bias, st);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// q/k/v [G, T, D] (dtype 0 = f32, 1 = bf16), qpos/kpos int32 [G, T]; out
// [G, T, D] in that dtype, lse [G, T] f32.  T % chunk == 0; chunk 32 or 64;
// D 16, 32 or 64.  Launches on `stream`; returns cudaGetLastError() of the
// launch.
extern "C" int chunked_window_attn_fwd(const void* q, const void* k, const void* v,
                                       const void* qpos, const void* kpos, void* out,
                                       void* lse, int G, int T, int D, int chunk, int dtype,
                                       float scale, float self_bias, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int* qp = (const int*)qpos;
    const int* kp = (const int*)kpos;
    float* l = (float*)lse;
    if (T % chunk) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
        return (int)launch_c<float>(chunk, D, q, k, v, qp, kp, out, l, G, T, scale, self_bias,
                                    st);
    if (dtype == 1)
        return (int)launch_c<__nv_bfloat16>(chunk, D, q, k, v, qp, kp, out, l, G, T, scale,
                                            self_bias, st);
    return (int)cudaErrorInvalidValue;
}
