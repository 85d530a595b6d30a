// K4: chunked-window causal attention backward, for Hopper (sm_90a).
// Replaces the Pallas TPU kernel
// musicnlp_tpu/ops/pallas/chunked_attention_kernel.py::_make_bwd (called
// through _core_bwd, the custom VJP of chunked_window_attn).
//
// What it computes, per row g of G, with the scores of K3
// (chunked_window_attn_fwd.cu) recomputed from its f32 lse:
//   p  = exp(s - lse[q]),  dp = dO[q] . v[w],
//   ds = p * (dp - delta[q] + dlse[q]) * scale      (dlse: lse is an output too)
//   dq[q] = sum_w ds k[w]       dk[w] = sum_q ds q[q]       dv[w] = sum_q p dO[q]
// over each query's window (chunks i-1 and i), so a key of chunk j gathers
// from the queries of chunks j and j+1.  delta[q] = dO[q] . O[q] comes in f32.
// Rounding points of the TPU kernel: p and ds are rounded to the input dtype
// before the products; sums are f32, dk / dv are returned in f32.
//
// Design (right and simple first; no atomics).  The TPU grid runs in order
// and lands each program's overlapping window gradients on resident [T, D]
// accumulators; Hopper blocks run in no order, so one block of 256 threads
// per (g, chunk j) owns both the dq rows of query chunk j and the dk / dv
// rows of key chunk j, and walks the three C x C tiles that feed them:
//   (queries j,   keys j-1) -> dq          (skipped for j = 0: zero keys)
//   (queries j,   keys j)   -> dq, dk, dv
//   (queries j+1, keys j)   -> dk, dv      (skipped for the last chunk)
// Each tile stages Q, dO, K and V as f32 rows padded to D+1 floats, computes
// s and dp with f32 FMAs, writes rounded p and ds to shared memory, and adds
// its products into register accumulators; every output row is written once.
// Shared memory: ~101 KB at C = D = 64, two blocks per SM.
//
// Bound on the H100: at the 22-04 LSH training shape (G 768, T 2048, D 64,
// C 64, bf16) the call moves ~1.8 GB (q, k, v, dO, positions, lse, delta,
// dlse read once; dq in bf16, dk and dv in f32 written once): 0.55 ms at
// 3.35 TB/s, against ~129 GFLOP (five D-long products per visible pair),
// 0.13 ms at 989 TFLOP/s -- bytes bound it.  This version recomputes the
// (j, j) tile's scores once per block but reloads Q / dO per tile and runs
// its products on the FP32 pipes; mma/wgmma tiles are the next step.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
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

template <typename T> __device__ __forceinline__ float round_to(float x) {
    return to_f(from_f<T>(x));
}

template <int C, int D>
constexpr size_t bwd_smem_bytes() {
    // sQ, sDO, sK, sV [C][D+1]; sP, sDS [C][C+1]; lse, delta, dlse [C] f32;
    // qpos, kpos [C] int
    return (size_t)(4 * C * (D + 1) + 2 * C * (C + 1) + 3 * C) * sizeof(float)
        + (size_t)2 * C * sizeof(int);
}

template <typename T, int C, int D>
__global__ void __launch_bounds__(NT, 2)
chunked_window_attn_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const T* __restrict__ dout,
                               const int* __restrict__ qpos, const int* __restrict__ kpos,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               const float* __restrict__ dlse, T* __restrict__ dq,
                               float* __restrict__ dk, float* __restrict__ dv, int T_,
                               float scale, float self_bias) {
    constexpr int DP = D + 1, CP = C + 1;
    constexpr int R = C / 16;           // rows (queries or keys) per thread
    constexpr int CD = D / 16;          // feature columns per thread
    extern __shared__ float smem[];
    float* sQ = smem;                   // [C][DP]
    float* sDO = sQ + C * DP;           // [C][DP]
    float* sK = sDO + C * DP;           // [C][DP]
    float* sV = sK + C * DP;            // [C][DP]
    float* sP = sV + C * DP;            // [C][CP]
    float* sDS = sP + C * CP;           // [C][CP]
    float* sL = sDS + C * CP;           // [C]
    float* sDe = sL + C;                // [C]
    float* sDl = sDe + C;               // [C]
    int* sQp = (int*)(sDl + C);         // [C]
    int* sKp = sQp + C;                 // [C]

    const int g = blockIdx.y, j = blockIdx.x, n = gridDim.x;
    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const size_t base = (size_t)g * T_;

    float dq_acc[R][CD], dk_acc[R][CD], dv_acc[R][CD];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) dq_acc[i][c] = dk_acc[i][c] = dv_acc[i][c] = 0.f;

    int loaded_q = -1;
    for (int t = 0; t < 3; ++t) {
        const int qi = t == 2 ? j + 1 : j;          // query chunk of the tile
        const int kj = t == 0 ? j - 1 : j;          // key chunk of the tile
        if (kj < 0 || qi >= n) continue;            // the same for the whole block
        __syncthreads();                             // the previous tile's reads are done
        if (qi != loaded_q) {
            const size_t r0 = base + (size_t)qi * C;
            for (int e = tid; e < C * D; e += NT) {
                const int r = e / D, c = e % D;
                sQ[r * DP + c] = to_f(q[(r0 + r) * D + c]);
                sDO[r * DP + c] = to_f(dout[(r0 + r) * D + c]);
            }
            for (int e = tid; e < C; e += NT) {
                sQp[e] = qpos[r0 + e];
                sL[e] = lse[r0 + e];
                sDe[e] = delta[r0 + e];
                sDl[e] = dlse[r0 + e];
            }
            loaded_q = qi;
        }
        {
            const size_t r0 = base + (size_t)kj * C;
            for (int e = tid; e < C * D; e += NT) {
                const int r = e / D, c = e % D;
                sK[r * DP + c] = to_f(k[(r0 + r) * D + c]);
                sV[r * DP + c] = to_f(v[(r0 + r) * D + c]);
            }
            for (int e = tid; e < C; e += NT) sKp[e] = kpos[r0 + e];
        }
        __syncthreads();

        // s and dp of the tile: query row ty + 16 a, key column tx + 16 b
        float s[R][R], dp[R][R];
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
            for (int b = 0; b < R; ++b) s[a][b] = dp[a][b] = 0.f;
#pragma unroll 4
        for (int h = 0; h < D; ++h) {
            float qa[R], oa[R], kb[R], vb[R];
#pragma unroll
            for (int a = 0; a < R; ++a) {
                qa[a] = sQ[(ty + 16 * a) * DP + h];
                oa[a] = sDO[(ty + 16 * a) * DP + h];
            }
#pragma unroll
            for (int b = 0; b < R; ++b) {
                kb[b] = sK[(tx + 16 * b) * DP + h];
                vb[b] = sV[(tx + 16 * b) * DP + h];
            }
#pragma unroll
            for (int a = 0; a < R; ++a)
#pragma unroll
                for (int b = 0; b < R; ++b) {
                    s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
                    dp[a][b] = fmaf(oa[a], vb[b], dp[a][b]);
                }
        }
#pragma unroll
        for (int a = 0; a < R; ++a) {
            const int qr = ty + 16 * a;
            const int qp = sQp[qr];
#pragma unroll
            for (int b = 0; b < R; ++b) {
                const int kc = tx + 16 * b;
                const int kp = sKp[kc];
                float x = s[a][b] * scale;
                if (kp <= qp) {
                    if (kp == qp) x += self_bias;
                } else {
                    x = kNegInf;
                }
                const float p = expf(x - sL[qr]);
                const float ds = p * ((dp[a][b] - sDe[qr]) + sDl[qr]) * scale;
                sP[qr * CP + kc] = round_to<T>(p);
                sDS[qr * CP + kc] = round_to<T>(ds);
            }
        }
        __syncthreads();

        if (t < 2) {      // dq rows ty + 16 a of query chunk j: sum over the tile's keys
#pragma unroll 4
            for (int w = 0; w < C; ++w) {
                float kd[CD];
#pragma unroll
                for (int c = 0; c < CD; ++c) kd[c] = sK[w * DP + tx + 16 * c];
#pragma unroll
                for (int a = 0; a < R; ++a) {
                    const float ds = sDS[(ty + 16 * a) * CP + w];
#pragma unroll
                    for (int c = 0; c < CD; ++c) dq_acc[a][c] = fmaf(ds, kd[c], dq_acc[a][c]);
                }
            }
        }
        if (t > 0) {      // dk / dv rows ty + 16 a of key chunk j: sum over the tile's queries
#pragma unroll 4
            for (int r = 0; r < C; ++r) {
                float qd[CD], od[CD];
#pragma unroll
                for (int c = 0; c < CD; ++c) {
                    qd[c] = sQ[r * DP + tx + 16 * c];
                    od[c] = sDO[r * DP + tx + 16 * c];
                }
#pragma unroll
                for (int a = 0; a < R; ++a) {
                    const float ds = sDS[r * CP + ty + 16 * a];
                    const float p = sP[r * CP + ty + 16 * a];
#pragma unroll
                    for (int c = 0; c < CD; ++c) {
                        dk_acc[a][c] = fmaf(ds, qd[c], dk_acc[a][c]);
                        dv_acc[a][c] = fmaf(p, od[c], dv_acc[a][c]);
                    }
                }
            }
        }
    }

#pragma unroll
    for (int a = 0; a < R; ++a) {
        const size_t row = base + (size_t)j * C + ty + 16 * a;
#pragma unroll
        for (int c = 0; c < CD; ++c) {
            const size_t o = row * D + tx + 16 * c;
            dq[o] = from_f<T>(dq_acc[a][c]);
            dk[o] = dk_acc[a][c];
            dv[o] = dv_acc[a][c];
        }
    }
}

template <typename T, int C, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const int* qpos, const int* kpos, const float* lse, const float* delta,
                   const float* dlse, void* dq, float* dk, float* dv, int G, int T_,
                   float scale, float self_bias, cudaStream_t stream) {
    const size_t smem = bwd_smem_bytes<C, D>();
    auto kern = chunked_window_attn_bwd_kernel<T, C, D>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid(T_ / C, G);
    kern<<<grid, NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (const T*)dout,
                                     qpos, kpos, lse, delta, dlse, (T*)dq, dk, dv, T_, scale,
                                     self_bias);
    return cudaGetLastError();
}

struct Args {
    const void *q, *k, *v, *dout;
    const int *qpos, *kpos;
    const float *lse, *delta, *dlse;
    void* dq;
    float *dk, *dv;
    int G, T;
    float scale, self_bias;
    cudaStream_t st;
};

template <typename T, int C, int D>
cudaError_t run(const Args& a) {
    return launch<T, C, D>(a.q, a.k, a.v, a.dout, a.qpos, a.kpos, a.lse, a.delta, a.dlse,
                           a.dq, a.dk, a.dv, a.G, a.T, a.scale, a.self_bias, a.st);
}

template <typename T, int C>
cudaError_t run_d(int D, const Args& a) {
    switch (D) {
        case 16: return run<T, C, 16>(a);
        case 32: return run<T, C, 32>(a);
        case 64: return run<T, C, 64>(a);
        default: return cudaErrorInvalidValue;
    }
}

template <typename T>
cudaError_t run_c(int C, int D, const Args& a) {
    switch (C) {
        case 32: return run_d<T, 32>(D, a);
        case 64: return run_d<T, 64>(D, a);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// q/k/v/dout [G, T, D] (dtype 0 = f32, 1 = bf16), qpos/kpos int32 [G, T],
// lse/delta/dlse f32 [G, T]; dq [G, T, D] in the input dtype, dk/dv [G, T, D]
// f32.  T % chunk == 0; chunk 32 or 64; D 16, 32 or 64.  Launches on
// `stream`; returns cudaGetLastError() of the launch.
extern "C" int chunked_window_attn_bwd(const void* q, const void* k, const void* v,
                                       const void* dout, const void* qpos, const void* kpos,
                                       const void* lse, const void* delta, const void* dlse,
                                       void* dq, void* dk, void* dv, int G, int T, int D,
                                       int chunk, int dtype, float scale, float self_bias,
                                       void* stream) {
    if (T % chunk) return (int)cudaErrorInvalidValue;
    const Args a{q, k, v, dout, (const int*)qpos, (const int*)kpos, (const float*)lse,
                 (const float*)delta, (const float*)dlse, dq, (float*)dk, (float*)dv, G, T,
                 scale, self_bias, (cudaStream_t)stream};
    if (dtype == 0) return (int)run_c<float>(chunk, D, a);
    if (dtype == 1) return (int)run_c<__nv_bfloat16>(chunk, D, a);
    return (int)cudaErrorInvalidValue;
}
