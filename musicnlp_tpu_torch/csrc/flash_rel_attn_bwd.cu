// K2: Transformer-XL relative attention backward, for Hopper (sm_90a).
// Replaces the Pallas TPU kernel
// musicnlp_tpu/ops/pallas/flash_attention.py::_make_bwd_fused (called through
// _flash_bwd, the custom VJP of flash_rel_attn).
//
// What it computes, per (batch*head) row bn, with the scores of K1
// (flash_rel_attn_fwd.cu) recomputed:
//   s[q,k]  = (rw[q].k[k] + rr[q].G[u]) * scale,   u = T - 1 - q + k, masked
//   p       = exp(s - lse[q]),   dp = dO[q].v[k],   ds = p * (dp - delta[q]) * scale
//   drw[q]  = sum_k ds k[k]            dk[k] = sum_q ds rw[q]
//   drr[q]  = sum_k ds G[u]            dv[k] = sum_q p dO[q]
//   dG[h,u] = sum_{b, q - k = T-1-u} ds rr[q]       (summed over the batch)
// delta[q] = dO[q].O[q] and lse come in f32.  Rounding points of the TPU
// kernel: p is rounded to the input dtype before the dV product, ds before
// every product (`dsg`); all sums are f32, dk / dv / dG are returned in f32.
// The TPU kernel sends the positional gradient through a sin/cos "U-form"
// only because Mosaic has no negative-stride roll; here the inverse skew is
// the index 63 - qi + ki into the staged G rows (as in K1), and dW_r follows
// from dG by autograd through the distance table outside the kernel.
//
// Design (right and simple first).  The TPU grid runs in order and keeps
// dk / dv resident across a (b*n) window; Hopper blocks run in no order, so
// the work is split in two kernels of one 256-thread block each:
//   dkdv: one block per (bn, 64-key tile); loops over the q tiles that see
//         the tile, keeps dk / dv in registers, writes them once.
//   dq:   one block per (bn, 64-row q tile); loops over the key tiles the
//         rows see (the tiles K1 visits), keeps drw / drr in registers, and
//         adds the tile pair's 127 diagonal rows of dG into a zeroed f32
//         buffer with atomicAdd (summation order varies from run to run).
// Tiles in the future, behind the window or inside the empty memory slots
// are skipped, as in K1; ragged T and S are zero-filled and masked.
// Operands sit in shared memory as f32 rows padded to H+1 floats; products
// are f32 FMAs.  Shared memory: 150 KB (dkdv) and 133 KB (dq) at H = 64,
// so one block per SM.
//
// Bound on the H100: at the TF-XL base training shape (B*N 252, T = S = 1024,
// H 64, bf16, causal) the work is 8 H-long products per visible pair (AC, BD,
// dP, dV, dK, dRW, dRR, dG): ~135 GFLOP, 0.137 ms at 989 TFLOP/s, against
// ~0.37 GB of inputs and outputs, 0.11 ms at 3.35 TB/s -- operations bound
// it.  This version recomputes the scores in both kernels (11 products) on
// the FP32 pipes, from shared memory; mma/wgmma tiles are the next step.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int NG = BQ + BK - 1; // distance-table rows a tile pair touches
constexpr int NT = 256;         // threads: a 16 x 16 grid, 4 x 4 scores each
constexpr int RQ = BQ / 16;     // query rows per thread
constexpr int CK = BK / 16;     // key columns per thread
constexpr int PS = BK + 1;      // row stride of the P / dS tiles

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

// rows [r0, r0 + n) of a [len, H] matrix into shared f32 rows of stride H+1,
// zero outside [0, len)
template <typename T, int H>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0, int n, int len) {
    for (int e = threadIdx.x; e < n * H; e += NT) {
        const int r = e / H, c = e % H, row = r0 + r;
        dst[r * (H + 1) + c] = (row >= 0 && row < len) ? to_f(src[(size_t)row * H + c]) : 0.f;
    }
}

// the 4 x 4 scores s (unscaled) and dp = dO.v of thread (tx, ty): rows
// ty + 16 i of the q tile, columns tx + 16 j of the key tile, G row 63 - qi + ki
template <int H>
__device__ __forceinline__ void scores(const float* sQw, const float* sQr, const float* sDO,
                                       const float* sK, const float* sV, const float* sG,
                                       int tx, int ty, float (&s)[RQ][CK], float (&dp)[RQ][CK]) {
    constexpr int HP = H + 1;
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = dp[i][j] = 0.f;
    const int g_base = (BQ - 1) - ty + tx;
#pragma unroll 4
    for (int h = 0; h < H; ++h) {
        float a[RQ], b[RQ], o[RQ], kv[CK], vv[CK], gv[RQ + CK - 1];
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
            a[i] = sQw[(ty + 16 * i) * HP + h];
            b[i] = sQr[(ty + 16 * i) * HP + h];
            o[i] = sDO[(ty + 16 * i) * HP + h];
        }
#pragma unroll
        for (int j = 0; j < CK; ++j) {
            kv[j] = sK[(tx + 16 * j) * HP + h];
            vv[j] = sV[(tx + 16 * j) * HP + h];
        }
#pragma unroll
        for (int dd = 0; dd < RQ + CK - 1; ++dd)
            gv[dd] = sG[(g_base + 16 * (dd - (RQ - 1))) * HP + h];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
            for (int j = 0; j < CK; ++j) {
                s[i][j] = fmaf(a[i], kv[j], fmaf(b[i], gv[j - i + RQ - 1], s[i][j]));
                dp[i][j] = fmaf(o[i], vv[j], dp[i][j]);
            }
    }
}

__device__ __forceinline__ bool visible(int q, int k, int T_, int S, int M, int mv, int window) {
    const int d = M + q - k;
    return q < T_ && k < S && d >= 0 && k >= M - mv && (window <= 0 || d < window);
}

template <int H>
constexpr size_t dkdv_smem_floats() {
    // sK, sV, sQw, sQr, sDO [64][H+1]; sG [127][H+1]; sP, sDS [64][65]; lse, delta
    return 5 * (size_t)BQ * (H + 1) + (size_t)NG * (H + 1) + 2 * (size_t)BQ * PS + 2 * BQ;
}

template <int H>
constexpr size_t dq_smem_floats() {
    // sQw, sQr, sDO, sK, sV [64][H+1]; sG [127][H+1]; sDS [64][65]; lse, delta
    return 5 * (size_t)BQ * (H + 1) + (size_t)NG * (H + 1) + (size_t)BQ * PS + 2 * BQ;
}

template <typename T, int H>
__global__ void __launch_bounds__(NT, 1)
k2_dkdv_kernel(const T* __restrict__ rw, const T* __restrict__ rr, const T* __restrict__ kk,
               const T* __restrict__ vv, const T* __restrict__ g, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv, const int* __restrict__ mv_ptr,
               int mv_const, int N, int T_, int S, int M, float scale, int window) {
    constexpr int HP = H + 1;
    constexpr int CH = H / 16;          // dk / dv columns per thread
    extern __shared__ float smem[];
    float* sK = smem;
    float* sV = sK + BK * HP;
    float* sQw = sV + BK * HP;
    float* sQr = sQw + BQ * HP;
    float* sDO = sQr + BQ * HP;
    float* sG = sDO + BQ * HP;
    float* sP = sG + NG * HP;
    float* sDS = sP + BQ * PS;
    float* sL = sDS + BQ * PS;
    float* sD = sL + BQ;

    const int bn = blockIdx.y;
    const int k0 = blockIdx.x * BK;
    const int head = bn % N;
    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int mv = mv_ptr ? *mv_ptr : mv_const;

    const T* rw_b = rw + (size_t)bn * T_ * H;
    const T* rr_b = rr + (size_t)bn * T_ * H;
    const T* do_b = dout + (size_t)bn * T_ * H;
    const float* lse_b = lse + (size_t)bn * T_;
    const float* dl_b = delta + (size_t)bn * T_;
    const T* g_h = g + (size_t)head * (T_ + S) * H;

    stage<T, H>(sK, kk + (size_t)bn * S * H, k0, BK, S);
    stage<T, H>(sV, vv + (size_t)bn * S * H, k0, BK, S);

    float acc_k[RQ][CH], acc_v[RQ][CH];     // key rows ty + 16 i, columns tx + 16 c
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < CH; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

    // q tiles that see some key of this tile
    const int k_last = min(k0 + BK, S) - 1;
    const int q_lo = max(0, k0 - M);
    int q_hi = T_;                                       // exclusive
    if (window > 0) q_hi = min(q_hi, window + k_last - M);
    const bool any = k_last >= M - mv && q_lo < q_hi;
    const int qt_begin = q_lo / BQ, qt_end = any ? (q_hi + BQ - 1) / BQ : qt_begin;

    for (int qt = qt_begin; qt < qt_end; ++qt) {
        const int q0 = qt * BQ;
        __syncthreads();                                 // previous tile's reads done
        stage<T, H>(sQw, rw_b, q0, BQ, T_);
        stage<T, H>(sQr, rr_b, q0, BQ, T_);
        stage<T, H>(sDO, do_b, q0, BQ, T_);
        stage<T, H>(sG, g_h, T_ - q0 - BQ + k0, NG, T_ + S);
        if (tid < BQ) {
            const int q = q0 + tid;
            sL[tid] = q < T_ ? lse_b[q] : 0.f;
            sD[tid] = q < T_ ? dl_b[q] : 0.f;
        }
        __syncthreads();

        float s[RQ][CK], dp[RQ][CK];
        scores<H>(sQw, sQr, sDO, sK, sV, sG, tx, ty, s, dp);
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
            const int qi = ty + 16 * i;
#pragma unroll
            for (int j = 0; j < CK; ++j) {
                const int ki = tx + 16 * j;
                const bool ok = visible(q0 + qi, k0 + ki, T_, S, M, mv, window);
                const float p = ok ? expf(s[i][j] * scale - sL[qi]) : 0.f;
                const float ds = p * (dp[i][j] - sD[qi]) * scale;
                sP[qi * PS + ki] = round_to<T>(p);
                sDS[qi * PS + ki] = round_to<T>(ds);
            }
        }
        __syncthreads();

#pragma unroll 4
        for (int qx = 0; qx < BQ; ++qx) {
            float o[CH], w[CH];
#pragma unroll
            for (int c = 0; c < CH; ++c) {
                o[c] = sDO[qx * HP + tx + 16 * c];
                w[c] = sQw[qx * HP + tx + 16 * c];
            }
#pragma unroll
            for (int i = 0; i < RQ; ++i) {
                const float p = sP[qx * PS + ty + 16 * i];
                const float ds = sDS[qx * PS + ty + 16 * i];
#pragma unroll
                for (int c = 0; c < CH; ++c) {
                    acc_v[i][c] = fmaf(p, o[c], acc_v[i][c]);
                    acc_k[i][c] = fmaf(ds, w[c], acc_k[i][c]);
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
        const int k = k0 + ty + 16 * i;
        if (k >= S) continue;
        float* dk_r = dk + ((size_t)bn * S + k) * H;
        float* dv_r = dv + ((size_t)bn * S + k) * H;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
            dk_r[tx + 16 * c] = acc_k[i][c];
            dv_r[tx + 16 * c] = acc_v[i][c];
        }
    }
}

template <typename T, int H>
__global__ void __launch_bounds__(NT, 1)
k2_dq_kernel(const T* __restrict__ rw, const T* __restrict__ rr, const T* __restrict__ kk,
             const T* __restrict__ vv, const T* __restrict__ g, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ drw, T* __restrict__ drr, float* __restrict__ dg,
             const int* __restrict__ mv_ptr, int mv_const, int N, int T_, int S, int M,
             float scale, int window) {
    constexpr int HP = H + 1;
    constexpr int CH = H / 16;          // drw / drr columns per thread
    extern __shared__ float smem[];
    float* sQw = smem;
    float* sQr = sQw + BQ * HP;
    float* sDO = sQr + BQ * HP;
    float* sK = sDO + BQ * HP;
    float* sV = sK + BK * HP;
    float* sG = sV + BK * HP;
    float* sDS = sG + NG * HP;
    float* sL = sDS + BQ * PS;
    float* sD = sL + BQ;

    const int bn = blockIdx.y;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest rows first
    const int head = bn % N;
    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int mv = mv_ptr ? *mv_ptr : mv_const;

    const T* k_b = kk + (size_t)bn * S * H;
    const T* v_b = vv + (size_t)bn * S * H;
    const T* g_h = g + (size_t)head * (T_ + S) * H;
    float* dg_h = dg + (size_t)head * (T_ + S) * H;

    stage<T, H>(sQw, rw + (size_t)bn * T_ * H, q0, BQ, T_);
    stage<T, H>(sQr, rr + (size_t)bn * T_ * H, q0, BQ, T_);
    stage<T, H>(sDO, dout + (size_t)bn * T_ * H, q0, BQ, T_);
    if (tid < BQ) {
        const int q = q0 + tid;
        sL[tid] = q < T_ ? lse[(size_t)bn * T_ + q] : 0.f;
        sD[tid] = q < T_ ? delta[(size_t)bn * T_ + q] : 0.f;
    }

    float acc_w[RQ][CH], acc_r[RQ][CH];     // q rows ty + 16 i, columns tx + 16 c
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < CH; ++c) acc_w[i][c] = acc_r[i][c] = 0.f;

    // keys any row of this tile can see (K1's range)
    const int q_last = min(q0 + BQ, T_) - 1;
    const int k_hi = min(S, M + q_last + 1);            // exclusive
    int k_lo = max(0, M - mv);
    if (window > 0) k_lo = max(k_lo, M + q0 - window + 1);
    const int kt_begin = k_lo / BK, kt_end = (k_hi + BK - 1) / BK;

    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k0 = kt * BK;
        const int u_lo = T_ - q0 - BQ + k0;             // G row of (qi = 63, ki = 0)
        __syncthreads();                                 // previous tile's reads done
        stage<T, H>(sK, k_b, k0, BK, S);
        stage<T, H>(sV, v_b, k0, BK, S);
        stage<T, H>(sG, g_h, u_lo, NG, T_ + S);
        __syncthreads();

        float s[RQ][CK], dp[RQ][CK];
        scores<H>(sQw, sQr, sDO, sK, sV, sG, tx, ty, s, dp);
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
            const int qi = ty + 16 * i;
#pragma unroll
            for (int j = 0; j < CK; ++j) {
                const int ki = tx + 16 * j;
                const bool ok = visible(q0 + qi, k0 + ki, T_, S, M, mv, window);
                const float p = ok ? expf(s[i][j] * scale - sL[qi]) : 0.f;
                sDS[qi * PS + ki] = round_to<T>(p * (dp[i][j] - sD[qi]) * scale);
            }
        }
        __syncthreads();

        // drw += ds k,  drr += ds G[63 - qi + ki]
#pragma unroll 4
        for (int kx = 0; kx < BK; ++kx) {
            float kv[CH];
#pragma unroll
            for (int c = 0; c < CH; ++c) kv[c] = sK[kx * HP + tx + 16 * c];
#pragma unroll
            for (int i = 0; i < RQ; ++i) {
                const int qi = ty + 16 * i;
                const float ds = sDS[qi * PS + kx];
                const float* grow = sG + (BQ - 1 - qi + kx) * HP + tx;
#pragma unroll
                for (int c = 0; c < CH; ++c) {
                    acc_w[i][c] = fmaf(ds, kv[c], acc_w[i][c]);
                    acc_r[i][c] = fmaf(ds, grow[16 * c], acc_r[i][c]);
                }
            }
        }

        // dG row u_lo + r (r = 63 - qi + ki) += sum over its diagonal of ds rr[qi]
        for (int e = tid; e < NG * H; e += NT) {
            const int r = e / H, c = e % H, u = u_lo + r;
            if (u < 0 || u >= T_ + S) continue;
            const int qi_lo = max(0, BQ - 1 - r), qi_hi = min(BQ - 1, BQ - 1 + BK - 1 - r);
            float acc = 0.f;
            for (int qi = qi_lo; qi <= qi_hi; ++qi)
                acc = fmaf(sDS[qi * PS + r - (BQ - 1) + qi], sQr[qi * HP + c], acc);
            if (acc != 0.f) atomicAdd(dg_h + (size_t)u * H + c, acc);
        }
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
        const int q = q0 + ty + 16 * i;
        if (q >= T_) continue;
        T* w_r = drw + ((size_t)bn * T_ + q) * H;
        T* r_r = drr + ((size_t)bn * T_ + q) * H;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
            w_r[tx + 16 * c] = from_f<T>(acc_w[i][c]);
            r_r[tx + 16 * c] = from_f<T>(acc_r[i][c]);
        }
    }
}

struct Args {
    const void *rw, *rr, *k, *v, *g, *dout, *lse, *delta;
    void *drw, *drr, *dk, *dv, *dg;
    const int* mv_ptr;
    int mv_const, BN, N, T, S, M;
    float scale;
    int window;
    cudaStream_t stream;
};

template <typename T, int H>
cudaError_t launch(const Args& a) {
    const size_t smem_kv = dkdv_smem_floats<H>() * sizeof(float);
    const size_t smem_q = dq_smem_floats<H>() * sizeof(float);
    auto kv = k2_dkdv_kernel<T, H>;
    auto kq = k2_dq_kernel<T, H>;
    cudaError_t err = cudaFuncSetAttribute(kv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem_kv);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
    if (err != cudaSuccess) return err;
    const T *rw = (const T*)a.rw, *rr = (const T*)a.rr, *k = (const T*)a.k, *v = (const T*)a.v,
            *g = (const T*)a.g, *dout = (const T*)a.dout;
    const float *lse = (const float*)a.lse, *delta = (const float*)a.delta;
    kv<<<dim3((a.S + BK - 1) / BK, a.BN), NT, smem_kv, a.stream>>>(
        rw, rr, k, v, g, dout, lse, delta, (float*)a.dk, (float*)a.dv, a.mv_ptr, a.mv_const,
        a.N, a.T, a.S, a.M, a.scale, a.window);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    kq<<<dim3((a.T + BQ - 1) / BQ, a.BN), NT, smem_q, a.stream>>>(
        rw, rr, k, v, g, dout, lse, delta, (T*)a.drw, (T*)a.drr, (float*)a.dg, a.mv_ptr,
        a.mv_const, a.N, a.T, a.S, a.M, a.scale, a.window);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_h(int H, const Args& a) {
    switch (H) {
        case 16: return launch<T, 16>(a);
        case 32: return launch<T, 32>(a);
        case 64: return launch<T, 64>(a);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// rw/rr/dout [BN, T, H], k/v [BN, S, H], g [N, T+S, H] in one dtype (0 = f32,
// 1 = bf16); lse/delta [BN, T] f32.  Writes drw/drr [BN, T, H] in that dtype,
// dk/dv [BN, S, H] f32, and ADDS into dg [N, T+S, H] f32 (the caller zeroes
// it).  mem_valid is read from the device int32 at mv_ptr, or is mv_const
// when mv_ptr is null; window <= 0 is no window.  Launches both kernels on
// `stream`; returns the first cudaGetLastError() that is not cudaSuccess.
extern "C" int flash_rel_attn_bwd(const void* rw, const void* rr, const void* k, const void* v,
                                  const void* g, const void* dout, const void* lse,
                                  const void* delta, void* drw, void* drr, void* dk, void* dv,
                                  void* dg, const void* mv_ptr, int mv_const, int BN, int N,
                                  int T, int S, int M, int H, int dtype, float scale,
                                  int window, void* stream) {
    Args a{rw, rr, k, v, g, dout, lse, delta, drw, drr, dk, dv, dg, (const int*)mv_ptr,
           mv_const, BN, N, T, S, M, scale, window, (cudaStream_t)stream};
    if (dtype == 0) return (int)launch_h<float>(H, a);
    if (dtype == 1) return (int)launch_h<__nv_bfloat16>(H, a);
    return (int)cudaErrorInvalidValue;
}
