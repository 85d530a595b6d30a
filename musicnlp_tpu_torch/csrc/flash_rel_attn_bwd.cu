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
// Two kernels, in both dtypes.  The TPU grid runs in order and keeps
// dk / dv resident across a (b*n) window; Hopper blocks run in no order, so
// the work is split in two:
//   dkdv: one block per (bn, 64-key tile); loops over the q tiles that see
//         the tile, keeps dk / dv in registers, writes them once.
//   dq:   one block per (bn, 64-row q tile); loops over the key tiles the
//         rows see (the tiles K1 visits), keeps drw / drr in registers, and
//         adds the tile pair's 127 diagonal rows of dG into a zeroed f32
//         buffer with atomics (summation order varies from run to run).
// Tiles in the future, behind the window or inside the empty memory slots
// are skipped, as in K1; ragged T and S are zero-filled and masked.
//
// f32 (k2_dkdv_kernel, k2_dq_kernel): operands sit in shared memory as f32
// rows padded to H+1 floats; products are f32 FMAs (150 KB / 133 KB of
// shared memory at H = 64, one 256-thread block per SM).  Kept as it is: the
// f32 parity of the tests rests on it, and TF32 would break it.
//
// bf16 (k2_dkdv_tc, k2_dq_tc), the training path: every product (AC, BD, dP,
// dV, dK, dRW, dRR, dG) is an mma.sync m16n8k16 (bf16 in, f32 accumulate) on
// ldmatrix fragments (mma_bf16.cuh); p and ds are rounded to bf16 where
// they enter a product, which is where the TPU kernel rounds them.  Four
// warps per block, warp w owns q rows 16w..16w+15 of a tile.  Operands sit
// in shared memory as bf16 rows of stride H+8 (ldmatrix without bank
// conflicts), loaded by cp.async with zero fill of rows outside [0, len):
// the next q tile's Qw / dO (dkdv) or key tile's K / V (dq) go into a second
// buffer while the current tile computes.  The relative-position skew
// follows the TPU kernel (rr . [G1; G2]^T, then a roll): BD of a tile pair
// is Qr . Gwin^T over the window Gwin of 128 table rows from u_lo = T - q0 -
// 64 + k0, staged as f32 in the warp's scratch and read at column 63 - qi +
// ki (warp w needs only columns [48 - 16w, 128 - 16w)).  Consecutive tiles'
// windows overlap by 64 rows, so Gwin lives in a ring of three 64-row slabs
// and each tile loads only its new slab.  In the dq kernel ds is scattered
// into a zero-filled bf16 tile dSskew [64 x 128], dSskew[qi][63 - qi + ki] =
// ds, so that drr = dSskew . Gwin and the window of dG is dSskew^T . Qr.
// The windows slide up by 64 rows per key tile, so rows [u_lo, u_lo + 64)
// are final after each one: the dG window is two 64-row halves of f32
// accumulators that swap roles; the finished half is added to device memory
// by float2 atomics and zeroed, the other carried (both flushed at the end).
// A warp's scratch holds its BD staging, then its rows of dSskew (dq) or of
// P and dS (dkdv), which all warps read after a barrier.  Shared memory at
// H = 64: 111 KB in each kernel, so two blocks (eight warps) run per SM.
//
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "row_dot.cuh"

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

// ------------------------------------------------- bf16 on the tensor cores
namespace tc {

using bf16 = __nv_bfloat16;
using namespace mma_bf16;

constexpr int NW = 4;            // warps; warp w owns q rows 16w..16w+15 of a tile
constexpr int NTC = 32 * NW;
constexpr int GW = 128;          // distance-table window rows per tile pair (127 used)
constexpr int XW = 80;           // BD columns warp w needs: [48 - 16w, 128 - 16w)
constexpr int XS = XW + 4;       // f32 row stride of a warp's BD staging
constexpr int DSS = GW + 8;      // bf16 row stride of dSskew
constexpr int PS2 = BK + 8;      // bf16 row stride of P / dS
// a warp's scratch: its BD staging [16][XS] f32, later (dq) its rows of
// dSskew [16][DSS] or (dkdv) of P and dS [16][PS2] bf16
constexpr int UNION = 16 * XS * 4;
static_assert(16 * DSS * 2 <= UNION && 2 * 16 * PS2 * 2 <= UNION, "warp scratch");

// The 128-row window sits in a ring of three 64-row slabs; `gs` holds the
// slabs of window rows [0, 64) and [64, 128).  Rows r .. r+15 of the window:
__device__ __forceinline__ const bf16* grow(const bf16* const (&gs)[2], int r, int HS) {
    return gs[r >> 6] + (r & 63) * HS;
}

// X = Qr[16w, 16w+16) . Gwin[48 - 16w, 128 - 16w)^T into the warp's f32
// staging sXw [16][XS]; BD[qi][ki] is then sXw[qr][15 - qr + ki], qi = 16w + qr
template <int H>
__device__ __forceinline__ void bd_window(float* sXw, const bf16* sQr,
                                          const bf16* const (&gs)[2], int w, int lane) {
    constexpr int HS = H + 8;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int np = 0; np < XW / 16; ++np) {
        const bf16* gr = grow(gs, 48 - 16 * w + 16 * np, HS);
        float x[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < H / 16; ++kk) {
            uint32_t a[4], b[4];
            load_a(a, sQr, HS, 16 * w, 16 * kk, lane);
            load_b(b, gr, HS, 0, 16 * kk, lane);
            mma(x[0], a, b[0], b[1]);
            mma(x[1], a, b[2], b[3]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int c = 16 * np + 8 * h + 2 * t;
            *reinterpret_cast<float2*>(sXw + g * XS + c) = make_float2(x[h][0], x[h][1]);
            *reinterpret_cast<float2*>(sXw + (g + 8) * XS + c) = make_float2(x[h][2], x[h][3]);
        }
    }
}

// S = Qw . K^T and dP = dO . V^T for the warp's 16 q rows over the 64 keys
// (C tiles: key columns 8j .. 8j+7)
template <int H>
__device__ __forceinline__ void qk_dov(float (&s)[8][4], float (&dp)[8][4], const bf16* sQw,
                                       const bf16* sDO, const bf16* sK, const bf16* sV, int w,
                                       int lane) {
    constexpr int HS = H + 8;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk) {
        uint32_t aw[4], ao[4];
        load_a(aw, sQw, HS, 16 * w, 16 * kk, lane);
        load_a(ao, sDO, HS, 16 * w, 16 * kk, lane);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
            uint32_t bk[4], bv[4];
            load_b(bk, sK, HS, 16 * np, 16 * kk, lane);
            load_b(bv, sV, HS, 16 * np, 16 * kk, lane);
            mma(s[2 * np], aw, bk[0], bk[1]);
            mma(s[2 * np + 1], aw, bk[2], bk[3]);
            mma(dp[2 * np], ao, bv[0], bv[1]);
            mma(dp[2 * np + 1], ao, bv[2], bv[3]);
        }
    }
}

// p and ds of the warp's entries in place of s and dp (f32; `pack` rounds
// them to bf16 where they enter a product); lse / delta of rows g and g + 8
// in l / dl; `full`: every pair of the tile is visible
__device__ __forceinline__ void p_ds(float (&s)[8][4], float (&dp)[8][4], const float* sXw,
                                     int q0, int k0, int w, int lane, const float (&l)[2],
                                     const float (&dl)[2], int T_, int S, int M, int mv,
                                     float scale, int window, bool full) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int qr = g + 8 * (e >> 1), ki = 8 * j + 2 * t + (e & 1);
            const float bd = sXw[qr * XS + 15 - qr + ki];
            const bool ok = full || visible(q0 + 16 * w + qr, k0 + ki, T_, S, M, mv, window);
            const float p = ok ? expf((s[j][e] + bd) * scale - l[e >> 1]) : 0.f;
            const float ds = p * (dp[j][e] - dl[e >> 1]) * scale;
            s[j][e] = p;
            dp[j][e] = ds;
        }
}

// every (q, k) pair of the tile pair (q0, k0) is visible
__device__ __forceinline__ bool tile_full(int q0, int k0, int T_, int S, int M, int mv,
                                          int window) {
    return q0 + BQ <= T_ && k0 + BK <= S && M + q0 - (k0 + BK - 1) >= 0 && k0 >= M - mv &&
           (window <= 0 || M + q0 + BQ - 1 - k0 < window);
}

// lse and delta of the warp's rows 16w + g (+8) of the q tile at q0
__device__ __forceinline__ void row_stats(float (&l)[2], float (&dl)[2], const float* lse_b,
                                          const float* dl_b, int q0, int w, int lane, int T_) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int q = q0 + 16 * w + (lane >> 2) + 8 * h;
        l[h] = q < T_ ? lse_b[q] : 0.f;
        dl[h] = q < T_ ? dl_b[q] : 0.f;
    }
}

template <int H>
constexpr size_t dkdv_smem_bytes() {
    // sK, sV; 2 stages of Qw, dO; Qr; the G ring (192 rows), all [.][H+8]
    // bf16; the warps' scratch
    return 2 * (size_t)(2 * BK + 2 * 2 * BQ + BQ + 3 * 64) * (H + 8) + (size_t)NW * UNION;
}

template <int H>
constexpr size_t dq_smem_bytes() {
    // sQw, sQr, sDO; 2 stages of K, V; the G ring (192 rows), all [.][H+8]
    // bf16; the warps' scratch
    return 2 * (size_t)(3 * BQ + 2 * 2 * BK + 3 * 64) * (H + 8) + (size_t)NW * UNION;
}

template <int H>
__global__ void __launch_bounds__(NTC, 2)
k2_dkdv_tc(const bf16* __restrict__ rw, const bf16* __restrict__ rr, const bf16* __restrict__ kk,
           const bf16* __restrict__ vv, const bf16* __restrict__ g, const bf16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dk, float* __restrict__ dv, const int* __restrict__ mv_ptr,
           int mv_const, int N, int T_, int S, int M, float scale, int window) {
    constexpr int HS = H + 8;
    constexpr int STAGE = 2 * BQ * HS;              // Qw, dO
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sK = reinterpret_cast<bf16*>(smem_raw);
    bf16* sV = sK + BK * HS;
    bf16* sQ = sV + BK * HS;                        // stage b: Qw, dO
    bf16* sQr = sQ + 2 * STAGE;
    bf16* sGr = sQr + BQ * HS;                      // ring of 3 slabs [64][HS]
    unsigned char* scratch = reinterpret_cast<unsigned char*>(sGr + 3 * 64 * HS);
    // warp v's rows of P and dS
    auto sP_of = [&](int v) { return reinterpret_cast<bf16*>(scratch + v * UNION); };
    auto sDS_of = [&](int v) { return sP_of(v) + 16 * PS2; };

    const int bn = blockIdx.y;
    const int k0 = blockIdx.x * BK;
    const int head = bn % N;
    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
    const int gq = lane >> 2, t = lane & 3;
    const int mv = mv_ptr ? *mv_ptr : mv_const;
    float* sXw = reinterpret_cast<float*>(scratch + w * UNION);

    const bf16* rw_b = rw + (size_t)bn * T_ * H;
    const bf16* rr_b = rr + (size_t)bn * T_ * H;
    const bf16* do_b = dout + (size_t)bn * T_ * H;
    const float* lse_b = lse + (size_t)bn * T_;
    const float* dl_b = delta + (size_t)bn * T_;
    const bf16* g_h = g + (size_t)head * (T_ + S) * H;

    // q tiles that see some key of this tile
    const int k_last = min(k0 + BK, S) - 1;
    const int q_lo = max(0, k0 - M);
    int q_hi = T_;                                       // exclusive
    if (window > 0) q_hi = min(q_hi, window + k_last - M);
    const bool any = k_last >= M - mv && q_lo < q_hi;
    const int qt_begin = q_lo / BQ, qt_end = any ? (q_hi + BQ - 1) / BQ : qt_begin;

    // the window slides down 64 rows per q tile: at step `it`, window rows
    // [64s, 64s + 64) are slab (s - it) mod 3, the lower one new each step
    auto slab = [&](int s, int it) { return sGr + (((s - it) % 3 + 3) % 3) * 64 * HS; };
    auto load_q = [&](int qt, bool first) {          // Qw, dO, the new G slab(s) of tile qt
        const int q0 = qt * BQ, it = qt - qt_begin, u_lo = T_ - q0 - BQ + k0;
        bf16* st = sQ + (it & 1) * STAGE;
        stage_rows<H>(st, rw_b, q0, BQ, T_, tid, NTC);
        stage_rows<H>(st + BQ * HS, do_b, q0, BQ, T_, tid, NTC);
        stage_rows<H>(slab(0, it), g_h, u_lo, 64, T_ + S, tid, NTC);
        if (first) stage_rows<H>(slab(1, it), g_h, u_lo + 64, 64, T_ + S, tid, NTC);
        cp_commit();
    };

    float dka[H / 8][4] = {}, dva[H / 8][4] = {};   // key rows 16w + g (+8), cols 8n + 2t
    if (qt_begin < qt_end) {
        stage_rows<H>(sK, kk + (size_t)bn * S * H, k0, BK, S, tid, NTC);
        stage_rows<H>(sV, vv + (size_t)bn * S * H, k0, BK, S, tid, NTC);
        stage_rows<H>(sQr, rr_b, qt_begin * BQ, BQ, T_, tid, NTC);
        load_q(qt_begin, true);
    }
    for (int qt = qt_begin; qt < qt_end; ++qt) {
        const int it = qt - qt_begin, q0 = qt * BQ;
        cp_wait<0>();
        __syncthreads();                 // tile qt landed; every warp is done with tile qt - 1
        if (qt + 1 < qt_end) load_q(qt + 1, false);
        const bf16* sQw = sQ + (it & 1) * STAGE;
        const bf16* sDO = sQw + BQ * HS;
        const bf16* const gs[2] = {slab(0, it), slab(1, it)};
        float l2[2], d2[2];
        row_stats(l2, d2, lse_b, dl_b, q0, w, lane, T_);

        bd_window<H>(sXw, sQr, gs, w, lane);
        __syncwarp();
        float s[8][4], dp[8][4];
        qk_dov<H>(s, dp, sQw, sDO, sK, sV, w, lane);
        p_ds(s, dp, sXw, q0, k0, w, lane, l2, d2, T_, S, M, mv, scale, window,
             tile_full(q0, k0, T_, S, M, mv, window));
        __syncwarp();                    // the warp's BD reads are done: its scratch takes P / dS
        bf16* myP = sP_of(w);
        bf16* myDS = sDS_of(w);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int o = (gq + 8 * h) * PS2 + 8 * j + 2 * t;
                *reinterpret_cast<uint32_t*>(myP + o) = pack(s[j][2 * h], s[j][2 * h + 1]);
                *reinterpret_cast<uint32_t*>(myDS + o) = pack(dp[j][2 * h], dp[j][2 * h + 1]);
            }
        __syncthreads();                 // every warp's P / dS rows are written, Qr read
        if (qt + 1 < qt_end) {
            stage_rows<H>(sQr, rr_b, q0 + BQ, BQ, T_, tid, NTC);
            cp_commit();
        }

        // dv += P^T dO, dk += dS^T Qw over the tile's 64 q rows (16 per
        // warp's scratch): key rows 16w..
#pragma unroll
        for (int kq = 0; kq < BQ / 16; ++kq) {
            uint32_t ap[4], ad[4];
            load_at(ap, sP_of(kq), PS2, 16 * w, 0, lane);
            load_at(ad, sDS_of(kq), PS2, 16 * w, 0, lane);
#pragma unroll
            for (int np = 0; np < H / 16; ++np) {
                uint32_t bo[4], bq[4];
                load_bt(bo, sDO, HS, 16 * np, 16 * kq, lane);
                load_bt(bq, sQw, HS, 16 * np, 16 * kq, lane);
                mma(dva[2 * np], ap, bo[0], bo[1]);
                mma(dva[2 * np + 1], ap, bo[2], bo[3]);
                mma(dka[2 * np], ad, bq[0], bq[1]);
                mma(dka[2 * np + 1], ad, bq[2], bq[3]);
            }
        }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int k = k0 + 16 * w + gq + 8 * h;
        if (k >= S) continue;
        float* dk_r = dk + ((size_t)bn * S + k) * H;
        float* dv_r = dv + ((size_t)bn * S + k) * H;
#pragma unroll
        for (int n = 0; n < H / 8; ++n) {
            *reinterpret_cast<float2*>(dk_r + 8 * n + 2 * t) =
                make_float2(dka[n][2 * h], dka[n][2 * h + 1]);
            *reinterpret_cast<float2*>(dv_r + 8 * n + 2 * t) =
                make_float2(dva[n][2 * h], dva[n][2 * h + 1]);
        }
    }
}

template <int H>
__global__ void __launch_bounds__(NTC, 2)
k2_dq_tc(const bf16* __restrict__ rw, const bf16* __restrict__ rr, const bf16* __restrict__ kk,
         const bf16* __restrict__ vv, const bf16* __restrict__ g, const bf16* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ drw,
         bf16* __restrict__ drr, float* __restrict__ dg, const int* __restrict__ mv_ptr,
         int mv_const, int N, int T_, int S, int M, float scale, int window) {
    constexpr int HS = H + 8;
    constexpr int STAGE = 2 * BK * HS;              // K, V
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sQw = reinterpret_cast<bf16*>(smem_raw);
    bf16* sQr = sQw + BQ * HS;
    bf16* sDO = sQr + BQ * HS;
    bf16* sKV = sDO + BQ * HS;                      // stage b: K, V
    bf16* sGr = sKV + 2 * STAGE;                    // ring of 3 slabs [64][HS]
    unsigned char* scratch = reinterpret_cast<unsigned char*>(sGr + 3 * 64 * HS);
    // warp v's rows of dSskew (q rows 16v..16v+15)
    auto dsk_of = [&](int v) { return reinterpret_cast<bf16*>(scratch + v * UNION); };

    const int bn = blockIdx.y;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest rows first
    const int head = bn % N;
    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
    const int gq = lane >> 2, t = lane & 3;
    const int mv = mv_ptr ? *mv_ptr : mv_const;
    float* sXw = reinterpret_cast<float*>(scratch + w * UNION);
    bf16* dsk = dsk_of(w);

    const bf16* k_b = kk + (size_t)bn * S * H;
    const bf16* v_b = vv + (size_t)bn * S * H;
    const bf16* g_h = g + (size_t)head * (T_ + S) * H;
    float* dg_h = dg + (size_t)head * (T_ + S) * H;

    // keys any row of this tile can see (K1's range)
    const int q_last = min(q0 + BQ, T_) - 1;
    const int k_hi = min(S, M + q_last + 1);            // exclusive
    int k_lo = max(0, M - mv);
    if (window > 0) k_lo = max(k_lo, M + q0 - window + 1);
    const int kt_begin = k_lo / BK, kt_end = (k_hi + BK - 1) / BK;

    // the window slides up 64 rows per key tile: at step `it`, window rows
    // [64s, 64s + 64) are slab (it + s) mod 3, the upper one new each step
    auto slab = [&](int s, int it) { return sGr + ((it + s) % 3) * 64 * HS; };
    auto load_k = [&](int kt, bool first) {          // K, V, the new G slab(s) of tile kt
        const int k0 = kt * BK, it = kt - kt_begin, u_lo = T_ - q0 - BQ + k0;
        bf16* st = sKV + (it & 1) * STAGE;
        stage_rows<H>(st, k_b, k0, BK, S, tid, NTC);
        stage_rows<H>(st + BK * HS, v_b, k0, BK, S, tid, NTC);
        if (first) stage_rows<H>(slab(0, it), g_h, u_lo, 64, T_ + S, tid, NTC);
        stage_rows<H>(slab(1, it), g_h, u_lo + 64, 64, T_ + S, tid, NTC);
        cp_commit();
    };

    float l2[2], d2[2];
    row_stats(l2, d2, lse + (size_t)bn * T_, delta + (size_t)bn * T_, q0, w, lane, T_);
    float dwa[H / 8][4] = {}, dra[H / 8][4] = {};   // q rows 16w + g (+8), cols 8n + 2t
    float dga[2][H / 8][4] = {};                    // the warp's 32 rows of the dG window

    // the warp's 32 dG rows [u0, u0 + 32) (16 mb + g + 8h) into device memory
    auto flush = [&](int u0) {
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int u = u0 + 16 * mb + gq + 8 * h;
                if (u < 0 || u >= T_ + S) continue;
#pragma unroll
                for (int n = 0; n < H / 8; ++n) {
                    const float2 v = make_float2(dga[mb][n][2 * h], dga[mb][n][2 * h + 1]);
                    if (v.x != 0.f || v.y != 0.f)
                        atomicAdd(reinterpret_cast<float2*>(dg_h + (size_t)u * H + 8 * n + 2 * t),
                                  v);
                }
            }
    };

    if (kt_begin < kt_end) {
        stage_rows<H>(sQw, rw + (size_t)bn * T_ * H, q0, BQ, T_, tid, NTC);
        stage_rows<H>(sQr, rr + (size_t)bn * T_ * H, q0, BQ, T_, tid, NTC);
        stage_rows<H>(sDO, dout + (size_t)bn * T_ * H, q0, BQ, T_, tid, NTC);
        load_k(kt_begin, true);
    }
    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int it = kt - kt_begin, k0 = kt * BK;
        const int u_lo = T_ - q0 - BQ + k0;             // G row of window row 0
        cp_wait<0>();
        __syncthreads();                 // tile kt landed; every warp is done with tile kt - 1
        if (kt + 1 < kt_end) load_k(kt + 1, false);
        const bf16* sK = sKV + (it & 1) * STAGE;
        const bf16* sV = sK + BK * HS;
        const bf16* const gs[2] = {slab(0, it), slab(1, it)};

        bd_window<H>(sXw, sQr, gs, w, lane);
        __syncwarp();
        float s[8][4], dp[8][4];
        qk_dov<H>(s, dp, sQw, sDO, sK, sV, w, lane);
        p_ds(s, dp, sXw, q0, k0, w, lane, l2, d2, T_, S, M, mv, scale, window,
             tile_full(q0, k0, T_, S, M, mv, window));

        // drw += dS . K
#pragma unroll
        for (int kk2 = 0; kk2 < BK / 16; ++kk2) {
            uint32_t a[4];
            c_to_a(a, dp[2 * kk2], dp[2 * kk2 + 1]);
#pragma unroll
            for (int np = 0; np < H / 16; ++np) {
                uint32_t bk[4];
                load_bt(bk, sK, HS, 16 * np, 16 * kk2, lane);
                mma(dwa[2 * np], a, bk[0], bk[1]);
                mma(dwa[2 * np + 1], a, bk[2], bk[3]);
            }
        }

        // the warp's scratch takes its rows of dSskew: zero, then
        // dSskew[qi][63 - qi + ki] = ds
        __syncwarp();                    // the warp's BD reads are done
        for (int e = lane; e < 16 * GW / 8; e += 32)
            *reinterpret_cast<uint4*>(dsk + (e / (GW / 8)) * DSS + (e % (GW / 8)) * 8) =
                make_uint4(0, 0, 0, 0);
        __syncwarp();
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int qr = gq + 8 * (e >> 1), ki = 8 * j + 2 * t + (e & 1);
                dsk[qr * DSS + 63 - 16 * w - qr + ki] = __float2bfloat16(dp[j][e]);
            }
        __syncwarp();

        // drr += dSskew . Gwin over the warp's band of window rows [48 - 16w, 128 - 16w)
#pragma unroll
        for (int kr = 0; kr < XW / 16; ++kr) {
            const int r0 = 48 - 16 * w + 16 * kr;
            const bf16* gr = grow(gs, r0, HS);
            uint32_t a[4];
            load_a(a, dsk, DSS, 0, r0, lane);
#pragma unroll
            for (int np = 0; np < H / 16; ++np) {
                uint32_t bg[4];
                load_bt(bg, gr, HS, 16 * np, 0, lane);
                mma(dra[2 * np], a, bg[0], bg[1]);
                mma(dra[2 * np + 1], a, bg[2], bg[3]);
            }
        }
        __syncthreads();                 // every warp's dSskew rows are written

        // dG window rows [rb, rb + 32) += dSskew^T . Qr, summed over the 64 q
        // rows (16 per warp's scratch); the half (rb / 64) that holds rows
        // [u_lo, u_lo + 64) is final
        const int half = ((w >> 1) ^ it) & 1, rb = 64 * half + 32 * (w & 1);
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
            const int r0 = rb + 16 * mb;
#pragma unroll
            for (int kq = 0; kq < BQ / 16; ++kq) {
                // window row r holds q rows [63 - r, 126 - r]: skip blocks outside
                if (16 * kq > 126 - r0 || 16 * kq + 15 < 48 - r0) continue;
                uint32_t a[4];
                load_at(a, dsk_of(kq), DSS, r0, 0, lane);
#pragma unroll
                for (int np = 0; np < H / 16; ++np) {
                    uint32_t bq[4];
                    load_bt(bq, sQr, HS, 16 * np, 16 * kq, lane);
                    mma(dga[mb][2 * np], a, bq[0], bq[1]);
                    mma(dga[mb][2 * np + 1], a, bq[2], bq[3]);
                }
            }
        }
        if (half == 0) {
            flush(u_lo + rb);
#pragma unroll
            for (int mb = 0; mb < 2; ++mb)
#pragma unroll
                for (int n = 0; n < H / 8; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e) dga[mb][n][e] = 0.f;
        }
    }
    if (kt_begin < kt_end) {             // the last window's upper half
        const int it = kt_end - 1 - kt_begin;
        const int half = ((w >> 1) ^ it) & 1;
        if (half == 1) flush(T_ - q0 - BQ + (kt_end - 1) * BK + 64 + 32 * (w & 1));
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int q = q0 + 16 * w + gq + 8 * h;
        if (q >= T_) continue;
        bf16* w_r = drw + ((size_t)bn * T_ + q) * H;
        bf16* r_r = drr + ((size_t)bn * T_ + q) * H;
#pragma unroll
        for (int n = 0; n < H / 8; ++n) {
            *reinterpret_cast<uint32_t*>(w_r + 8 * n + 2 * t) = pack(dwa[n][2 * h], dwa[n][2 * h + 1]);
            *reinterpret_cast<uint32_t*>(r_r + 8 * n + 2 * t) = pack(dra[n][2 * h], dra[n][2 * h + 1]);
        }
    }
}

}  // namespace tc

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

template <int H>
cudaError_t launch_tc(const Args& a) {
    using tc::bf16;
    const size_t smem_kv = tc::dkdv_smem_bytes<H>(), smem_q = tc::dq_smem_bytes<H>();
    auto kv = tc::k2_dkdv_tc<H>;
    auto kq = tc::k2_dq_tc<H>;
    cudaError_t err = cudaFuncSetAttribute(kv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem_kv);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
    if (err != cudaSuccess) return err;
    const bf16 *rw = (const bf16*)a.rw, *rr = (const bf16*)a.rr, *k = (const bf16*)a.k,
               *v = (const bf16*)a.v, *g = (const bf16*)a.g, *dout = (const bf16*)a.dout;
    const float *lse = (const float*)a.lse, *delta = (const float*)a.delta;
    kv<<<dim3((a.S + BK - 1) / BK, a.BN), tc::NTC, smem_kv, a.stream>>>(
        rw, rr, k, v, g, dout, lse, delta, (float*)a.dk, (float*)a.dv, a.mv_ptr, a.mv_const,
        a.N, a.T, a.S, a.M, a.scale, a.window);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    kq<<<dim3((a.T + BQ - 1) / BQ, a.BN), tc::NTC, smem_q, a.stream>>>(
        rw, rr, k, v, g, dout, lse, delta, (bf16*)a.drw, (bf16*)a.drr, (float*)a.dg, a.mv_ptr,
        a.mv_const, a.N, a.T, a.S, a.M, a.scale, a.window);
    return cudaGetLastError();
}

cudaError_t launch_tc_h(int H, const Args& a) {
    switch (H) {
        case 16: return launch_tc<16>(a);
        case 32: return launch_tc<32>(a);
        case 64: return launch_tc<64>(a);
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
// f32 runs the FMA kernels, bf16 the tensor-core ones.
extern "C" int flash_rel_attn_bwd(const void* rw, const void* rr, const void* k, const void* v,
                                  const void* g, const void* dout, const void* lse,
                                  const void* delta, void* drw, void* drr, void* dk, void* dv,
                                  void* dg, const void* mv_ptr, int mv_const, int BN, int N,
                                  int T, int S, int M, int H, int dtype, float scale,
                                  int window, void* stream) {
    Args a{rw, rr, k, v, g, dout, lse, delta, drw, drr, dk, dv, dg, (const int*)mv_ptr,
           mv_const, BN, N, T, S, M, scale, window, (cudaStream_t)stream};
    if (dtype == 0) return (int)launch_h<float>(H, a);
    if (dtype == 1) return (int)launch_tc_h(H, a);
    return (int)cudaErrorInvalidValue;
}

// delta[r] = dout[r] . out[r] in f32 over rows [rows, H] of one dtype (0 =
// f32, 1 = bf16): the input `delta` of flash_rel_attn_bwd, for its wrapper.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int flash_rel_attn_bwd_delta(const void* dout, const void* out, void* delta,
                                        long long rows, int H, int dtype, void* stream) {
    return (int)row_dot::launch(dout, out, (float*)delta, rows, H, dtype,
                                (cudaStream_t)stream);
}
