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
// Design (no atomics).  The TPU grid runs in order and lands each program's
// overlapping window gradients on resident [T, D] accumulators; Hopper
// blocks run in no order, so a block owns the dq rows of its query chunks
// and the dk / dv rows of its key chunks, and every output row is written
// once.  The tiles that feed chunk j:
//   (queries j,   keys j-1) -> dq_j        (none for j = 0: zero keys)
//   (queries j,   keys j)   -> dq_j, dk_j, dv_j
//   (queries j+1, keys j)   -> dk_j, dv_j  (none for the last chunk)
//
// f32 (chunked_window_attn_bwd_kernel): one 256-thread block per (g, chunk
// j) walks those three tiles; it stages Q, dO, K and V as f32 rows padded to
// D+1 floats, computes s and dp with f32 FMAs, writes rounded p and ds to
// shared memory and adds their products into register accumulators (~101 KB
// of shared memory at C = D = 64, two blocks per SM).  Kept as it is: the
// f32 parity of the tests rests on it.
//
// bf16 (k4_tc), the training path: one block of C / 16 warps per (g, run of
// RUN = 16 consecutive chunks).  It walks the run's chunks in order: the
// tile (j+1, j) gives dk_j / dv_j and also dq_{j+1}, carried to the next
// chunk, so a chunk costs two tiles, not three (plus one look-back tile per
// run for the run's first dq).  Warp w owns query rows 16w.. for S, dP and
// dq and key rows 16w.. for dk and dv.  S = Q K^T, dP = dO V^T, dq += dS K,
// dv += P^T dO and dk += dS^T Q are mma.sync m16n8k16 products (bf16 in, f32
// accumulate; mma_bf16.cuh); the masks, self_bias, the finite NEG_INF, the
// lse cotangent and the exp stay f32 on the accumulator fragments, and p and
// ds are rounded to bf16 where they enter a product, as on the TPU.  Q / dO
// (3 slots) and K / V (2 slots) sit in shared memory as bf16 rows of stride
// D+8; each chunk is loaded once per run by cp.async, the next chunk's while
// the current one's tiles compute.  Shared memory ~111 KB at C = D = 64: two
// blocks (eight warps) per SM.
//
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"
#include "row_dot.cuh"

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

// ------------------------------------------------- bf16 on the tensor cores
namespace tc {

using bf16 = __nv_bfloat16;
using namespace mma_bf16;

constexpr int RUN = 16;                 // consecutive chunks per block

template <int C, int D>
constexpr size_t smem_bytes() {
    // Q, dO [3 slots][C][D+8]; K, V [2 slots][C][D+8]; P, dS [C][C+8] bf16;
    // lse, delta, dlse, qpos [3][C]; kpos [2][C]
    return 2 * (10 * (size_t)C * (D + 8) + 2 * (size_t)C * (C + 8)) + 4 * (4 * 3 * C + 2 * C);
}

template <int C, int D>
__global__ void __launch_bounds__(2 * C, 2)
k4_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
      const bf16* __restrict__ dout, const int* __restrict__ qpos, const int* __restrict__ kpos,
      const float* __restrict__ lse, const float* __restrict__ delta,
      const float* __restrict__ dlse, bf16* __restrict__ dq, float* __restrict__ dk,
      float* __restrict__ dv, int T_, float scale, float self_bias) {
    constexpr int NT = 2 * C;           // C / 16 warps
    constexpr int DS = D + 8, PS = C + 8;
    constexpr int NB = C / 8;           // key columns: C tiles of 8
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // [3][C][DS]: query chunk c in slot c % 3
    bf16* sO = sQ + 3 * C * DS;                     // dO, the same slots
    bf16* sK = sO + 3 * C * DS;                     // [2][C][DS]: key chunk c in slot c % 2
    bf16* sV = sK + 2 * C * DS;
    bf16* sP = sV + 2 * C * DS;                     // [C][PS]
    bf16* sDS = sP + C * PS;
    float* sL = reinterpret_cast<float*>(sDS + C * PS);  // [3][C] each, per query slot
    float* sDe = sL + 3 * C;
    float* sDl = sDe + 3 * C;
    int* sQp = reinterpret_cast<int*>(sDl + 3 * C);
    int* sKp = sQp + 3 * C;                         // [2][C], per key slot

    const int gr = blockIdx.y, n = T_ / C;
    const int j0 = blockIdx.x * RUN, j1 = min(j0 + RUN, n);
    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
    const int gq = lane >> 2, t = lane & 3;
    const size_t base = (size_t)gr * T_;

    auto load_q = [&](int c) {                      // query chunk c -> slot c % 3
        const int slot = c % 3;
        stage_rows<D>(sQ + slot * C * DS, q + base * D, c * C, C, T_, tid, NT);
        stage_rows<D>(sO + slot * C * DS, dout + base * D, c * C, C, T_, tid, NT);
        for (int e = tid; e < C; e += NT) {
            const size_t r = base + (size_t)c * C + e;
            cp_async4(sL + slot * C + e, lse + r, true);
            cp_async4(sDe + slot * C + e, delta + r, true);
            cp_async4(sDl + slot * C + e, dlse + r, true);
            cp_async4(sQp + slot * C + e, qpos + r, true);
        }
    };
    auto load_k = [&](int c) {                      // key chunk c -> slot c % 2
        const int slot = c % 2;
        stage_rows<D>(sK + slot * C * DS, k + base * D, c * C, C, T_, tid, NT);
        stage_rows<D>(sV + slot * C * DS, v + base * D, c * C, C, T_, tid, NT);
        for (int e = tid; e < C; e += NT)
            cp_async4(sKp + slot * C + e, kpos + base + (size_t)c * C + e, true);
    };

    float dqa[D / 8][4] = {}, dka[D / 8][4] = {}, dva[D / 8][4] = {};

    // the tile (query chunk qc, key chunk kc): S, dP and p / ds on the
    // accumulator fragments; dq += dS K (rows 16w.. of qc) if want_dq; dv +=
    // P^T dO and dk += dS^T Q (rows 16w.. of kc) if want_kv
    auto tile = [&](int qc, int kc, bool want_dq, bool want_kv) {
        const int qs = qc % 3, ks = kc % 2;
        const bf16* tQ = sQ + qs * C * DS;
        const bf16* tO = sO + qs * C * DS;
        const bf16* tK = sK + ks * C * DS;
        const bf16* tV = sV + ks * C * DS;
        // s = Q K^T, dp = dO V^T: query rows 16w + g (+8), key columns 8b + 2t (+1)
        float s[NB][4], dp[NB][4];
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[b][e] = dp[b][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t aq[4], ao[4];
            load_a(aq, tQ, DS, 16 * w, 16 * kk, lane);
            load_a(ao, tO, DS, 16 * w, 16 * kk, lane);
#pragma unroll
            for (int np = 0; np < C / 16; ++np) {
                uint32_t bk[4], bv[4];
                load_b(bk, tK, DS, 16 * np, 16 * kk, lane);
                load_b(bv, tV, DS, 16 * np, 16 * kk, lane);
                mma(s[2 * np], aq, bk[0], bk[1]);
                mma(s[2 * np + 1], aq, bk[2], bk[3]);
                mma(dp[2 * np], ao, bv[0], bv[1]);
                mma(dp[2 * np + 1], ao, bv[2], bv[3]);
            }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int qr = 16 * w + gq + 8 * h;
            const int qp = sQp[qs * C + qr];
            const float l = sL[qs * C + qr], de = sDe[qs * C + qr], dl = sDl[qs * C + qr];
#pragma unroll
            for (int b = 0; b < NB; ++b)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int kp = sKp[ks * C + 8 * b + 2 * t + e];
                    float x = s[b][2 * h + e] * scale;
                    if (kp <= qp) {
                        if (kp == qp) x += self_bias;
                    } else {
                        x = kNegInf;
                    }
                    const float p = expf(x - l);
                    const float ds = p * ((dp[b][2 * h + e] - de) + dl) * scale;
                    s[b][2 * h + e] = p;          // rounded to bf16 by `pack`
                    dp[b][2 * h + e] = ds;
                }
        }
        if (want_dq) {
#pragma unroll
            for (int kk = 0; kk < C / 16; ++kk) {
                uint32_t a[4];
                c_to_a(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
                for (int np = 0; np < D / 16; ++np) {
                    uint32_t bk[4];
                    load_bt(bk, tK, DS, 16 * np, 16 * kk, lane);
                    mma(dqa[2 * np], a, bk[0], bk[1]);
                    mma(dqa[2 * np + 1], a, bk[2], bk[3]);
                }
            }
        }
        if (want_kv) {
            __syncthreads();            // the previous tile's P / dS are read
#pragma unroll
            for (int b = 0; b < NB; ++b)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int o = (16 * w + gq + 8 * h) * PS + 8 * b + 2 * t;
                    *reinterpret_cast<uint32_t*>(sP + o) = pack(s[b][2 * h], s[b][2 * h + 1]);
                    *reinterpret_cast<uint32_t*>(sDS + o) = pack(dp[b][2 * h], dp[b][2 * h + 1]);
                }
            __syncthreads();
#pragma unroll
            for (int kq = 0; kq < C / 16; ++kq) {
                uint32_t ap[4], ad[4];
                load_at(ap, sP, PS, 16 * w, 16 * kq, lane);
                load_at(ad, sDS, PS, 16 * w, 16 * kq, lane);
#pragma unroll
                for (int np = 0; np < D / 16; ++np) {
                    uint32_t bo[4], bq[4];
                    load_bt(bo, tO, DS, 16 * np, 16 * kq, lane);
                    load_bt(bq, tQ, DS, 16 * np, 16 * kq, lane);
                    mma(dva[2 * np], ap, bo[0], bo[1]);
                    mma(dva[2 * np + 1], ap, bo[2], bo[3]);
                    mma(dka[2 * np], ad, bq[0], bq[1]);
                    mma(dka[2 * np + 1], ad, bq[2], bq[3]);
                }
            }
        }
    };

    // rows 16w + g (+8) of chunk c: acc (zeroed after) into out, as bf16 or f32
    auto store = [&](float (&acc)[D / 8][4], int c, auto* out) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const size_t row = base + (size_t)c * C + 16 * w + gq + 8 * h;
#pragma unroll
            for (int nb = 0; nb < D / 8; ++nb) {
                const size_t o = row * D + 8 * nb + 2 * t;
                if constexpr (sizeof(*out) == 2)
                    *reinterpret_cast<uint32_t*>(out + o) = pack(acc[nb][2 * h], acc[nb][2 * h + 1]);
                else
                    *reinterpret_cast<float2*>(out + o) = make_float2(acc[nb][2 * h],
                                                                      acc[nb][2 * h + 1]);
                acc[nb][2 * h] = acc[nb][2 * h + 1] = 0.f;
            }
        }
    };

    // The run's tiles in order, one tile per trip (a single copy of the tile
    // code): the look-back tile (j0, j0 - 1), for dq_{j0} alone, if j0 > 0;
    // then for each chunk j the tile (j, j) -> dq_j (then written), dk_j, dv_j
    // and the tile (j+1, j) -> dk_j, dv_j (then written) and dq_{j+1},
    // carried to chunk j+1 (not past the run, whose next block takes its own
    // look-back tile).  Chunk j's data (K_j, Q_j, Q_{j+1}) has landed before
    // its first tile; chunk j+1's is loaded while chunk j's tiles run.
    if (j0 > 0) load_k(j0 - 1);
    load_q(j0);
    load_k(j0);
    if (j0 + 1 < n) load_q(j0 + 1);
    cp_commit();
    for (int tau = j0 > 0 ? -1 : 0; tau < 2 * (j1 - j0); ++tau) {
        const bool look = tau < 0, own = !look && (tau & 1) == 0;
        const int j = look ? j0 : j0 + (tau >> 1);
        if (!look && !own && j + 1 >= n) continue;        // the last chunk has no (j+1, j)
        if (look || own) {
            cp_wait<0>();
            __syncthreads();            // chunk j's data landed; the previous slots are free
            if (own && j + 1 < j1) {
                load_k(j + 1);
                if (j + 2 < n) load_q(j + 2);
            }
            cp_commit();
        }
        tile(look || own ? j : j + 1, look ? j0 - 1 : j, look || own || j + 1 < j1, !look);
        if (own) store(dqa, j, dq);
        if (!look && (!own || j + 1 >= n)) {
            store(dka, j, dk);
            store(dva, j, dv);
        }
    }
    cp_wait<0>();                       // no copy left in flight
}

template <int C, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const int* qpos, const int* kpos, const float* lse, const float* delta,
                   const float* dlse, void* dq, float* dk, float* dv, int G, int T_,
                   float scale, float self_bias, cudaStream_t stream) {
    const size_t smem = smem_bytes<C, D>();
    auto kern = k4_tc<C, D>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<dim3((T_ / C + RUN - 1) / RUN, G), 2 * C, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, qpos, kpos, lse,
        delta, dlse, (bf16*)dq, dk, dv, T_, scale, self_bias);
    return cudaGetLastError();
}

}  // namespace tc

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
    if constexpr (std::is_same_v<T, __nv_bfloat16>)      // the tensor-core kernel
        return tc::launch<C, D>(a.q, a.k, a.v, a.dout, a.qpos, a.kpos, a.lse, a.delta,
                                a.dlse, a.dq, a.dk, a.dv, a.G, a.T, a.scale, a.self_bias, a.st);
    else
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
// f32.  T % chunk == 0; chunk 32 or 64; D 16, 32 or 64.  f32 runs the FMA
// kernel, bf16 the tensor-core one.  Launches on `stream`; returns
// cudaGetLastError() of the launch.
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

// delta[r] = dout[r] . out[r] in f32 over rows [rows, D] of one dtype (0 =
// f32, 1 = bf16): the input `delta` of chunked_window_attn_bwd, for its
// wrapper.  Launches on `stream`; returns cudaGetLastError().
extern "C" int chunked_window_attn_bwd_delta(const void* dout, const void* out, void* delta,
                                             long long rows, int D, int dtype, void* stream) {
    return (int)row_dot::launch(dout, out, (float*)delta, rows, D, dtype,
                                (cudaStream_t)stream);
}
