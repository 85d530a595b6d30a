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
// bf16 and f16 at chunks 32 / 64, D <= 64 (k4_tc, templated on the element
// type), the training path: one block of C / 16 warps per (g, run of
// RUN = 16 consecutive chunks).  It walks the run's chunks in order: the
// tile (j+1, j) gives dk_j / dv_j and also dq_{j+1}, carried to the next
// chunk, so a chunk costs two tiles, not three (plus one look-back tile per
// run for the run's first dq).  Warp w owns query rows 16w.. for S, dP and
// dq and key rows 16w.. for dk and dv.  S = Q K^T, dP = dO V^T, dq += dS K,
// dv += P^T dO and dk += dS^T Q are mma.sync m16n8k16 products (bf16 or f16
// in, f32 accumulate; mma_bf16.cuh); the masks, self_bias, the finite
// NEG_INF, the lse cotangent and the exp stay f32 on the accumulator
// fragments, and p and ds are rounded to the input dtype where they enter a
// product, as on the TPU.  f16 takes this kernel too, not the tiled one
// below: it costs two tiles per chunk where the tiled split costs about
// three.  Q / dO (3 slots) and K / V (2 slots) sit in shared memory as b16
// rows of stride D+8; each chunk is loaded once per run by cp.async, the
// next chunk's while the current one's tiles compute.  Shared memory ~111 KB at C = D = 64: two
// blocks (eight warps) per SM.
//
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "elem.cuh"
#include "mma_bf16.cuh"
#include "kernel_resources.cuh"
#include "row_dot.cuh"
#include "slab_mma.cuh"

namespace {

constexpr int NT = 256;          // threads: a 16 x 16 grid
constexpr float kNegInf = -1e9f;

using namespace elem;
using kernel_resources::resources;

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

// ------------------------------------------ bf16 and f16 on the tensor cores
namespace tc {

using namespace mma_bf16;

constexpr int RUN = 16;                 // consecutive chunks per block

template <int C, int D>
constexpr size_t smem_bytes() {
    // Q, dO [3 slots][C][D+8]; K, V [2 slots][C][D+8]; P, dS [C][C+8] b16;
    // lse, delta, dlse, qpos [3][C]; kpos [2][C]
    return 2 * (10 * (size_t)C * (D + 8) + 2 * (size_t)C * (C + 8)) + 4 * (4 * 3 * C + 2 * C);
}

template <typename E, int C, int D>
__global__ void __launch_bounds__(2 * C, 2)
k4_tc(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
      const E* __restrict__ dout, const int* __restrict__ qpos, const int* __restrict__ kpos,
      const float* __restrict__ lse, const float* __restrict__ delta,
      const float* __restrict__ dlse, E* __restrict__ dq, float* __restrict__ dk,
      float* __restrict__ dv, int T_, float scale, float self_bias) {
    constexpr int NT = 2 * C;           // C / 16 warps
    constexpr int DS = D + 8, PS = C + 8;
    constexpr int NB = C / 8;           // key columns: C tiles of 8
    extern __shared__ __align__(16) unsigned char smem_raw[];
    E* sQ = reinterpret_cast<E*>(smem_raw);         // [3][C][DS]: query chunk c in slot c % 3
    E* sO = sQ + 3 * C * DS;                        // dO, the same slots
    E* sK = sO + 3 * C * DS;                        // [2][C][DS]: key chunk c in slot c % 2
    E* sV = sK + 2 * C * DS;
    E* sP = sV + 2 * C * DS;                        // [C][PS]
    E* sDS = sP + C * PS;
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
        const E* tQ = sQ + qs * C * DS;
        const E* tO = sO + qs * C * DS;
        const E* tK = sK + ks * C * DS;
        const E* tV = sV + ks * C * DS;
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
                mma<E>(s[2 * np], aq, bk[0], bk[1]);
                mma<E>(s[2 * np + 1], aq, bk[2], bk[3]);
                mma<E>(dp[2 * np], ao, bv[0], bv[1]);
                mma<E>(dp[2 * np + 1], ao, bv[2], bv[3]);
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
                    s[b][2 * h + e] = p;          // rounded to E by `pack`
                    dp[b][2 * h + e] = ds;
                }
        }
        if (want_dq) {
#pragma unroll
            for (int kk = 0; kk < C / 16; ++kk) {
                uint32_t a[4];
                c_to_a<E>(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
                for (int np = 0; np < D / 16; ++np) {
                    uint32_t bk[4];
                    load_bt(bk, tK, DS, 16 * np, 16 * kk, lane);
                    mma<E>(dqa[2 * np], a, bk[0], bk[1]);
                    mma<E>(dqa[2 * np + 1], a, bk[2], bk[3]);
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
                    *reinterpret_cast<uint32_t*>(sP + o) = pack<E>(s[b][2 * h], s[b][2 * h + 1]);
                    *reinterpret_cast<uint32_t*>(sDS + o) = pack<E>(dp[b][2 * h], dp[b][2 * h + 1]);
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
                    mma<E>(dva[2 * np], ap, bo[0], bo[1]);
                    mma<E>(dva[2 * np + 1], ap, bo[2], bo[3]);
                    mma<E>(dka[2 * np], ad, bq[0], bq[1]);
                    mma<E>(dka[2 * np + 1], ad, bq[2], bq[3]);
                }
            }
        }
    };

    // rows 16w + g (+8) of chunk c: acc (zeroed after) into out, as E or f32
    auto store = [&](float (&acc)[D / 8][4], int c, auto* out) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const size_t row = base + (size_t)c * C + 16 * w + gq + 8 * h;
#pragma unroll
            for (int nb = 0; nb < D / 8; ++nb) {
                const size_t o = row * D + 8 * nb + 2 * t;
                if constexpr (sizeof(*out) == 2)
                    *reinterpret_cast<uint32_t*>(out + o) =
                        pack<E>(acc[nb][2 * h], acc[nb][2 * h + 1]);
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

template <typename E, int C, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const int* qpos, const int* kpos, const float* lse, const float* delta,
                   const float* dlse, void* dq, float* dk, float* dv, int G, int T_,
                   float scale, float self_bias, cudaStream_t stream) {
    const size_t smem = smem_bytes<C, D>();
    auto kern = k4_tc<E, C, D>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<dim3((T_ / C + RUN - 1) / RUN, G), 2 * C, smem, stream>>>(
        (const E*)q, (const E*)k, (const E*)v, (const E*)dout, qpos, kpos, lse, delta, dlse,
        (E*)dq, dk, dv, T_, scale, self_bias);
    return cudaGetLastError();
}

}  // namespace tc

// ------------------------------------------- any chunk and D 128: the tiled form
// What the two kernels above do not take -- a chunk other than 32 or 64, or
// D = 128 -- in two kernels over 64-row tiles, as K2's kernels split the
// work (chunked_window_attn_fwd.cu's k3_tiled is the forward); f32 FMAs for
// f32 (k4_dq_tiled, k4_dkdv_tiled), the tensor cores for bf16 and f16
// (k4_dq_tc, k4_dkdv_tc, below):
//   k4_dq_tiled:   one block per (g, 64 query rows): walks the 64-key tiles
//                  of the union of its rows' windows, keeps dq in registers;
//   k4_dkdv_tiled: one block per (g, 64 key rows): walks the 64-row query
//                  tiles whose windows hold its keys (the queries of chunks
//                  j and j + 1 for a key of chunk j), keeps dk / dv in
//                  registers.
// The FMA kernels recompute s and dp = dO . v as f32 FMA chains from shared
// memory, p = exp(s - lse) for a key inside the query's window (0 outside
// it), ds = p (dp - delta + dlse) scale, and round p and ds to the input
// dtype where they enter a product.  Shared memory at D = 128: 150 KB / 167
// KB.
namespace tiled {

constexpr int B = 64;              // rows per tile
constexpr int R = B / 16;          // rows and columns per thread
constexpr int PS = B + 1;          // P / dS row stride

template <int D>
constexpr size_t smem_bytes(int n_pds) {
    // sQ, sDO, sK, sV [B][D+1]; n_pds tiles [B][PS] (dS, and P for dkdv);
    // lse, delta, dlse [B] f32; qpos, kpos [B] int
    return ((size_t)4 * B * (D + 1) + (size_t)n_pds * B * PS + 3 * B) * sizeof(float)
        + 2 * B * sizeof(int);
}

template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0, int T_) {
    for (int e = threadIdx.x; e < B * D; e += NT) {
        const int r = e / D, c = e % D, row = r0 + r;
        dst[r * (D + 1) + c] = (row >= 0 && row < T_) ? to_f(src[(size_t)row * D + c]) : 0.f;
    }
}

// query positions and the f32 row terms of query rows [q0, q0 + B)
__device__ __forceinline__ void stage_rows(int* sQp, float* sL, float* sD, float* sDL,
                                           const int* qpos, const float* lse,
                                           const float* delta, const float* dlse, size_t base,
                                           int q0, int T_) {
    const int t = threadIdx.x;
    if (t < B) {
        const bool ok = q0 + t < T_;
        sQp[t] = ok ? qpos[base + q0 + t] : INT_MIN;
        sL[t] = ok ? lse[base + q0 + t] : 0.f;
        sD[t] = ok ? delta[base + q0 + t] : 0.f;
        sDL[t] = ok ? dlse[base + q0 + t] : 0.f;
    }
}

// key positions of key rows [k0, k0 + B): chunk 0's look-back never visible
__device__ __forceinline__ void stage_kpos(int* sKp, const int* kpos, size_t base, int k0,
                                           int T_) {
    const int t = threadIdx.x;
    if (t < B) {
        const int w = k0 + t;
        sKp[t] = (w >= 0 && w < T_) ? kpos[base + w] : INT_MAX;
    }
}

// query row r (chunk r / C) sees key rows [(r / C - 1) C, (r / C + 1) C)
__device__ __forceinline__ bool in_window(int r, int w, int C) {
    const int lo = (r / C - 1) * C;
    return w >= lo && w < lo + 2 * C;
}

// s (unscaled) and dp = dO . v of thread (tx, ty): query rows ty + 16 i,
// key rows tx + 16 j
template <int D>
__device__ __forceinline__ void scores(const float* sQ, const float* sDO, const float* sK,
                                       const float* sV, int tx, int ty, float (&s)[R][R],
                                       float (&dp)[R][R]) {
    constexpr int DP = D + 1;
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int h = 0; h < D; ++h) {
        float a[R], o[R], b[R], vv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
            a[i] = sQ[(ty + 16 * i) * DP + h];
            o[i] = sDO[(ty + 16 * i) * DP + h];
        }
#pragma unroll
        for (int j = 0; j < R; ++j) {
            b[j] = sK[(tx + 16 * j) * DP + h];
            vv[j] = sV[(tx + 16 * j) * DP + h];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
            for (int j = 0; j < R; ++j) {
                s[i][j] = fmaf(a[i], b[j], s[i][j]);
                dp[i][j] = fmaf(o[i], vv[j], dp[i][j]);
            }
    }
}

// p = exp(s - lse) of query row r and key row w (0 outside the window), the
// masks and self_bias of the forward
__device__ __forceinline__ float prob(float s, int r, int w, int qp, int kp, float lse_r,
                                      int C, float scale, float self_bias) {
    if (!in_window(r, w, C)) return 0.f;
    float x = s * scale;
    if (kp <= qp) {
        if (kp == qp) x += self_bias;
    } else {
        x = kNegInf;
    }
    return expf(x - lse_r);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, 1)
k4_dq_tiled(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const int* __restrict__ qpos,
            const int* __restrict__ kpos, const float* __restrict__ lse,
            const float* __restrict__ delta, const float* __restrict__ dlse,
            T* __restrict__ dq, int T_, int C, float scale, float self_bias) {
    constexpr int DP = D + 1;
    constexpr int CD = D / 16;          // dq columns per thread
    extern __shared__ float smem[];
    float* sQ = smem;
    float* sDO = sQ + B * DP;
    float* sK = sDO + B * DP;
    float* sV = sK + B * DP;
    float* sDS = sV + B * DP;           // [B][PS]
    float* sL = sDS + B * PS;
    float* sD = sL + B;
    float* sDL = sD + B;
    int* sQp = (int*)(sDL + B);
    int* sKp = sQp + B;

    const int g = blockIdx.y;
    const int q0 = blockIdx.x * B;
    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const size_t base = (size_t)g * T_;
    const T* k_g = k + base * D;
    const T* v_g = v + base * D;

    stage<T, D>(sQ, q + base * D, q0, T_);
    stage<T, D>(sDO, dout + base * D, q0, T_);
    stage_rows(sQp, sL, sD, sDL, qpos, lse, delta, dlse, base, q0, T_);

    float acc[R][CD];                   // query rows ty + 16 i, columns tx + 16 c
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;

    const int q_last = min(q0 + B, T_) - 1;
    const int w_lo = (q0 / C - 1) * C, w_hi = (q_last / C + 1) * C;
    for (int k0 = w_lo; k0 < w_hi; k0 += B) {
        __syncthreads();                                 // previous tile's reads done
        stage<T, D>(sK, k_g, k0, T_);
        stage<T, D>(sV, v_g, k0, T_);
        stage_kpos(sKp, kpos, base, k0, T_);
        __syncthreads();

        float s[R][R], dp[R][R];
        scores<D>(sQ, sDO, sK, sV, tx, ty, s, dp);
#pragma unroll
        for (int i = 0; i < R; ++i) {
            const int qi = ty + 16 * i;
#pragma unroll
            for (int j = 0; j < R; ++j) {
                const int kj = tx + 16 * j;
                const float p = prob(s[i][j], q0 + qi, k0 + kj, sQp[qi], sKp[kj], sL[qi], C,
                                     scale, self_bias);
                sDS[qi * PS + kj] = round_to<T>(p * (dp[i][j] - sD[qi] + sDL[qi]) * scale);
            }
        }
        __syncthreads();

#pragma unroll 4
        for (int kx = 0; kx < B; ++kx) {
            float kv[CD];
#pragma unroll
            for (int c = 0; c < CD; ++c) kv[c] = sK[kx * DP + tx + 16 * c];
#pragma unroll
            for (int i = 0; i < R; ++i) {
                const float ds = sDS[(ty + 16 * i) * PS + kx];
#pragma unroll
                for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(ds, kv[c], acc[i][c]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
        const int r = q0 + ty + 16 * i;
        if (r >= T_) continue;
        T* o = dq + (base + r) * D;
#pragma unroll
        for (int c = 0; c < CD; ++c) o[tx + 16 * c] = from_f<T>(acc[i][c]);
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, 1)
k4_dkdv_tiled(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const int* __restrict__ qpos,
              const int* __restrict__ kpos, const float* __restrict__ lse,
              const float* __restrict__ delta, const float* __restrict__ dlse,
              float* __restrict__ dk, float* __restrict__ dv, int T_, int C, float scale,
              float self_bias) {
    constexpr int DP = D + 1;
    constexpr int CD = D / 16;          // dk / dv columns per thread
    extern __shared__ float smem[];
    float* sK = smem;
    float* sV = sK + B * DP;
    float* sQ = sV + B * DP;
    float* sDO = sQ + B * DP;
    float* sP = sDO + B * DP;           // [B][PS]
    float* sDS = sP + B * PS;           // [B][PS]
    float* sL = sDS + B * PS;
    float* sD = sL + B;
    float* sDL = sD + B;
    int* sQp = (int*)(sDL + B);
    int* sKp = sQp + B;

    const int g = blockIdx.y;
    const int k0 = blockIdx.x * B;
    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const size_t base = (size_t)g * T_;
    const T* q_g = q + base * D;
    const T* do_g = dout + base * D;

    stage<T, D>(sK, k + base * D, k0, T_);
    stage<T, D>(sV, v + base * D, k0, T_);
    stage_kpos(sKp, kpos, base, k0, T_);

    float acc_k[R][CD], acc_v[R][CD];   // key rows ty + 16 i, columns tx + 16 c
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

    // the query rows whose windows hold a key of [k0, k_last]
    const int k_last = min(k0 + B, T_) - 1;
    const int r_lo = (k0 / C) * C, r_hi = min((k_last / C + 2) * C, T_);
    for (int q0 = r_lo; q0 < r_hi; q0 += B) {
        __syncthreads();                                 // previous tile's reads done
        stage<T, D>(sQ, q_g, q0, T_);
        stage<T, D>(sDO, do_g, q0, T_);
        stage_rows(sQp, sL, sD, sDL, qpos, lse, delta, dlse, base, q0, T_);
        __syncthreads();

        float s[R][R], dp[R][R];
        scores<D>(sQ, sDO, sK, sV, tx, ty, s, dp);
#pragma unroll
        for (int i = 0; i < R; ++i) {
            const int qi = ty + 16 * i, r = q0 + qi;
#pragma unroll
            for (int j = 0; j < R; ++j) {
                const int kj = tx + 16 * j, w = k0 + kj;
                const float p = (r < T_ && w < T_)
                    ? prob(s[i][j], r, w, sQp[qi], sKp[kj], sL[qi], C, scale, self_bias) : 0.f;
                sP[qi * PS + kj] = round_to<T>(p);
                sDS[qi * PS + kj] = round_to<T>(p * (dp[i][j] - sD[qi] + sDL[qi]) * scale);
            }
        }
        __syncthreads();

#pragma unroll 4
        for (int qx = 0; qx < B; ++qx) {
            float o[CD], a[CD];
#pragma unroll
            for (int c = 0; c < CD; ++c) {
                o[c] = sDO[qx * DP + tx + 16 * c];
                a[c] = sQ[qx * DP + tx + 16 * c];
            }
#pragma unroll
            for (int i = 0; i < R; ++i) {
                const float p = sP[qx * PS + ty + 16 * i];
                const float ds = sDS[qx * PS + ty + 16 * i];
#pragma unroll
                for (int c = 0; c < CD; ++c) {
                    acc_v[i][c] = fmaf(p, o[c], acc_v[i][c]);
                    acc_k[i][c] = fmaf(ds, a[c], acc_k[i][c]);
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
        const int w = k0 + ty + 16 * i;
        if (w >= T_) continue;
#pragma unroll
        for (int c = 0; c < CD; ++c) {
            dk[(base + w) * D + tx + 16 * c] = acc_k[i][c];
            dv[(base + w) * D + tx + 16 * c] = acc_v[i][c];
        }
    }
}

// ---- the same split on the tensor cores, for bf16 and f16 (k4_dq_tc, k4_dkdv_tc)
// S = Q K^T, dP = dO V^T, dq += dS K, dv += P^T dO and dk += dS^T Q are
// mma.sync m16n8k16 products (mma_bf16.cuh); the window, the masks,
// self_bias, kNegInf, the lse cotangent and expf stay f32 on the
// accumulator fragments, as `prob` computes them above, and p and ds are
// rounded to the input dtype where they enter a product.  Q, dO, K and V sit
// in shared memory as b16 rows of stride D+8, loaded by cp.async with zero
// fill; the next tile's operands load while the current tile computes.  A
// tile's 64 rows are four 16-row groups; at D <= 64 a group is one warp,
// at D = 128 two (eight warps per block), which split the group's 64 keys
// for S and dP and the D columns of each accumulator in halves, so that a
// lane holds at most 64 f32 of dk and dv.  Shared memory at D = 128: 112 KB
// (dq, two blocks per SM) and 122 KB (dk / dv, one); at D = 64, 65 / 74 KB
// (three blocks each).
template <int D>
struct Split {
    static constexpr int SP = D > 64 ? 2 : 1;   // warps per 16-row group
    static constexpr int NW = (B / 16) * SP;
    static constexpr int NT = 32 * NW;
    static constexpr int KW = B / SP;           // keys of a warp's S / dP
    static constexpr int DW = D / SP;           // accumulator columns of a warp
    static constexpr int DS = D + 8, PS = B + 8;
};

template <int D>
constexpr size_t dq_tc_smem_bytes() {
    // Q, dO [B][DS]; 2 stages of K, V [B][DS]; dS [B][PS], all b16; lse,
    // delta, dlse [B] f32; qpos [B], 2 stages of kpos [B] int
    return 2 * (size_t)(6 * B * Split<D>::DS + B * Split<D>::PS) + 4 * (3 * B + B + 2 * B);
}

template <int D>
constexpr size_t dkdv_tc_smem_bytes() {
    // K, V [B][DS]; 2 stages of Q, dO [B][DS]; P, dS [B][PS], all b16; 2
    // stages of lse, delta, dlse [B] f32 and qpos [B] int; kpos [B] int
    return 2 * (size_t)(6 * B * Split<D>::DS + 2 * B * Split<D>::PS) + 4 * (2 * 4 * B + B);
}

// S and dP of group p's 16 rows of tA (Q) / tO (dO) over the warp's keys
// [KW c, KW c + KW) of tK / tV (C tiles: key columns KW c + 8j .. +7)
template <typename E, int D>
__device__ __forceinline__ void qk_dov(float (&s)[Split<D>::KW / 8][4],
                                       float (&dp)[Split<D>::KW / 8][4], const E* tQ,
                                       const E* tO, const E* tK, const E* tV, int p, int c,
                                       int lane) {
    using mma_bf16::load_a;
    using mma_bf16::load_b;
    constexpr int DS = Split<D>::DS, KW = Split<D>::KW;
#pragma unroll
    for (int j = 0; j < KW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t aq[4], ao[4];
        load_a(aq, tQ, DS, 16 * p, 16 * kk, lane);
        load_a(ao, tO, DS, 16 * p, 16 * kk, lane);
#pragma unroll
        for (int np = 0; np < KW / 16; ++np) {
            uint32_t bk[4], bv[4];
            load_b(bk, tK, DS, KW * c + 16 * np, 16 * kk, lane);
            load_b(bv, tV, DS, KW * c + 16 * np, 16 * kk, lane);
            mma_bf16::mma<E>(s[2 * np], aq, bk[0], bk[1]);
            mma_bf16::mma<E>(s[2 * np + 1], aq, bk[2], bk[3]);
            mma_bf16::mma<E>(dp[2 * np], ao, bv[0], bv[1]);
            mma_bf16::mma<E>(dp[2 * np + 1], ao, bv[2], bv[3]);
        }
    }
}

// the warp's p or ds entries (rows 16p + g (+8), keys KW c + 8j + 2t (+1))
// into the b16 tile dst [B][PS], rounded to E
template <typename E, int D>
__device__ __forceinline__ void put_tile(E* dst, const float (&x)[Split<D>::KW / 8][4], int p,
                                         int c, int lane) {
    constexpr int KW = Split<D>::KW, PS = Split<D>::PS;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < KW / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
            *reinterpret_cast<uint32_t*>(dst + (16 * p + g + 8 * h) * PS + KW * c + 8 * j + 2 * t) =
                mma_bf16::pack<E>(x[j][2 * h], x[j][2 * h + 1]);
}

template <typename E, int D>
__global__ void __launch_bounds__(Split<D>::NT, Split<D>::SP == 1 ? 3 : 2)
k4_dq_tc(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
         const E* __restrict__ dout, const int* __restrict__ qpos, const int* __restrict__ kpos,
         const float* __restrict__ lse, const float* __restrict__ delta,
         const float* __restrict__ dlse, E* __restrict__ dq, int T_, int C, float scale,
         float self_bias) {
    using namespace mma_bf16;
    using SPL = Split<D>;
    constexpr int DS = SPL::DS, PS = SPL::PS, KW = SPL::KW, DW = SPL::DW, SP = SPL::SP;
    constexpr int STAGE = 2 * B * DS;               // K, V
    extern __shared__ __align__(16) unsigned char smem_raw[];
    E* sQ = reinterpret_cast<E*>(smem_raw);
    E* sO = sQ + B * DS;
    E* sKV = sO + B * DS;                           // stage b: K, V
    E* sDS = sKV + 2 * STAGE;                       // [B][PS] (SP 2)
    float* sL = reinterpret_cast<float*>(sDS + B * PS);
    float* sD = sL + B;
    float* sDL = sD + B;
    int* sQp = reinterpret_cast<int*>(sDL + B);
    int* sKp = sQp + B;                             // stage b: [B]

    const int g = blockIdx.y;
    const int q0 = blockIdx.x * B;
    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
    const int p = w / SP, c = w % SP;               // 16-row group, warp in the group
    const int gq = lane >> 2, t = lane & 3;
    const size_t base = (size_t)g * T_;
    const E* k_g = k + base * D;
    const E* v_g = v + base * D;

    const int q_last = min(q0 + B, T_) - 1;
    const int w_lo = (q0 / C - 1) * C, w_hi = (q_last / C + 1) * C;
    // K, V and the key positions of the tile at k0 into stage b (a key
    // outside [0, T): INT_MAX, never visible)
    auto load_k = [&](int k0, int b) {
        E* st = sKV + b * STAGE;
        mma_bf16::stage_rows<D>(st, k_g, k0, B, T_, tid, SPL::NT);
        mma_bf16::stage_rows<D>(st + B * DS, v_g, k0, B, T_, tid, SPL::NT);
        cp_commit();
        stage_kpos(sKp + b * B, kpos, base, k0, T_);
    };
    mma_bf16::stage_rows<D>(sQ, q + base * D, q0, B, T_, tid, SPL::NT);
    mma_bf16::stage_rows<D>(sO, dout + base * D, q0, B, T_, tid, SPL::NT);
    stage_rows(sQp, sL, sD, sDL, qpos, lse, delta, dlse, base, q0, T_);
    load_k(w_lo, 0);

    float dqa[DW / 8][4] = {};          // query rows 16p + g (+8), columns DW c + 8n + 2t
    for (int k0 = w_lo, it = 0; k0 < w_hi; k0 += B, ++it) {
        const int b = it & 1;
        cp_wait<0>();
        __syncthreads();                // tile it landed; every warp is done with tile it - 1
        if (k0 + B < w_hi) load_k(k0 + B, b ^ 1);
        const E* tK = sKV + b * STAGE;
        const E* tV = tK + B * DS;
        const int* kp_t = sKp + b * B;

        float s[KW / 8][4], dp[KW / 8][4];
        qk_dov<E, D>(s, dp, sQ, sO, tK, tV, p, c, lane);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int qi = 16 * p + gq + 8 * h;
            const int qp = sQp[qi];
            const float l = sL[qi], de = sD[qi], dl = sDL[qi];
#pragma unroll
            for (int j = 0; j < KW / 8; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int kj = KW * c + 8 * j + 2 * t + e;
                    const float pr = prob(s[j][2 * h + e], q0 + qi, k0 + kj, qp, kp_t[kj], l, C,
                                          scale, self_bias);
                    s[j][2 * h + e] = pr;
                    dp[j][2 * h + e] = pr * (dp[j][2 * h + e] - de + dl) * scale;
                }
        }
        if constexpr (SP == 1) {        // dq += dS K, dS from the accumulators
#pragma unroll
            for (int kk = 0; kk < B / 16; ++kk) {
                uint32_t a[4];
                c_to_a<E>(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
                for (int np = 0; np < D / 16; ++np) {
                    uint32_t bk[4];
                    load_bt(bk, tK, DS, 16 * np, 16 * kk, lane);
                    mma<E>(dqa[2 * np], a, bk[0], bk[1]);
                    mma<E>(dqa[2 * np + 1], a, bk[2], bk[3]);
                }
            }
        } else {                        // the group's dS rows through shared memory
            put_tile<E, D>(sDS, dp, p, c, lane);
            __syncthreads();
#pragma unroll
            for (int kk = 0; kk < B / 16; ++kk) {
                uint32_t a[4];
                load_a(a, sDS, PS, 16 * p, 16 * kk, lane);
#pragma unroll
                for (int np = 0; np < DW / 16; ++np) {
                    uint32_t bk[4];
                    load_bt(bk, tK, DS, DW * c + 16 * np, 16 * kk, lane);
                    mma<E>(dqa[2 * np], a, bk[0], bk[1]);
                    mma<E>(dqa[2 * np + 1], a, bk[2], bk[3]);
                }
            }
        }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = q0 + 16 * p + gq + 8 * h;
        if (r >= T_) continue;
        E* o = dq + (base + r) * D + DW * c;
#pragma unroll
        for (int n = 0; n < DW / 8; ++n)
            *reinterpret_cast<uint32_t*>(o + 8 * n + 2 * t) =
                pack<E>(dqa[n][2 * h], dqa[n][2 * h + 1]);
    }
}

template <typename E, int D>
__global__ void __launch_bounds__(Split<D>::NT, Split<D>::SP == 1 ? 2 : 1)
k4_dkdv_tc(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
           const E* __restrict__ dout, const int* __restrict__ qpos,
           const int* __restrict__ kpos, const float* __restrict__ lse,
           const float* __restrict__ delta, const float* __restrict__ dlse,
           float* __restrict__ dk, float* __restrict__ dv, int T_, int C, float scale,
           float self_bias) {
    using namespace mma_bf16;
    using SPL = Split<D>;
    constexpr int DS = SPL::DS, PS = SPL::PS, KW = SPL::KW, DW = SPL::DW, SP = SPL::SP;
    constexpr int STAGE = 2 * B * DS;               // Q, dO
    extern __shared__ __align__(16) unsigned char smem_raw[];
    E* sK = reinterpret_cast<E*>(smem_raw);
    E* sV = sK + B * DS;
    E* sQO = sV + B * DS;                           // stage b: Q, dO
    E* sP = sQO + 2 * STAGE;                        // [B][PS]
    E* sDS = sP + B * PS;
    float* sL = reinterpret_cast<float*>(sDS + B * PS);   // stage b: lse, delta, dlse [B]
    int* sQp = reinterpret_cast<int*>(sL + 2 * 3 * B);    // stage b: [B]
    int* sKp = sQp + 2 * B;

    const int g = blockIdx.y;
    const int k0 = blockIdx.x * B;
    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
    const int p = w / SP, c = w % SP;               // 16-row group, warp in the group
    const int gq = lane >> 2, t = lane & 3;
    const size_t base = (size_t)g * T_;
    const E* q_g = q + base * D;
    const E* do_g = dout + base * D;

    // the query rows whose windows hold a key of [k0, k_last]
    const int k_last = min(k0 + B, T_) - 1;
    const int r_lo = (k0 / C) * C, r_hi = min((k_last / C + 2) * C, T_);
    // Q, dO and the row terms of the query tile at q0 into stage b
    auto load_q = [&](int q0, int b) {
        E* st = sQO + b * STAGE;
        mma_bf16::stage_rows<D>(st, q_g, q0, B, T_, tid, SPL::NT);
        mma_bf16::stage_rows<D>(st + B * DS, do_g, q0, B, T_, tid, SPL::NT);
        cp_commit();
        float* sl = sL + b * 3 * B;
        stage_rows(sQp + b * B, sl, sl + B, sl + 2 * B, qpos, lse, delta, dlse, base, q0, T_);
    };
    mma_bf16::stage_rows<D>(sK, k + base * D, k0, B, T_, tid, SPL::NT);
    mma_bf16::stage_rows<D>(sV, v + base * D, k0, B, T_, tid, SPL::NT);
    stage_kpos(sKp, kpos, base, k0, T_);
    load_q(r_lo, 0);

    // key rows 16p + g (+8), columns DW c + 8n + 2t
    float dka[DW / 8][4] = {}, dva[DW / 8][4] = {};
    for (int q0 = r_lo, it = 0; q0 < r_hi; q0 += B, ++it) {
        const int b = it & 1;
        cp_wait<0>();
        __syncthreads();                // tile it landed; every warp is done with tile it - 1
        if (q0 + B < r_hi) load_q(q0 + B, b ^ 1);
        const E* tQ = sQO + b * STAGE;
        const E* tO = tQ + B * DS;
        const float* sl = sL + b * 3 * B;
        const int* qp_t = sQp + b * B;

        float s[KW / 8][4], dp[KW / 8][4];
        qk_dov<E, D>(s, dp, tQ, tO, sK, sV, p, c, lane);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int qi = 16 * p + gq + 8 * h, r = q0 + qi;
            const int qp = qp_t[qi];
            const float l = sl[qi], de = sl[B + qi], dl = sl[2 * B + qi];
#pragma unroll
            for (int j = 0; j < KW / 8; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int kj = KW * c + 8 * j + 2 * t + e, wk = k0 + kj;
                    const float pr = (r < T_ && wk < T_)
                        ? prob(s[j][2 * h + e], r, wk, qp, sKp[kj], l, C, scale, self_bias)
                        : 0.f;
                    s[j][2 * h + e] = pr;
                    dp[j][2 * h + e] = pr * (dp[j][2 * h + e] - de + dl) * scale;
                }
        }
        put_tile<E, D>(sP, s, p, c, lane);
        put_tile<E, D>(sDS, dp, p, c, lane);
        __syncthreads();                // every warp's P / dS entries are written

        // dv += P^T dO, dk += dS^T Q over the tile's 64 query rows
#pragma unroll
        for (int kq = 0; kq < B / 16; ++kq) {
            uint32_t ap[4], ad[4];
            load_at(ap, sP, PS, 16 * p, 16 * kq, lane);
            load_at(ad, sDS, PS, 16 * p, 16 * kq, lane);
#pragma unroll
            for (int np = 0; np < DW / 16; ++np) {
                uint32_t bo[4], bq[4];
                load_bt(bo, tO, DS, DW * c + 16 * np, 16 * kq, lane);
                load_bt(bq, tQ, DS, DW * c + 16 * np, 16 * kq, lane);
                mma<E>(dva[2 * np], ap, bo[0], bo[1]);
                mma<E>(dva[2 * np + 1], ap, bo[2], bo[3]);
                mma<E>(dka[2 * np], ad, bq[0], bq[1]);
                mma<E>(dka[2 * np + 1], ad, bq[2], bq[3]);
            }
        }
    }
    cp_wait<0>();                       // no copy left in flight

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int wk = k0 + 16 * p + gq + 8 * h;
        if (wk >= T_) continue;
        float* dk_r = dk + (base + wk) * D + DW * c;
        float* dv_r = dv + (base + wk) * D + DW * c;
#pragma unroll
        for (int n = 0; n < DW / 8; ++n) {
            *reinterpret_cast<float2*>(dk_r + 8 * n + 2 * t) =
                make_float2(dka[n][2 * h], dka[n][2 * h + 1]);
            *reinterpret_cast<float2*>(dv_r + 8 * n + 2 * t) =
                make_float2(dva[n][2 * h], dva[n][2 * h + 1]);
        }
    }
}

template <typename E, int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* dout,
                      const int* qpos, const int* kpos, const float* lse, const float* delta,
                      const float* dlse, void* dq, float* dk, float* dv, int G, int T_, int C,
                      float scale, float self_bias, cudaStream_t stream) {
    const size_t smem_q = dq_tc_smem_bytes<D>(), smem_kv = dkdv_tc_smem_bytes<D>();
    auto kq = k4_dq_tc<E, D>;
    auto kv = k4_dkdv_tc<E, D>;
    cudaError_t err = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem_q);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
    if (err != cudaSuccess) return err;
    const dim3 grid((T_ + B - 1) / B, G);
    const E *q_ = (const E*)q, *k_ = (const E*)k, *v_ = (const E*)v, *do_ = (const E*)dout;
    kq<<<grid, Split<D>::NT, smem_q, stream>>>(q_, k_, v_, do_, qpos, kpos, lse, delta, dlse,
                                               (E*)dq, T_, C, scale, self_bias);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    kv<<<grid, Split<D>::NT, smem_kv, stream>>>(q_, k_, v_, do_, qpos, kpos, lse, delta, dlse,
                                                dk, dv, T_, C, scale, self_bias);
    return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const int* qpos, const int* kpos, const float* lse, const float* delta,
                   const float* dlse, void* dq, float* dk, float* dv, int G, int T_, int C,
                   float scale, float self_bias, cudaStream_t stream) {
    const size_t smem_q = smem_bytes<D>(1), smem_kv = smem_bytes<D>(2);
    auto kq = k4_dq_tiled<T, D>;
    auto kv = k4_dkdv_tiled<T, D>;
    cudaError_t err = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem_q);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
    if (err != cudaSuccess) return err;
    const dim3 grid((T_ + B - 1) / B, G);
    const T *q_ = (const T*)q, *k_ = (const T*)k, *v_ = (const T*)v, *do_ = (const T*)dout;
    kq<<<grid, NT, smem_q, stream>>>(q_, k_, v_, do_, qpos, kpos, lse, delta, dlse, (T*)dq, T_,
                                     C, scale, self_bias);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    kv<<<grid, NT, smem_kv, stream>>>(q_, k_, v_, do_, qpos, kpos, lse, delta, dlse, dk, dv, T_,
                                      C, scale, self_bias);
    return cudaGetLastError();
}

}  // namespace tiled

// ------------------------------------------- head dims above 128: the slab split
// Every call at a head dim H above 128 (a multiple of 128), in f32, bf16
// and f16: the tiled split above (k4_dq_slab per 64 query rows over the key
// tiles of their windows; k4_dkdv_slab per 64 keys over the query tiles
// that see them) at one warp per 16-row group, over slabs of the head dim.
// H = 64 ns; a block of four warps per (g, tile, output slab z) writes
// columns [64 z, 64 z + 64) of dq (dq) or of dk and dv (dkdv).  Per tile
// pair it loops over the ns slabs (`pair_scores`): each slab of Q, dO, K and
// V is staged by cp.async and S = Q . K^T, dP = dO . V^T are added into the
// warp's fragments, so both are sums over the whole head dim before p and
// ds exist; slab z is staged last and stays for the output products.  Each
// output slab's block recomputes S and dP.  p and ds are `prob`'s, with the
// own key of a row in a layer with a self bias rescored by slab_mma.cuh's
// self_score (the sequential f32 FMA chain over all H, as k3_slab does), so
// p = exp(s - lse) is exactly 1 where a row sees only its own key.  The
// products are slab_mma.cuh's: bf16 / f16 mma.sync, f32 3xTF32.  Shared
// memory 37 / 55 KB (16 bits), 69 / 103 KB (f32), dq / dkdv.
namespace slabs {

using namespace slab;
using tiled::B;
using tiled::in_window;
using tiled::prob;
using tiled::stage_kpos;
using tiled::stage_rows;

constexpr int W = 64;            // slab width
constexpr int NT = 32 * (B / 16);

template <typename E>
struct Lay {
    static constexpr int RS = W + PAD<E>, PS = B + PAD<E>;
    // Q, dO, K, V [B][RS]; n_pds tiles [B][PS] (P and dS for dkdv); lse,
    // delta, dlse [B] f32; qpos, kpos [B] int
    static constexpr size_t bytes(int n_pds) {
        return (size_t)(4 * B * RS + n_pds * B * PS) * sizeof(E) + 3 * B * 4 + 2 * B * 4;
    }
};

// S = Q . K^T and dP = dO . V^T of the tile pair (q0, k0) over the ns slabs
// of the head dim, slab z last
template <typename E>
__device__ __forceinline__ void pair_scores(float (&s)[B / 8][4], float (&dp)[B / 8][4], E* sQ,
                                            E* sO, E* sK, E* sV, const E* q_g, const E* do_g,
                                            const E* k_g, const E* v_g, int q0, int k0, int T_,
                                            int H, int ns, int z, int tid, int p, int lane) {
    constexpr int RS = Lay<E>::RS;
#pragma unroll
    for (int j = 0; j < B / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    for (int i = 0; i < ns; ++i) {
        const int c0 = W * ((z + 1 + i) % ns);
        __syncthreads();                 // every warp is done with the staged tiles
        stage<W>(sQ, q_g, q0, B, T_, H, c0, tid, NT);
        stage<W>(sO, do_g, q0, B, T_, H, c0, tid, NT);
        stage<W>(sK, k_g, k0, B, T_, H, c0, tid, NT);
        stage<W>(sV, v_g, k0, B, T_, H, c0, tid, NT);
        mma_bf16::cp_commit();
        mma_bf16::cp_wait<0>();
        __syncthreads();
        slab_product<E, W>(s, sQ, 16 * p, sK, 0, RS, lane);
        slab_product<E, W>(dp, sO, 16 * p, sV, 0, RS, lane);
    }
}

// p and ds of the warp's entries in place of s and dp (`prob`, with the own
// key rescored by self_score in a layer with a self bias: a row holds at
// most one own key per tile, patched after the tile's p); q rows q0 + 16p +
// g (+8), keys k0 + 8j + 2t (+1); the row terms from sQp / sL / sD / sDL
template <typename E, bool BIAS>
__device__ __forceinline__ void p_ds(float (&s)[B / 8][4], float (&dp)[B / 8][4],
                                     const int* sQp, const int* sKp, const float* sL,
                                     const float* sD, const float* sDL, const E* q_g,
                                     const E* k_g, int q0, int k0, int T_, int H, int C,
                                     float scale, float self_bias, int p, int lane) {
    const int g = lane >> 2, t = lane & 3;
    int own[2] = {-1, -1};               // the lane's column of row h's own key
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int qi = 16 * p + g + 8 * h, r = q0 + qi;
        const int qp = sQp[qi];
        const float l = sL[qi];
#pragma unroll
        for (int j = 0; j < B / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int kj = 8 * j + 2 * t + e, wk = k0 + kj;
                const bool live = r < T_ && wk < T_;
                if (BIAS && live && sKp[kj] == qp && in_window(r, wk, C)) own[h] = kj;
                s[j][2 * h + e] =
                    live ? prob(s[j][2 * h + e], r, wk, qp, sKp[kj], l, C, scale, self_bias) : 0.f;
            }
    }
    if (BIAS && __any_sync(0xffffffffu, own[0] >= 0 || own[1] >= 0)) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            if (own[h] < 0) continue;
            const int r = q0 + 16 * p + g + 8 * h;
            const float pr = expf(self_score<E>(q_g + (size_t)r * H, k_g + (size_t)(k0 + own[h]) * H,
                                                H, scale, self_bias) - sL[16 * p + g + 8 * h]);
#pragma unroll
            for (int j = 0; j < B / 8; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e)
                    if (8 * j + 2 * t + e == own[h]) s[j][2 * h + e] = pr;
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int qi = 16 * p + g + 8 * h;
        const float de = sD[qi], dl = sDL[qi];
#pragma unroll
        for (int j = 0; j < B / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
                dp[j][2 * h + e] = s[j][2 * h + e] * (dp[j][2 * h + e] - de + dl) * scale;
    }
}

template <typename E, bool BIAS>
__global__ void __launch_bounds__(NT, 2)
k4_dq_slab(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
           const E* __restrict__ dout, const int* __restrict__ qpos,
           const int* __restrict__ kpos, const float* __restrict__ lse,
           const float* __restrict__ delta, const float* __restrict__ dlse,
           E* __restrict__ dq, int T_, int C, float scale, float self_bias, int ns) {
    constexpr int RS = Lay<E>::RS, K8 = KS<E>;
    const int H = W * ns;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    E* sQ = reinterpret_cast<E*>(smem_raw);
    E* sO = sQ + B * RS;
    E* sK = sO + B * RS;
    E* sV = sK + B * RS;
    float* sL = reinterpret_cast<float*>(sV + B * RS);
    float* sD = sL + B;
    float* sDL = sD + B;
    int* sQp = reinterpret_cast<int*>(sDL + B);
    int* sKp = sQp + B;

    const int g = blockIdx.y, z = blockIdx.z;
    const int q0 = blockIdx.x * B;
    const int tid = threadIdx.x, p = tid >> 5, lane = tid & 31;
    const int gq = lane >> 2, t = lane & 3;
    const size_t base = (size_t)g * T_;
    const E *q_g = q + base * H, *k_g = k + base * H, *v_g = v + base * H;
    const E* do_g = dout + base * H;
    stage_rows(sQp, sL, sD, sDL, qpos, lse, delta, dlse, base, q0, T_);

    const int q_last = min(q0 + B, T_) - 1;
    const int w_lo = (q0 / C - 1) * C, w_hi = (q_last / C + 1) * C;
    float dqa[W / 8][4] = {};            // query rows 16p + g (+8), columns 8n + 2t of slab z
    for (int k0 = w_lo; k0 < w_hi; k0 += B) {
        float s[B / 8][4], dp[B / 8][4];
        pair_scores<E>(s, dp, sQ, sO, sK, sV, q_g, do_g, k_g, v_g, q0, k0, T_, H, ns, z, tid,
                       p, lane);
        // the tile's key positions (the previous tile's were read before
        // pair_scores' first barrier)
        stage_kpos(sKp, kpos, base, k0, T_);
        __syncthreads();
        p_ds<E, BIAS>(s, dp, sQp, sKp, sL, sD, sDL, q_g, k_g, q0, k0, T_, H, C, scale,
                      self_bias, p, lane);
        // dq += dS . K[:, W z..], dS from the accumulators (the tile's
        // products summed apart, then added rounded to nearest)
#pragma unroll
        for (int c = 0; c < W / 16; c += CH) {           // CH n-pairs per pass
            float t[2 * CH][4] = {};
#pragma unroll
            for (int kb = 0; kb < B / K8; ++kb) {
                FragA<E> a;
                acc_a<E>(a, dp, kb, lane);
#pragma unroll
                for (int j = 0; j < CH && c + j < W / 16; ++j) {
                    FragB<E> b[2];
                    load_bt(b, sK, RS, 16 * (c + j), K8 * kb, lane);
                    mma(t[2 * j], a, b[0]);
                    mma(t[2 * j + 1], a, b[1]);
                }
            }
            add_pass(dqa, t, c);
        }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = q0 + 16 * p + gq + 8 * h;
        if (r >= T_) continue;
        E* o = dq + (base + r) * H + W * z;
#pragma unroll
        for (int n = 0; n < W / 8; ++n) put2<E>(o + 8 * n + 2 * t, dqa[n][2 * h], dqa[n][2 * h + 1]);
    }
}

template <typename E, bool BIAS>
__global__ void __launch_bounds__(NT, 2)
k4_dkdv_slab(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
             const E* __restrict__ dout, const int* __restrict__ qpos,
             const int* __restrict__ kpos, const float* __restrict__ lse,
             const float* __restrict__ delta, const float* __restrict__ dlse,
             float* __restrict__ dk, float* __restrict__ dv, int T_, int C, float scale,
             float self_bias, int ns) {
    using L = Lay<E>;
    constexpr int RS = L::RS, PS = L::PS, K8 = KS<E>;
    const int H = W * ns;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    E* sQ = reinterpret_cast<E*>(smem_raw);
    E* sO = sQ + B * RS;
    E* sK = sO + B * RS;
    E* sV = sK + B * RS;
    E* sP = sV + B * RS;
    E* sDS = sP + B * PS;
    float* sL = reinterpret_cast<float*>(sDS + B * PS);
    float* sD = sL + B;
    float* sDL = sD + B;
    int* sQp = reinterpret_cast<int*>(sDL + B);
    int* sKp = sQp + B;

    const int g = blockIdx.y, z = blockIdx.z;
    const int k0 = blockIdx.x * B;
    const int tid = threadIdx.x, p = tid >> 5, lane = tid & 31;
    const int gq = lane >> 2, t = lane & 3;
    const size_t base = (size_t)g * T_;
    const E *q_g = q + base * H, *k_g = k + base * H, *v_g = v + base * H;
    const E* do_g = dout + base * H;
    stage_kpos(sKp, kpos, base, k0, T_);

    // the query rows whose windows hold a key of [k0, k_last]
    const int k_last = min(k0 + B, T_) - 1;
    const int r_lo = (k0 / C) * C, r_hi = min((k_last / C + 2) * C, T_);
    float dka[W / 8][4] = {}, dva[W / 8][4] = {};   // key rows 16p + g (+8), cols 8n + 2t
    for (int q0 = r_lo; q0 < r_hi; q0 += B) {
        float s[B / 8][4], dp[B / 8][4];
        pair_scores<E>(s, dp, sQ, sO, sK, sV, q_g, do_g, k_g, v_g, q0, k0, T_, H, ns, z, tid,
                       p, lane);
        // the q tile's row terms (the previous tile's were read before
        // pair_scores' first barrier)
        stage_rows(sQp, sL, sD, sDL, qpos, lse, delta, dlse, base, q0, T_);
        __syncthreads();
        p_ds<E, BIAS>(s, dp, sQp, sKp, sL, sD, sDL, q_g, k_g, q0, k0, T_, H, C, scale,
                      self_bias, p, lane);
#pragma unroll
        for (int j = 0; j < B / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int o = (16 * p + gq + 8 * h) * PS + 8 * j + 2 * t;
                put2<E>(sP + o, s[j][2 * h], s[j][2 * h + 1]);
                put2<E>(sDS + o, dp[j][2 * h], dp[j][2 * h + 1]);
            }
        __syncthreads();                 // every warp's P / dS rows are written

        // dv += P^T dO[:, W z..], dk += dS^T Q[:, W z..] over the tile's 64
        // query rows (summed apart, then added rounded to nearest)
#pragma unroll
        for (int c = 0; c < W / 16; ++c) {               // one n-pair per pass
            float tv[2][4] = {}, tk[2][4] = {};
#pragma unroll 1
            for (int kq = 0; kq < B / K8; ++kq) {
                FragA<E> ap, ad;
                load_at(ap, sP, PS, 16 * p, K8 * kq, lane);
                load_at(ad, sDS, PS, 16 * p, K8 * kq, lane);
                FragB<E> bo[2], bq[2];
                load_bt(bo, sO, RS, 16 * c, K8 * kq, lane);
                load_bt(bq, sQ, RS, 16 * c, K8 * kq, lane);
                mma(tv[0], ap, bo[0]);
                mma(tv[1], ap, bo[1]);
                mma(tk[0], ad, bq[0]);
                mma(tk[1], ad, bq[1]);
            }
            add_pass(dva, tv, c);
            add_pass(dka, tk, c);
        }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int wk = k0 + 16 * p + gq + 8 * h;
        if (wk >= T_) continue;
        float* dk_r = dk + (base + wk) * H + W * z;
        float* dv_r = dv + (base + wk) * H + W * z;
#pragma unroll
        for (int n = 0; n < W / 8; ++n) {
            put2<float>(dk_r + 8 * n + 2 * t, dka[n][2 * h], dka[n][2 * h + 1]);
            put2<float>(dv_r + 8 * n + 2 * t, dva[n][2 * h], dva[n][2 * h + 1]);
        }
    }
}

template <typename E, bool BIAS>
cudaError_t launch_b(const void* q, const void* k, const void* v, const void* dout,
                     const int* qpos, const int* kpos, const float* lse, const float* delta,
                     const float* dlse, void* dq, float* dk, float* dv, int G, int T_, int C,
                     int H, float scale, float self_bias, cudaStream_t stream) {
    const size_t smem_q = Lay<E>::bytes(0), smem_kv = Lay<E>::bytes(2);
    auto kq = k4_dq_slab<E, BIAS>;
    auto kv = k4_dkdv_slab<E, BIAS>;
    cudaError_t err = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem_q);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
    if (err != cudaSuccess) return err;
    const int ns = H / W;
    const dim3 grid((T_ + B - 1) / B, G, ns);
    const E *q_ = (const E*)q, *k_ = (const E*)k, *v_ = (const E*)v, *do_ = (const E*)dout;
    kq<<<grid, NT, smem_q, stream>>>(q_, k_, v_, do_, qpos, kpos, lse, delta, dlse, (E*)dq, T_,
                                     C, scale, self_bias, ns);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    kv<<<grid, NT, smem_kv, stream>>>(q_, k_, v_, do_, qpos, kpos, lse, delta, dlse, dk, dv, T_,
                                      C, scale, self_bias, ns);
    return cudaGetLastError();
}

template <typename E>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const int* qpos, const int* kpos, const float* lse, const float* delta,
                   const float* dlse, void* dq, float* dk, float* dv, int G, int T_, int C,
                   int H, float scale, float self_bias, cudaStream_t stream) {
    if (self_bias != 0.f)
        return launch_b<E, true>(q, k, v, dout, qpos, kpos, lse, delta, dlse, dq, dk, dv, G,
                                 T_, C, H, scale, self_bias, stream);
    return launch_b<E, false>(q, k, v, dout, qpos, kpos, lse, delta, dlse, dq, dk, dv, G, T_,
                              C, H, scale, self_bias, stream);
}

}  // namespace slabs

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
    if constexpr (sizeof(T) == 2)                         // the tensor-core kernel
        return tc::launch<T, C, D>(a.q, a.k, a.v, a.dout, a.qpos, a.kpos, a.lse, a.delta,
                                   a.dlse, a.dq, a.dk, a.dv, a.G, a.T, a.scale, a.self_bias,
                                   a.st);
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

// the tiled split: f32 FMAs for T = float, the tensor cores for bf16 / f16
template <typename T, int D>
cudaError_t run_tiled_d(int C, const Args& a) {
    if constexpr (sizeof(T) == 2)
        return tiled::launch_tc<T, D>(a.q, a.k, a.v, a.dout, a.qpos, a.kpos, a.lse, a.delta,
                                      a.dlse, a.dq, a.dk, a.dv, a.G, a.T, C, a.scale,
                                      a.self_bias, a.st);
    else
        return tiled::launch<T, D>(a.q, a.k, a.v, a.dout, a.qpos, a.kpos, a.lse, a.delta,
                                   a.dlse, a.dq, a.dk, a.dv, a.G, a.T, C, a.scale, a.self_bias,
                                   a.st);
}

template <typename T>
cudaError_t run_tiled(int C, int D, const Args& a) {
    switch (D) {
        case 16: return run_tiled_d<T, 16>(C, a);
        case 32: return run_tiled_d<T, 32>(C, a);
        case 64: return run_tiled_d<T, 64>(C, a);
        case 128: return run_tiled_d<T, 128>(C, a);
        default: return cudaErrorInvalidValue;
    }
}

// the resources of the tensor-core kernels of a 16-bit call: k4_tc (out[0..4];
// out[5..9] zero) or k4_dq_tc and k4_dkdv_tc
template <typename E, int D>
cudaError_t resources_d(int C, int* out) {
    if constexpr (D <= 64) {
        if (C == 32 || C == 64) {
            for (int i = 5; i < 10; ++i) out[i] = 0;
            if (C == 32) return resources(tc::k4_tc<E, 32, D>, tc::smem_bytes<32, D>(), 64, out);
            return resources(tc::k4_tc<E, 64, D>, tc::smem_bytes<64, D>(), 128, out);
        }
    }
    constexpr int NT = tiled::Split<D>::NT;
    cudaError_t err = resources(tiled::k4_dq_tc<E, D>, tiled::dq_tc_smem_bytes<D>(), NT, out);
    if (err != cudaSuccess) return err;
    return resources(tiled::k4_dkdv_tc<E, D>, tiled::dkdv_tc_smem_bytes<D>(), NT, out + 5);
}

// the resources of k4_dq_slab and k4_dkdv_slab (their self-bias instances),
// which run D above 128
template <typename E>
cudaError_t resources_slab(int* out) {
    using L = slabs::Lay<E>;
    cudaError_t err = resources(slabs::k4_dq_slab<E, true>, L::bytes(0), slabs::NT, out);
    if (err != cudaSuccess) return err;
    return resources(slabs::k4_dkdv_slab<E, true>, L::bytes(2), slabs::NT, out + 5);
}

template <typename E>
cudaError_t resources_c(int C, int D, int* out) {
    if (D > 128 && D % 128 == 0) return resources_slab<E>(out);
    switch (D) {
        case 16: return resources_d<E, 16>(C, out);
        case 32: return resources_d<E, 32>(C, out);
        case 64: return resources_d<E, 64>(C, out);
        case 128: return resources_d<E, 128>(C, out);
        default: return cudaErrorInvalidValue;
    }
}

template <typename T>
cudaError_t route(int C, int D, const Args& a) {
    // D above 128: the slab split; chunks 32 / 64 at D <= 64: the per-chunk
    // kernels; the rest: the tiled split
    if (D > 128 && D % 128 == 0)
        return slabs::launch<T>(a.q, a.k, a.v, a.dout, a.qpos, a.kpos, a.lse, a.delta, a.dlse,
                                a.dq, a.dk, a.dv, a.G, a.T, C, D, a.scale, a.self_bias, a.st);
    return (C == 32 || C == 64) && D <= 64 ? run_c<T>(C, D, a) : run_tiled<T>(C, D, a);
}

}  // namespace

// q/k/v/dout [G, T, D] (dtype 0 = f32, 1 = bf16, 2 = f16), qpos/kpos int32
// [G, T], lse/delta/dlse f32 [G, T]; dq [G, T, D] in the input dtype, dk/dv
// [G, T, D] f32.  T % chunk == 0; D 16, 32, 64, 128 or a multiple of 128.
// Chunks 32 and 64 at D <= 64 run the per-chunk kernels (f32: the FMA
// kernel; bf16 and f16: k4_tc); every other chunk and D 128 run the tiled
// split (f32: k4_dq_tiled / k4_dkdv_tiled; bf16 and f16: k4_dq_tc /
// k4_dkdv_tc); D above 128 runs k4_dq_slab / k4_dkdv_slab.
// Launches on `stream`; returns cudaGetLastError() of the launch.
extern "C" int chunked_window_attn_bwd(const void* q, const void* k, const void* v,
                                       const void* dout, const void* qpos, const void* kpos,
                                       const void* lse, const void* delta, const void* dlse,
                                       void* dq, void* dk, void* dv, int G, int T, int D,
                                       int chunk, int dtype, float scale, float self_bias,
                                       void* stream) {
    if (chunk <= 0 || T % chunk) return (int)cudaErrorInvalidValue;
    const Args a{q, k, v, dout, (const int*)qpos, (const int*)kpos, (const float*)lse,
                 (const float*)delta, (const float*)dlse, dq, (float*)dk, (float*)dv, G, T,
                 scale, self_bias, (cudaStream_t)stream};
    if (dtype == 0) return (int)route<float>(chunk, D, a);
    if (dtype == 1) return (int)route<__nv_bfloat16>(chunk, D, a);
    if (dtype == 2) return (int)route<__half>(chunk, D, a);
    return (int)cudaErrorInvalidValue;
}

// delta[r] = dout[r] . out[r] in f32 over rows [rows, D] of one dtype (0 =
// f32, 1 = bf16, 2 = f16): the input `delta` of chunked_window_attn_bwd, for its
// wrapper.  Launches on `stream`; returns cudaGetLastError().
extern "C" int chunked_window_attn_bwd_delta(const void* dout, const void* out, void* delta,
                                             long long rows, int D, int dtype, void* stream) {
    return (int)row_dot::launch(dout, out, (float*)delta, rows, D, dtype,
                                (cudaStream_t)stream);
}

// The resources of the tensor-core kernels a bf16 (dtype 1) or f16 (2) call
// at this chunk and D runs, as the loaded library reports them: out[0..4] =
// registers, local (spill) bytes, dynamic shared bytes, resident blocks per
// SM and threads per block of k4_tc (out[5..9] zero) or of k4_dq_tc, and
// out[5..9] of k4_dkdv_tc, or (D above 128, every dtype 0-2) of
// k4_dq_slab / k4_dkdv_slab.  Returns a cudaError_t
// (cudaErrorInvalidValue for f32 up to D 128 or a D it does not take).
extern "C" int chunked_window_attn_bwd_resources(int chunk, int D, int dtype, int* out) {
    if (chunk <= 0) return (int)cudaErrorInvalidValue;
    if (dtype == 0)                // f32 has tensor-core kernels above D 128 only
        return D > 128 && D % 128 == 0 ? (int)resources_slab<float>(out)
                                       : (int)cudaErrorInvalidValue;
    if (dtype == 1) return (int)resources_c<__nv_bfloat16>(chunk, D, out);
    if (dtype == 2) return (int)resources_c<__half>(chunk, D, out);
    return (int)cudaErrorInvalidValue;
}
