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
// Routes, chosen inside the C entry point by dtype, chunk and D: every f32
// call and every call above D 128 -> the slab split (k4_dq_slab /
// k4_dkdv_slab, below; f32 in 3xTF32); bf16 / f16 at chunks 32 / 64 and D
// <= 64 -> k4_tc; the other bf16 / f16 calls -> the tiled split on the
// tensor cores (k4_dq_tc / k4_dkdv_tc).
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

#include "mma_bf16.cuh"
#include "kernel_resources.cuh"
#include "row_dot.cuh"
#include "slab_mma.cuh"

namespace {

constexpr float kNegInf = -1e9f;

using kernel_resources::resources;

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
// What k4_tc does not take in bf16 and f16 -- a chunk other than 32 or 64,
// or D = 128 -- in two kernels over 64-row tiles, as K2's kernels split the
// work (chunked_window_attn_fwd.cu's k3_union_tc is the forward):
//   k4_dq_tc:   one block per (g, 64 query rows): walks the 64-key tiles of
//               the union of its rows' windows, keeps dq in registers;
//   k4_dkdv_tc: one block per (g, 64 key rows): walks the 64-row query
//               tiles whose windows hold its keys (the queries of chunks j
//               and j + 1 for a key of chunk j), keeps dk / dv in registers.
// p = exp(s - lse) for a key inside the query's window (0 outside it), ds =
// p (dp - delta + dlse) scale, p and ds rounded to the input dtype where
// they enter a product.  The slab split below walks the same tiles.
namespace tiled {

constexpr int B = 64;              // rows per tile

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

}  // namespace tiled

// ---------------------------------------- every f32 call, and 16 bits above D 128: the slab split
// k4_dq_slab (query tiles, each over the 64-key tiles of its rows' windows)
// and k4_dkdv_slab (key tiles, each over the 64-row query tiles that see
// it): the tiled split above over slabs of the head dim, for every f32 call
// (D 16, 32, 64, 128 and above, in 3xTF32) and bf16 / f16 above D 128.
// They replace the Pallas kernel's f32 and wide-head paths
// (chunked_attention_kernel.py::_make_bwd, as the file's other kernels do).
// Eight warps, two per 16-row group: warp c of group p computes S = Q K^T
// and dP = dO V^T for its 16 rows over keys [32c, 32c + 32), interleaved
// (`pair_product`), and owns columns [OW c, OW c + OW) of every output slab
// (OW = W / 2).  Per tile pair the head dim streams through a ring of two
// cp.async stages (slab i + 1 loads while slab i's products run): S and dP
// are summed over the slabs once, p and ds follow on the fragments (selects,
// not branches), the pair's dS (dq) or P^T and dS^T (dk / dv, transposed so
// that they load by ldmatrix) go to shared memory, and the block applies
// them to each of its output slabs in turn (dq += dS K; dv += P^T dO, dk +=
// dS^T Q), restaging only the operand slab each needs (the last score
// slab's tiles serve the last output slab in place).  The running sums of
// up to ZS output slabs stay in registers (a lane holds 16 f32 per slab and
// output), so S and dP are computed once per tile pair up to D 512 for dq
// and D 256 for dk / dv; above that the output slabs split over ceil(ns /
// ZS) blocks (grid z), each recomputing the scores.  At one slab (D <= 64)
// the block's fixed operands (Q, dO for dq; K, V for dk / dv) are staged
// once, in stage 0's spare tiles, and only the moving pair streams.  The LSH own key is the key of a row's
// own index (qpos == kpos there: the bucket sort moves q and k together);
// in a tile pair that holds own keys, lane l of each warp continues
// self_score's sequential f32 FMA chain of row 16p + l % 16 one k-block at
// a time inside the product loop (its latency hidden among the products),
// and p_ds takes it by a shuffle, so that the own key's score is fl(fl(chain
// scale) + self_bias), the one K3 built lse from, and p = 1 exactly where a
// row sees only its own key: once per row and kernel, from shared memory.
// In f32 each k-block's score products and each tile pair's output products
// go into a fresh fragment (the first product with C = 0) and from there
// into the running sums by an f32 add (the tensor cores truncate while they
// accumulate).  f32 over several slabs (D >= 128) carries S across slabs
// as a pair hi + lo (carry_slab, in 32 KB of shared memory) and p takes
// exp(fl(s scale - lse) + lo scale): with unnormalised keys at scale 1 (|s|
// ~ 50) one f32 running sum put p ~1e-5 off, the whole f32 limit.  What
// bounds it: the products, five D-long ones per visible pair, at the tensor
// cores' rate (f32 at a third of TF32's), and in f32 the operand splits
// around them; at one slab also the moving pair's bytes, restaged from L2
// per tile pair.  Shared memory: f32 W 64 157 KB (dq) / 174 KB (dk / dv),
// 189 / 207 KB with the carry, 16 bits 83 / 92 KB; one block of eight
// warps per SM (the registers of the running sums).
namespace slabs {

using namespace slab;
using tiled::B;

constexpr int SP = 2;                   // warps per 16-row group
constexpr int NT = 32 * SP * (B / 16);  // eight warps
constexpr int KW = B / SP;              // keys of a warp's S / dP
constexpr int ZQ = 8, ZKV = 4;          // most output slabs a dq / dk-dv block holds

// f32 scores over several slabs carry their sum as a pair (carry_slab): the
// instances that hold more than one output slab, which f32 takes at D >= 128
template <typename E, int ZS>
constexpr bool kCarry = kF32<E> && ZS > 1;
constexpr size_t CARRY_BYTES = 2 * NT * (KW / 8) * 4 * sizeof(float);   // each lane's pair

template <typename E, int W>
struct Lay {
    static constexpr int RS = W + PAD<E>, PS = B + PAD<E>;
    static constexpr int TILE = B * RS;                      // one staged [64][W] tile
    static constexpr int OW = W / SP < 16 ? 16 : W / SP;     // a warp's columns of an output slab
    // the ring (two stages of Q, dO, K, V); n_pds [B][PS] tiles (dS; P and
    // dS for dk / dv)
    static constexpr size_t bytes(int n_pds, bool carry = false) {
        return (size_t)(8 * TILE + n_pds * B * PS) * sizeof(E) + (carry ? CARRY_BYTES : 0);
    }
};

// a slab instance: width W, output slabs per block of dq (ZQ) and dk / dv (ZKV)
template <int W_, int ZQ_, int ZKV_>
struct Cfg {
    static constexpr int W = W_, ZQ = ZQ_, ZKV = ZKV_;
};

// f(Cfg) for the instance a call at head dim D runs: W = min(D, 64), every
// output slab in one block up to ZQ / ZKV slabs (16 bits take D above 128 only)
template <typename E, typename F>
cudaError_t with_cfg(int D, F&& f) {
    if constexpr (kF32<E>) {
        switch (D) {
            case 16: return f(Cfg<16, 1, 1>{});
            case 32: return f(Cfg<32, 1, 1>{});
            case 64: return f(Cfg<64, 1, 1>{});
            case 128: return f(Cfg<64, 2, 2>{});
        }
    }
    if (D <= 128 || D % 128) return cudaErrorInvalidValue;
    return D <= 256 ? f(Cfg<64, 4, 4>{}) : f(Cfg<64, ZQ, ZKV>{});
}

// the row terms of rows r0 and r0 + 8: position (INT_MIN past T), lse,
// delta, dlse, and the first key of the row's window, lo (chunk C)
struct Rows {
    int qp[2], lo[2];
    float l[2], de[2], dl[2];
};

__device__ __forceinline__ void load_rows(Rows& x, const int* qpos, const float* lse,
                                          const float* delta, const float* dlse, size_t base,
                                          int r0, int T_, int C) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        const bool ok = r < T_;
        x.lo[h] = (r / C - 1) * C;
        x.qp[h] = ok ? __ldg(qpos + base + r) : INT_MIN;
        x.l[h] = ok ? __ldg(lse + base + r) : 0.f;
        x.de[h] = ok ? __ldg(delta + base + r) : 0.f;
        x.dl[h] = ok ? __ldg(dlse + base + r) : 0.f;
    }
}

// p and ds of the warp's entries in place of s and dp: rows q0 + 16p + g
// (+8) (row terms x), keys k0 + KW c + 8j + 2t (+1) (positions kp); `prob`
// (the row's window from x.lo), but a row's own key (key index == row, kpos
// == qpos) in a layer with a self bias takes the chained score of its row,
// which lane (row - q0 - 16p) holds in own_v.  LO: s is the pair s + lo
// (carry_slab; lo the lane's words at `lo`), and a visible entry without a
// self bias takes exp(fl(s scale - lse) + lo scale), so that neither s nor
// s scale is rounded at its own magnitude.  Selects, not branches: every
// entry takes one exp, and no entry waits on a divergent path
template <bool LO>
__device__ __forceinline__ void p_ds(float (&s)[KW / 8][4], float (&dp)[KW / 8][4],
                                     const float* lo, const Rows& x,
                                     const int (&kp)[KW / 8][2], float own_v, bool bias, int q0,
                                     int k0, int T_, int C, float scale, float self_bias, int p,
                                     int c, int lane) {
    const int g = lane >> 2, t = lane & 3;
    float own[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) own[h] = __shfl_sync(0xffffffffu, own_v, g + 8 * h);
#pragma unroll
    for (int j = 0; j < KW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int h = e >> 1, r = q0 + 16 * p + g + 8 * h;
            const int wk = k0 + KW * c + 8 * j + 2 * t + (e & 1), kpe = kp[j][e & 1];
            const bool in = r < T_ && wk < T_ && wk >= x.lo[h] && wk < x.lo[h] + 2 * C;
            float xs = s[j][e] * scale;
            xs = kpe == x.qp[h] ? xs + self_bias : xs;
            xs = kpe <= x.qp[h] ? xs : kNegInf;
            xs = bias && wk == r && kpe == x.qp[h] ? own[h] : xs;
            float arg = xs - x.l[h];
            // visible and not biased: the entries whose score is s scale
            if constexpr (LO)
                arg = kpe < x.qp[h] || (kpe == x.qp[h] && !bias)
                          ? __fadd_rn(__fmaf_rn(s[j][e], scale, -x.l[h]),
                                      __fmul_rn(lo[(4 * j + e) * 32 + lane], scale))
                          : arg;
            const float pr = in ? expf(arg) : 0.f;
            s[j][e] = pr;
            dp[j][e] = pr * (dp[j][e] - x.de[h] + x.dl[h]) * scale;
        }
}

template <typename E, int W, int ZS>
__global__ void __launch_bounds__(NT, 1)
k4_dq_slab(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
           const E* __restrict__ dout, const int* __restrict__ qpos,
           const int* __restrict__ kpos, const float* __restrict__ lse,
           const float* __restrict__ delta, const float* __restrict__ dlse,
           E* __restrict__ dq, int T_, int C, float scale, float self_bias, int ns) {
    using L = Lay<E, W>;
    constexpr int RS = L::RS, PS = L::PS, TILE = L::TILE, OW = L::OW, K8 = KS<E>;
    constexpr bool CARRY = kCarry<E, ZS>;
    const int H = W * ns;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    E* ring = reinterpret_cast<E*>(smem_raw);    // stage b: Q, dO, K, V at ring + (4 b + i) TILE
    E* sDS = ring + 8 * TILE;                    // [B][PS]

    const int g = blockIdx.y, z0 = blockIdx.z * ZS, nz = min(ZS, ns - z0);
    const int q0 = blockIdx.x * B;
    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
    const int p = w / SP, c = w % SP, gq = lane >> 2, t = lane & 3;
    const bool bias = self_bias != 0.f, once = ns == 1;
    // CARRY: the warp's score pairs between slabs, past dS
    float* hold = reinterpret_cast<float*>(sDS + B * PS) + w * 2 * 4 * (KW / 8) * 32;
    const size_t base = (size_t)g * T_;
    const E *q_g = q + base * H, *k_g = k + base * H, *v_g = v + base * H;
    const E* do_g = dout + base * H;

    Rows x;
    load_rows(x, qpos, lse, delta, dlse, base, q0 + 16 * p + gq, T_, C);
    // the key tiles of the rows' windows, none wholly before the sequence
    const int q_last = min(q0 + B, T_) - 1;
    int w_lo = (q0 / C - 1) * C;
    if (w_lo < 0) w_lo += -w_lo / B * B;
    const int n_kt = ((q_last / C + 1) * C - w_lo + B - 1) / B;
    // the items of a key tile: its ns score slabs, then the block's output
    // slabs but the head dim's last, which the last score slab's tiles serve
    const bool last_in = z0 + nz == ns;
    const int per = ns + nz - last_in, n_items = n_kt * per;
    auto issue = [&](int n) {                    // item n's tiles into stage n % 2
        const int m = n % per, k0 = w_lo + n / per * B;
        E* st = ring + (n & 1) * 4 * TILE;
        if (m < ns) {
            if (!once) {
                stage<W>(st, q_g, q0, B, T_, H, W * m, tid, NT);
                stage<W>(st + TILE, do_g, q0, B, T_, H, W * m, tid, NT);
            }
            stage<W>(st + 2 * TILE, k_g, k0, B, T_, H, W * m, tid, NT);
            stage<W>(st + 3 * TILE, v_g, k0, B, T_, H, W * m, tid, NT);
        } else {
            stage<W>(st + 2 * TILE, k_g, k0, B, T_, H, W * (z0 + m - ns), tid, NT);
        }
        mma_bf16::cp_commit();
    };
    if (once) {                                  // Q, dO: stage 0's first tiles, for good
        stage<W>(ring, q_g, q0, B, T_, H, 0, tid, NT);
        stage<W>(ring + TILE, do_g, q0, B, T_, H, 0, tid, NT);
    }
    issue(0);

    // query rows 16p + gq (+8), columns W (z0 + zz) + OW c + 8n + 2t
    float acc[ZS][OW / 8][4] = {};
    // dq[:, slab z0 + zi] += dS . K_slab (tK), the warp's columns, the
    // pair's products summed apart
    auto apply = [&](int zi, const E* tK) {
        if (OW * c >= W) return;                 // W 16: the group's second warp has none
#pragma unroll
        for (int zz = 0; zz < ZS; ++zz) {
            if (zz != zi) continue;
#pragma unroll
            for (int cp = 0; cp < OW / 16; cp += CH) {
                float tq[2 * CH][4] = {};
#pragma unroll 1
                for (int kb = 0; kb < B / K8; ++kb) {
                    FragA<E> a;
                    load_a(a, sDS, PS, 16 * p, K8 * kb, lane);
#pragma unroll
                    for (int j = 0; j < CH && cp + j < OW / 16; ++j) {
                        FragB<E> b[2];
                        load_bt(b, tK, RS, OW * c + 16 * (cp + j), K8 * kb, lane);
                        mma(tq[2 * j], a, b[0]);
                        mma(tq[2 * j + 1], a, b[1]);
                    }
                }
                add_pass(acc[zz], tq, cp);
            }
        }
    };

    float s[KW / 8][4], dp[KW / 8][4];
    int kp[KW / 8][2];
    float own = 0.f;                             // lane l: the own score's chain of row 16p + l % 16
    const int ol = 16 * p + (lane & 15), ro = q0 + ol;
    for (int n = 0; n < n_items; ++n) {
        const int m = n % per, k0 = w_lo + n / per * B;
        mma_bf16::cp_wait<0>();
        __syncthreads();                         // item n landed; item n - 1 is done
        if (n + 1 < n_items) issue(n + 1);
        const E* st = ring + (n & 1) * 4 * TILE;
        const E* tQ = once ? ring : st;
        if (m >= ns) {
            apply(m - ns, st + 2 * TILE);
            continue;
        }
        if (m == 0) {
#pragma unroll
            for (int j = 0; j < KW / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
            own = 0.f;
        }
        if (m == ns - 1) load_keys(kp, kpos, base, k0 + KW * c + 2 * t, T_);
        // a pair that holds own keys: lane l also chains row 16p + l % 16
        // against its own key (clamped into the key tile)
        if (bias && k0 < q0 + B && q0 < k0 + B)
            pair_product<E, W, true>(s, dp, tQ, tQ + TILE, st + 2 * TILE, st + 3 * TILE, 16 * p,
                                     KW * c, RS, lane, own, tQ + ol * RS,
                                     st + 2 * TILE + min(max(ro - k0, 0), B - 1) * RS);
        else
            pair_product<E, W, false>(s, dp, tQ, tQ + TILE, st + 2 * TILE, st + 3 * TILE,
                                      16 * p, KW * c, RS, lane, own, tQ, tQ);
        if constexpr (CARRY) carry_slab(s, hold, m, ns, lane);
        if (m < ns - 1) continue;
        p_ds<CARRY>(s, dp, hold + 4 * (KW / 8) * 32, x, kp,
                    __fadd_rn(__fmul_rn(own, scale), self_bias), bias, q0, k0, T_, C, scale,
                    self_bias, p, c, lane);
        put_frags<E, false>(sDS, dp, PS, 16 * p, KW * c, lane);
        mma_bf16::group_sync<SP>(p);             // the group's dS rows are written
        if (last_in) apply(ns - 1 - z0, st + 2 * TILE);
    }
    mma_bf16::cp_wait<0>();                      // no copy left in flight

#pragma unroll
    for (int zz = 0; zz < ZS; ++zz) {
        if (zz >= nz || OW * c >= W) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = q0 + 16 * p + gq + 8 * h;
            if (r >= T_) continue;
            E* o = dq + (base + r) * H + W * (z0 + zz) + OW * c;
#pragma unroll
            for (int n = 0; n < OW / 8; ++n)
                put2<E>(o + 8 * n + 2 * t, acc[zz][n][2 * h], acc[zz][n][2 * h + 1]);
        }
    }
}

template <typename E, int W, int ZS>
__global__ void __launch_bounds__(NT, 1)
k4_dkdv_slab(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
             const E* __restrict__ dout, const int* __restrict__ qpos,
             const int* __restrict__ kpos, const float* __restrict__ lse,
             const float* __restrict__ delta, const float* __restrict__ dlse,
             float* __restrict__ dk, float* __restrict__ dv, int T_, int C, float scale,
             float self_bias, int ns) {
    using L = Lay<E, W>;
    constexpr int RS = L::RS, PS = L::PS, TILE = L::TILE, OW = L::OW, K8 = KS<E>;
    constexpr bool CARRY = kCarry<E, ZS>;
    const int H = W * ns;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    E* ring = reinterpret_cast<E*>(smem_raw);    // stage b: Q, dO, K, V at ring + (4 b + i) TILE
    E* sP = ring + 8 * TILE;                     // P^T [B keys][PS]
    E* sDS = sP + B * PS;                        // dS^T

    const int g = blockIdx.y, z0 = blockIdx.z * ZS, nz = min(ZS, ns - z0);
    const int k0 = blockIdx.x * B;
    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
    const int p = w / SP, c = w % SP, gq = lane >> 2, t = lane & 3;
    const bool bias = self_bias != 0.f, once = ns == 1;
    // CARRY: the warp's score pairs between slabs, past dS
    float* hold = reinterpret_cast<float*>(sDS + B * PS) + w * 2 * 4 * (KW / 8) * 32;
    const size_t base = (size_t)g * T_;
    const E *q_g = q + base * H, *k_g = k + base * H, *v_g = v + base * H;
    const E* do_g = dout + base * H;

    int kp[KW / 8][2];
    load_keys(kp, kpos, base, k0 + KW * c + 2 * t, T_);
    // the query tiles whose windows hold a key of [k0, k_last]
    const int k_last = min(k0 + B, T_) - 1;
    const int r_lo = (k0 / C) * C, r_hi = min((k_last / C + 2) * C, T_);
    const int n_qt = (r_hi - r_lo + B - 1) / B;
    const bool last_in = z0 + nz == ns;
    const int per = ns + nz - last_in, n_items = n_qt * per;
    auto issue = [&](int n) {                    // item n's tiles into stage n % 2
        const int m = n % per, q0 = r_lo + n / per * B;
        E* st = ring + (n & 1) * 4 * TILE;
        const int c0 = W * (m < ns ? m : z0 + m - ns);
        stage<W>(st, q_g, q0, B, T_, H, c0, tid, NT);
        stage<W>(st + TILE, do_g, q0, B, T_, H, c0, tid, NT);
        if (m < ns && !once) {
            stage<W>(st + 2 * TILE, k_g, k0, B, T_, H, c0, tid, NT);
            stage<W>(st + 3 * TILE, v_g, k0, B, T_, H, c0, tid, NT);
        }
        mma_bf16::cp_commit();
    };
    if (once) {                                  // K, V: stage 0's last tiles, for good
        stage<W>(ring + 2 * TILE, k_g, k0, B, T_, H, 0, tid, NT);
        stage<W>(ring + 3 * TILE, v_g, k0, B, T_, H, 0, tid, NT);
    }
    issue(0);

    // key rows 16p + gq (+8), columns W (z0 + zz) + OW c + 8n + 2t
    float dka[ZS][OW / 8][4] = {}, dva[ZS][OW / 8][4] = {};
    // dv[:, slab z0 + zi] += P^T dO_slab, dk += dS^T Q_slab (tQ, tO), the
    // warp's columns, PC n-pairs per pass (one where the running sums of four
    // slabs leave no registers for more), the pair's products summed apart
    constexpr int PC = ZS <= 2 ? 2 : 1;
    auto apply = [&](int zi, const E* tQ, const E* tO) {
        if (OW * c >= W) return;                 // W 16: the group's second warp has none
#pragma unroll
        for (int zz = 0; zz < ZS; ++zz) {
            if (zz != zi) continue;
#pragma unroll
            for (int cp = 0; cp < OW / 16; cp += PC) {
                float tv[2 * PC][4] = {}, tk[2 * PC][4] = {};
#pragma unroll 1
                for (int kq = 0; kq < B / K8; ++kq) {
                    FragA<E> ap, ad;
                    load_a(ap, sP, PS, 16 * p, K8 * kq, lane);
                    load_a(ad, sDS, PS, 16 * p, K8 * kq, lane);
#pragma unroll
                    for (int j = 0; j < PC && cp + j < OW / 16; ++j) {
                        FragB<E> bo[2], bq[2];
                        load_bt(bo, tO, RS, OW * c + 16 * (cp + j), K8 * kq, lane);
                        load_bt(bq, tQ, RS, OW * c + 16 * (cp + j), K8 * kq, lane);
                        mma(tv[2 * j], ap, bo[0]);
                        mma(tk[2 * j], ad, bq[0]);
                        mma(tv[2 * j + 1], ap, bo[1]);
                        mma(tk[2 * j + 1], ad, bq[1]);
                    }
                }
                add_pass(dva[zz], tv, cp);
                add_pass(dka[zz], tk, cp);
            }
        }
    };

    Rows x;
    float s[KW / 8][4], dp[KW / 8][4];
    float own = 0.f;                             // lane l: the own score's chain of row 16p + l % 16
    const int ol = 16 * p + (lane & 15);
    for (int n = 0; n < n_items; ++n) {
        const int m = n % per, q0 = r_lo + n / per * B;
        mma_bf16::cp_wait<0>();
        __syncthreads();                         // item n landed; item n - 1 is done
        if (n + 1 < n_items) issue(n + 1);
        const E* st = ring + (n & 1) * 4 * TILE;
        const E* tK = (once ? ring : st) + 2 * TILE;
        if (m >= ns) {
            apply(m - ns, st, st + TILE);
            continue;
        }
        if (m == 0) {
#pragma unroll
            for (int j = 0; j < KW / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
            own = 0.f;
        }
        if (m == ns - 1) load_rows(x, qpos, lse, delta, dlse, base, q0 + 16 * p + gq, T_, C);
        // a pair that holds own keys: lane l also chains row 16p + l % 16 of
        // the q tile against its own key (clamped into the key tile)
        if (bias && k0 < q0 + B && q0 < k0 + B)
            pair_product<E, W, true>(s, dp, st, st + TILE, tK, tK + TILE, 16 * p, KW * c, RS,
                                     lane, own, st + ol * RS,
                                     tK + min(max(q0 + ol - k0, 0), B - 1) * RS);
        else
            pair_product<E, W, false>(s, dp, st, st + TILE, tK, tK + TILE, 16 * p, KW * c, RS,
                                      lane, own, st, st);
        if constexpr (CARRY) carry_slab(s, hold, m, ns, lane);
        if (m < ns - 1) continue;
        p_ds<CARRY>(s, dp, hold + 4 * (KW / 8) * 32, x, kp,
                    __fadd_rn(__fmul_rn(own, scale), self_bias), bias, q0, k0, T_, C, scale,
                    self_bias, p, c, lane);
        put_frags<E, true>(sP, s, PS, 16 * p, KW * c, lane);
        put_frags<E, true>(sDS, dp, PS, 16 * p, KW * c, lane);
        __syncthreads();                         // every warp's P^T / dS^T entries are written
        if (last_in) apply(ns - 1 - z0, st, st + TILE);
    }
    mma_bf16::cp_wait<0>();                      // no copy left in flight

#pragma unroll
    for (int zz = 0; zz < ZS; ++zz) {
        if (zz >= nz || OW * c >= W) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int wk = k0 + 16 * p + gq + 8 * h;
            if (wk >= T_) continue;
            const size_t o = (base + wk) * H + W * (z0 + zz) + OW * c;
#pragma unroll
            for (int n = 0; n < OW / 8; ++n) {
                put2<float>(dk + o + 8 * n + 2 * t, dka[zz][n][2 * h], dka[zz][n][2 * h + 1]);
                put2<float>(dv + o + 8 * n + 2 * t, dva[zz][n][2 * h], dva[zz][n][2 * h + 1]);
            }
        }
    }
}

template <typename E, int W, int ZQ_, int ZKV_>
cudaError_t launch_w(const Args& a, int C, int ns) {
    using L = Lay<E, W>;
    const size_t smem_q = L::bytes(1, kCarry<E, ZQ_>), smem_kv = L::bytes(2, kCarry<E, ZKV_>);
    auto kq = k4_dq_slab<E, W, ZQ_>;
    auto kv = k4_dkdv_slab<E, W, ZKV_>;
    cudaError_t err = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem_q);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
    if (err != cudaSuccess) return err;
    const int tiles = (a.T + B - 1) / B;
    const E *q = (const E*)a.q, *k = (const E*)a.k, *v = (const E*)a.v, *dout = (const E*)a.dout;
    kq<<<dim3(tiles, a.G, (ns + ZQ_ - 1) / ZQ_), NT, smem_q, a.st>>>(
        q, k, v, dout, a.qpos, a.kpos, a.lse, a.delta, a.dlse, (E*)a.dq, a.T, C, a.scale,
        a.self_bias, ns);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    kv<<<dim3(tiles, a.G, (ns + ZKV_ - 1) / ZKV_), NT, smem_kv, a.st>>>(
        q, k, v, dout, a.qpos, a.kpos, a.lse, a.delta, a.dlse, a.dk, a.dv, a.T, C, a.scale,
        a.self_bias, ns);
    return cudaGetLastError();
}

template <typename E>
cudaError_t launch(const Args& a, int C, int D) {
    return with_cfg<E>(D, [&](auto cfg) {
        using F = decltype(cfg);
        return launch_w<E, F::W, F::ZQ, F::ZKV>(a, C, D / F::W);
    });
}

// the resources of the dq and dk / dv instances a call at head dim D runs
template <typename E>
cudaError_t resources_d(int D, int* out) {
    return with_cfg<E>(D, [&](auto cfg) {
        using F = decltype(cfg);
        using L = Lay<E, F::W>;
        cudaError_t err = resources(k4_dq_slab<E, F::W, F::ZQ>,
                                    L::bytes(1, kCarry<E, F::ZQ>), NT, out);
        if (err != cudaSuccess) return err;
        return resources(k4_dkdv_slab<E, F::W, F::ZKV>, L::bytes(2, kCarry<E, F::ZKV>), NT,
                         out + 5);
    });
}

}  // namespace slabs

template <typename E, int C, int D>
cudaError_t run(const Args& a) {
    return tc::launch<E, C, D>(a.q, a.k, a.v, a.dout, a.qpos, a.kpos, a.lse, a.delta, a.dlse,
                               a.dq, a.dk, a.dv, a.G, a.T, a.scale, a.self_bias, a.st);
}

template <typename E, int C>
cudaError_t run_d(int D, const Args& a) {
    switch (D) {
        case 16: return run<E, C, 16>(a);
        case 32: return run<E, C, 32>(a);
        case 64: return run<E, C, 64>(a);
        default: return cudaErrorInvalidValue;
    }
}

template <typename E>
cudaError_t run_c(int C, int D, const Args& a) {
    switch (C) {
        case 32: return run_d<E, 32>(D, a);
        case 64: return run_d<E, 64>(D, a);
        default: return cudaErrorInvalidValue;
    }
}

template <typename E, int D>
cudaError_t run_tiled_d(int C, const Args& a) {
    return tiled::launch_tc<E, D>(a.q, a.k, a.v, a.dout, a.qpos, a.kpos, a.lse, a.delta, a.dlse,
                                  a.dq, a.dk, a.dv, a.G, a.T, C, a.scale, a.self_bias, a.st);
}

template <typename E>
cudaError_t run_tiled(int C, int D, const Args& a) {
    switch (D) {
        case 16: return run_tiled_d<E, 16>(C, a);
        case 32: return run_tiled_d<E, 32>(C, a);
        case 64: return run_tiled_d<E, 64>(C, a);
        case 128: return run_tiled_d<E, 128>(C, a);
        default: return cudaErrorInvalidValue;
    }
}

// the resources of the tensor-core kernels of a 16-bit call up to D 128:
// k4_tc (out[0..4]; out[5..9] zero) or k4_dq_tc and k4_dkdv_tc
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

// the kernels a call of this dtype, chunk and D runs: every f32 call and D
// above 128 -> the slab split; bf16 / f16 at chunks 32 / 64 and D <= 64 ->
// k4_tc; the rest -> the tiled split on the tensor cores
template <typename E>
cudaError_t resources_c(int C, int D, int* out) {
    if constexpr (!slab::kF32<E>) {
        switch (D) {
            case 16: return resources_d<E, 16>(C, out);
            case 32: return resources_d<E, 32>(C, out);
            case 64: return resources_d<E, 64>(C, out);
            case 128: return resources_d<E, 128>(C, out);
        }
    }
    return slabs::resources_d<E>(D, out);
}

template <typename E>
cudaError_t route(int C, int D, const Args& a) {
    if constexpr (!slab::kF32<E>) {
        if (D <= 128)
            return (C == 32 || C == 64) && D <= 64 ? run_c<E>(C, D, a) : run_tiled<E>(C, D, a);
    }
    return slabs::launch<E>(a, C, D);
}

}  // namespace

// q/k/v/dout [G, T, D] (dtype 0 = f32, 1 = bf16, 2 = f16), qpos/kpos int32
// [G, T], lse/delta/dlse f32 [G, T]; dq [G, T, D] in the input dtype, dk/dv
// [G, T, D] f32.  T % chunk == 0; D 16, 32, 64, 128 or a multiple of 128.
// Every f32 call and D above 128 run k4_dq_slab / k4_dkdv_slab; bf16 and
// f16 at chunks 32 and 64 with D <= 64 run k4_tc, every other chunk and D
// 128 the tiled split (k4_dq_tc / k4_dkdv_tc).
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

// The resources of the kernels a call of this dtype (0 = f32, 1 = bf16, 2 =
// f16), chunk and D runs, as the loaded library reports them: out[0..4] =
// registers, local (spill) bytes, dynamic shared bytes, resident blocks per
// SM and threads per block of k4_tc (out[5..9] zero), k4_dq_tc or
// k4_dq_slab, and out[5..9] of k4_dkdv_tc or k4_dkdv_slab.  Returns a
// cudaError_t (cudaErrorInvalidValue for a D it does not take).
extern "C" int chunked_window_attn_bwd_resources(int chunk, int D, int dtype, int* out) {
    if (chunk <= 0) return (int)cudaErrorInvalidValue;
    if (dtype == 0) return (int)resources_c<float>(chunk, D, out);
    if (dtype == 1) return (int)resources_c<__nv_bfloat16>(chunk, D, out);
    if (dtype == 2) return (int)resources_c<__half>(chunk, D, out);
    return (int)cudaErrorInvalidValue;
}
