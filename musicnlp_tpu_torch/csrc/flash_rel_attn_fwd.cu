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
// Both kernels are flash attention: one block per (bn, 64-row q tile), a
// loop over the 64-key tiles the rows can see (the longest rows' blocks
// first) with the running max / sum / context on chip; tiles fully in the
// future, fully behind the window or fully inside the empty memory slots are
// skipped.  p is rounded to v's dtype before the PV product and l is held at
// >= 1e-30, where the TPU kernel does both.
//
// Bound on the H100 (SXM, 700 W): three H-long products (AC, BD, PV) per
// visible pair and each input read once.  At the training shape (BN 252,
// T = S = 1024, H 64, bf16, causal) that is ~50.7 GFLOP, 0.0513 ms at 989
// TFLOP/s (bytes: 0.052 GB, 0.016 ms): operations bound it.  At the scoring
// shape (BN 96) 19.3 GFLOP and 66 MB bound it about equally (0.0196 / 0.0198
// ms).
//
// Two kernels, chosen inside the C entry point by dtype and H:
//   bf16 / f16 up to H 128: k1_tc (below);
//   f32 at every H, bf16 / f16 above 128: k1_slab (the slab kernel, after
//   namespace tc), whose f32 products are 3xTF32 on the tensor cores.
// The grouped-query form (entry point gqa_attn_fwd; k1_gqa_tc, k1_gqa_slab)
// is the same forward without the distance term, for G query heads over
// one key / value head: the score is q . k * scale.
//
// bf16 and f16 (k1_tc, templated on the element type E), at H <= 128: the
// q tile's 64 rows are four 16-row groups; at H <= 64 a group is one warp,
// at H = 128 two (eight warps per block, see Split).  AC = Qw . K^T, BD and
// PV are mma.sync m16n8k16 (E in, f32 accumulate) on ldmatrix fragments
// (mma_bf16.cuh); the group's Qw / Qr fragments stay in registers for the
// whole key loop.  BD is K2's skew (flash_rel_attn_bwd.cu): X = Qr . Gwin^T
// over the warp's XW = KW + 16 columns [48 - 16p + KW c, ...) of the
// 128-row table window from u_lo = T - q0 - 64 + k0 (KW = 64 keys per warp,
// or 32 at H = 128 where warp c takes keys [32c, 32c + 32)), staged as f32 in
// the warp's scratch and read back at column 15 - qr + kl.  Consecutive key
// tiles' windows overlap by 64 rows, so the window is a ring of three 64-row
// slabs and each key tile loads only its new slab.  K / V / the new slab of
// the next key tile are loaded by cp.async into a second buffer while the
// current tile computes (one barrier per tile).  The online softmax runs on
// the accumulator fragments: row max across the four lanes of a quad by
// shuffles (at H = 128 then across the group's two warps through shared
// memory), each lane's partial row sum rescaled by alpha and reduced once at
// the end, p = exp2f((x - m) * log2(e)) with x and m in natural units (so
// max, masks and lse are exactly the f32 values of the reference), p
// rounded to E by RNE where it enters PV against V read by ldmatrix.trans
// (at H <= 64 straight from the accumulators by c_to_a; at H = 128 the
// group's two halves of P meet as b16 rows over its BD staging, behind a
// named barrier, and warp c multiplies them into ctx columns [64c, 64c +
// 64)).  Tile pairs that the TPU kernel calls `interior` (every pair
// visible; here also every key inside [0, S)) skip the per-pair mask.  The
// context is scaled by one reciprocal per row.  Shared memory at H = 64: Qw,
// Qr 18 KB, K / V x 2 stages 36 KB, the table ring 27 KB, the warps' BD
// staging 21 KB -- 102 KB, two blocks (eight warps) per SM; at H = 128: 35 +
// 70 + 52 + 27 KB -- 180 KB, one block of eight warps.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "kernel_resources.cuh"
#include "mma_bf16.cuh"
#include "slab_mma.cuh"

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr float kNegInf = -1e30f;

using kernel_resources::resources;

// ------------------------------------------- bf16 and f16 on the tensor cores
namespace tc {

using namespace mma_bf16;

constexpr int NG = BQ / 16;      // 16-row groups of a q tile
constexpr float kLog2e = 1.4426950408889634f;

// A group of warps owns 16 q rows.  At H <= 64 it is one warp.  At H = 128
// it is two: warp c computes AC and BD over keys [32c, 32c + 32) of the key
// tile and owns ctx columns [64c, 64c + 64), so that a lane holds 64 f32 of
// ctx and 16 of scores beside its Qw / Qr fragments (one warp would hold 64
// + 32 + 64: over two blocks' budget, and the row's sums need both halves
// anyway).  The pair shares its row max, its halves of P (b16) and, at the
// end, its row sums through shared memory behind a named barrier.
template <int H>
struct Split {
    static constexpr int SP = H > 64 ? 2 : 1;   // warps per 16-row group
    static constexpr int NW = NG * SP;          // warps per block
    static constexpr int NT = 32 * NW;
    static constexpr int KW = BK / SP;          // keys of a warp's scores
    static constexpr int HW = H / SP;           // ctx columns of a warp
    static constexpr int XW = KW + 16;          // BD columns a warp needs
    static constexpr int XS = XW + 4;           // f32 row stride of a warp's BD staging
    static constexpr int PS = BK + 8;           // b16 row stride of a group's P (SP 2)
    static_assert(SP == 1 || 16 * PS * 2 <= SP * 16 * XS * 4, "P fits the group's staging");
};

template <int H>
constexpr size_t smem_bytes() {
    // Qw, Qr; 2 stages of K, V; the table ring (3 slabs of 64 rows), all
    // [.][H+8] b16; each warp's BD staging [16][XS] f32 (at SP 2 the group's
    // P rows overwrite it once its BD is read); at SP 2 each warp's row max /
    // sum [16] f32
    using SPL = Split<H>;
    return 2 * (size_t)(2 * BQ + 2 * 2 * BK + 3 * 64) * (H + 8) +
           (size_t)SPL::NW * 16 * SPL::XS * 4 + (SPL::SP > 1 ? (size_t)SPL::NW * 16 * 4 : 0);
}

// every pair of the tile pair (q0, k0) is visible: the TPU kernel's
// `interior` (flash_attention.py:166-169), and every key inside [0, S)
__device__ __forceinline__ bool interior(int q0, int k0, int S, int M, int mv, int window) {
    return k0 + BK <= S && M + q0 - (k0 + BK - 1) >= 0 && k0 >= M - mv &&
           (window <= 0 || M + q0 + BQ - 1 - k0 < window);
}

// One key tile of the online softmax on the warp's fragments.  s holds AC
// (rows gq, gq + 8 of the group: e >> 1; key columns kc + 8j + 2t + (e & 1)
// of the tile's keys, kc = KW c) and becomes p; BD comes from the warp's
// staging sXw.  m: the rows' running max, l: this lane's partial row sums
// over its keys, both rescaled by alpha, which the caller applies to its
// ctx sums.  At SP 2 the group's two warps take the max of both halves
// through sRow (their [16] f32 row slots; `mate` is the other warp's).
// MASK: the per-pair mask (a tile pair that is not interior); q is the
// query of row gq.  The slab kernel (k1_slab) runs it at SP 2.
template <bool MASK, int H, bool BD = true>
__device__ __forceinline__ void tile_p(float (&s)[Split<H>::KW / 8][4], float (&m)[2],
                                       float (&l)[2], float (&alpha)[2], const float* sXw,
                                       float* sRow, const float* mate, int grp, int q, int kc,
                                       int gq, int t, int S, int M, int mv, float scale,
                                       int window) {
    using SPL = Split<H>;
    constexpr int KW = SPL::KW, XS = SPL::XS;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < KW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int h = e >> 1, qr = gq + 8 * h, ki = 8 * j + 2 * t + (e & 1);
            float x;
            if constexpr (BD)
                x = (s[j][e] + sXw[qr * XS + 15 - qr + ki]) * scale;
            else
                x = s[j][e] * scale;     // the grouped-query form: no distance term
            if (MASK) {
                const int k = kc + ki, d = M + q + 8 * h - k;
                if (!(d >= 0 && k < S && k >= M - mv && (window <= 0 || d < window)))
                    x = kNegInf;
            }
            s[j][e] = x;
            mx[h] = fmaxf(mx[h], x);
        }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    }
    if constexpr (SPL::SP > 1) {        // the max over both key halves
        if (t == 0) {
            sRow[gq] = mx[0];
            sRow[gq + 8] = mx[1];
        }
        group_sync<SPL::SP>(grp);
        mx[0] = fmaxf(mx[0], mate[gq]);
        mx[1] = fmaxf(mx[1], mate[gq + 8]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        alpha[h] = exp2f((m[h] - mx[h]) * kLog2e);
        m[h] = mx[h];
        l[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < KW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float p = exp2f((s[j][e] - mx[e >> 1]) * kLog2e);
            l[e >> 1] += p;
            s[j][e] = p;                 // rounded to E where it enters PV
        }
}

// tile_p, then o (the warp's ctx accumulators) rescaled by alpha
template <bool MASK, int H, bool BD = true>
__device__ __forceinline__ void softmax_tile(float (&s)[Split<H>::KW / 8][4],
                                             float (&o)[Split<H>::HW / 8][4], float (&m)[2],
                                             float (&l)[2], const float* sXw, float* sRow,
                                             const float* mate, int grp, int q, int kc, int gq,
                                             int t, int S, int M, int mv, float scale,
                                             int window) {
    float alpha[2];
    tile_p<MASK, H, BD>(s, m, l, alpha, sXw, sRow, mate, grp, q, kc, gq, t, S, M, mv, scale,
                        window);
#pragma unroll
    for (int n = 0; n < Split<H>::HW / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
}

template <typename E, int H>
__global__ void __launch_bounds__(Split<H>::NT, Split<H>::SP == 1 ? 2 : 1)
k1_tc(const E* __restrict__ rw, const E* __restrict__ rr, const E* __restrict__ kk,
      const E* __restrict__ vv, const E* __restrict__ g, E* __restrict__ out,
      float* __restrict__ lse, const int* __restrict__ mv_ptr, int mv_const, int N, int T_,
      int S, int M, float scale, int window) {
    using SPL = Split<H>;
    constexpr int SP = SPL::SP, KW = SPL::KW, HW = SPL::HW, XW = SPL::XW, XS = SPL::XS;
    constexpr int NT = SPL::NT, PS = SPL::PS;
    constexpr int HS = H + 8;
    constexpr int KH = H / 16;                      // k-blocks of the score products
    constexpr int STAGE = 2 * BK * HS;              // K, V
    extern __shared__ __align__(16) unsigned char smem_raw[];
    E* sQw = reinterpret_cast<E*>(smem_raw);
    E* sQr = sQw + BQ * HS;
    E* sKV = sQr + BQ * HS;                         // stage b: K, V
    E* sGr = sKV + 2 * STAGE;                       // ring of 3 slabs [64][HS]
    float* sX = reinterpret_cast<float*>(sGr + 3 * 64 * HS);   // [NW][16][XS]
    float* sRows = sX + SPL::NW * 16 * XS;                      // [NW][16] (SP 2)

    const int bn = blockIdx.y;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest rows first
    const int head = bn % N;
    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
    const int p = w / SP, c = w % SP;               // 16-row group, warp in the group
    const int gq = lane >> 2, t = lane & 3;
    const int mv = mv_ptr ? *mv_ptr : mv_const;
    float* sXw = sX + w * 16 * XS;
    E* sPg = reinterpret_cast<E*>(sX + p * SP * 16 * XS);      // the group's P [16][PS] (SP 2)
    float* sRow = sRows + w * 16;
    const float* mate = sRows + (w ^ (SP - 1)) * 16;

    const E* k_b = kk + (size_t)bn * S * H;
    const E* v_b = vv + (size_t)bn * S * H;
    const E* g_h = g + (size_t)head * (T_ + S) * H;

    // keys any row of this tile can see
    const int q_last = min(q0 + BQ, T_) - 1;
    const int k_hi = min(S, M + q_last + 1);            // exclusive
    int k_lo = max(0, M - mv);
    if (window > 0) k_lo = max(k_lo, M + q0 - window + 1);
    const int kt_begin = k_lo / BK, kt_end = (k_hi + BK - 1) / BK;

    // the table window slides up 64 rows per key tile: at step `it`, window
    // rows [64s, 64s + 64) are slab (it + s) mod 3, the upper one new each step
    auto slab = [&](int s, int it) { return sGr + ((it + s) % 3) * 64 * HS; };
    auto load_k = [&](int kt, bool first) {          // K, V, the new table slab(s) of tile kt
        const int k0 = kt * BK, it = kt - kt_begin, u_lo = T_ - q0 - BQ + k0;
        E* st = sKV + (it & 1) * STAGE;
        stage_rows<H>(st, k_b, k0, BK, S, tid, NT);
        stage_rows<H>(st + BK * HS, v_b, k0, BK, S, tid, NT);
        if (first) stage_rows<H>(slab(0, it), g_h, u_lo, 64, T_ + S, tid, NT);
        stage_rows<H>(slab(1, it), g_h, u_lo + 64, 64, T_ + S, tid, NT);
        cp_commit();
    };

    float o[HW / 8][4] = {};                        // ctx rows 16p + gq (+8), cols HW c + 8n + 2t
    float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
    uint32_t aw[KH][4], ar[KH][4];                  // the group's Qw / Qr A fragments
    if (kt_begin < kt_end) {
        stage_rows<H>(sQw, rw + (size_t)bn * T_ * H, q0, BQ, T_, tid, NT);
        stage_rows<H>(sQr, rr + (size_t)bn * T_ * H, q0, BQ, T_, tid, NT);
        load_k(kt_begin, true);
        cp_wait<0>();
        __syncthreads();
#pragma unroll
        for (int kb = 0; kb < KH; ++kb) {
            load_a(aw[kb], sQw, HS, 16 * p, 16 * kb, lane);
            load_a(ar[kb], sQr, HS, 16 * p, 16 * kb, lane);
        }
    }
    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int it = kt - kt_begin, k0 = kt * BK;
        cp_wait<0>();
        __syncthreads();                 // tile kt landed; every warp is done with tile kt - 1
        if (kt + 1 < kt_end) load_k(kt + 1, false);
        const E* sK = sKV + (it & 1) * STAGE;
        const E* sV = sK + BK * HS;

        // X = Qr[16p, 16p + 16) . Gwin[48 - 16p + KW c, + XW)^T into the warp's
        // staging: BD[qr][KW c + kl] is X[qr][15 - qr + kl]
#pragma unroll
        for (int np = 0; np < XW / 16; ++np) {
            const int r0 = 48 - 16 * p + KW * c + 16 * np;   // window row; never crosses a slab
            const E* gr = slab(r0 >> 6, it) + (r0 & 63) * HS;
            float x[2][4] = {};
#pragma unroll
            for (int kb = 0; kb < KH; ++kb) {
                uint32_t b[4];
                load_b(b, gr, HS, 0, 16 * kb, lane);
                mma<E>(x[0], ar[kb], b[0], b[1]);
                mma<E>(x[1], ar[kb], b[2], b[3]);
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int col = 16 * np + 8 * h + 2 * t;
                *reinterpret_cast<float2*>(sXw + gq * XS + col) = make_float2(x[h][0], x[h][1]);
                *reinterpret_cast<float2*>(sXw + (gq + 8) * XS + col) =
                    make_float2(x[h][2], x[h][3]);
            }
        }
        // AC = Qw . K^T over the warp's keys: key columns KW c + 8j .. +7
        float s[KW / 8][4] = {};
#pragma unroll
        for (int kb = 0; kb < KH; ++kb)
#pragma unroll
            for (int np = 0; np < KW / 16; ++np) {
                uint32_t b[4];
                load_b(b, sK, HS, KW * c + 16 * np, 16 * kb, lane);
                mma<E>(s[2 * np], aw[kb], b[0], b[1]);
                mma<E>(s[2 * np + 1], aw[kb], b[2], b[3]);
            }
        __syncwarp();                    // the warp's BD staging is written
        const int q = q0 + 16 * p + gq;
        if (interior(q0, k0, S, M, mv, window))
            softmax_tile<false, H>(s, o, m_r, l_r, sXw, sRow, mate, p, q, k0 + KW * c, gq, t,
                                   S, M, mv, scale, window);
        else
            softmax_tile<true, H>(s, o, m_r, l_r, sXw, sRow, mate, p, q, k0 + KW * c, gq, t,
                                  S, M, mv, scale, window);

        // o += P . V[:, HW c, + HW) over the tile's 64 keys
        if constexpr (SP == 1) {         // P from the accumulators
#pragma unroll
            for (int kb = 0; kb < BK / 16; ++kb) {
                uint32_t a[4];
                c_to_a<E>(a, s[2 * kb], s[2 * kb + 1]);
#pragma unroll
                for (int np = 0; np < H / 16; ++np) {
                    uint32_t b[4];
                    load_bt(b, sV, HS, 16 * np, 16 * kb, lane);
                    mma<E>(o[2 * np], a, b[0], b[1]);
                    mma<E>(o[2 * np + 1], a, b[2], b[3]);
                }
            }
        } else {                         // the group's P rows over its staging (BD is read)
#pragma unroll
            for (int j = 0; j < KW / 8; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    *reinterpret_cast<uint32_t*>(sPg + (gq + 8 * h) * PS + KW * c + 8 * j +
                                                 2 * t) = pack<E>(s[j][2 * h], s[j][2 * h + 1]);
            group_sync<SP>(p);
#pragma unroll
            for (int kb = 0; kb < BK / 16; ++kb) {
                uint32_t a[4];
                load_a(a, sPg, PS, 0, 16 * kb, lane);
#pragma unroll
                for (int np = 0; np < HW / 16; ++np) {
                    uint32_t b[4];
                    load_bt(b, sV, HS, HW * c + 16 * np, 16 * kb, lane);
                    mma<E>(o[2 * np], a, b[0], b[1]);
                    mma<E>(o[2 * np + 1], a, b[2], b[3]);
                }
            }
        }
    }

    float l_row[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        float l = l_r[h];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        l_row[h] = l;
    }
    if constexpr (SP > 1) {              // the sum over both key halves
        if (t == 0) {                    // the mate has read this tile's max (it passed P's barrier)
            sRow[gq] = l_row[0];
            sRow[gq + 8] = l_row[1];
        }
        group_sync<SP>(p);
        l_row[0] += mate[gq];
        l_row[1] += mate[gq + 8];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int q = q0 + 16 * p + gq + 8 * h;
        if (q >= T_) continue;
        const float lc = fmaxf(l_row[h], 1e-30f), inv = 1.f / lc;
        E* o_r = out + ((size_t)bn * T_ + q) * H + HW * c;
#pragma unroll
        for (int n = 0; n < HW / 8; ++n)
            *reinterpret_cast<uint32_t*>(o_r + 8 * n + 2 * t) =
                pack<E>(o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
        if (c == 0 && t == 0) lse[(size_t)bn * T_ + q] = m_r[h] + logf(lc);
    }
}

template <typename E, int H>
cudaError_t launch(const void* rw, const void* rr, const void* k, const void* v,
                   const void* g, void* out, float* lse, const int* mv_ptr, int mv_const,
                   int BN, int N, int T_, int S, int M, float scale, int window,
                   cudaStream_t stream) {
    const size_t smem = smem_bytes<H>();
    auto kern = k1_tc<E, H>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((T_ + BQ - 1) / BQ, BN);
    kern<<<grid, Split<H>::NT, smem, stream>>>(
        (const E*)rw, (const E*)rr, (const E*)k, (const E*)v, (const E*)g, (E*)out, lse,
        mv_ptr, mv_const, N, T_, S, M, scale, window);
    return cudaGetLastError();
}

// The grouped-query form (k1_gqa_tc): k1_tc without the distance term, for
// a model whose G query heads share one key / value head (GQA).  q [BN, T,
// H] (row bn = b N + h), k / v [BN / G, T, H]: query row bn reads key row bn
// / G.  No memory (S = T, M = 0); window > 0 keeps 0 <= q - k < window
// (a sliding layer), 0 the causal mask alone (a full layer).  The score is
// q . k * scale: no Qr, no table ring, no BD staging, so the block stages Q
// once and K / V in two cp.async stages; the online softmax (tile_p<.., BD
// false>), the interior tile pairs, the rounding of p and lse are k1_tc's.
// At H = 128 the group's two warps share their P rows through a region of
// their own.  Shared memory at H = 128: Q 17 KB, K / V x 2 stages 70 KB, P
// 9 KB -- 95 KB.
template <int H>
constexpr size_t gqa_smem_bytes() {
    // Q; 2 stages of K, V, all [.][H+8] b16; at SP 2 each group's P [16][PS]
    // b16 and each warp's row max / sum [16] f32
    using SPL = Split<H>;
    return 2 * (size_t)(BQ + 2 * 2 * BK) * (H + 8) +
           (SPL::SP > 1 ? 2 * (size_t)NG * 16 * SPL::PS + (size_t)SPL::NW * 16 * 4 : 0);
}

template <typename E, int H>
__global__ void __launch_bounds__(Split<H>::NT, Split<H>::SP == 1 ? 2 : 1)
k1_gqa_tc(const E* __restrict__ qq, const E* __restrict__ kk, const E* __restrict__ vv,
          E* __restrict__ out, float* __restrict__ lse, int G, int T_, float scale, int window) {
    using SPL = Split<H>;
    constexpr int SP = SPL::SP, KW = SPL::KW, HW = SPL::HW, NT = SPL::NT, PS = SPL::PS;
    constexpr int HS = H + 8;
    constexpr int KH = H / 16;                      // k-blocks of the score products
    constexpr int STAGE = 2 * BK * HS;              // K, V
    extern __shared__ __align__(16) unsigned char smem_raw[];
    E* sQ = reinterpret_cast<E*>(smem_raw);
    E* sKV = sQ + BQ * HS;                          // stage b: K, V
    E* sP = sKV + 2 * STAGE;                        // [NG][16][PS] (SP 2)
    float* sRows = reinterpret_cast<float*>(sP + NG * 16 * PS);   // [NW][16] (SP 2)

    const int bn = blockIdx.y;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest rows first
    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
    const int p = w / SP, c = w % SP;               // 16-row group, warp in the group
    const int gq = lane >> 2, t = lane & 3;
    E* sPg = sP + p * 16 * PS;                      // the group's P rows (SP 2)
    float* sRow = sRows + w * 16;
    const float* mate = sRows + (w ^ (SP - 1)) * 16;

    const E* k_b = kk + (size_t)(bn / G) * T_ * H;
    const E* v_b = vv + (size_t)(bn / G) * T_ * H;

    // keys any row of this tile can see
    const int k_hi = min(q0 + BQ, T_);                  // exclusive
    const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
    const int kt_begin = k_lo / BK, kt_end = (k_hi + BK - 1) / BK;
    auto load_k = [&](int kt) {                      // K, V of tile kt
        E* st = sKV + ((kt - kt_begin) & 1) * STAGE;
        stage_rows<H>(st, k_b, kt * BK, BK, T_, tid, NT);
        stage_rows<H>(st + BK * HS, v_b, kt * BK, BK, T_, tid, NT);
        cp_commit();
    };

    float o[HW / 8][4] = {};                        // ctx rows 16p + gq (+8), cols HW c + 8n + 2t
    float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
    uint32_t aq[KH][4];                             // the group's Q A fragments
    stage_rows<H>(sQ, qq + (size_t)bn * T_ * H, q0, BQ, T_, tid, NT);
    load_k(kt_begin);
    cp_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kb = 0; kb < KH; ++kb) load_a(aq[kb], sQ, HS, 16 * p, 16 * kb, lane);
    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int it = kt - kt_begin, k0 = kt * BK;
        cp_wait<0>();
        __syncthreads();                 // tile kt landed; every warp is done with tile kt - 1
        if (kt + 1 < kt_end) load_k(kt + 1);
        const E* sK = sKV + (it & 1) * STAGE;
        const E* sV = sK + BK * HS;

        // S = Q . K^T over the warp's keys: key columns KW c + 8j .. +7
        float s[KW / 8][4] = {};
#pragma unroll
        for (int kb = 0; kb < KH; ++kb)
#pragma unroll
            for (int np = 0; np < KW / 16; ++np) {
                uint32_t b[4];
                load_b(b, sK, HS, KW * c + 16 * np, 16 * kb, lane);
                mma<E>(s[2 * np], aq[kb], b[0], b[1]);
                mma<E>(s[2 * np + 1], aq[kb], b[2], b[3]);
            }
        const int q = q0 + 16 * p + gq;
        if (interior(q0, k0, T_, 0, 0, window))
            softmax_tile<false, H, false>(s, o, m_r, l_r, nullptr, sRow, mate, p, q, k0 + KW * c,
                                          gq, t, T_, 0, 0, scale, window);
        else
            softmax_tile<true, H, false>(s, o, m_r, l_r, nullptr, sRow, mate, p, q, k0 + KW * c,
                                         gq, t, T_, 0, 0, scale, window);

        // o += P . V[:, HW c, + HW) over the tile's 64 keys
        if constexpr (SP == 1) {         // P from the accumulators
#pragma unroll
            for (int kb = 0; kb < BK / 16; ++kb) {
                uint32_t a[4];
                c_to_a<E>(a, s[2 * kb], s[2 * kb + 1]);
#pragma unroll
                for (int np = 0; np < H / 16; ++np) {
                    uint32_t b[4];
                    load_bt(b, sV, HS, 16 * np, 16 * kb, lane);
                    mma<E>(o[2 * np], a, b[0], b[1]);
                    mma<E>(o[2 * np + 1], a, b[2], b[3]);
                }
            }
        } else {                         // the group's P rows (the last tile's read: barrier above)
#pragma unroll
            for (int j = 0; j < KW / 8; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    *reinterpret_cast<uint32_t*>(sPg + (gq + 8 * h) * PS + KW * c + 8 * j +
                                                 2 * t) = pack<E>(s[j][2 * h], s[j][2 * h + 1]);
            group_sync<SP>(p);
#pragma unroll
            for (int kb = 0; kb < BK / 16; ++kb) {
                uint32_t a[4];
                load_a(a, sPg, PS, 0, 16 * kb, lane);
#pragma unroll
                for (int np = 0; np < HW / 16; ++np) {
                    uint32_t b[4];
                    load_bt(b, sV, HS, HW * c + 16 * np, 16 * kb, lane);
                    mma<E>(o[2 * np], a, b[0], b[1]);
                    mma<E>(o[2 * np + 1], a, b[2], b[3]);
                }
            }
        }
    }

    float l_row[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        float l = l_r[h];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        l_row[h] = l;
    }
    if constexpr (SP > 1) {              // the sum over both key halves
        if (t == 0) {
            sRow[gq] = l_row[0];
            sRow[gq + 8] = l_row[1];
        }
        group_sync<SP>(p);
        l_row[0] += mate[gq];
        l_row[1] += mate[gq + 8];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int q = q0 + 16 * p + gq + 8 * h;
        if (q >= T_) continue;
        const float lc = fmaxf(l_row[h], 1e-30f), inv = 1.f / lc;
        E* o_r = out + ((size_t)bn * T_ + q) * H + HW * c;
#pragma unroll
        for (int n = 0; n < HW / 8; ++n)
            *reinterpret_cast<uint32_t*>(o_r + 8 * n + 2 * t) =
                pack<E>(o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
        if (c == 0 && t == 0) lse[(size_t)bn * T_ + q] = m_r[h] + logf(lc);
    }
}

template <typename E, int H>
cudaError_t launch_gqa(const void* q, const void* k, const void* v, void* out, float* lse,
                       int BN, int G, int T_, float scale, int window, cudaStream_t stream) {
    const size_t smem = gqa_smem_bytes<H>();
    auto kern = k1_gqa_tc<E, H>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((T_ + BQ - 1) / BQ, BN);
    kern<<<grid, Split<H>::NT, smem, stream>>>((const E*)q, (const E*)k, (const E*)v, (E*)out,
                                               lse, G, T_, scale, window);
    return cudaGetLastError();
}

}  // namespace tc

// ------------------------------------------------- the slab kernel (k1_slab)
// Every f32 call, and a 16-bit call at a head dim above 128: H = W ns, the
// slab width W = H up to 64 (f32) or 64.  A block per (bn, 64-row q tile,
// group of up to ZS output slabs) walks K1's key tiles once.  Eight warps,
// two per 16-row group (k1_tc's layout at H = 128, tc::Split<128>): warp c
// of group p sums AC = Qw . K^T over keys [32c, 32c + 32) of the tile and X
// = Qr . Gwin^T over the 48 window columns [48 - 16p + 32c, + 48) those
// keys' skew reads, and owns columns [OW c, OW c + OW) of each of the
// block's output slabs (OW = W / 2).  Per tile pair the head dim streams
// through a ring of two cp.async stages of five 64-row tiles (Qw, Qr, K and
// the 128-row window; slab i + 1 loads while slab i's products run): each
// slab's AC is summed apart (a zeroed fragment per slab, its k-blocks added
// in f32) and added to the pair's sums, slab 0 first, and X's per-slab sums
// land in the warp's f32 staging (skew_slab), so the scores are computed
// once per tile pair; then the online softmax (tc::tile_p: the max of both
// key halves through shared memory), the ctx sums of every output slab
// rescaled, and the group's P rows (rounded to E; f32 as they are) written
// over its BD staging.  The block's output slabs follow as items of their
// own, V's slab staged in K's place: ctx[:, slab z] += P . V_slab, the
// warp's columns, the tile pair's products summed apart, then added.  The
// sums of up to ZS output slabs stay in registers (16 f32 per slab and
// lane): `with_cfg` keeps every slab in one block up to H 256 (ZS 4) and
// 512 (ZS 8); above, grid z splits the output slabs, each block recomputing
// the scores.  At one slab (f32 up to H 64) Qw and Qr are staged once, in
// stage 0.  The masks, the online softmax, lse and the rounding of p are
// k1_tc's.  The products are slab_mma.cuh's: mma.sync m16n8k16 for bf16 /
// f16, 3xTF32 m16n8k8 for f32.  What bounds it: the three H-long products
// per visible pair at the tensor cores' rate (f32 at a third of TF32's),
// and the operand splits around them in f32.  Shared memory at W 64: 197 KB
// (f32) / 116 KB (16 bits); one block of eight warps per SM.
namespace slabs {

using namespace slab;
using SPL = tc::Split<128>;       // two warps per 16-row group

constexpr int SP = SPL::SP, NT = SPL::NT, NW = SPL::NW, KW = SPL::KW, XW = SPL::XW,
              XS = SPL::XS;

template <typename E, int W>
struct Lay {
    static constexpr int RS = W + PAD<E>;             // operand row stride
    static constexpr int PS = BK + PAD<E>;            // P row stride
    static constexpr int TILE = BQ * RS;              // one staged [64][W] tile
    static constexpr int OW = W / SP < 16 ? 16 : W / SP;   // a warp's columns of an output slab
    // a ring stage: Qw, Qr, K (an output item's V), the window's two halves
    static constexpr int QW = 0, QR = 1, KK = 2, GG = 3, NTILE = 5;
    static constexpr size_t RING = (size_t)2 * NTILE * TILE * sizeof(E);
    static constexpr size_t X_BYTES = (size_t)NW * 16 * XS * 4;
    static_assert(16 * PS * sizeof(E) <= (size_t)SP * 16 * XS * 4, "P fits the group's staging");
    // the ring; the warps' BD staging (each group's P over it); each warp's
    // row max / sum [16] f32
    static constexpr size_t bytes() { return RING + X_BYTES + (size_t)NW * 16 * 4; }
};

// a slab instance: width W, output slabs a block holds ZS
template <int W_, int ZS_>
struct Cfg {
    static constexpr int W = W_, ZS = ZS_;
};

// f(Cfg) for the instance a call at head dim H runs: f32 in slabs of
// min(H, 64), 16 bits (H above 128) of 64; every output slab in one block
// up to 256 columns, then up to 512
template <typename E, typename F>
cudaError_t with_cfg(int H, F&& f) {
    if constexpr (kF32<E>) {
        switch (H) {
            case 16: return f(Cfg<16, 1>{});
            case 32: return f(Cfg<32, 1>{});
            case 64: return f(Cfg<64, 1>{});
            case 128: return f(Cfg<64, 2>{});
        }
    }
    if (H <= 128 || H % 128) return cudaErrorInvalidValue;
    return H <= 256 ? f(Cfg<64, 4>{}) : f(Cfg<64, 8>{});
}

template <typename E, int W, int ZS>
__global__ void __launch_bounds__(NT, 1)
k1_slab(const E* __restrict__ rw, const E* __restrict__ rr, const E* __restrict__ kk,
        const E* __restrict__ vv, const E* __restrict__ g, E* __restrict__ out,
        float* __restrict__ lse, const int* __restrict__ mv_ptr, int mv_const, int N, int T_,
        int S, int M, float scale, int window, int ns) {
    using L = Lay<E, W>;
    constexpr int RS = L::RS, PS = L::PS, TILE = L::TILE, OW = L::OW, K8 = KS<E>;
    // k-blocks of a product unrolled at a time: as many as the registers
    // allow without a spill (ptxas: f32 W 64 spilled at all 8, ZS 8 at 2)
    constexpr int UNR = ZS > 4 ? 1 : kF32<E> && W == 64 ? 4 : W / K8;
    const int H = W * ns;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    E* ring = reinterpret_cast<E*>(smem_raw);    // stage b: tile i at ring + (NTILE b + i) TILE
    float* sX = reinterpret_cast<float*>(smem_raw + L::RING);   // [NW][16][XS]
    float* sRows = sX + NW * 16 * XS;                            // [NW][16]

    const int bn = blockIdx.y, z0 = blockIdx.z * ZS, nz = min(ZS, ns - z0);
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest rows first
    const int head = bn % N;
    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
    const int p = w / SP, c = w % SP, gq = lane >> 2, t = lane & 3;
    const int mv = mv_ptr ? *mv_ptr : mv_const;
    const bool once = ns == 1;
    float* sXw = sX + w * 16 * XS;
    E* sPg = reinterpret_cast<E*>(sX + p * SP * 16 * XS);     // the group's P [16][PS]
    float* sRow = sRows + w * 16;
    const float* mate = sRows + (w ^ 1) * 16;

    const E* rw_b = rw + (size_t)bn * T_ * H;
    const E* rr_b = rr + (size_t)bn * T_ * H;
    const E* k_b = kk + (size_t)bn * S * H;
    const E* v_b = vv + (size_t)bn * S * H;
    const E* g_h = g + (size_t)head * (T_ + S) * H;

    // keys any row of this tile can see
    const int q_last = min(q0 + BQ, T_) - 1;
    const int k_hi = min(S, M + q_last + 1);            // exclusive
    int k_lo = max(0, M - mv);
    if (window > 0) k_lo = max(k_lo, M + q0 - window + 1);
    const int kt_begin = k_lo / BK, kt_end = (k_hi + BK - 1) / BK;
    // the items of a key tile: its ns score slabs, then the block's output slabs
    const int per = ns + nz, n_items = max(kt_end - kt_begin, 0) * per;
    auto issue = [&](int n) {                    // item n's tiles into stage n % 2
        const int m = n % per, k0 = (kt_begin + n / per) * BK;
        E* st = ring + (n & 1) * L::NTILE * TILE;
        if (m < ns) {
            if (!once) {
                stage<W>(st + L::QW * TILE, rw_b, q0, BQ, T_, H, W * m, tid, NT);
                stage<W>(st + L::QR * TILE, rr_b, q0, BQ, T_, H, W * m, tid, NT);
            }
            stage<W>(st + L::KK * TILE, k_b, k0, BK, S, H, W * m, tid, NT);
            stage<W>(st + L::GG * TILE, g_h, T_ - q0 - BQ + k0, 2 * BK, T_ + S, H, W * m, tid,
                     NT);
        } else {
            stage<W>(st + L::KK * TILE, v_b, k0, BK, S, H, W * (z0 + m - ns), tid, NT);
        }
        mma_bf16::cp_commit();
    };
    if (n_items > 0) {
        if (once) {                              // Qw, Qr: stage 0's first tiles, for good
            stage<W>(ring + L::QW * TILE, rw_b, q0, BQ, T_, H, 0, tid, NT);
            stage<W>(ring + L::QR * TILE, rr_b, q0, BQ, T_, H, 0, tid, NT);
        }
        issue(0);
    }

    // ctx rows 16p + gq (+8), columns W (z0 + zz) + OW c + 8n + 2t
    float o[ZS][OW / 8][4] = {};
    float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
    // ctx[:, slab z0 + zi] += P . V_slab (tV), the warp's columns, PC
    // n-pairs per pass, the tile pair's products summed apart
    constexpr int PC = ZS <= 2 ? 2 : 1;
    auto apply = [&](int zi, const E* tV) {
        if (OW * c >= W) return;                 // W 16: the group's second warp has none
#pragma unroll
        for (int zz = 0; zz < ZS; ++zz) {
            if (zz != zi) continue;
#pragma unroll
            for (int cp = 0; cp < OW / 16; cp += PC) {
                float tv[2 * PC][4] = {};
#pragma unroll (UNR)
                for (int kb = 0; kb < BK / K8; ++kb) {
                    FragA<E> a;
                    load_a(a, sPg, PS, 0, K8 * kb, lane);
#pragma unroll
                    for (int j = 0; j < PC && cp + j < OW / 16; ++j) {
                        FragB<E> b[2];
                        load_bt(b, tV, RS, OW * c + 16 * (cp + j), K8 * kb, lane);
                        mma(tv[2 * j], a, b[0]);
                        mma(tv[2 * j + 1], a, b[1]);
                    }
                }
                add_pass(o[zz], tv, cp);
            }
        }
    };

    float s[KW / 8][4];
    for (int n = 0; n < n_items; ++n) {
        const int m = n % per, k0 = (kt_begin + n / per) * BK;
        mma_bf16::cp_wait<0>();
        __syncthreads();                         // item n landed; item n - 1 is done
        if (n + 1 < n_items) issue(n + 1);
        const E* st = ring + (n & 1) * L::NTILE * TILE;
        if (m >= ns) {
            apply(m - ns, st + L::KK * TILE);
            continue;
        }
        const E* tQ = once ? ring : st;
        // AC over the warp's keys, the slab's sum apart, then added
        float sm[KW / 8][4] = {};
        slab_product<E, W, CH, false, UNR>(sm, tQ + L::QW * TILE, 16 * p, st + L::KK * TILE,
                                           KW * c, RS, lane);
#pragma unroll
        for (int j = 0; j < KW / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = m ? s[j][e] + sm[j][e] : sm[j][e];
        skew_slab<E, W, XW, XS, UNR>(sXw, tQ + L::QR * TILE, 16 * p, st + L::GG * TILE,
                                     48 - 16 * p + KW * c, m == 0, lane);
        if (m < ns - 1) continue;
        __syncwarp();                            // the warp's X is staged
        const int q = q0 + 16 * p + gq;
        float alpha[2];
        if (tc::interior(q0, k0, S, M, mv, window))
            tc::tile_p<false, 128>(s, m_r, l_r, alpha, sXw, sRow, mate, p, q, k0 + KW * c, gq,
                                   t, S, M, mv, scale, window);
        else
            tc::tile_p<true, 128>(s, m_r, l_r, alpha, sXw, sRow, mate, p, q, k0 + KW * c, gq, t,
                                  S, M, mv, scale, window);
#pragma unroll
        for (int zz = 0; zz < ZS; ++zz)
#pragma unroll
            for (int nn = 0; nn < OW / 8; ++nn)
#pragma unroll
                for (int e = 0; e < 4; ++e) o[zz][nn][e] *= alpha[e >> 1];
        // the group's P rows over its staging (both warps' BD reads are
        // done: tile_p's max exchange is behind the group barrier)
        put_frags<E, false>(sPg, s, PS, 0, KW * c, lane);
    }
    mma_bf16::cp_wait<0>();                      // no copy left in flight

    float l_row[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        float l = l_r[h];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        l_row[h] = l;
    }
    if (t == 0) {                                // the sum over both key halves (the mate
        sRow[gq] = l_row[0];                     // read the last max before an item barrier)
        sRow[gq + 8] = l_row[1];
    }
    mma_bf16::group_sync<SP>(p);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int q = q0 + 16 * p + gq + 8 * h;
        if (q >= T_) continue;
        const float lc = fmaxf(l_row[h] + mate[gq + 8 * h], 1e-30f), inv = 1.f / lc;
#pragma unroll
        for (int zz = 0; zz < ZS; ++zz) {
            if (zz >= nz || OW * c >= W) continue;
            E* o_r = out + ((size_t)bn * T_ + q) * H + W * (z0 + zz) + OW * c;
#pragma unroll
            for (int nn = 0; nn < OW / 8; ++nn)
                put2<E>(o_r + 8 * nn + 2 * t, o[zz][nn][2 * h] * inv, o[zz][nn][2 * h + 1] * inv);
        }
        if (z0 == 0 && c == 0 && t == 0) lse[(size_t)bn * T_ + q] = m_r[h] + logf(lc);
    }
}

template <typename E, int W, int ZS>
cudaError_t launch(const void* rw, const void* rr, const void* k, const void* v,
                   const void* g, void* out, float* lse, const int* mv_ptr, int mv_const,
                   int BN, int N, int T_, int S, int M, float scale, int window, int ns,
                   cudaStream_t stream) {
    const size_t smem = Lay<E, W>::bytes();
    auto kern = k1_slab<E, W, ZS>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((T_ + BQ - 1) / BQ, BN, (ns + ZS - 1) / ZS);
    kern<<<grid, NT, smem, stream>>>(
        (const E*)rw, (const E*)rr, (const E*)k, (const E*)v, (const E*)g, (E*)out, lse,
        mv_ptr, mv_const, N, T_, S, M, scale, window, ns);
    return cudaGetLastError();
}

// The grouped-query form of k1_slab (k1_gqa_slab): every f32 call of the
// grouped-query forward, and a 16-bit call above head dim 128.  k1_slab's
// layout, items and products without the distance term: a score item
// stages Q's and K's slabs (no Qr, no table window), the output items V's;
// query row bn reads key / value row bn / G; no memory (S = T).  The P rows
// of a group sit where k1_slab stages its BD.
template <typename E, int W, int ZS>
__global__ void __launch_bounds__(NT, 1)
k1_gqa_slab(const E* __restrict__ qq, const E* __restrict__ kk, const E* __restrict__ vv,
            E* __restrict__ out, float* __restrict__ lse, int G, int T_, float scale, int window,
            int ns) {
    using L = Lay<E, W>;
    constexpr int RS = L::RS, PS = L::PS, TILE = L::TILE, OW = L::OW, K8 = KS<E>;
    constexpr int UNR = ZS > 4 ? 1 : kF32<E> && W == 64 ? 4 : W / K8;   // k1_slab's
    const int H = W * ns;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    E* ring = reinterpret_cast<E*>(smem_raw);    // stage b: tile i at ring + (NTILE b + i) TILE
    float* sX = reinterpret_cast<float*>(smem_raw + L::RING);   // the groups' P rows
    float* sRows = sX + NW * 16 * XS;                            // [NW][16]

    const int bn = blockIdx.y, z0 = blockIdx.z * ZS, nz = min(ZS, ns - z0);
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest rows first
    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
    const int p = w / SP, c = w % SP, gq = lane >> 2, t = lane & 3;
    const bool once = ns == 1;
    E* sPg = reinterpret_cast<E*>(sX + p * SP * 16 * XS);     // the group's P [16][PS]
    float* sRow = sRows + w * 16;
    const float* mate = sRows + (w ^ 1) * 16;

    const E* q_b = qq + (size_t)bn * T_ * H;
    const E* k_b = kk + (size_t)(bn / G) * T_ * H;
    const E* v_b = vv + (size_t)(bn / G) * T_ * H;

    // keys any row of this tile can see
    const int k_hi = min(q0 + BQ, T_);                  // exclusive
    const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
    const int kt_begin = k_lo / BK, kt_end = (k_hi + BK - 1) / BK;
    // the items of a key tile: its ns score slabs, then the block's output slabs
    const int per = ns + nz, n_items = (kt_end - kt_begin) * per;
    auto issue = [&](int n) {                    // item n's tiles into stage n % 2
        const int m = n % per, k0 = (kt_begin + n / per) * BK;
        E* st = ring + (n & 1) * L::NTILE * TILE;
        if (m < ns) {
            if (!once) stage<W>(st + L::QW * TILE, q_b, q0, BQ, T_, H, W * m, tid, NT);
            stage<W>(st + L::KK * TILE, k_b, k0, BK, T_, H, W * m, tid, NT);
        } else {
            stage<W>(st + L::KK * TILE, v_b, k0, BK, T_, H, W * (z0 + m - ns), tid, NT);
        }
        mma_bf16::cp_commit();
    };
    if (once) stage<W>(ring + L::QW * TILE, q_b, q0, BQ, T_, H, 0, tid, NT);   // Q for good
    issue(0);

    // ctx rows 16p + gq (+8), columns W (z0 + zz) + OW c + 8n + 2t
    float o[ZS][OW / 8][4] = {};
    float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
    constexpr int PC = ZS <= 2 ? 2 : 1;
    auto apply = [&](int zi, const E* tV) {     // k1_slab's: ctx[:, slab z0 + zi] += P . V_slab
        if (OW * c >= W) return;
#pragma unroll
        for (int zz = 0; zz < ZS; ++zz) {
            if (zz != zi) continue;
#pragma unroll
            for (int cp = 0; cp < OW / 16; cp += PC) {
                float tv[2 * PC][4] = {};
#pragma unroll (UNR)
                for (int kb = 0; kb < BK / K8; ++kb) {
                    FragA<E> a;
                    load_a(a, sPg, PS, 0, K8 * kb, lane);
#pragma unroll
                    for (int j = 0; j < PC && cp + j < OW / 16; ++j) {
                        FragB<E> b[2];
                        load_bt(b, tV, RS, OW * c + 16 * (cp + j), K8 * kb, lane);
                        mma(tv[2 * j], a, b[0]);
                        mma(tv[2 * j + 1], a, b[1]);
                    }
                }
                add_pass(o[zz], tv, cp);
            }
        }
    };

    float s[KW / 8][4];
    for (int n = 0; n < n_items; ++n) {
        const int m = n % per, k0 = (kt_begin + n / per) * BK;
        mma_bf16::cp_wait<0>();
        __syncthreads();                         // item n landed; item n - 1 is done
        if (n + 1 < n_items) issue(n + 1);
        const E* st = ring + (n & 1) * L::NTILE * TILE;
        if (m >= ns) {
            apply(m - ns, st + L::KK * TILE);
            continue;
        }
        const E* tQ = once ? ring : st;
        float sm[KW / 8][4] = {};                // S over the warp's keys, the slab's sum apart
        slab_product<E, W, CH, false, UNR>(sm, tQ + L::QW * TILE, 16 * p, st + L::KK * TILE,
                                           KW * c, RS, lane);
#pragma unroll
        for (int j = 0; j < KW / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = m ? s[j][e] + sm[j][e] : sm[j][e];
        if (m < ns - 1) continue;
        const int q = q0 + 16 * p + gq;
        float alpha[2];
        if (tc::interior(q0, k0, T_, 0, 0, window))
            tc::tile_p<false, 128, false>(s, m_r, l_r, alpha, nullptr, sRow, mate, p, q,
                                          k0 + KW * c, gq, t, T_, 0, 0, scale, window);
        else
            tc::tile_p<true, 128, false>(s, m_r, l_r, alpha, nullptr, sRow, mate, p, q,
                                         k0 + KW * c, gq, t, T_, 0, 0, scale, window);
#pragma unroll
        for (int zz = 0; zz < ZS; ++zz)
#pragma unroll
            for (int nn = 0; nn < OW / 8; ++nn)
#pragma unroll
                for (int e = 0; e < 4; ++e) o[zz][nn][e] *= alpha[e >> 1];
        put_frags<E, false>(sPg, s, PS, 0, KW * c, lane);   // the mate read the last P (barrier)
    }
    mma_bf16::cp_wait<0>();                      // no copy left in flight

    float l_row[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        float l = l_r[h];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        l_row[h] = l;
    }
    if (t == 0) {
        sRow[gq] = l_row[0];
        sRow[gq + 8] = l_row[1];
    }
    mma_bf16::group_sync<SP>(p);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int q = q0 + 16 * p + gq + 8 * h;
        if (q >= T_) continue;
        const float lc = fmaxf(l_row[h] + mate[gq + 8 * h], 1e-30f), inv = 1.f / lc;
#pragma unroll
        for (int zz = 0; zz < ZS; ++zz) {
            if (zz >= nz || OW * c >= W) continue;
            E* o_r = out + ((size_t)bn * T_ + q) * H + W * (z0 + zz) + OW * c;
#pragma unroll
            for (int nn = 0; nn < OW / 8; ++nn)
                put2<E>(o_r + 8 * nn + 2 * t, o[zz][nn][2 * h] * inv, o[zz][nn][2 * h + 1] * inv);
        }
        if (z0 == 0 && c == 0 && t == 0) lse[(size_t)bn * T_ + q] = m_r[h] + logf(lc);
    }
}

template <typename E, int W, int ZS>
cudaError_t launch_gqa(const void* q, const void* k, const void* v, void* out, float* lse,
                       int BN, int G, int T_, float scale, int window, int ns,
                       cudaStream_t stream) {
    const size_t smem = Lay<E, W>::bytes();
    auto kern = k1_gqa_slab<E, W, ZS>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((T_ + BQ - 1) / BQ, BN, (ns + ZS - 1) / ZS);
    kern<<<grid, NT, smem, stream>>>((const E*)q, (const E*)k, (const E*)v, (E*)out, lse, G, T_,
                                     scale, window, ns);
    return cudaGetLastError();
}

}  // namespace slabs

// the head dims a call takes: 16, 32, 64 and 128, and every multiple of 128
__host__ __device__ constexpr bool takes(int H) {
    return H == 16 || H == 32 || H == 64 || (H > 0 && H % 128 == 0);
}

template <typename T>
cudaError_t launch_h(int H, const void* rw, const void* rr, const void* k, const void* v,
                     const void* g, void* out, float* lse, const int* mv_ptr, int mv_const,
                     int BN, int N, int T_, int S, int M, float scale, int window,
                     cudaStream_t st) {
    if (!takes(H)) return cudaErrorInvalidValue;
    if constexpr (sizeof(T) == 2) {                  // bf16, f16: k1_tc up to H 128
        switch (H) {
            case 16: return tc::launch<T, 16>(rw, rr, k, v, g, out, lse, mv_ptr, mv_const,
                                              BN, N, T_, S, M, scale, window, st);
            case 32: return tc::launch<T, 32>(rw, rr, k, v, g, out, lse, mv_ptr, mv_const,
                                              BN, N, T_, S, M, scale, window, st);
            case 64: return tc::launch<T, 64>(rw, rr, k, v, g, out, lse, mv_ptr, mv_const,
                                              BN, N, T_, S, M, scale, window, st);
            case 128: return tc::launch<T, 128>(rw, rr, k, v, g, out, lse, mv_ptr, mv_const,
                                                BN, N, T_, S, M, scale, window, st);
        }
    }
    return slabs::with_cfg<T>(H, [&](auto cfg) {     // f32, and 16 bits above 128
        using F = decltype(cfg);
        return slabs::launch<T, F::W, F::ZS>(rw, rr, k, v, g, out, lse, mv_ptr, mv_const, BN, N,
                                             T_, S, M, scale, window, H / F::W, st);
    });
}

template <typename E, int H>
cudaError_t resources_h(int* out) {
    return resources(tc::k1_tc<E, H>, tc::smem_bytes<H>(), tc::Split<H>::NT, out);
}

// the kernel a call of this dtype and H runs
template <typename E>
cudaError_t resources_e(int H, int* out) {
    if (!takes(H)) return cudaErrorInvalidValue;
    if constexpr (sizeof(E) == 2) {
        switch (H) {
            case 16: return resources_h<E, 16>(out);
            case 32: return resources_h<E, 32>(out);
            case 64: return resources_h<E, 64>(out);
            case 128: return resources_h<E, 128>(out);
        }
    }
    return slabs::with_cfg<E>(H, [&](auto cfg) {
        using F = decltype(cfg);
        return resources(slabs::k1_slab<E, F::W, F::ZS>, slabs::Lay<E, F::W>::bytes(),
                         slabs::NT, out);
    });
}

}  // namespace

// rw/rr [BN, T, H], k/v [BN, S, H], g [N, T+S, H] (dtype 0 = f32, 1 = bf16,
// 2 = f16; H 16, 32, 64 or a multiple of 128); out [BN, T, H] in that
// dtype, lse [BN, T] f32.  mem_valid is read from the device int32 at
// mv_ptr, or is mv_const when mv_ptr is null.  window <= 0 is no window.
// bf16 and f16 run k1_tc up to H 128 and k1_slab above; f32 runs k1_slab
// (3xTF32) at every H.  Launches on `stream`; returns cudaGetLastError() of
// the launch.
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
    if (dtype == 2)
        return (int)launch_h<__half>(H, rw, rr, k, v, g, out, l, mv, mv_const, BN, N, T, S, M,
                                     scale, window, st);
    return (int)cudaErrorInvalidValue;
}

// The resources of the kernel a call of this dtype (0 = f32, 1 = bf16, 2 =
// f16) at head dim H runs, as the loaded library reports them: out[0..4] =
// registers, local (spill) bytes, dynamic shared bytes, resident blocks per
// SM and threads per block of k1_tc or k1_slab.  Returns a cudaError_t
// (cudaErrorInvalidValue for an H the kernels do not take).
extern "C" int flash_rel_attn_fwd_resources(int H, int dtype, int* out) {
    if (dtype == 0) return (int)resources_e<float>(H, out);
    if (dtype == 1) return (int)resources_e<__nv_bfloat16>(H, out);
    if (dtype == 2) return (int)resources_e<__half>(H, out);
    return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------- the grouped-query form
template <typename E>
cudaError_t gqa_launch_h(int H, const void* q, const void* k, const void* v, void* out,
                         float* lse, int BN, int G, int T_, float scale, int window,
                         cudaStream_t st) {
    if (!takes(H)) return cudaErrorInvalidValue;
    if constexpr (sizeof(E) == 2) {                  // bf16, f16: k1_gqa_tc up to H 128
        switch (H) {
            case 16: return tc::launch_gqa<E, 16>(q, k, v, out, lse, BN, G, T_, scale, window, st);
            case 32: return tc::launch_gqa<E, 32>(q, k, v, out, lse, BN, G, T_, scale, window, st);
            case 64: return tc::launch_gqa<E, 64>(q, k, v, out, lse, BN, G, T_, scale, window, st);
            case 128:
                return tc::launch_gqa<E, 128>(q, k, v, out, lse, BN, G, T_, scale, window, st);
        }
    }
    return slabs::with_cfg<E>(H, [&](auto cfg) {     // f32, and 16 bits above 128
        using F = decltype(cfg);
        return slabs::launch_gqa<E, F::W, F::ZS>(q, k, v, out, lse, BN, G, T_, scale, window,
                                                 H / F::W, st);
    });
}

// q [BN, T, H], k / v [BN / G, T, H] in one dtype (0 = f32, 1 = bf16, 2 =
// f16; H 16, 32, 64 or a multiple of 128): query row bn reads key / value
// row bn / G.  out [BN, T, H] in that dtype, lse [BN, T] f32.  Causal;
// window > 0 keeps q - k < window.  bf16 and f16 run k1_gqa_tc up to H 128
// and k1_gqa_slab above; f32 runs k1_gqa_slab (3xTF32) at every H.
// Launches on `stream`; returns cudaGetLastError() of the launch
// (cudaErrorInvalidValue for another dtype or H, or a BN that G does not
// divide).
extern "C" int gqa_attn_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                            int BN, int G, int T, int H, int dtype, float scale, int window,
                            void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (G < 1 || BN % G) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
        return (int)gqa_launch_h<float>(H, q, k, v, out, (float*)lse, BN, G, T, scale, window, st);
    if (dtype == 1)
        return (int)gqa_launch_h<__nv_bfloat16>(H, q, k, v, out, (float*)lse, BN, G, T, scale,
                                                window, st);
    if (dtype == 2)
        return (int)gqa_launch_h<__half>(H, q, k, v, out, (float*)lse, BN, G, T, scale, window,
                                         st);
    return (int)cudaErrorInvalidValue;
}

// The resources of the kernel a grouped-query call of this dtype (0 = f32,
// 1 = bf16, 2 = f16) and H runs, k1_gqa_tc or k1_gqa_slab, as
// flash_rel_attn_fwd_resources reports K1's.
extern "C" int gqa_attn_fwd_resources(int H, int dtype, int* out) {
    auto of = [&](auto e) -> cudaError_t {
        using E = decltype(e);
        if (!takes(H)) return cudaErrorInvalidValue;
        auto slab = [&]() {
            return slabs::with_cfg<E>(H, [&](auto cfg) {
                using F = decltype(cfg);
                return resources(slabs::k1_gqa_slab<E, F::W, F::ZS>, slabs::Lay<E, F::W>::bytes(),
                                 slabs::NT, out);
            });
        };
        if constexpr (sizeof(E) == 4) return slab();
        else if (H > 128) return slab();
        else switch (H) {
            case 16: return resources(tc::k1_gqa_tc<E, 16>, tc::gqa_smem_bytes<16>(),
                                      tc::Split<16>::NT, out);
            case 32: return resources(tc::k1_gqa_tc<E, 32>, tc::gqa_smem_bytes<32>(),
                                      tc::Split<32>::NT, out);
            case 64: return resources(tc::k1_gqa_tc<E, 64>, tc::gqa_smem_bytes<64>(),
                                      tc::Split<64>::NT, out);
            case 128: return resources(tc::k1_gqa_tc<E, 128>, tc::gqa_smem_bytes<128>(),
                                       tc::Split<128>::NT, out);
        }
        return cudaErrorInvalidValue;
    };
    if (dtype == 0) return (int)of(0.f);
    if (dtype == 1) return (int)of(__nv_bfloat16{});
    if (dtype == 2) return (int)of(__half{});
    return (int)cudaErrorInvalidValue;
}
