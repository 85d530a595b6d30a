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
// Two kernels per route.  The TPU grid runs in order and keeps
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
// Routes, chosen inside the C entry point by dtype and H:
//   bf16 / f16 up to H 128: k2_dkdv_tc / k2_dq_tc (below);
//   f32 at every H, bf16 / f16 above 128: k2_dkdv_slab / k2_dq_slab (the
//   slab kernels, after namespace tc), f32 products in 3xTF32.
//
// bf16 and f16 (k2_dkdv_tc, k2_dq_tc, templated on the element type), the
// training path, at H <= 128: every product (AC, BD, dP, dV, dK, dRW, dRR,
// dG) is an mma.sync m16n8k16 (bf16 or f16 in, f32 accumulate) on ldmatrix
// fragments (mma_bf16.cuh); p and ds are rounded to the input dtype where
// they enter a product, which is where the TPU kernel rounds them.  A tile's
// 64 rows are four 16-row groups: group p owns q rows 16p..16p+15 (S, dP,
// drw, drr) and key rows 16p.. (dk, dv).  At H <= 64 a group is one warp.
// At H = 128 it is two (eight warps per block): warp c of a group computes
// S and dP over keys [32c, 32c + 32) and owns columns [64c, 64c + 64) of
// each accumulator, and the group shares p / ds through its scratch behind
// a named barrier, so that no lane holds more than 64 f32 of one
// accumulator (one warp's drw, drr and dG window would take 256 registers
// at H = 128, over the 255 a thread has).  Operands sit in shared memory
// as b16 rows of stride H+8 (ldmatrix without bank conflicts), loaded by
// cp.async with zero fill of rows outside [0, len): the next q tile's Qw /
// dO (dkdv) or key tile's K / V (dq) go into a second buffer while the
// current tile computes.  The relative-position skew follows the TPU
// kernel (rr . [G1; G2]^T, then a roll): BD of a tile pair is Qr . Gwin^T
// over the window Gwin of 128 table rows from u_lo = T - q0 - 64 + k0,
// staged as f32 in the warp's scratch and read at column 63 - qi + ki (a
// warp of group p needs only columns [48 - 16p + 32c, 48 - 16p + 32c + KW
// + 16), KW = 64 / warps per group).  Consecutive tiles' windows overlap by
// 64 rows, so Gwin lives in a ring of three 64-row slabs and each tile
// loads only its new slab.  In the dq kernel ds is scattered into a
// zero-filled tile dSskew [64 x 128], dSskew[qi][63 - qi + ki] = ds, so
// that drr = dSskew . Gwin and the window of dG is dSskew^T . Qr.  The
// windows slide up by 64 rows per key tile, so rows [u_lo, u_lo + 64) are
// final after each one: the dG window is two 64-row halves of f32
// accumulators that swap roles; the finished half is added to device
// memory by float2 atomics and zeroed, the other carried (both flushed at
// the end).  A group's scratch holds its warps' BD staging, then its rows
// of dSskew (dq; at H = 128 also of dS) or of P and dS (dkdv), which all
// warps read after a barrier.  Shared memory at H = 64: 111 KB in each
// kernel, so two blocks (eight warps) run per SM; at H = 128: 196 KB, one
// block of eight warps.
//
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "elem.cuh"
#include "mma_bf16.cuh"
#include "kernel_resources.cuh"
#include "row_dot.cuh"
#include "slab_mma.cuh"

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile

using namespace elem;
using kernel_resources::resources;

__device__ __forceinline__ bool visible(int q, int k, int T_, int S, int M, int mv, int window) {
    const int d = M + q - k;
    return q < T_ && k < S && d >= 0 && k >= M - mv && (window <= 0 || d < window);
}

// ------------------------------------------ bf16 and f16 on the tensor cores
namespace tc {

using namespace mma_bf16;

constexpr int GW = 128;          // distance-table window rows per tile pair (127 used)
constexpr int DSS = GW + 8;      // b16 row stride of dSskew
constexpr int PS2 = BK + 8;      // b16 row stride of P / dS
constexpr int NG = BQ / 16;      // 16-row groups of a tile

// The work split at head dim H.  Group p owns q rows 16p..16p+15 of a tile
// (S, dP, drw, drr) or key rows 16p.. (dk, dv).  At H <= 64 a group is one
// warp.  At H = 128 a group is two warps (SP = 2), so that no lane holds
// more than H / 2 columns of an accumulator: warp c of the group computes
// S and dP over keys [32c, 32c + 32) and owns columns [64c, 64c + 64) of
// every accumulator (dk, dv; drw, drr and the dG window); the group shares
// its p / ds through its scratch.
template <int H>
struct Split {
    static constexpr int SP = H > 64 ? 2 : 1;   // warps per group
    static constexpr int NW = NG * SP;          // warps per block
    static constexpr int NT = 32 * NW;
    static constexpr int KW = BK / SP;          // keys of a warp's S / dP
    static constexpr int HW = H / SP;           // accumulator columns of a warp
    static constexpr int XW = KW + 16;          // BD columns a warp needs
    static constexpr int XS = XW + 4;           // f32 row stride of a warp's BD staging
    // a group's scratch: its warps' BD staging [16][XS] f32, later (dq) its
    // rows of dSskew [16][DSS] (and, at SP 2, of dS [16][PS2]) or (dkdv) of
    // P and dS [16][PS2], b16
    static constexpr int UNION = SP * 16 * XS * 4;
    static_assert(16 * DSS * 2 + (SP - 1) * 16 * PS2 * 2 <= UNION && 2 * 16 * PS2 * 2 <= UNION,
                  "group scratch");
};

// The 128-row window sits in a ring of three 64-row slabs; `gs` holds the
// slabs of window rows [0, 64) and [64, 128).  Rows r .. r+15 of the window
// (indexed at run time, `gs` takes 16 bytes of stack: a select instead
// keeps it in registers but makes the H = 64 dq kernel, at 255 registers,
// spill):
template <typename E>
__device__ __forceinline__ const E* grow(const E* const (&gs)[2], int r, int HS) {
    return gs[r >> 6] + (r & 63) * HS;
}

// X = Qr[16p, 16p+16) . Gwin[r0, r0 + XW)^T, r0 = 48 - 16p + KW c, into the
// warp's f32 staging sXw [16][XS]; BD[qi][KW c + kl] is then
// sXw[qr][15 - qr + kl], qi = 16p + qr
template <typename E, int H>
__device__ __forceinline__ void bd_window(float* sXw, const E* sQr, const E* const (&gs)[2],
                                          int p, int c, int lane) {
    using SPL = Split<H>;
    constexpr int HS = H + 8;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int np = 0; np < SPL::XW / 16; ++np) {
        const E* gr = grow(gs, 48 - 16 * p + SPL::KW * c + 16 * np, HS);
        float x[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < H / 16; ++kk) {
            uint32_t a[4], b[4];
            load_a(a, sQr, HS, 16 * p, 16 * kk, lane);
            load_b(b, gr, HS, 0, 16 * kk, lane);
            mma<E>(x[0], a, b[0], b[1]);
            mma<E>(x[1], a, b[2], b[3]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int col = 16 * np + 8 * h + 2 * t;
            *reinterpret_cast<float2*>(sXw + g * SPL::XS + col) = make_float2(x[h][0], x[h][1]);
            *reinterpret_cast<float2*>(sXw + (g + 8) * SPL::XS + col) =
                make_float2(x[h][2], x[h][3]);
        }
    }
}

// S = Qw . K^T and dP = dO . V^T for the group's 16 q rows over the warp's
// KW keys [KW c, KW c + KW) (C tiles: key columns KW c + 8j .. +7)
template <typename E, int H>
__device__ __forceinline__ void qk_dov(float (&s)[Split<H>::KW / 8][4],
                                       float (&dp)[Split<H>::KW / 8][4], const E* sQw,
                                       const E* sDO, const E* sK, const E* sV, int p, int c,
                                       int lane) {
    constexpr int HS = H + 8, KW = Split<H>::KW;
#pragma unroll
    for (int j = 0; j < KW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk) {
        uint32_t aw[4], ao[4];
        load_a(aw, sQw, HS, 16 * p, 16 * kk, lane);
        load_a(ao, sDO, HS, 16 * p, 16 * kk, lane);
#pragma unroll
        for (int np = 0; np < KW / 16; ++np) {
            uint32_t bk[4], bv[4];
            load_b(bk, sK, HS, KW * c + 16 * np, 16 * kk, lane);
            load_b(bv, sV, HS, KW * c + 16 * np, 16 * kk, lane);
            mma<E>(s[2 * np], aw, bk[0], bk[1]);
            mma<E>(s[2 * np + 1], aw, bk[2], bk[3]);
            mma<E>(dp[2 * np], ao, bv[0], bv[1]);
            mma<E>(dp[2 * np + 1], ao, bv[2], bv[3]);
        }
    }
}

// p and ds of the warp's entries in place of s and dp (f32; `pack` rounds
// them to E where they enter a product); lse / delta of rows g and g + 8 in
// l / dl; `full`: every pair of the tile is visible
template <int H>
__device__ __forceinline__ void p_ds(float (&s)[Split<H>::KW / 8][4],
                                     float (&dp)[Split<H>::KW / 8][4], const float* sXw, int q0,
                                     int k0, int p, int c, int lane, const float (&l)[2],
                                     const float (&dl)[2], int T_, int S, int M, int mv,
                                     float scale, int window, bool full) {
    constexpr int KW = Split<H>::KW, XS = Split<H>::XS;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < KW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int qr = g + 8 * (e >> 1), kl = 8 * j + 2 * t + (e & 1);
            const float bd = sXw[qr * XS + 15 - qr + kl];
            const bool ok =
                full || visible(q0 + 16 * p + qr, k0 + KW * c + kl, T_, S, M, mv, window);
            const float pr = ok ? expf((s[j][e] + bd) * scale - l[e >> 1]) : 0.f;
            const float ds = pr * (dp[j][e] - dl[e >> 1]) * scale;
            s[j][e] = pr;
            dp[j][e] = ds;
        }
}

// every (q, k) pair of the tile pair (q0, k0) is visible
__device__ __forceinline__ bool tile_full(int q0, int k0, int T_, int S, int M, int mv,
                                          int window) {
    return q0 + BQ <= T_ && k0 + BK <= S && M + q0 - (k0 + BK - 1) >= 0 && k0 >= M - mv &&
           (window <= 0 || M + q0 + BQ - 1 - k0 < window);
}

// lse and delta of group p's rows 16p + g (+8) of the q tile at q0
__device__ __forceinline__ void row_stats(float (&l)[2], float (&dl)[2], const float* lse_b,
                                          const float* dl_b, int q0, int p, int lane, int T_) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int q = q0 + 16 * p + (lane >> 2) + 8 * h;
        l[h] = q < T_ ? lse_b[q] : 0.f;
        dl[h] = q < T_ ? dl_b[q] : 0.f;
    }
}

// the warp's p / ds entries (rows g, g + 8 of its group, keys KW c + 8j +
// 2t (+1)) into b16 rows of stride PS2, rounded to E
template <typename E, int H>
__device__ __forceinline__ void put_rows(E* dst, const float (&x)[Split<H>::KW / 8][4], int c,
                                         int lane) {
    constexpr int KW = Split<H>::KW;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < KW / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
            *reinterpret_cast<uint32_t*>(dst + (g + 8 * h) * PS2 + KW * c + 8 * j + 2 * t) =
                pack<E>(x[j][2 * h], x[j][2 * h + 1]);
}

template <int H>
constexpr size_t dkdv_smem_bytes() {
    // sK, sV; 2 stages of Qw, dO; Qr; the G ring (192 rows), all [.][H+8]
    // b16; the groups' scratch
    return 2 * (size_t)(2 * BK + 2 * 2 * BQ + BQ + 3 * 64) * (H + 8) + (size_t)NG * Split<H>::UNION;
}

template <int H>
constexpr size_t dq_smem_bytes() {
    // sQw, sQr, sDO; 2 stages of K, V; the G ring (192 rows), all [.][H+8]
    // b16; the groups' scratch
    return 2 * (size_t)(3 * BQ + 2 * 2 * BK + 3 * 64) * (H + 8) + (size_t)NG * Split<H>::UNION;
}

template <typename E, int H>
__global__ void __launch_bounds__(Split<H>::NT, Split<H>::SP == 1 ? 2 : 1)
k2_dkdv_tc(const E* __restrict__ rw, const E* __restrict__ rr, const E* __restrict__ kk,
           const E* __restrict__ vv, const E* __restrict__ g, const E* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dk, float* __restrict__ dv, const int* __restrict__ mv_ptr,
           int mv_const, int N, int T_, int S, int M, float scale, int window) {
    using SPL = Split<H>;
    constexpr int HS = H + 8, KW = SPL::KW, HW = SPL::HW;
    constexpr int STAGE = 2 * BQ * HS;              // Qw, dO
    extern __shared__ __align__(16) unsigned char smem_raw[];
    E* sK = reinterpret_cast<E*>(smem_raw);
    E* sV = sK + BK * HS;
    E* sQ = sV + BK * HS;                           // stage b: Qw, dO
    E* sQr = sQ + 2 * STAGE;
    E* sGr = sQr + BQ * HS;                         // ring of 3 slabs [64][HS]
    unsigned char* scratch = reinterpret_cast<unsigned char*>(sGr + 3 * 64 * HS);
    // group v's rows of P and dS
    auto sP_of = [&](int v) { return reinterpret_cast<E*>(scratch + v * SPL::UNION); };
    auto sDS_of = [&](int v) { return sP_of(v) + 16 * PS2; };

    const int bn = blockIdx.y;
    const int k0 = blockIdx.x * BK;
    const int head = bn % N;
    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
    const int p = w / SPL::SP, c = w % SPL::SP;     // group, warp in the group
    const int gq = lane >> 2, t = lane & 3;
    const int mv = mv_ptr ? *mv_ptr : mv_const;
    float* sXw = reinterpret_cast<float*>(scratch + p * SPL::UNION) + c * 16 * SPL::XS;

    const E* rw_b = rw + (size_t)bn * T_ * H;
    const E* rr_b = rr + (size_t)bn * T_ * H;
    const E* do_b = dout + (size_t)bn * T_ * H;
    const float* lse_b = lse + (size_t)bn * T_;
    const float* dl_b = delta + (size_t)bn * T_;
    const E* g_h = g + (size_t)head * (T_ + S) * H;

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
        E* st = sQ + (it & 1) * STAGE;
        stage_rows<H>(st, rw_b, q0, BQ, T_, tid, SPL::NT);
        stage_rows<H>(st + BQ * HS, do_b, q0, BQ, T_, tid, SPL::NT);
        stage_rows<H>(slab(0, it), g_h, u_lo, 64, T_ + S, tid, SPL::NT);
        if (first) stage_rows<H>(slab(1, it), g_h, u_lo + 64, 64, T_ + S, tid, SPL::NT);
        cp_commit();
    };

    // key rows 16p + g (+8), columns HW c + 8n + 2t
    float dka[HW / 8][4] = {}, dva[HW / 8][4] = {};
    if (qt_begin < qt_end) {
        stage_rows<H>(sK, kk + (size_t)bn * S * H, k0, BK, S, tid, SPL::NT);
        stage_rows<H>(sV, vv + (size_t)bn * S * H, k0, BK, S, tid, SPL::NT);
        stage_rows<H>(sQr, rr_b, qt_begin * BQ, BQ, T_, tid, SPL::NT);
        load_q(qt_begin, true);
    }
    for (int qt = qt_begin; qt < qt_end; ++qt) {
        const int it = qt - qt_begin, q0 = qt * BQ;
        cp_wait<0>();
        __syncthreads();                 // tile qt landed; every warp is done with tile qt - 1
        if (qt + 1 < qt_end) load_q(qt + 1, false);
        const E* sQw = sQ + (it & 1) * STAGE;
        const E* sDO = sQw + BQ * HS;
        const E* const gs[2] = {slab(0, it), slab(1, it)};
        float l2[2], d2[2];
        row_stats(l2, d2, lse_b, dl_b, q0, p, lane, T_);

        bd_window<E, H>(sXw, sQr, gs, p, c, lane);
        __syncwarp();
        float s[KW / 8][4], dp[KW / 8][4];
        qk_dov<E, H>(s, dp, sQw, sDO, sK, sV, p, c, lane);
        p_ds<H>(s, dp, sXw, q0, k0, p, c, lane, l2, d2, T_, S, M, mv, scale, window,
                tile_full(q0, k0, T_, S, M, mv, window));
        group_sync<SPL::SP>(p);          // the group's BD reads are done: its scratch takes P / dS
        put_rows<E, H>(sP_of(p), s, c, lane);
        put_rows<E, H>(sDS_of(p), dp, c, lane);
        __syncthreads();                 // every group's P / dS rows are written, Qr read
        if (qt + 1 < qt_end) {
            stage_rows<H>(sQr, rr_b, q0 + BQ, BQ, T_, tid, SPL::NT);
            cp_commit();
        }

        // dv += P^T dO, dk += dS^T Qw over the tile's 64 q rows (16 per
        // group's scratch): key rows 16p.., columns HW c..
#pragma unroll
        for (int kq = 0; kq < NG; ++kq) {
            uint32_t ap[4], ad[4];
            load_at(ap, sP_of(kq), PS2, 16 * p, 0, lane);
            load_at(ad, sDS_of(kq), PS2, 16 * p, 0, lane);
#pragma unroll
            for (int np = 0; np < HW / 16; ++np) {
                uint32_t bo[4], bq[4];
                load_bt(bo, sDO, HS, HW * c + 16 * np, 16 * kq, lane);
                load_bt(bq, sQw, HS, HW * c + 16 * np, 16 * kq, lane);
                mma<E>(dva[2 * np], ap, bo[0], bo[1]);
                mma<E>(dva[2 * np + 1], ap, bo[2], bo[3]);
                mma<E>(dka[2 * np], ad, bq[0], bq[1]);
                mma<E>(dka[2 * np + 1], ad, bq[2], bq[3]);
            }
        }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int k = k0 + 16 * p + gq + 8 * h;
        if (k >= S) continue;
        float* dk_r = dk + ((size_t)bn * S + k) * H + HW * c;
        float* dv_r = dv + ((size_t)bn * S + k) * H + HW * c;
#pragma unroll
        for (int n = 0; n < HW / 8; ++n) {
            *reinterpret_cast<float2*>(dk_r + 8 * n + 2 * t) =
                make_float2(dka[n][2 * h], dka[n][2 * h + 1]);
            *reinterpret_cast<float2*>(dv_r + 8 * n + 2 * t) =
                make_float2(dva[n][2 * h], dva[n][2 * h + 1]);
        }
    }
}

template <typename E, int H>
__global__ void __launch_bounds__(Split<H>::NT, Split<H>::SP == 1 ? 2 : 1)
k2_dq_tc(const E* __restrict__ rw, const E* __restrict__ rr, const E* __restrict__ kk,
         const E* __restrict__ vv, const E* __restrict__ g, const E* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ delta, E* __restrict__ drw,
         E* __restrict__ drr, float* __restrict__ dg, const int* __restrict__ mv_ptr,
         int mv_const, int N, int T_, int S, int M, float scale, int window) {
    using SPL = Split<H>;
    constexpr int HS = H + 8, KW = SPL::KW, HW = SPL::HW, SP = SPL::SP;
    constexpr int STAGE = 2 * BK * HS;              // K, V
    extern __shared__ __align__(16) unsigned char smem_raw[];
    E* sQw = reinterpret_cast<E*>(smem_raw);
    E* sQr = sQw + BQ * HS;
    E* sDO = sQr + BQ * HS;
    E* sKV = sDO + BQ * HS;                         // stage b: K, V
    E* sGr = sKV + 2 * STAGE;                       // ring of 3 slabs [64][HS]
    unsigned char* scratch = reinterpret_cast<unsigned char*>(sGr + 3 * 64 * HS);
    // group v's rows of dSskew (q rows 16v..16v+15); at SP 2 its rows of dS follow
    auto dsk_of = [&](int v) { return reinterpret_cast<E*>(scratch + v * SPL::UNION); };

    const int bn = blockIdx.y;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest rows first
    const int head = bn % N;
    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
    const int p = w / SP, c = w % SP;               // group, warp in the group
    const int gq = lane >> 2, t = lane & 3;
    const int mv = mv_ptr ? *mv_ptr : mv_const;
    float* sXw = reinterpret_cast<float*>(scratch + p * SPL::UNION) + c * 16 * SPL::XS;
    E* dsk = dsk_of(p);
    E* dsr = dsk + 16 * DSS;                        // the group's dS rows (SP 2)

    const E* k_b = kk + (size_t)bn * S * H;
    const E* v_b = vv + (size_t)bn * S * H;
    const E* g_h = g + (size_t)head * (T_ + S) * H;
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
        E* st = sKV + (it & 1) * STAGE;
        stage_rows<H>(st, k_b, k0, BK, S, tid, SPL::NT);
        stage_rows<H>(st + BK * HS, v_b, k0, BK, S, tid, SPL::NT);
        if (first) stage_rows<H>(slab(0, it), g_h, u_lo, 64, T_ + S, tid, SPL::NT);
        stage_rows<H>(slab(1, it), g_h, u_lo + 64, 64, T_ + S, tid, SPL::NT);
        cp_commit();
    };

    float l2[2], d2[2];
    row_stats(l2, d2, lse + (size_t)bn * T_, delta + (size_t)bn * T_, q0, p, lane, T_);
    // q rows 16p + g (+8), columns HW c + 8n + 2t
    float dwa[HW / 8][4] = {}, dra[HW / 8][4] = {};
    float dga[2][HW / 8][4] = {};                   // the warp's 32 rows of the dG window

    // the warp's 32 dG rows [u0, u0 + 32) (16 mb + g + 8h), its columns, into device memory
    auto flush = [&](int u0) {
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int u = u0 + 16 * mb + gq + 8 * h;
                if (u < 0 || u >= T_ + S) continue;
#pragma unroll
                for (int n = 0; n < HW / 8; ++n) {
                    const float2 v = make_float2(dga[mb][n][2 * h], dga[mb][n][2 * h + 1]);
                    if (v.x != 0.f || v.y != 0.f)
                        atomicAdd(reinterpret_cast<float2*>(dg_h + (size_t)u * H + HW * c +
                                                            8 * n + 2 * t),
                                  v);
                }
            }
    };

    if (kt_begin < kt_end) {
        stage_rows<H>(sQw, rw + (size_t)bn * T_ * H, q0, BQ, T_, tid, SPL::NT);
        stage_rows<H>(sQr, rr + (size_t)bn * T_ * H, q0, BQ, T_, tid, SPL::NT);
        stage_rows<H>(sDO, dout + (size_t)bn * T_ * H, q0, BQ, T_, tid, SPL::NT);
        load_k(kt_begin, true);
    }
    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int it = kt - kt_begin, k0 = kt * BK;
        const int u_lo = T_ - q0 - BQ + k0;             // G row of window row 0
        cp_wait<0>();
        __syncthreads();                 // tile kt landed; every warp is done with tile kt - 1
        if (kt + 1 < kt_end) load_k(kt + 1, false);
        const E* sK = sKV + (it & 1) * STAGE;
        const E* sV = sK + BK * HS;
        const E* const gs[2] = {slab(0, it), slab(1, it)};

        bd_window<E, H>(sXw, sQr, gs, p, c, lane);
        __syncwarp();
        float s[KW / 8][4], dp[KW / 8][4];
        qk_dov<E, H>(s, dp, sQw, sDO, sK, sV, p, c, lane);
        p_ds<H>(s, dp, sXw, q0, k0, p, c, lane, l2, d2, T_, S, M, mv, scale, window,
                tile_full(q0, k0, T_, S, M, mv, window));

        if constexpr (SP == 1) {         // drw += dS . K, dS from the accumulators
#pragma unroll
            for (int kk2 = 0; kk2 < BK / 16; ++kk2) {
                uint32_t a[4];
                c_to_a<E>(a, dp[2 * kk2], dp[2 * kk2 + 1]);
#pragma unroll
                for (int np = 0; np < H / 16; ++np) {
                    uint32_t bk[4];
                    load_bt(bk, sK, HS, 16 * np, 16 * kk2, lane);
                    mma<E>(dwa[2 * np], a, bk[0], bk[1]);
                    mma<E>(dwa[2 * np + 1], a, bk[2], bk[3]);
                }
            }
        }

        // the group's scratch takes its rows of dSskew: zero, then
        // dSskew[qi][63 - qi + ki] = ds (and, at SP 2, dS[qi][ki] = ds)
        group_sync<SP>(p);               // the group's BD reads are done
        for (int e = lane + 32 * c; e < 16 * GW / 8; e += 32 * SP)
            *reinterpret_cast<uint4*>(dsk + (e / (GW / 8)) * DSS + (e % (GW / 8)) * 8) =
                make_uint4(0, 0, 0, 0);
        group_sync<SP>(p);
#pragma unroll
        for (int j = 0; j < KW / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int qr = gq + 8 * (e >> 1), ki = KW * c + 8 * j + 2 * t + (e & 1);
                dsk[qr * DSS + 63 - 16 * p - qr + ki] = from_f<E>(dp[j][e]);
            }
        if constexpr (SP > 1) put_rows<E, H>(dsr, dp, c, lane);
        group_sync<SP>(p);

        if constexpr (SP > 1) {          // drw += dS . K over the group's 64 keys, columns HW c..
#pragma unroll
            for (int kk2 = 0; kk2 < BK / 16; ++kk2) {
                uint32_t a[4];
                load_a(a, dsr, PS2, 0, 16 * kk2, lane);
#pragma unroll
                for (int np = 0; np < HW / 16; ++np) {
                    uint32_t bk[4];
                    load_bt(bk, sK, HS, HW * c + 16 * np, 16 * kk2, lane);
                    mma<E>(dwa[2 * np], a, bk[0], bk[1]);
                    mma<E>(dwa[2 * np + 1], a, bk[2], bk[3]);
                }
            }
        }

        // drr += dSskew . Gwin over the group's band of window rows [48 - 16p, 128 - 16p)
#pragma unroll
        for (int kr = 0; kr < 80 / 16; ++kr) {
            const int r0 = 48 - 16 * p + 16 * kr;
            const E* gr = grow(gs, r0, HS);
            uint32_t a[4];
            load_a(a, dsk, DSS, 0, r0, lane);
#pragma unroll
            for (int np = 0; np < HW / 16; ++np) {
                uint32_t bg[4];
                load_bt(bg, gr, HS, HW * c + 16 * np, 0, lane);
                mma<E>(dra[2 * np], a, bg[0], bg[1]);
                mma<E>(dra[2 * np + 1], a, bg[2], bg[3]);
            }
        }
        __syncthreads();                 // every group's dSskew rows are written

        // dG window rows [rb, rb + 32), columns HW c.., += dSskew^T . Qr,
        // summed over the 64 q rows (16 per group's scratch); the half
        // (rb / 64) that holds rows [u_lo, u_lo + 64) is final
        const int half = ((p >> 1) ^ it) & 1, rb = 64 * half + 32 * (p & 1);
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
            const int r0 = rb + 16 * mb;
#pragma unroll
            for (int kq = 0; kq < NG; ++kq) {
                // window row r holds q rows [63 - r, 126 - r]: skip blocks outside
                if (16 * kq > 126 - r0 || 16 * kq + 15 < 48 - r0) continue;
                uint32_t a[4];
                load_at(a, dsk_of(kq), DSS, r0, 0, lane);
#pragma unroll
                for (int np = 0; np < HW / 16; ++np) {
                    uint32_t bq[4];
                    load_bt(bq, sQr, HS, HW * c + 16 * np, 16 * kq, lane);
                    mma<E>(dga[mb][2 * np], a, bq[0], bq[1]);
                    mma<E>(dga[mb][2 * np + 1], a, bq[2], bq[3]);
                }
            }
        }
        if (half == 0) {
            flush(u_lo + rb);
#pragma unroll
            for (int mb = 0; mb < 2; ++mb)
#pragma unroll
                for (int n = 0; n < HW / 8; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e) dga[mb][n][e] = 0.f;
        }
    }
    if (kt_begin < kt_end) {             // the last window's upper half
        const int it = kt_end - 1 - kt_begin;
        const int half = ((p >> 1) ^ it) & 1;
        if (half == 1) flush(T_ - q0 - BQ + (kt_end - 1) * BK + 64 + 32 * (p & 1));
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int q = q0 + 16 * p + gq + 8 * h;
        if (q >= T_) continue;
        E* w_r = drw + ((size_t)bn * T_ + q) * H + HW * c;
        E* r_r = drr + ((size_t)bn * T_ + q) * H + HW * c;
#pragma unroll
        for (int n = 0; n < HW / 8; ++n) {
            *reinterpret_cast<uint32_t*>(w_r + 8 * n + 2 * t) =
                pack<E>(dwa[n][2 * h], dwa[n][2 * h + 1]);
            *reinterpret_cast<uint32_t*>(r_r + 8 * n + 2 * t) =
                pack<E>(dra[n][2 * h], dra[n][2 * h + 1]);
        }
    }
}

}  // namespace tc

// ------------------------------------------------- the slab kernels
// Every f32 call, and a 16-bit call at a head dim above 128: k2_dkdv_slab
// and k2_dq_slab, the split of the tensor-core kernels above at one warp per
// 16-row group, over slabs of the head dim.  H = W ns (W = H up to 64 in
// f32, else 64); a block of four warps owns one output slab z: columns [W
// z, W z + W) of dk / dv (dkdv) or of drw, drr and dG (dq).  Per tile pair
// it loops over the ns slabs (`pair_scores`): each slab of Qw, Qr, dO, K, V
// and the 128-row table window is staged by cp.async and its products added
// into the warp's S, dP and BD window fragments, so the contractions run
// over the whole head dim before p and ds exist; slab z is staged last, so
// its tiles stay for the output products.  Each output slab's block
// recomputes S and dP (ns blocks per tile pair).  p, ds and the skew are
// the tensor-core kernels' (p_ds; dSskew[qi][63 - qi + ki] = ds); dk / dv
// accumulate over the q tiles in registers (P and dS rows shared through
// shared memory), drw / drr over the key tiles, and each key tile's 127
// rows of dG, computed per 16-row block, are added to device memory by
// float2 atomics (no window halves carried: the slab kernels hold S, dP and
// BD of a whole tile in registers).  The products are slab_mma.cuh's: bf16
// / f16 mma.sync, f32 3xTF32, so f32 runs on the tensor cores at about f32
// accuracy.  Shared memory in f32 at W 64: 153 KB (dkdv, BD staged over
// the window) and 173 KB (dq), one block per SM; in 16 bits 102 / 101 KB,
// two.
namespace slabs {

using namespace slab;

constexpr int NW = BQ / 16;      // warps: one per 16-row group
constexpr int NT = 32 * NW;
constexpr int XW = BK + 16;      // BD window columns a warp reads
constexpr int XS = XW + 4;       // f32 row stride of a warp's BD staging

template <typename E, int W>
struct Lay {
    static constexpr int RS = W + PAD<E>;            // operand row stride
    static constexpr int PS = BK + PAD<E>;           // P / dS row stride
    static constexpr int DSS = 2 * BK + PAD<E>;      // dSskew row stride
    static constexpr size_t T_BYTES = (size_t)BQ * RS * sizeof(E);   // one 64-row tile
    static constexpr size_t G_BYTES = 2 * T_BYTES;                   // the 128-row window
    static constexpr size_t X_BYTES = (size_t)NW * 16 * XS * 4;
    static constexpr bool X_ON_G = G_BYTES >= X_BYTES;
    // K, V, Qw, dO, Qr; the window (BD staged over it when it fits); P, dS
    static constexpr size_t dkdv_bytes() {
        return 5 * T_BYTES + G_BYTES + (X_ON_G ? 0 : X_BYTES) + (size_t)2 * BQ * PS * sizeof(E);
    }
    // Qw, Qr, dO, K, V; the window; BD staging; dSskew
    static constexpr size_t dq_bytes() {
        return 5 * T_BYTES + G_BYTES + X_BYTES + (size_t)BQ * DSS * sizeof(E);
    }
};

__host__ __device__ constexpr int slab_width(int H) { return H < 64 ? H : 64; }

// The staged tiles of a block: [64][RS] each, the window [128][RS]
template <typename E>
struct Tiles {
    E *qw, *qr, *dO, *k, *v, *g;
};

// S = Qw . K^T, dP = dO . V^T over the tile's 64 keys and X = Qr . Gwin[48 -
// 16p, + XW)^T of the tile pair (q0, k0), summed over the ns slabs of the
// head dim, slab z last.  `q_once` / `k_once`: the q tile's (Qw, Qr, dO) /
// the key tile's (K, V) single slab is staged already (ns = 1)
template <typename E, int W>
__device__ __forceinline__ void pair_scores(float (&s)[BK / 8][4], float (&dp)[BK / 8][4],
                                            float (&x)[XW / 8][4], const Tiles<E>& sm,
                                            const E* rw_b, const E* rr_b, const E* do_b,
                                            const E* k_b, const E* v_b, const E* g_h, int q0,
                                            int k0, int T_, int S, int H, int ns, int z,
                                            bool q_once, bool k_once, int tid, int p, int lane) {
    constexpr int RS = Lay<E, W>::RS;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int n = 0; n < XW / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
    for (int i = 0; i < ns; ++i) {
        const int c0 = W * ((z + 1 + i) % ns);
        __syncthreads();                 // every warp is done with the staged tiles
        if (!q_once) {
            stage<W>(sm.qw, rw_b, q0, BQ, T_, H, c0, tid, NT);
            stage<W>(sm.qr, rr_b, q0, BQ, T_, H, c0, tid, NT);
            stage<W>(sm.dO, do_b, q0, BQ, T_, H, c0, tid, NT);
        }
        if (!k_once) {
            stage<W>(sm.k, k_b, k0, BK, S, H, c0, tid, NT);
            stage<W>(sm.v, v_b, k0, BK, S, H, c0, tid, NT);
        }
        stage<W>(sm.g, g_h, T_ - q0 - BQ + k0, 2 * BK, T_ + S, H, c0, tid, NT);
        mma_bf16::cp_commit();
        mma_bf16::cp_wait<0>();
        __syncthreads();
        slab_product<E, W>(s, sm.qw, 16 * p, sm.k, 0, RS, lane);
        slab_product<E, W>(dp, sm.dO, 16 * p, sm.v, 0, RS, lane);
        slab_product<E, W>(x, sm.qr, 16 * p, sm.g, 48 - 16 * p, RS, lane);
    }
}

// X into the warp's staging sXw [16][XS], then p and ds in place of s and
// dp (the tensor-core kernels' p_ds at one warp per group: BD[qr][kl] =
// X[qr][15 - qr + kl]); l / dl: lse and delta of rows g, g + 8
__device__ __forceinline__ void p_ds(float (&s)[BK / 8][4], float (&dp)[BK / 8][4],
                                     const float (&x)[XW / 8][4], float* sXw, int q0, int k0,
                                     int p, int lane, const float (&l)[2], const float (&dl)[2],
                                     int T_, int S, int M, int mv, float scale, int window) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int n = 0; n < XW / 8; ++n) {
        *reinterpret_cast<float2*>(sXw + g * XS + 8 * n + 2 * t) = make_float2(x[n][0], x[n][1]);
        *reinterpret_cast<float2*>(sXw + (g + 8) * XS + 8 * n + 2 * t) =
            make_float2(x[n][2], x[n][3]);
    }
    __syncwarp();
    const bool full = tc::tile_full(q0, k0, T_, S, M, mv, window);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int qr = g + 8 * (e >> 1), kl = 8 * j + 2 * t + (e & 1);
            const float bd = sXw[qr * XS + 15 - qr + kl];
            const bool ok = full || visible(q0 + 16 * p + qr, k0 + kl, T_, S, M, mv, window);
            const float pr = ok ? expf((s[j][e] + bd) * scale - l[e >> 1]) : 0.f;
            dp[j][e] = pr * (dp[j][e] - dl[e >> 1]) * scale;
            s[j][e] = pr;
        }
}

template <typename E, int W>
__global__ void __launch_bounds__(NT, 2)
k2_dkdv_slab(const E* __restrict__ rw, const E* __restrict__ rr, const E* __restrict__ kk,
             const E* __restrict__ vv, const E* __restrict__ g, const E* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dk, float* __restrict__ dv, const int* __restrict__ mv_ptr,
             int mv_const, int N, int T_, int S, int M, float scale, int window, int ns) {
    using L = Lay<E, W>;
    constexpr int RS = L::RS, PS = L::PS, K8 = KS<E>;
    const int H = W * ns;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Tiles<E> sm;
    sm.k = reinterpret_cast<E*>(smem_raw);
    sm.v = sm.k + BK * RS;
    sm.qw = sm.v + BK * RS;
    sm.dO = sm.qw + BQ * RS;
    sm.qr = sm.dO + BQ * RS;
    sm.g = sm.qr + BQ * RS;
    float* sX = reinterpret_cast<float*>(L::X_ON_G ? sm.g : sm.g + 2 * BK * RS);
    E* sP = reinterpret_cast<E*>(reinterpret_cast<unsigned char*>(sm.g) + L::G_BYTES +
                                 (L::X_ON_G ? 0 : L::X_BYTES));
    E* sDS = sP + BQ * PS;

    const int bn = blockIdx.y, z = blockIdx.z;
    const int k0 = blockIdx.x * BK;
    const int head = bn % N;
    const int tid = threadIdx.x, p = tid >> 5, lane = tid & 31;
    const int gq = lane >> 2, t = lane & 3;
    const int mv = mv_ptr ? *mv_ptr : mv_const;
    float* sXw = sX + p * 16 * XS;

    const E* rw_b = rw + (size_t)bn * T_ * H;
    const E* rr_b = rr + (size_t)bn * T_ * H;
    const E* do_b = dout + (size_t)bn * T_ * H;
    const E* k_b = kk + (size_t)bn * S * H;
    const E* v_b = vv + (size_t)bn * S * H;
    const float* lse_b = lse + (size_t)bn * T_;
    const float* dl_b = delta + (size_t)bn * T_;
    const E* g_h = g + (size_t)head * (T_ + S) * H;

    // q tiles that see some key of this tile
    const int k_last = min(k0 + BK, S) - 1;
    const int q_lo = max(0, k0 - M);
    int q_hi = T_;                                       // exclusive
    if (window > 0) q_hi = min(q_hi, window + k_last - M);
    const bool any = k_last >= M - mv && q_lo < q_hi;
    const int qt_begin = q_lo / BQ, qt_end = any ? (q_hi + BQ - 1) / BQ : qt_begin;

    float dka[W / 8][4] = {}, dva[W / 8][4] = {};   // key rows 16p + gq (+8), cols 8n + 2t
    for (int qt = qt_begin; qt < qt_end; ++qt) {
        const int q0 = qt * BQ;
        float s[BK / 8][4], dp[BK / 8][4], x[XW / 8][4];
        pair_scores<E, W>(s, dp, x, sm, rw_b, rr_b, do_b, k_b, v_b, g_h, q0, k0, T_, S, H, ns,
                          z, false, ns == 1 && qt > qt_begin, tid, p, lane);
        float l2[2], d2[2];
        tc::row_stats(l2, d2, lse_b, dl_b, q0, p, lane, T_);
        if constexpr (L::X_ON_G) __syncthreads();   // every warp's window reads are done
        p_ds(s, dp, x, sXw, q0, k0, p, lane, l2, d2, T_, S, M, mv, scale, window);
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int o = (16 * p + gq + 8 * h) * PS + 8 * j + 2 * t;
                put2<E>(sP + o, s[j][2 * h], s[j][2 * h + 1]);
                put2<E>(sDS + o, dp[j][2 * h], dp[j][2 * h + 1]);
            }
        __syncthreads();                 // every warp's P / dS rows are written

        // dv += P^T dO[:, W z..], dk += dS^T Qw[:, W z..] over the tile's 64 q
        // rows (summed apart, then added rounded to nearest)
#pragma unroll
        for (int c = 0; c < W / 16; c += CH) {           // CH n-pairs per pass
            float tv[2 * CH][4] = {}, tk[2 * CH][4] = {};
#pragma unroll 1
            for (int kq = 0; kq < BQ / K8; ++kq) {
                FragA<E> ap, ad;
                load_at(ap, sP, PS, 16 * p, K8 * kq, lane);
                load_at(ad, sDS, PS, 16 * p, K8 * kq, lane);
#pragma unroll
                for (int j = 0; j < CH && c + j < W / 16; ++j) {
                    FragB<E> bo[2], bq[2];
                    load_bt(bo, sm.dO, RS, 16 * (c + j), K8 * kq, lane);
                    load_bt(bq, sm.qw, RS, 16 * (c + j), K8 * kq, lane);
                    mma(tv[2 * j], ap, bo[0]);
                    mma(tv[2 * j + 1], ap, bo[1]);
                    mma(tk[2 * j], ad, bq[0]);
                    mma(tk[2 * j + 1], ad, bq[1]);
                }
            }
            add_pass(dva, tv, c);
            add_pass(dka, tk, c);
        }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int k = k0 + 16 * p + gq + 8 * h;
        if (k >= S) continue;
        float* dk_r = dk + ((size_t)bn * S + k) * H + W * z;
        float* dv_r = dv + ((size_t)bn * S + k) * H + W * z;
#pragma unroll
        for (int n = 0; n < W / 8; ++n) {
            put2<float>(dk_r + 8 * n + 2 * t, dka[n][2 * h], dka[n][2 * h + 1]);
            put2<float>(dv_r + 8 * n + 2 * t, dva[n][2 * h], dva[n][2 * h + 1]);
        }
    }
}

template <typename E, int W>
__global__ void __launch_bounds__(NT, 2)
k2_dq_slab(const E* __restrict__ rw, const E* __restrict__ rr, const E* __restrict__ kk,
           const E* __restrict__ vv, const E* __restrict__ g, const E* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta, E* __restrict__ drw,
           E* __restrict__ drr, float* __restrict__ dg, const int* __restrict__ mv_ptr,
           int mv_const, int N, int T_, int S, int M, float scale, int window, int ns) {
    using L = Lay<E, W>;
    constexpr int RS = L::RS, DSS = L::DSS, K8 = KS<E>;
    const int H = W * ns;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Tiles<E> sm;
    sm.qw = reinterpret_cast<E*>(smem_raw);
    sm.qr = sm.qw + BQ * RS;
    sm.dO = sm.qr + BQ * RS;
    sm.k = sm.dO + BQ * RS;
    sm.v = sm.k + BK * RS;
    sm.g = sm.v + BK * RS;
    float* sX = reinterpret_cast<float*>(sm.g + 2 * BK * RS);
    E* sDsk = reinterpret_cast<E*>(sX + NW * 16 * XS);   // dSskew [64][DSS]

    const int bn = blockIdx.y, z = blockIdx.z;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest rows first
    const int head = bn % N;
    const int tid = threadIdx.x, p = tid >> 5, lane = tid & 31;
    const int gq = lane >> 2, t = lane & 3;
    const int mv = mv_ptr ? *mv_ptr : mv_const;
    float* sXw = sX + p * 16 * XS;
    E* dsk = sDsk + 16 * p * DSS;                   // the warp's rows of dSskew

    const E* rw_b = rw + (size_t)bn * T_ * H;
    const E* rr_b = rr + (size_t)bn * T_ * H;
    const E* do_b = dout + (size_t)bn * T_ * H;
    const E* k_b = kk + (size_t)bn * S * H;
    const E* v_b = vv + (size_t)bn * S * H;
    const E* g_h = g + (size_t)head * (T_ + S) * H;
    float* dg_h = dg + (size_t)head * (T_ + S) * H + W * z;

    // keys any row of this tile can see (K1's range)
    const int q_last = min(q0 + BQ, T_) - 1;
    const int k_hi = min(S, M + q_last + 1);            // exclusive
    int k_lo = max(0, M - mv);
    if (window > 0) k_lo = max(k_lo, M + q0 - window + 1);
    const int kt_begin = k_lo / BK, kt_end = (k_hi + BK - 1) / BK;

    float l2[2], d2[2];
    tc::row_stats(l2, d2, lse + (size_t)bn * T_, delta + (size_t)bn * T_, q0, p, lane, T_);
    float dwa[W / 8][4] = {}, dra[W / 8][4] = {};   // q rows 16p + gq (+8), cols 8n + 2t
    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k0 = kt * BK, u_lo = T_ - q0 - BQ + k0;   // G row of window row 0
        float s[BK / 8][4], dp[BK / 8][4], x[XW / 8][4];
        pair_scores<E, W>(s, dp, x, sm, rw_b, rr_b, do_b, k_b, v_b, g_h, q0, k0, T_, S, H, ns,
                          z, ns == 1 && kt > kt_begin, false, tid, p, lane);
        p_ds(s, dp, x, sXw, q0, k0, p, lane, l2, d2, T_, S, M, mv, scale, window);

        // drw += dS . K[:, W z..], dS from the accumulators (each tile's
        // products summed apart, then added rounded to nearest, as drr's)
#pragma unroll
        for (int c = 0; c < W / 16; c += CH) {           // CH n-pairs per pass
            float tw[2 * CH][4] = {};
#pragma unroll
            for (int kb = 0; kb < BK / K8; ++kb) {
                FragA<E> a;
                acc_a<E>(a, dp, kb, lane);
#pragma unroll
                for (int j = 0; j < CH && c + j < W / 16; ++j) {
                    FragB<E> b[2];
                    load_bt(b, sm.k, RS, 16 * (c + j), K8 * kb, lane);
                    mma(tw[2 * j], a, b[0]);
                    mma(tw[2 * j + 1], a, b[1]);
                }
            }
            add_pass(dwa, tw, c);
        }
        // the warp's rows of dSskew: zero, then dSskew[qr][63 - 16p - qr + ki] = ds
        for (int e = lane; e < 16 * 2 * BK / PAD<E>; e += 32)
            *reinterpret_cast<uint4*>(dsk + (e / (2 * BK / PAD<E>)) * DSS +
                                      (e % (2 * BK / PAD<E>)) * PAD<E>) = make_uint4(0, 0, 0, 0);
        __syncwarp();
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int qr = gq + 8 * (e >> 1), ki = 8 * j + 2 * t + (e & 1);
                dsk[qr * DSS + 63 - 16 * p - qr + ki] = from_f<E>(dp[j][e]);
            }
        __syncwarp();
        // drr += dSskew . Gwin[:, W z..] over the warp's window rows [48 - 16p, 128 - 16p)
#pragma unroll
        for (int c = 0; c < W / 16; c += CH) {           // CH n-pairs per pass
            float tr[2 * CH][4] = {};
#pragma unroll 1
            for (int kr = 0; kr < 80 / K8; ++kr) {
                const int r0 = 48 - 16 * p + K8 * kr;
                FragA<E> a;
                load_a(a, sDsk, DSS, 16 * p, r0, lane);
#pragma unroll
                for (int j = 0; j < CH && c + j < W / 16; ++j) {
                    FragB<E> b[2];
                    load_bt(b, sm.g, RS, 16 * (c + j), r0, lane);
                    mma(tr[2 * j], a, b[0]);
                    mma(tr[2 * j + 1], a, b[1]);
                }
            }
            add_pass(dra, tr, c);
        }
        __syncthreads();                 // every warp's dSskew rows are written

        // dG window rows [32p, 32p + 32), columns W z.., += dSskew^T . Qr over
        // the tile's q rows (window row r holds q rows [63 - r, 126 - r]),
        // added to device memory block by block
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
            const int r0 = 32 * p + 16 * mb;
            float ga[W / 8][4] = {};
#pragma unroll 1
            for (int kq = 0; kq < BQ / K8; ++kq) {
                if (K8 * kq > 126 - r0 || K8 * kq + K8 - 1 < 48 - r0) continue;
                FragA<E> a;
                load_at(a, sDsk, DSS, r0, K8 * kq, lane);
#pragma unroll
                for (int np = 0; np < W / 16; ++np) {
                    FragB<E> b[2];
                    load_bt(b, sm.qr, RS, 16 * np, K8 * kq, lane);
                    mma(ga[2 * np], a, b[0]);
                    mma(ga[2 * np + 1], a, b[1]);
                }
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int u = u_lo + r0 + gq + 8 * h;
                if (u < 0 || u >= T_ + S) continue;
#pragma unroll
                for (int n = 0; n < W / 8; ++n) {
                    const float2 v = make_float2(ga[n][2 * h], ga[n][2 * h + 1]);
                    if (v.x != 0.f || v.y != 0.f)
                        atomicAdd(reinterpret_cast<float2*>(dg_h + (size_t)u * H + 8 * n + 2 * t), v);
                }
            }
        }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int q = q0 + 16 * p + gq + 8 * h;
        if (q >= T_) continue;
        E* w_r = drw + ((size_t)bn * T_ + q) * H + W * z;
        E* r_r = drr + ((size_t)bn * T_ + q) * H + W * z;
#pragma unroll
        for (int n = 0; n < W / 8; ++n) {
            put2<E>(w_r + 8 * n + 2 * t, dwa[n][2 * h], dwa[n][2 * h + 1]);
            put2<E>(r_r + 8 * n + 2 * t, dra[n][2 * h], dra[n][2 * h + 1]);
        }
    }
}

}  // namespace slabs

struct Args {
    const void *rw, *rr, *k, *v, *g, *dout, *lse, *delta;
    void *drw, *drr, *dk, *dv, *dg;
    const int* mv_ptr;
    int mv_const, BN, N, T, S, M;
    float scale;
    int window;
    cudaStream_t stream;
};

template <typename E, int H>
cudaError_t launch_tc(const Args& a) {
    const size_t smem_kv = tc::dkdv_smem_bytes<H>(), smem_q = tc::dq_smem_bytes<H>();
    auto kv = tc::k2_dkdv_tc<E, H>;
    auto kq = tc::k2_dq_tc<E, H>;
    cudaError_t err = cudaFuncSetAttribute(kv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem_kv);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
    if (err != cudaSuccess) return err;
    const E *rw = (const E*)a.rw, *rr = (const E*)a.rr, *k = (const E*)a.k, *v = (const E*)a.v,
            *g = (const E*)a.g, *dout = (const E*)a.dout;
    const float *lse = (const float*)a.lse, *delta = (const float*)a.delta;
    constexpr int NT = tc::Split<H>::NT;
    kv<<<dim3((a.S + BK - 1) / BK, a.BN), NT, smem_kv, a.stream>>>(
        rw, rr, k, v, g, dout, lse, delta, (float*)a.dk, (float*)a.dv, a.mv_ptr, a.mv_const,
        a.N, a.T, a.S, a.M, a.scale, a.window);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    kq<<<dim3((a.T + BQ - 1) / BQ, a.BN), NT, smem_q, a.stream>>>(
        rw, rr, k, v, g, dout, lse, delta, (E*)a.drw, (E*)a.drr, (float*)a.dg, a.mv_ptr,
        a.mv_const, a.N, a.T, a.S, a.M, a.scale, a.window);
    return cudaGetLastError();
}

template <typename E, int W>
cudaError_t launch_slab(const Args& a, int ns) {
    using L = slabs::Lay<E, W>;
    const size_t smem_kv = L::dkdv_bytes(), smem_q = L::dq_bytes();
    auto kv = slabs::k2_dkdv_slab<E, W>;
    auto kq = slabs::k2_dq_slab<E, W>;
    cudaError_t err = cudaFuncSetAttribute(kv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem_kv);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
    if (err != cudaSuccess) return err;
    const E *rw = (const E*)a.rw, *rr = (const E*)a.rr, *k = (const E*)a.k, *v = (const E*)a.v,
            *g = (const E*)a.g, *dout = (const E*)a.dout;
    const float *lse = (const float*)a.lse, *delta = (const float*)a.delta;
    kv<<<dim3((a.S + BK - 1) / BK, a.BN, ns), slabs::NT, smem_kv, a.stream>>>(
        rw, rr, k, v, g, dout, lse, delta, (float*)a.dk, (float*)a.dv, a.mv_ptr, a.mv_const,
        a.N, a.T, a.S, a.M, a.scale, a.window, ns);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    kq<<<dim3((a.T + BQ - 1) / BQ, a.BN, ns), slabs::NT, smem_q, a.stream>>>(
        rw, rr, k, v, g, dout, lse, delta, (E*)a.drw, (E*)a.drr, (float*)a.dg, a.mv_ptr,
        a.mv_const, a.N, a.T, a.S, a.M, a.scale, a.window, ns);
    return cudaGetLastError();
}

// the head dims a call takes: 16, 32, 64 and 128, and every multiple of 128
constexpr bool takes(int H) { return H == 16 || H == 32 || H == 64 || (H > 0 && H % 128 == 0); }

// bf16 / f16: the tensor-core kernels up to H 128, the slab kernels above;
// f32: the slab kernels at every H
template <typename E>
cudaError_t launch_h(int H, const Args& a) {
    if (!takes(H)) return cudaErrorInvalidValue;
    if constexpr (sizeof(E) == 2) {
        switch (H) {
            case 16: return launch_tc<E, 16>(a);
            case 32: return launch_tc<E, 32>(a);
            case 64: return launch_tc<E, 64>(a);
            case 128: return launch_tc<E, 128>(a);
            default: return launch_slab<E, 64>(a, H / 64);
        }
    } else {
        switch (slabs::slab_width(H)) {
            case 16: return launch_slab<E, 16>(a, 1);
            case 32: return launch_slab<E, 32>(a, 1);
            default: return launch_slab<E, 64>(a, H / 64);
        }
    }
}

template <typename E, int H>
cudaError_t resources_tc(int* out) {
    constexpr int NT = tc::Split<H>::NT;
    cudaError_t err = resources(tc::k2_dkdv_tc<E, H>, tc::dkdv_smem_bytes<H>(), NT, out);
    if (err != cudaSuccess) return err;
    return resources(tc::k2_dq_tc<E, H>, tc::dq_smem_bytes<H>(), NT, out + 5);
}

template <typename E, int W>
cudaError_t resources_slab(int* out) {
    using L = slabs::Lay<E, W>;
    cudaError_t err = resources(slabs::k2_dkdv_slab<E, W>, L::dkdv_bytes(), slabs::NT, out);
    if (err != cudaSuccess) return err;
    return resources(slabs::k2_dq_slab<E, W>, L::dq_bytes(), slabs::NT, out + 5);
}

// the kernels a call of this dtype and H runs
template <typename E>
cudaError_t resources_h(int H, int* out) {
    if (!takes(H)) return cudaErrorInvalidValue;
    if constexpr (sizeof(E) == 2) {
        switch (H) {
            case 16: return resources_tc<E, 16>(out);
            case 32: return resources_tc<E, 32>(out);
            case 64: return resources_tc<E, 64>(out);
            case 128: return resources_tc<E, 128>(out);
            default: return resources_slab<E, 64>(out);
        }
    } else {
        switch (slabs::slab_width(H)) {
            case 16: return resources_slab<E, 16>(out);
            case 32: return resources_slab<E, 32>(out);
            default: return resources_slab<E, 64>(out);
        }
    }
}

}  // namespace

// rw/rr/dout [BN, T, H], k/v [BN, S, H], g [N, T+S, H] in one dtype (0 = f32,
// 1 = bf16, 2 = f16; H 16, 32, 64, 128 or a multiple of 128); lse/delta
// [BN, T] f32.  Writes
// drw/drr [BN, T, H] in that dtype, dk/dv [BN, S, H] f32, and ADDS into dg
// [N, T+S, H] f32 (the caller zeroes it).  mem_valid is read from the device
// int32 at mv_ptr, or is mv_const when mv_ptr is null; window <= 0 is no
// window.  Launches both kernels on `stream`; returns the first
// cudaGetLastError() that is not cudaSuccess.  bf16 and f16 run k2_dkdv_tc
// / k2_dq_tc up to H 128 and the slab kernels above; f32 runs the slab
// kernels (3xTF32) at every H.
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
    if (dtype == 2) return (int)launch_h<__half>(H, a);
    return (int)cudaErrorInvalidValue;
}

// delta[r] = dout[r] . out[r] in f32 over rows [rows, H] of one dtype (0 =
// f32, 1 = bf16, 2 = f16): the input `delta` of flash_rel_attn_bwd, for its wrapper.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int flash_rel_attn_bwd_delta(const void* dout, const void* out, void* delta,
                                        long long rows, int H, int dtype, void* stream) {
    return (int)row_dot::launch(dout, out, (float*)delta, rows, H, dtype,
                                (cudaStream_t)stream);
}

// The resources of the kernels a call of this dtype (0 = f32, 1 = bf16, 2
// = f16) at head dim H runs, as the loaded library reports them: out[0..4]
// = registers, local (spill) bytes, dynamic shared bytes, resident blocks
// per SM and threads per block of k2_dkdv_tc or k2_dkdv_slab, out[5..9] of
// k2_dq_tc or k2_dq_slab.  Returns a cudaError_t (cudaErrorInvalidValue
// for an H the kernels do not take).
extern "C" int flash_rel_attn_bwd_resources(int H, int dtype, int* out) {
    if (dtype == 0) return (int)resources_h<float>(H, out);
    if (dtype == 1) return (int)resources_h<__nv_bfloat16>(H, out);
    if (dtype == 2) return (int)resources_h<__half>(H, out);
    return (int)cudaErrorInvalidValue;
}
