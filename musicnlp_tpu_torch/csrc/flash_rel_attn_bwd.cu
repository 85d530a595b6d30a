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

#include "mma_bf16.cuh"
#include "kernel_resources.cuh"
#include "row_dot.cuh"
#include "slab_mma.cuh"

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile

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
                slab::put1<E>(dsk + qr * DSS + 63 - 16 * p - qr + ki, dp[j][e]);
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
// (a block per 64-key tile, over the q tiles that see it) and k2_dq_slab (a
// block per 64-row q tile, over the key tiles its rows see), the split of
// the tensor-core kernels above over slabs of the head dim: H = W ns, W =
// min(H, 32) in f32 and 64 in 16 bits.  Eight warps, two per 16-row group
// (tc::Split<128>'s layout): warp c of group p computes S = Qw K^T and dP =
// dO V^T for its 16 q rows over keys [32c, 32c + 32), and X = Qr Gwin^T over
// the 48 window rows those keys' skew reads, and owns columns [OW c, OW c +
// OW) of every output slab (OW = W / 2) for dk / dv and drw / drr.  Per tile
// pair the head dim streams through a ring of two cp.async stages of seven
// 64-row tiles (Qw, dO, Qr, K, V and the 128-row window; slab i + 1 loads
// while slab i's products run): S, dP and X are summed over the slabs once
// (X's per-slab sums land in the warp's f32 staging, where the skew reads
// them: BD[qr][kl] = X[qr][15 - qr + kl]), p and ds follow (tc::p_ds), and
// the block applies the pair's P / dS (dkdv, stored transposed so that P^T
// and dS^T load by ldmatrix) or dS and dSskew (dq; dSskew[qi][63 - qi +
// ki] = ds) to each of its output slabs in turn, restaging only the
// operands each needs (the last score slab's tiles serve the last output
// slab in place).  The running sums of up to ZS output slabs (256 columns)
// stay in registers, so the scores are computed once per tile pair up to H
// 256; above that the output slabs split over ceil(ns / ZS) blocks (grid
// z), each recomputing them.  dG: each key tile's 128 window rows of the
// slab, computed by 16-row blocks (one per warp), are added to device
// memory by float2 atomics.  Carrying the window halves across key tiles,
// as the 16-bit kernels do, would keep each warp's 16 rows of its ZS
// output slabs through the walk, 16 W ZS / 32 more f32 per lane: 32 at H
// 64 (k2_dq_slab<float, 32, 2>, 190-208 registers: 222-240 of the 255 a
// thread may hold; not tried) and 64 at H 128 (<float, 32, 4>, 242: past
// 255).  The window is not kept as a ring across key tiles either: with
// the head dim streamed, its upper half would stay resident at full H
// between tile pairs, 64 (H + 4) f32: 17 KB at H 64 on this kernel's 202
// KB (219 of the 227 KB a block may have; it would save one of the seven
// 64-row tiles staged per slab and tile pair; not tried), 33 KB at H 128
// (235 KB: does not fit), 65 KB at 256.  The products are slab_mma.cuh's:
// bf16 / f16 mma.sync, f32 3xTF32, each k-block's score products and each
// tile pair's output products summed apart in a zeroed fragment and added
// into the running sums with an f32 add.  What bounds it: the products
// (S, dP, BD and five output products per pair) at the tensor cores' rate
// (f32 at a third of TF32's), then the atomics of dG.  Shared memory: dkdv
// 190 KB (f32) / 174 KB (16 bits), dq 207 / 182 KB; one block of eight
// warps per SM.
namespace slabs {

using namespace slab;

constexpr int SP = 2;                   // warps per 16-row group
constexpr int NT = 32 * SP * (BQ / 16); // eight warps
constexpr int KW = BK / SP;             // keys of a warp's S / dP
constexpr int XW = KW + 16;             // BD window columns a warp reads
constexpr int XS = XW + 4;              // f32 row stride of a warp's BD staging
static_assert(KW == tc::Split<128>::KW && XS == tc::Split<128>::XS, "tc::p_ds<128>'s layout");

template <typename E, int W>
struct Lay {
    static constexpr int RS = W + PAD<E>;            // operand row stride
    static constexpr int PS = BK + PAD<E>;           // P / dS row stride
    static constexpr int DSS = 2 * BK + PAD<E>;      // dSskew row stride
    static constexpr int TILE = BQ * RS;             // one staged [64][W] tile
    static constexpr int OW = W / SP < 16 ? 16 : W / SP;   // a warp's columns of an output slab
    // a ring stage: Qw, dO, Qr, K, V, the window's two halves
    static constexpr int QW = 0, DO = 1, QR = 2, KK = 3, VV = 4, GG = 5, NTILE = 7;
    static constexpr size_t RING = (size_t)2 * NTILE * TILE * sizeof(E);
    static constexpr size_t X_BYTES = (size_t)(NT / 32) * 16 * XS * 4;
    // the ring; the warps' BD staging; P^T and dS^T [BK][PS]
    static constexpr size_t dkdv_bytes() {
        return RING + X_BYTES + (size_t)2 * BK * PS * sizeof(E);
    }
    // the ring; the warps' BD staging; dS [BQ][PS]; dSskew [BQ][DSS]
    static constexpr size_t dq_bytes() {
        return RING + X_BYTES + (size_t)BQ * (PS + DSS) * sizeof(E);
    }
};

// a slab instance: width W, output slabs a block holds ZS
template <int W_, int ZS_>
struct Cfg {
    static constexpr int W = W_, ZS = ZS_;
};

// f(Cfg) for the instance a call at head dim H runs: f32 in slabs of
// min(H, 32), 16 bits (H above 128) of 64; up to 256 output columns a block
template <typename E, typename F>
cudaError_t with_cfg(int H, F&& f) {
    if constexpr (kF32<E>) {
        switch (H) {
            case 16: return f(Cfg<16, 1>{});
            case 32: return f(Cfg<32, 1>{});
            case 64: return f(Cfg<32, 2>{});
            case 128: return f(Cfg<32, 4>{});
        }
        if (H <= 128 || H % 128) return cudaErrorInvalidValue;
        return f(Cfg<32, 8>{});
    } else {
        if (H <= 128 || H % 128) return cudaErrorInvalidValue;
        return f(Cfg<64, 4>{});
    }
}

template <typename E, int W, int ZS>
__global__ void __launch_bounds__(NT, 1)
k2_dkdv_slab(const E* __restrict__ rw, const E* __restrict__ rr, const E* __restrict__ kk,
             const E* __restrict__ vv, const E* __restrict__ g, const E* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dk, float* __restrict__ dv, const int* __restrict__ mv_ptr,
             int mv_const, int N, int T_, int S, int M, float scale, int window, int ns) {
    using L = Lay<E, W>;
    constexpr int RS = L::RS, PS = L::PS, TILE = L::TILE, OW = L::OW, K8 = KS<E>;
    const int H = W * ns;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    E* ring = reinterpret_cast<E*>(smem_raw);    // stage b: tile i at ring + (NTILE b + i) TILE
    float* sX = reinterpret_cast<float*>(smem_raw + L::RING);
    E* sP = reinterpret_cast<E*>(smem_raw + L::RING + L::X_BYTES);   // P^T [BK][PS]
    E* sDS = sP + BK * PS;                                           // dS^T

    const int bn = blockIdx.y, z0 = blockIdx.z * ZS, nz = min(ZS, ns - z0);
    const int k0 = blockIdx.x * BK;
    const int head = bn % N;
    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
    const int p = w / SP, c = w % SP, gq = lane >> 2, t = lane & 3;
    const int mv = mv_ptr ? *mv_ptr : mv_const;
    float* sXw = sX + w * 16 * XS;

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
    // the items of a q tile: its ns score slabs, then the block's output
    // slabs but the head dim's last, which the last score slab's tiles serve
    const bool last_in = z0 + nz == ns;
    const int per = ns + nz - last_in, n_items = (qt_end - qt_begin) * per;
    auto issue = [&](int n) {                    // item n's tiles into stage n % 2
        const int m = n % per, q0 = (qt_begin + n / per) * BQ;
        E* st = ring + (n & 1) * L::NTILE * TILE;
        const int c0 = W * (m < ns ? m : z0 + m - ns);
        stage<W>(st + L::QW * TILE, rw_b, q0, BQ, T_, H, c0, tid, NT);
        stage<W>(st + L::DO * TILE, do_b, q0, BQ, T_, H, c0, tid, NT);
        if (m < ns) {
            stage<W>(st + L::QR * TILE, rr_b, q0, BQ, T_, H, c0, tid, NT);
            stage<W>(st + L::KK * TILE, k_b, k0, BK, S, H, c0, tid, NT);
            stage<W>(st + L::VV * TILE, v_b, k0, BK, S, H, c0, tid, NT);
            stage<W>(st + L::GG * TILE, g_h, T_ - q0 - BQ + k0, 2 * BK, T_ + S, H, c0, tid, NT);
        }
        mma_bf16::cp_commit();
    };
    if (n_items > 0) issue(0);

    // key rows 16p + gq (+8), columns W (z0 + zz) + OW c + 8n + 2t
    float dka[ZS][OW / 8][4] = {}, dva[ZS][OW / 8][4] = {};
    // dv[:, slab z0 + zi] += P^T dO_slab, dk += dS^T Qw_slab, the warp's
    // columns, PC n-pairs per pass, the pair's products summed apart
    constexpr int PC = ZS <= 2 ? 2 : 1;
    auto apply = [&](int zi, const E* st) {
        if (OW * c >= W) return;                 // W 16: the group's second warp has none
        const E* tQ = st + L::QW * TILE;
        const E* tO = st + L::DO * TILE;
#pragma unroll
        for (int zz = 0; zz < ZS; ++zz) {
            if (zz != zi) continue;
#pragma unroll
            for (int cp = 0; cp < OW / 16; cp += PC) {
                float tv[2 * PC][4] = {}, tk[2 * PC][4] = {};
#pragma unroll 1
                for (int kq = 0; kq < BQ / K8; ++kq) {
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

    float s[KW / 8][4], dp[KW / 8][4], l2[2], d2[2], unused = 0.f;
    for (int n = 0; n < n_items; ++n) {
        const int m = n % per, q0 = (qt_begin + n / per) * BQ;
        mma_bf16::cp_wait<0>();
        __syncthreads();                         // item n landed; item n - 1 is done
        if (n + 1 < n_items) issue(n + 1);
        const E* st = ring + (n & 1) * L::NTILE * TILE;
        if (m >= ns) {
            apply(m - ns, st);
            continue;
        }
        if (m == 0) {
#pragma unroll
            for (int j = 0; j < KW / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
        }
        if (m == ns - 1) tc::row_stats(l2, d2, lse_b, dl_b, q0, p, lane, T_);
        pair_product<E, W, false>(s, dp, st + L::QW * TILE, st + L::DO * TILE,
                                  st + L::KK * TILE, st + L::VV * TILE, 16 * p, KW * c, RS, lane,
                                  unused, nullptr, nullptr);
        skew_slab<E, W, XW, XS>(sXw, st + L::QR * TILE, 16 * p, st + L::GG * TILE,
                                48 - 16 * p + KW * c, m == 0, lane);
        if (m < ns - 1) continue;
        __syncwarp();                            // the warp's X is staged
        tc::p_ds<128>(s, dp, sXw, q0, k0, p, c, lane, l2, d2, T_, S, M, mv, scale, window,
                      tc::tile_full(q0, k0, T_, S, M, mv, window));
        put_frags<E, true>(sP, s, PS, 16 * p, KW * c, lane);
        put_frags<E, true>(sDS, dp, PS, 16 * p, KW * c, lane);
        __syncthreads();                         // every warp's P^T / dS^T entries are written
        if (last_in) apply(ns - 1 - z0, st);
    }
    mma_bf16::cp_wait<0>();                      // no copy left in flight

#pragma unroll
    for (int zz = 0; zz < ZS; ++zz) {
        if (zz >= nz || OW * c >= W) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int k = k0 + 16 * p + gq + 8 * h;
            if (k >= S) continue;
            const size_t o = ((size_t)bn * S + k) * H + W * (z0 + zz) + OW * c;
#pragma unroll
            for (int n = 0; n < OW / 8; ++n) {
                put2<float>(dk + o + 8 * n + 2 * t, dka[zz][n][2 * h], dka[zz][n][2 * h + 1]);
                put2<float>(dv + o + 8 * n + 2 * t, dva[zz][n][2 * h], dva[zz][n][2 * h + 1]);
            }
        }
    }
}

template <typename E, int W, int ZS>
__global__ void __launch_bounds__(NT, 1)
k2_dq_slab(const E* __restrict__ rw, const E* __restrict__ rr, const E* __restrict__ kk,
           const E* __restrict__ vv, const E* __restrict__ g, const E* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta, E* __restrict__ drw,
           E* __restrict__ drr, float* __restrict__ dg, const int* __restrict__ mv_ptr,
           int mv_const, int N, int T_, int S, int M, float scale, int window, int ns) {
    using L = Lay<E, W>;
    constexpr int RS = L::RS, PS = L::PS, DSS = L::DSS, TILE = L::TILE, OW = L::OW, K8 = KS<E>;
    const int H = W * ns;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    E* ring = reinterpret_cast<E*>(smem_raw);    // stage b: tile i at ring + (NTILE b + i) TILE
    float* sX = reinterpret_cast<float*>(smem_raw + L::RING);
    E* sDS = reinterpret_cast<E*>(smem_raw + L::RING + L::X_BYTES);  // dS [BQ][PS]
    E* sDsk = sDS + BQ * PS;                                         // dSskew [BQ][DSS]

    const int bn = blockIdx.y, z0 = blockIdx.z * ZS, nz = min(ZS, ns - z0);
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest rows first
    const int head = bn % N;
    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
    const int p = w / SP, c = w % SP, gq = lane >> 2, t = lane & 3;
    const int mv = mv_ptr ? *mv_ptr : mv_const;
    float* sXw = sX + w * 16 * XS;
    E* dsk = sDsk + 16 * p * DSS;                // the group's rows of dSskew

    const E* rw_b = rw + (size_t)bn * T_ * H;
    const E* rr_b = rr + (size_t)bn * T_ * H;
    const E* do_b = dout + (size_t)bn * T_ * H;
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
    const bool last_in = z0 + nz == ns;
    const int per = ns + nz - last_in, n_items = max(kt_end - kt_begin, 0) * per;
    auto issue = [&](int n) {                    // item n's tiles into stage n % 2
        const int m = n % per, k0 = (kt_begin + n / per) * BK;
        E* st = ring + (n & 1) * L::NTILE * TILE;
        const int c0 = W * (m < ns ? m : z0 + m - ns);
        stage<W>(st + L::QR * TILE, rr_b, q0, BQ, T_, H, c0, tid, NT);
        stage<W>(st + L::KK * TILE, k_b, k0, BK, S, H, c0, tid, NT);
        stage<W>(st + L::GG * TILE, g_h, T_ - q0 - BQ + k0, 2 * BK, T_ + S, H, c0, tid, NT);
        if (m < ns) {
            stage<W>(st + L::QW * TILE, rw_b, q0, BQ, T_, H, c0, tid, NT);
            stage<W>(st + L::DO * TILE, do_b, q0, BQ, T_, H, c0, tid, NT);
            stage<W>(st + L::VV * TILE, v_b, k0, BK, S, H, c0, tid, NT);
        }
        mma_bf16::cp_commit();
    };
    if (n_items > 0) issue(0);

    float l2[2], d2[2];
    tc::row_stats(l2, d2, lse + (size_t)bn * T_, delta + (size_t)bn * T_, q0, p, lane, T_);
    // q rows 16p + gq (+8), columns W (z0 + zz) + OW c + 8n + 2t
    float dwa[ZS][OW / 8][4] = {}, dra[ZS][OW / 8][4] = {};
    // slab z0 + zi of the tile pair at k0 (staged in st): drw += dS . K, drr
    // += dSskew . Gwin over the group's band of window rows [48 - 16p, 128 -
    // 16p) (the warp's columns; the pair's products summed apart), and the
    // window rows [16w, 16w + 16) of dG += dSskew^T . Qr into device memory
    auto apply = [&](int zi, const E* st, int k0) {
        const E* tK = st + L::KK * TILE;
        const E* tG = st + L::GG * TILE;
        const E* tQr = st + L::QR * TILE;
        if (OW * c < W) {                        // W 16: the group's second warp has none
#pragma unroll
            for (int zz = 0; zz < ZS; ++zz) {
                if (zz != zi) continue;
#pragma unroll
                for (int cp = 0; cp < OW / 16; cp += CH) {
                    float tw[2 * CH][4] = {}, tr[2 * CH][4] = {};
#pragma unroll 1
                    for (int kb = 0; kb < BK / K8; ++kb) {
                        FragA<E> a;
                        load_a(a, sDS, PS, 16 * p, K8 * kb, lane);
#pragma unroll
                        for (int j = 0; j < CH && cp + j < OW / 16; ++j) {
                            FragB<E> b[2];
                            load_bt(b, tK, RS, OW * c + 16 * (cp + j), K8 * kb, lane);
                            mma(tw[2 * j], a, b[0]);
                            mma(tw[2 * j + 1], a, b[1]);
                        }
                    }
#pragma unroll 1
                    for (int kr = 0; kr < 80 / K8; ++kr) {
                        const int r0 = 48 - 16 * p + K8 * kr;
                        FragA<E> a;
                        load_a(a, sDsk, DSS, 16 * p, r0, lane);
#pragma unroll
                        for (int j = 0; j < CH && cp + j < OW / 16; ++j) {
                            FragB<E> b[2];
                            load_bt(b, tG, RS, OW * c + 16 * (cp + j), r0, lane);
                            mma(tr[2 * j], a, b[0]);
                            mma(tr[2 * j + 1], a, b[1]);
                        }
                    }
                    add_pass(dwa[zz], tw, cp);
                    add_pass(dra[zz], tr, cp);
                }
            }
        }
        // window rows [r0, r0 + 16) hold q rows [48 - r0, 126 - r0]
        const int r0 = 16 * w, u_lo = T_ - q0 - BQ + k0;
        float ga[W / 8][4] = {};
#pragma unroll 1
        for (int kq = 0; kq < BQ / K8; ++kq) {
            if (K8 * kq > 126 - r0 || K8 * kq + K8 - 1 < 48 - r0) continue;
            FragA<E> a;
            load_at(a, sDsk, DSS, r0, K8 * kq, lane);
#pragma unroll
            for (int np = 0; np < W / 16; ++np) {
                FragB<E> b[2];
                load_bt(b, tQr, RS, 16 * np, K8 * kq, lane);
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
                    atomicAdd(reinterpret_cast<float2*>(dg_h + (size_t)u * H +
                                                        W * (z0 + zi) + 8 * n + 2 * t),
                              v);
            }
        }
    };

    float s[KW / 8][4], dp[KW / 8][4], unused = 0.f;
    for (int n = 0; n < n_items; ++n) {
        const int m = n % per, k0 = (kt_begin + n / per) * BK;
        mma_bf16::cp_wait<0>();
        __syncthreads();                         // item n landed; item n - 1 is done
        if (n + 1 < n_items) issue(n + 1);
        const E* st = ring + (n & 1) * L::NTILE * TILE;
        if (m >= ns) {
            apply(m - ns, st, k0);
            continue;
        }
        if (m == 0) {
#pragma unroll
            for (int j = 0; j < KW / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
        }
        pair_product<E, W, false>(s, dp, st + L::QW * TILE, st + L::DO * TILE,
                                  st + L::KK * TILE, st + L::VV * TILE, 16 * p, KW * c, RS, lane,
                                  unused, nullptr, nullptr);
        skew_slab<E, W, XW, XS>(sXw, st + L::QR * TILE, 16 * p, st + L::GG * TILE,
                                48 - 16 * p + KW * c, m == 0, lane);
        if (m < ns - 1) continue;
        __syncwarp();                            // the warp's X is staged
        tc::p_ds<128>(s, dp, sXw, q0, k0, p, c, lane, l2, d2, T_, S, M, mv, scale, window,
                      tc::tile_full(q0, k0, T_, S, M, mv, window));
        // the group's rows of dS, and of dSskew: zero, then dSskew[qr][63 -
        // 16p - qr + ki] = ds
        put_frags<E, false>(sDS, dp, PS, 16 * p, KW * c, lane);
        for (int e = lane + 32 * c; e < 16 * 2 * BK / PAD<E>; e += 32 * SP)
            *reinterpret_cast<uint4*>(dsk + (e / (2 * BK / PAD<E>)) * DSS +
                                      (e % (2 * BK / PAD<E>)) * PAD<E>) = make_uint4(0, 0, 0, 0);
        mma_bf16::group_sync<SP>(p);             // the group's dSskew rows are zero
#pragma unroll
        for (int j = 0; j < KW / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int qr = gq + 8 * (e >> 1), ki = KW * c + 8 * j + 2 * t + (e & 1);
                put1<E>(dsk + qr * DSS + 63 - 16 * p - qr + ki, dp[j][e]);
            }
        __syncthreads();                         // every group's dS / dSskew rows are written
        if (last_in) apply(ns - 1 - z0, st, k0);
    }
    mma_bf16::cp_wait<0>();                      // no copy left in flight

#pragma unroll
    for (int zz = 0; zz < ZS; ++zz) {
        if (zz >= nz || OW * c >= W) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int q = q0 + 16 * p + gq + 8 * h;
            if (q >= T_) continue;
            const size_t o = ((size_t)bn * T_ + q) * H + W * (z0 + zz) + OW * c;
#pragma unroll
            for (int n = 0; n < OW / 8; ++n) {
                put2<E>(drw + o + 8 * n + 2 * t, dwa[zz][n][2 * h], dwa[zz][n][2 * h + 1]);
                put2<E>(drr + o + 8 * n + 2 * t, dra[zz][n][2 * h], dra[zz][n][2 * h + 1]);
            }
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

template <typename E, int W, int ZS>
cudaError_t launch_slab(const Args& a, int ns) {
    using L = slabs::Lay<E, W>;
    const size_t smem_kv = L::dkdv_bytes(), smem_q = L::dq_bytes();
    auto kv = slabs::k2_dkdv_slab<E, W, ZS>;
    auto kq = slabs::k2_dq_slab<E, W, ZS>;
    cudaError_t err = cudaFuncSetAttribute(kv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem_kv);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
    if (err != cudaSuccess) return err;
    const E *rw = (const E*)a.rw, *rr = (const E*)a.rr, *k = (const E*)a.k, *v = (const E*)a.v,
            *g = (const E*)a.g, *dout = (const E*)a.dout;
    const float *lse = (const float*)a.lse, *delta = (const float*)a.delta;
    const int nz = (ns + ZS - 1) / ZS;
    kv<<<dim3((a.S + BK - 1) / BK, a.BN, nz), slabs::NT, smem_kv, a.stream>>>(
        rw, rr, k, v, g, dout, lse, delta, (float*)a.dk, (float*)a.dv, a.mv_ptr, a.mv_const,
        a.N, a.T, a.S, a.M, a.scale, a.window, ns);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    kq<<<dim3((a.T + BQ - 1) / BQ, a.BN, nz), slabs::NT, smem_q, a.stream>>>(
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
        }
    }
    return slabs::with_cfg<E>(H, [&](auto cfg) {
        using F = decltype(cfg);
        return launch_slab<E, F::W, F::ZS>(a, H / F::W);
    });
}

template <typename E, int H>
cudaError_t resources_tc(int* out) {
    constexpr int NT = tc::Split<H>::NT;
    cudaError_t err = resources(tc::k2_dkdv_tc<E, H>, tc::dkdv_smem_bytes<H>(), NT, out);
    if (err != cudaSuccess) return err;
    return resources(tc::k2_dq_tc<E, H>, tc::dq_smem_bytes<H>(), NT, out + 5);
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
        }
    }
    return slabs::with_cfg<E>(H, [&](auto cfg) {
        using F = decltype(cfg);
        using L = slabs::Lay<E, F::W>;
        cudaError_t err = resources(slabs::k2_dkdv_slab<E, F::W, F::ZS>, L::dkdv_bytes(),
                                    slabs::NT, out);
        if (err != cudaSuccess) return err;
        return resources(slabs::k2_dq_slab<E, F::W, F::ZS>, L::dq_bytes(), slabs::NT, out + 5);
    });
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
