// The product policy of the slab kernels of K1-K4 (flash_rel_attn_fwd.cu,
// flash_rel_attn_bwd.cu, chunked_window_attn_fwd.cu,
// chunked_window_attn_bwd.cu): the kernels that run every f32 call of K1-K4
// and every call at a head dim above 128.  One kernel body
// serves three element types E:
//   bf16, f16  mma.sync m16n8k16 (E in, f32 accumulate), one per product;
//   f32        3xTF32: mma.sync m16n8k8 with TF32 inputs, f32 accumulate.
//              Each f32 operand x is split where its fragment is loaded into
//              hi = x rounded to TF32 and lo = x - hi (exact in f32) rounded
//              to TF32, both to nearest with ties away from zero
//              (cvt.rna.tf32's rounding, done on the bits: plus 2^12, and
//              the low 13 bits cleared for hi, dropped by the tensor core
//              for lo), and a product is lo.hi + hi.lo + hi.hi, the small
//              terms first: only lo.lo (~2^-22 of the product) and lo's own
//              rounding (~2^-22 of x) are lost, so the sums keep about f32
//              accuracy at a third of the TF32 rate.  Operands are split as fragments, not as
//              staged values, because a split copy of every staged tile
//              would double the f32 tiles' shared memory.
// The tensor cores accumulate with truncation, not rounding to nearest, so a
// long sum of f32 products drifts by about an ulp of the sum per step: a
// kernel adds each k-block's (scores) or each tile's (outputs) products into
// a zeroed fragment and that into its running sums with an f32 add (K2's dk
// / dv over 1,024 rows read 1.5e-5 of their max with one accumulator,
// against the 1e-5 limit; drr at head dim 256, 1.4e-5 with the scores summed
// over four slabs in one).  K1 / K3's forward scores sum each slab apart
// and add the slab sums in order (at |s| ~ 50 one running sum over the 32
// k-blocks of head dim 256 lay farther from f64 than the plain f32 forward);
// K4's f32 scores over several slabs (D >= 128) carry their sum across slabs
// as a pair (carry_slab, below).
// Operands sit in shared memory as E rows whose stride is the slab width W
// plus 16 bytes (an odd number of 16-byte units: ldmatrix without bank
// conflicts).  A k-block of a product is KS = 16 (b16) or 8 (f32) elements
// deep; both are 32 bytes, so the ldmatrix lane addresses of mma_bf16.cuh
// hold for f32 rows read as b16 pairs:
//   A [16 x 8] tf32:  a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4]
//   B [8 x 8]  tf32:  b0 = B[t][g], b1 = B[t+4][g]        (lane = 4 g + t)
// which are ldmatrix.x4's four 8 x 4-word matrices.  ldmatrix.trans moves
// b16 halves, so the f32 operands read transposed ([k][n] for B, [k][m] for
// A) are read as single words.  C fragments are the same for both
// instructions: c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1].
#pragma once
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace slab {

using mma_bf16::cp_async16;

template <typename E> constexpr bool kF32 = std::is_same_v<E, float>;
constexpr int CH = 2;            // n-pairs per pass of the slab kernels' products
template <typename E> constexpr int KS = kF32<E> ? 8 : 16;         // k-block depth
template <typename E> constexpr int PAD = 16 / (int)sizeof(E);      // row pad (elements)

template <typename E> struct FragA { uint32_t r[4]; };
template <> struct FragA<float> { uint32_t h[4], l[4]; };
template <typename E> struct FragB { uint32_t r[2]; };
template <> struct FragB<float> { uint32_t h[2], l[2]; };

// x (f32 bits) -> its TF32 high part and the TF32 rounding of the rest, both
// to nearest with ties away from zero (the bits are sign and magnitude, so
// adding half of 2^13 rounds the magnitude away from zero).  lo keeps its
// low 13 bits: the tensor core drops them, which completes the rounding
// (as ptxas lowers cvt.rna.tf32 feeding an mma), one instruction fewer
__device__ __forceinline__ void split(uint32_t x, uint32_t& h, uint32_t& l) {
    h = (x + 0x1000u) & 0xffffe000u;
    l = __float_as_uint(__uint_as_float(x) - __uint_as_float(h)) + 0x1000u;
}

template <int N>
__device__ __forceinline__ void split_all(const uint32_t (&x)[N], uint32_t (&h)[N],
                                          uint32_t (&l)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) split(x[i], h[i], l[i]);
}

// not volatile: a register-only instruction the compiler may interleave,
// so that the three dependent products of one accumulator are not scheduled
// back to back (in order, each would wait out the previous one's latency)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the same with C = 0: d = a . b (d's contents dropped, no zeroing)
__device__ __forceinline__ void mma_tf32_z(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                           uint32_t b1) {
    asm(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

template <typename E>
__device__ __forceinline__ void mma16_z(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
    if constexpr (std::is_same_v<E, __half>)
        asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
            : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
    else
        asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
            : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// d = a . b over one k-block, into a fragment whose contents are dropped
// (the zeroed fragment of the flush rule, without zeroing it)
template <typename E>
__device__ __forceinline__ void mma_z(float (&d)[4], const FragA<E>& a, const FragB<E>& b) {
    if constexpr (kF32<E>) {
        mma_tf32_z(d, a.l, b.h[0], b.h[1]);
        mma_tf32(d, a.h, b.l[0], b.l[1]);
        mma_tf32(d, a.h, b.h[0], b.h[1]);
    } else {
        mma16_z<E>(d, a.r, b.r[0], b.r[1]);
    }
}

// d += a . b over one k-block
template <typename E>
__device__ __forceinline__ void mma(float (&d)[4], const FragA<E>& a, const FragB<E>& b) {
    if constexpr (kF32<E>) {
        mma_tf32(d, a.l, b.h[0], b.h[1]);
        mma_tf32(d, a.h, b.l[0], b.l[1]);
        mma_tf32(d, a.h, b.h[0], b.h[1]);
    } else {
        mma_bf16::mma<E>(d, a.r, b.r[0], b.r[1]);
    }
}

template <typename E>
__device__ __forceinline__ void set_a(FragA<E>& a, const uint32_t (&x)[4]) {
    if constexpr (kF32<E>)
        split_all(x, a.h, a.l);
    else
#pragma unroll
        for (int i = 0; i < 4; ++i) a.r[i] = x[i];
}

template <typename E>
__device__ __forceinline__ void set_b(FragB<E>& b, uint32_t x0, uint32_t x1) {
    const uint32_t x[2] = {x0, x1};
    if constexpr (kF32<E>)
        split_all(x, b.h, b.l);
    else {
        b.r[0] = x0;
        b.r[1] = x1;
    }
}

__device__ __forceinline__ uint32_t word(const float* p) { return __float_as_uint(*p); }

// A = rows [m0, m0 + 16) x k-block [k0, k0 + KS) of a matrix stored [m][k]
template <typename E>
__device__ __forceinline__ void load_a(FragA<E>& a, const E* base, int ld, int m0, int k0,
                                       int lane) {
    uint32_t x[4];
    mma_bf16::ldsm_x4(x, base + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * PAD<E>);
    set_a(a, x);
}

// A = the same block of a matrix stored [k][m] (A = stored^T)
template <typename E>
__device__ __forceinline__ void load_at(FragA<E>& a, const E* base, int ld, int m0, int k0,
                                        int lane) {
    uint32_t x[4];
    if constexpr (kF32<E>) {
        const int g = lane >> 2, t = lane & 3;
        const float* p = base + (k0 + t) * ld + m0 + g;
        x[0] = word(p);
        x[1] = word(p + 8);
        x[2] = word(p + 4 * ld);
        x[3] = word(p + 4 * ld + 8);
    } else {
        mma_bf16::ldsm_x4_t(x, base + (k0 + (lane & 7) + ((lane >> 4) << 3)) * ld + m0 +
                                   (((lane >> 3) & 1) << 3));
    }
    set_a(a, x);
}

// B of n-blocks [n0, n0 + 8) (b[0]) and [n0 + 8, n0 + 16) (b[1]) over the
// k-block [k0, k0 + KS), from a matrix stored [n][k] (C = X . stored^T)
template <typename E>
__device__ __forceinline__ void load_b(FragB<E> (&b)[2], const E* base, int ld, int n0, int k0,
                                       int lane) {
    uint32_t x[4];
    mma_bf16::ldsm_x4(x, base + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                             ((lane >> 3) & 1) * PAD<E>);
    set_b(b[0], x[0], x[1]);
    set_b(b[1], x[2], x[3]);
}

// the same from a matrix stored [k][n] (C = X . stored)
template <typename E>
__device__ __forceinline__ void load_bt(FragB<E> (&b)[2], const E* base, int ld, int n0, int k0,
                                        int lane) {
    if constexpr (kF32<E>) {
        const int g = lane >> 2, t = lane & 3;
        const float* p = base + (k0 + t) * ld + n0 + g;
        set_b(b[0], word(p), word(p + 4 * ld));
        set_b(b[1], word(p + 8), word(p + 4 * ld + 8));
    } else {
        uint32_t x[4];
        mma_bf16::ldsm_x4_t(x, base + (k0 + (lane & 15)) * ld + n0 + ((lane >> 4) << 3));
        set_b(b[0], x[0], x[1]);
        set_b(b[1], x[2], x[3]);
    }
}

// the A fragment of k-block kb of a [16 x 8 n] accumulator row held as C
// tiles c[n]: b16 takes tiles 2 kb and 2 kb + 1 rounded to E (RNE), f32
// tile kb, its columns t and t + 4 gathered from the quad by shuffles
template <typename E, int N>
__device__ __forceinline__ void acc_a(FragA<E>& a, const float (&c)[N][4], int kb, int lane) {
    if constexpr (kF32<E>) {
        const int t = lane & 3, src = (lane & ~3) | (t >> 1);
        const bool odd = t & 1;
        const float(&ct)[4] = c[kb];
        uint32_t x[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {          // rows g (h 0) and g + 8 (h 1)
            const float lo0 = __shfl_sync(0xffffffffu, ct[2 * h], src);
            const float lo1 = __shfl_sync(0xffffffffu, ct[2 * h + 1], src);
            const float hi0 = __shfl_sync(0xffffffffu, ct[2 * h], src + 2);
            const float hi1 = __shfl_sync(0xffffffffu, ct[2 * h + 1], src + 2);
            x[h] = __float_as_uint(odd ? lo1 : lo0);       // column t
            x[2 + h] = __float_as_uint(odd ? hi1 : hi0);   // column t + 4
        }
        set_a(a, x);
    } else {
        mma_bf16::c_to_a<E>(a.r, c[2 * kb], c[2 * kb + 1]);
    }
}

// acc[2 c .. 2 c + M) += t, element by element (an f32 add, rounded to
// nearest): one pass over n-pairs c, c + 1, ... of a product
template <int M, int N>
__device__ __forceinline__ void add_pass(float (&acc)[N][4], const float (&t)[M][4], int c) {
#pragma unroll
    for (int j = 0; j < M && 2 * c + j < N; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[2 * c + j][e] += t[j][e];
}

// acc continued over the W columns of the staged rows a and b in column
// order: self_score's sequential f32 FMA chain, a piece at a time
template <typename E, int W>
__device__ __forceinline__ float own_chain(float acc, const E* a, const E* b) {
    if constexpr (kF32<E>) {
#pragma unroll
        for (int d = 0; d < W; ++d) acc = fmaf(a[d], b[d], acc);
    } else {
        const uint32_t* a2 = reinterpret_cast<const uint32_t*>(a);
        const uint32_t* b2 = reinterpret_cast<const uint32_t*>(b);
#pragma unroll
        for (int d = 0; d < W / 2; ++d) {
            const float2 x = mma_bf16::unpack<E>(a2[d]), y = mma_bf16::unpack<E>(b2[d]);
            acc = fmaf(x.x, y.x, acc);
            acc = fmaf(x.y, y.y, acc);
        }
    }
    return acc;
}

// acc += A[m0, m0 + 16) . B[n0, n0 + 8 N)^T over one slab's W columns (A and
// B stored [row][col], row stride ld).  In passes of PASS n-pairs (A is
// reloaded per pass); each k-block's products summed apart in t, then added
// to acc rounded to nearest, so the tensor cores' truncation acts on one
// k-block's sum and never on the running score (a score of |s| ~ 50, an LSH
// layer's at head dim 256 with unit inputs, summed over 32 k-blocks with
// flushes per slab only, missed the f32 limit by 1.2x through exp(s - lse)).
// The k-blocks are unrolled UNROLL at a time (the backward kernels: not
// at all, so that few fragments are in flight beside their running sums;
// the forward ones as far as their registers allow: 5-17% faster on an
// H100), and the kernels take passes of CH n-pairs: the f32 fragments are
// twice the registers.  CHAIN: *own continues over the slab's columns of the
// staged rows ca and cb (own_chain, one k-block's columns at a time, in
// order, in the first pass), so that the sequential chain's latency hides
// among the products.
template <typename E, int W, int PASS = CH, bool CHAIN = false, int UNROLL = 1, int N>
__device__ __forceinline__ void slab_product(float (&acc)[N][4], const E* A, int m0, const E* B,
                                             int n0, int ld, int lane, float* own = nullptr,
                                             const E* ca = nullptr, const E* cb = nullptr) {
#pragma unroll
    for (int c = 0; c < N / 2; c += PASS) {
#pragma unroll (UNROLL)
        for (int kb = 0; kb < W / KS<E>; ++kb) {
            float t[2 * PASS][4] = {};
            FragA<E> a;
            load_a(a, A, ld, m0, KS<E> * kb, lane);
#pragma unroll
            for (int j = 0; j < PASS && c + j < N / 2; ++j) {
                FragB<E> b[2];
                load_b(b, B, ld, n0 + 16 * (c + j), KS<E> * kb, lane);
                mma(t[2 * j], a, b[0]);
                mma(t[2 * j + 1], a, b[1]);
            }
            if constexpr (CHAIN)
                if (c == 0) *own = own_chain<E, KS<E>>(*own, ca + KS<E> * kb, cb + KS<E> * kb);
            add_pass(acc, t, c);
        }
    }
}

// K1 / K2's skew product of one staged slab: X = Qr[m0, m0 + 16) . G[n0,
// n0 + XW)^T over the slab's W columns (row stride W + PAD) into the warp's
// f32 staging sXw [16][XS], where BD[qr][kl] = X[qr][15 - qr + kl] is read:
// stored at the head dim's first slab, added (f32, rounded to nearest)
// after; the k-blocks unrolled UNROLL at a time (slab_product's)
template <typename E, int W, int XW, int XS, int UNROLL = 1>
__device__ __forceinline__ void skew_slab(float* sXw, const E* Qr, int m0, const E* G, int n0,
                                          bool first, int lane) {
    float x[XW / 8][4] = {};
    slab_product<E, W, CH, false, UNROLL>(x, Qr, m0, G, n0, W + PAD<E>, lane);
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int n = 0; n < XW / 8; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float2* o = reinterpret_cast<float2*>(sXw + (g + 8 * h) * XS + 8 * n + 2 * t);
            const float2 v = first ? make_float2(0.f, 0.f) : *o;
            *o = make_float2(v.x + x[n][2 * h], v.y + x[n][2 * h + 1]);
        }
}

// two f32 values as E at dst (rounded to E by RNE; f32 as they are)
template <typename E>
__device__ __forceinline__ void put2(E* dst, float lo, float hi) {
    if constexpr (kF32<E>)
        *reinterpret_cast<float2*>(dst) = make_float2(lo, hi);
    else
        *reinterpret_cast<uint32_t*>(dst) = mma_bf16::pack<E>(lo, hi);
}

// one f32 value as E at dst (rounded to E by RNE; f32 as it is)
template <typename E>
__device__ __forceinline__ void put1(E* dst, float x) {
    if constexpr (kF32<E>)
        *dst = x;
    else if constexpr (std::is_same_v<E, __half>)
        *dst = __float2half_rn(x);
    else
        *dst = __float2bfloat16_rn(x);
}

// rows [r0, r0 + n) x columns [c0, c0 + W) of a [len, ld] matrix into
// shared rows of stride W + PAD; zero fill outside [0, len); nt threads
template <int W, typename E>
__device__ __forceinline__ void stage(E* dst, const E* src, int r0, int n, int len, int ld,
                                      int c0, int tid, int nt) {
    constexpr int CPR = W / PAD<E>;                  // 16-byte chunks per row
    for (int e = tid; e < n * CPR; e += nt) {
        const int r = e / CPR, c = (e % CPR) * PAD<E>, row = r0 + r;
        const bool ok = row >= 0 && row < len;
        cp_async16(dst + r * (W + PAD<E>) + c, src + (ok ? (size_t)row * ld + c0 + c : 0), ok);
    }
}

// The backward slab kernels' scores: S += Q . K^T and dP += dO . V^T over
// one staged slab of W columns, rows m0 + [0, 16) of Q / dO against keys n0
// + [0, 8 N) of K / V (row stride ld); each k-block's products summed apart
// in a fresh fragment, then added (slab_product's rule), S and dP
// interleaved so that the tensor cores have twice the independent chains.
// CHAIN: `own` continues over the slab's columns of the staged rows ca and
// cb (own_chain, one k-block's columns at a time, in order), so that the
// sequential chain's latency hides among the products
template <typename E, int W, bool CHAIN, int N>
__device__ __forceinline__ void pair_product(float (&s)[N][4], float (&dp)[N][4], const E* Q,
                                             const E* O, const E* K, const E* V, int m0,
                                             int n0, int ld, int lane, float& own, const E* ca,
                                             const E* cb) {
#pragma unroll 1
    for (int kb = 0; kb < W / KS<E>; ++kb) {
        float ts[N][4], td[N][4];
        FragA<E> aq, ao;
        load_a(aq, Q, ld, m0, KS<E> * kb, lane);
        load_a(ao, O, ld, m0, KS<E> * kb, lane);
#pragma unroll
        for (int j = 0; j < N / 2; ++j) {
            FragB<E> bk[2], bv[2];
            load_b(bk, K, ld, n0 + 16 * j, KS<E> * kb, lane);
            load_b(bv, V, ld, n0 + 16 * j, KS<E> * kb, lane);
            mma_z(ts[2 * j], aq, bk[0]);
            mma_z(td[2 * j], ao, bv[0]);
            mma_z(ts[2 * j + 1], aq, bk[1]);
            mma_z(td[2 * j + 1], ao, bv[1]);
        }
        if constexpr (CHAIN)
            own = own_chain<E, KS<E>>(own, ca + KS<E> * kb, cb + KS<E> * kb);
        add_pass(s, ts, 0);
        add_pass(dp, td, 0);
    }
}

// s + e == a + b exactly, s = fl(a + b), whatever the magnitudes (Knuth's
// TwoSum; the _rn intrinsics keep the steps from being fused or reordered)
__device__ __forceinline__ float two_sum(float a, float b, float& e) {
    const float s = __fadd_rn(a, b), bv = __fsub_rn(s, a);
    e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bv)), __fsub_rn(b, bv));
    return s;
}

// The f32 backward kernels' score S over ns >= 2 slabs of the head dim,
// carried as an unevaluated pair hi + lo: after slab m the slab's sum s
// (its k-blocks added in f32, as pair_product adds them) goes into the pair
// by two_sum.  The pair waits in `hold`, each lane's own words of [2][4
// N][32] f32 in shared memory (hi, then lo: no barrier, and no registers
// held through the products), and s restarts at 0; after the last slab s
// = hi, and lo stays in `hold` for p_ds.  A score of |s| ~ 50 summed in
// f32 over 16-32 k-blocks rounds at ~4e-6 per add, which exp(s - lse)
// turns into a relative error of p of that size; the pair leaves only
// each slab's own sum rounded.
template <int N>
__device__ __forceinline__ void carry_slab(float (&s)[N][4], float* hold, int m, int ns,
                                           int lane) {
    float* lo = hold + 4 * N * 32;
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int i = (4 * j + e) * 32 + lane;
            float err;
            const float h = two_sum(m ? hold[i] : 0.f, s[j][e], err);
            lo[i] = __fadd_rn(m ? lo[i] : 0.f, err);
            if (m < ns - 1) hold[i] = h;
            s[j][e] = m < ns - 1 ? 0.f : h;
        }
}

// K3 / K4: the positions of keys w0 + 8j (+1), j < N, a lane's columns of
// a warp's scores (rows base + w of kpos; INT_MAX outside [0, T): never
// visible)
template <int N>
__device__ __forceinline__ void load_keys(int (&kp)[N][2], const int* kpos, size_t base, int w0,
                                          int T_) {
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int w = w0 + 8 * j + e;
            kp[j][e] = w >= 0 && w < T_ ? __ldg(kpos + base + w) : INT_MAX;
        }
}

// a C fragment row block x (rows r0 + g (+8), columns c0 + 8j + 2t (+1))
// into the shared tile dst (row stride ld) as it is (dst[row][column]) or
// transposed (dst[column][row]), rounded to E
template <typename E, bool TRANS, int N>
__device__ __forceinline__ void put_frags(E* dst, const float (&x)[N][4], int ld, int r0, int c0,
                                          int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = r0 + g + 8 * h, k = c0 + 8 * j + 2 * t;
            if constexpr (TRANS) {
                put1<E>(dst + k * ld + r, x[j][2 * h]);
                put1<E>(dst + (k + 1) * ld + r, x[j][2 * h + 1]);
            } else {
                put2<E>(dst + r * ld + k, x[j][2 * h], x[j][2 * h + 1]);
            }
        }
}

}  // namespace slab
