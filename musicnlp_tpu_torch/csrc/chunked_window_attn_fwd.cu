// K3: chunked-window causal attention forward (the Reformer's local and LSH
// layers), for Hopper (sm_90a).  Replaces the Pallas TPU kernel
// musicnlp_tpu/ops/pallas/chunked_attention_kernel.py::_make_fwd (called
// through _fwd_call / chunked_window_attn; its two-dot form _make_fwd2
// computes the same function).
//
// What it computes, per row g of G and query chunk i (chunk C, head dim D):
// the window is the C keys of chunk i-1 (none before chunk 0: zeros, masked)
// followed by the C keys of chunk i, and for each query q of chunk i
//   s[q, w]  = (q . k[w]) * scale
//   masked   : kpos[w] > qpos[q]                   -> -1e9 (finite, as on the TPU)
//   self     : kpos[w] == qpos[q]                  -> s + self_bias
//   ctx[q]   = sum_w round(p[q, w]) v[w] / l,  p = exp(s - max), l = max(sum p, 1e-30)
//   lse[q]   = max + log(l)                        (f32, its own [G, T] tensor)
// Padding arrives as kpos = T; LSH layers pass sorted (permuted) positions.
// A query whose whole window is masked gets the window's uniform average.
// The TPU version's blocking (m chunks per program, lse packed into lane
// padding) is layout, not semantics, and is not carried over.
//
// Bound on the H100 (SXM, 700 W): at the 22-04 LSH shape (G 768, T 2048,
// D 64, C 64, bf16) the call moves ~0.82 GB (q, k, v and both positions read
// once, ctx and lse written once) for ~52 GFLOP: 0.246 ms at 3.35 TB/s
// against 0.05 ms at 989 TFLOP/s -- bytes bound it (local, G 384: 0.123 ms).
//
// Routes (chosen inside the C entry point by dtype, chunk and D):
//   bf16 / f16, chunks 32 / 64 at D <= 64: k3_tc (tensor cores);
//   bf16 / f16, every other chunk and D 128: k3_union_tc (tensor cores);
//   f32 at every chunk and D, and every dtype above D 128: k3_slab (tensor
//   cores; f32 in 3xTF32).
//
// bf16 and f16 (k3_tc, templated on the element type E), the training and
// scoring path: K4's run layout (chunked_window_attn_bwd.cu).  One block of
// C / 16 warps per (g, run of RUN = 16 consecutive chunks) walks its run in
// order and keeps the previous chunk's K / V / kpos resident, so each chunk
// is loaded once per run, by cp.async, while the chunk before it computes;
// only a run's first chunk loads its look-back (chunk 0's is zeros with kpos
// INT_MAX: never visible).  Warp w owns query rows 16w..16w+15.  S = Q .
// [K_{i-1}; K_i]^T is 2C / 8 n-blocks of mma.sync m16n8k16 (E in, f32
// accumulate; mma_bf16.cuh) in registers: the whole 2C-wide row fits, so no
// online softmax.  The element chain runs on the accumulator fragments and
// is kept lean: the positions are staged once per chunk (kpos read as int2
// pairs, qpos in registers), scale and self_bias are hoisted, the layers
// without a self bias run an instance without its compare, row max and sum
// are quad shuffles, p = exp2f((x - max) * log2(e)) with x and max in
// natural units (so the masks, the max and lse are the f32 values of the
// reference), and each output row takes one reciprocal.  P becomes E A
// fragments by RNE (c_to_a) for PV against V read by ldmatrix.trans.  One
// exception keeps lse exact: a row that sees only its own key (the LSH
// layers' self bias, -1e5, makes it the max) has lse = fl(s + self_bias),
// whose f32 steps are 2^-7; a tensor-core sum of s, in another order than
// the f32 product of the reference, can round it to a neighbouring step, so
// that one score is recomputed as the sequential f32 FMA chain over d, the
// reference's order (self_score; only warps that hold such a row take that
// branch).  Shared memory at C = D = 64: K, V x 3 slots 54 KB, Q x 2 slots
// 18 KB, positions 1.3 KB -- 74 KB per block.
//
// The tiled walk (k3_union_tc) takes the other 16-bit calls up to D 128
// (see `namespace tiled` below), and the slab walk (k3_slab) every f32 call
// and every call above D 128 (`namespace slabs`).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "kernel_resources.cuh"
#include "mma_bf16.cuh"
#include "slab_mma.cuh"

namespace {

constexpr float kNegInf = -1e9f;

using kernel_resources::resources;

// ------------------------------------------- bf16 and f16 on the tensor cores
namespace tc {

using namespace mma_bf16;

constexpr int RUN = 16;                 // consecutive chunks per block
constexpr float kLog2e = 1.4426950408889634f;

// fl(fl(q . k * scale) + self_bias) for the D-long E rows qr and kr (16-byte
// aligned), q . k as the sequential f32 FMA chain over d: the reference's
// order, which the lse of a row that sees only its own key keeps (see the
// note at the top)
template <typename E, int D>
__device__ __forceinline__ float self_score(const E* qr, const E* kr, float scale,
                                            float self_bias) {
    const uint4* q4 = reinterpret_cast<const uint4*>(qr);
    const uint4* k4 = reinterpret_cast<const uint4*>(kr);
    uint4 qv[D / 8], kv[D / 8];          // every load issued before the chain
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
        qv[d] = q4[d];
        kv[d] = k4[d];
    }
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
        const uint32_t* a = reinterpret_cast<const uint32_t*>(&qv[d]);
        const uint32_t* b = reinterpret_cast<const uint32_t*>(&kv[d]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float2 x = unpack<E>(a[j]), y = unpack<E>(b[j]);
            acc = fmaf(x.x, y.x, acc);
            acc = fmaf(x.y, y.y, acc);
        }
    }
    return __fadd_rn(__fmul_rn(acc, scale), self_bias);
}

template <int C, int D>
constexpr size_t smem_bytes() {
    // K, V [3 slots][C][D+8] and Q [2 slots][C][D+8] b16; kpos [3][C] and
    // qpos [2][C] int
    return 2 * (size_t)8 * C * (D + 8) + 4 * (size_t)5 * C;
}

// The warp's [16 x 2C] window scores -> p (unnormalised), with the rows' max
// mx and sums l (>= 1e-30) after the quad reductions.  s: rows gq, gq + 8
// (e >> 1), window columns 8b + 2t + (e & 1) (b < C / 8: the look-back);
// kp: the key positions of the look-back and own chunk; qp: the rows' query
// positions.  BIAS: self_bias where kpos == qpos (the LSH layers), and a row
// that sees only its own key recomputes that score from qrow (the warp's Q
// rows) and kw (the key slots) as the sequential f32 FMA chain (see the note
// at the top).
template <typename E, int C, int D, bool BIAS>
__device__ __forceinline__ void window_softmax(float (&s)[C / 4][4], float (&mx)[2],
                                               float (&l)[2], const int* const (&kp)[2],
                                               const int (&qp)[2], const E* qrow,
                                               const E* const (&kw)[2], int gq, int t,
                                               float scale, float self_bias) {
    constexpr int NB = C / 4, HB = C / 8, DS = D + 8;
    auto kpos2 = [&](int b) {           // positions of window columns 8b + 2t, 8b + 2t + 1
        return *reinterpret_cast<const int2*>(kp[b / HB] + 8 * (b % HB) + 2 * t);
    };
    int kmin = INT_MAX;                 // the least key position in the lane's columns
    mx[0] = mx[1] = -INFINITY;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
        const int2 k2 = kpos2(b);
        if (BIAS) kmin = min(kmin, min(k2.x, k2.y));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int h = e >> 1, kpos = (e & 1) ? k2.y : k2.x;
            float x = s[b][e] * scale;
            if (BIAS && kpos == qp[h]) x += self_bias;
            if (kpos > qp[h]) x = kNegInf;
            s[b][e] = x;
            mx[h] = fmaxf(mx[h], x);
        }
    }
    auto quad_max = [&] {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        }
    };
    quad_max();
    if (BIAS) {
        // only a row whose position is the window's least key position sees
        // no key but its own, whose biased score is then the row's max
        kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, 1));
        kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, 2));
        if (__any_sync(0xffffffffu, qp[0] == kmin || qp[1] == kmin)) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                if (qp[h] != kmin) continue;
                int c = -1;                 // this lane's column holding that max, if any
#pragma unroll
                for (int b = 0; b < NB; ++b) {
                    const int2 k2 = kpos2(b);
#pragma unroll
                    for (int e = 2 * h; e < 2 * h + 2; ++e)
                        if (((e & 1) ? k2.y : k2.x) == qp[h] && s[b][e] == mx[h])
                            c = 8 * b + 2 * t + (e & 1);
                }
                if (c < 0) continue;
                const float x = self_score<E, D>(qrow + (gq + 8 * h) * DS,
                                                 (c < C ? kw[0] : kw[1]) + (c % C) * DS, scale,
                                                 self_bias);
#pragma unroll
                for (int b = 0; b < NB; ++b)
#pragma unroll
                    for (int e = 2 * h; e < 2 * h + 2; ++e)
                        if (8 * b + 2 * t + (e & 1) == c) s[b][e] = x;
            }
            mx[0] = mx[1] = -INFINITY;
#pragma unroll
            for (int b = 0; b < NB; ++b)
#pragma unroll
                for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[b][e]);
            quad_max();
        }
    }
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float p = exp2f((s[b][e] - mx[e >> 1]) * kLog2e);
            l[e >> 1] += p;
            s[b][e] = p;                 // rounded to E by c_to_a
        }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        l[h] = fmaxf(l[h], 1e-30f);
    }
}

// BIAS: the layer has a self bias (self_bias != 0: the LSH layers)
template <typename E, int C, int D, bool BIAS>
__global__ void __launch_bounds__(2 * C, 2)
k3_tc(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
      const int* __restrict__ qpos, const int* __restrict__ kpos, E* __restrict__ out,
      float* __restrict__ lse, int T_, float scale, float self_bias) {
    constexpr int NT = 2 * C;           // C / 16 warps
    constexpr int DS = D + 8;
    constexpr int NB = C / 4;           // window columns: 2C in n-blocks of 8
    constexpr int HB = C / 8;           // n-blocks per chunk of the window
    extern __shared__ __align__(16) unsigned char smem_raw[];
    E* sK = reinterpret_cast<E*>(smem_raw);         // [3][C][DS]: key chunk c in slot (c + 3) % 3
    E* sV = sK + 3 * C * DS;
    E* sQ = sV + 3 * C * DS;                        // [2][C][DS]: query chunk c in slot c % 2
    int* sKp = reinterpret_cast<int*>(sQ + 2 * C * DS);   // [3][C], as K
    int* sQp = sKp + 3 * C;                         // [2][C], as Q

    const int gr = blockIdx.y, n = T_ / C;
    const int j0 = blockIdx.x * RUN, j1 = min(j0 + RUN, n);
    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
    const int gq = lane >> 2, t = lane & 3;
    const size_t base = (size_t)gr * T_;

    auto kslot = [](int c) { return (c + 3) % 3; };
    auto load_kv = [&](int c) {          // key chunk c; c = -1: the zeros before chunk 0
        const int sl = kslot(c);
        stage_rows<D>(sK + sl * C * DS, k + base * D, c * C, C, T_, tid, NT);
        stage_rows<D>(sV + sl * C * DS, v + base * D, c * C, C, T_, tid, NT);
        for (int e = tid; e < C; e += NT) {
            if (c >= 0)
                cp_async4(sKp + sl * C + e, kpos + base + (size_t)c * C + e, true);
            else
                sKp[sl * C + e] = INT_MAX;          // never visible
        }
    };
    auto load_q = [&](int c) {           // query chunk c
        const int sl = c & 1;
        stage_rows<D>(sQ + sl * C * DS, q + base * D, c * C, C, T_, tid, NT);
        for (int e = tid; e < C; e += NT)
            cp_async4(sQp + sl * C + e, qpos + base + (size_t)c * C + e, true);
    };

    load_kv(j0 - 1);                     // the run's look-back
    load_kv(j0);
    load_q(j0);
    cp_commit();
    for (int i = j0; i < j1; ++i) {
        cp_wait<0>();
        __syncthreads();                 // chunk i landed; every warp is done with chunk i - 1
        if (i + 1 < j1) {                // into the slots chunk i - 1 held
            load_kv(i + 1);
            load_q(i + 1);
            cp_commit();
        }
        const E* tQ = sQ + (i & 1) * C * DS;
        const E* const kw[2] = {sK + kslot(i - 1) * C * DS, sK + kslot(i) * C * DS};
        const E* const vw[2] = {sV + kslot(i - 1) * C * DS, sV + kslot(i) * C * DS};
        const int* const kp[2] = {sKp + kslot(i - 1) * C, sKp + kslot(i) * C};
        const int qp[2] = {sQp[(i & 1) * C + 16 * w + gq], sQp[(i & 1) * C + 16 * w + gq + 8]};

        // S = Q . [K_{i-1}; K_i]^T: n-block b is window columns 8b .. 8b+7
        float s[NB][4] = {};
#pragma unroll
        for (int kb = 0; kb < D / 16; ++kb) {
            uint32_t a[4];
            load_a(a, tQ, DS, 16 * w, 16 * kb, lane);
#pragma unroll
            for (int hf = 0; hf < 2; ++hf)
#pragma unroll
                for (int np = 0; np < C / 16; ++np) {
                    uint32_t b[4];
                    load_b(b, kw[hf], DS, 16 * np, 16 * kb, lane);
                    mma<E>(s[hf * HB + 2 * np], a, b[0], b[1]);
                    mma<E>(s[hf * HB + 2 * np + 1], a, b[2], b[3]);
                }
        }
        float mx[2], l[2];
        window_softmax<E, C, D, BIAS>(s, mx, l, kp, qp, tQ + 16 * w * DS, kw, gq, t, scale,
                                      self_bias);

        // ctx = P . [V_{i-1}; V_i]
        float o[D / 8][4] = {};
#pragma unroll
        for (int kb = 0; kb < C / 8; ++kb) {
            uint32_t a[4];
            c_to_a<E>(a, s[2 * kb], s[2 * kb + 1]);
            const E* vt = vw[kb / (C / 16)];
#pragma unroll
            for (int np = 0; np < D / 16; ++np) {
                uint32_t b[4];
                load_bt(b, vt, DS, 16 * np, 16 * (kb % (C / 16)), lane);
                mma<E>(o[2 * np], a, b[0], b[1]);
                mma<E>(o[2 * np + 1], a, b[2], b[3]);
            }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const float inv = 1.f / l[h];
            const size_t row = base + (size_t)i * C + 16 * w + gq + 8 * h;
#pragma unroll
            for (int nb = 0; nb < D / 8; ++nb)
                *reinterpret_cast<uint32_t*>(out + row * D + 8 * nb + 2 * t) =
                    pack<E>(o[nb][2 * h] * inv, o[nb][2 * h + 1] * inv);
            if (t == 0) lse[row] = mx[h] + logf(l[h]);
        }
    }
}

template <typename E, int C, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* qpos,
                   const int* kpos, void* out, float* lse, int G, int T_, float scale,
                   float self_bias, cudaStream_t stream) {
    const size_t smem = smem_bytes<C, D>();
    auto kern = self_bias != 0.f ? k3_tc<E, C, D, true> : k3_tc<E, C, D, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<dim3((T_ / C + RUN - 1) / RUN, G), 2 * C, smem, stream>>>(
        (const E*)q, (const E*)k, (const E*)v, qpos, kpos, (E*)out, lse, T_, scale, self_bias);
    return cudaGetLastError();
}

}  // namespace tc

// ----------------------------- bf16 / f16 at any other chunk and D 128: the tiled form
// What the per-chunk kernel above does not take -- a chunk other than 32 or
// 64, or D = 128 (its [C, 2C] tiles would not fit in shared memory at C
// 128) -- as flash attention over the windows.  One block per (g, 64 query
// rows), which may span several chunks (C < 64) or part of one (C > 64),
// walks the 64-key tiles of the union of its rows' windows, [(q0 / C - 1) C,
// (q_last / C + 1) C), with an online softmax.  A key outside a row's window
// is no term of its softmax; a key inside it that the query may not see (a
// later position, or chunk 0's zero look-back) scores NEG_INF, as above.  p
// is rounded to v's dtype against the running max before PV, as K1 does.
namespace tiled {

constexpr int B = 64;              // query rows per block, keys per tile
constexpr float kNone = -3e38f;    // running max before any key of the window

// k3_union_tc: S = Q K^T and PV are mma.sync m16n8k16 products
// (mma_bf16.cuh); the window, the masks, self_bias and the online softmax
// stay f32 on the accumulator fragments, with p rounded to E where it enters PV.  Q, K and V
// sit in shared memory as b16 rows of stride D+8, loaded by cp.async with
// zero fill; the next key tile loads while the current one computes.  A
// tile's 64 rows are four 16-row groups; at D <= 64 a group is one warp, at
// D = 128 two (eight warps per block), which split the group's 64 keys for S
// and the D columns of ctx in halves, so that a lane holds 16 f32 of scores
// and 32 of ctx; the pair takes its row max over both halves and its row
// sums through shared memory and multiplies the group's P (b16 rows in
// shared memory) into its columns, behind a named barrier, as K1 does at H
// = 128.  A key outside a row's window scores -inf (no term; the running max
// starts at the finite kNone, so a tile with none of a row's keys rescales
// nothing); the mask and the self bias are K3's.  In a layer with a self
// bias, the score of each row's own key (kpos == qpos, inside its window) is
// recomputed as the sequential f32 FMA chain (self_score), so that a row
// that sees only its own key keeps lse = fl(s + self_bias) exactly.  Shared
// memory at D = 128: 97 KB (two blocks per SM); at D = 64, 47 KB.
template <int D>
struct Split {
    static constexpr int SP = D > 64 ? 2 : 1;   // warps per 16-row group
    static constexpr int NW = (B / 16) * SP;
    static constexpr int NT = 32 * NW;
    static constexpr int KW = B / SP;           // keys of a warp's S
    static constexpr int DW = D / SP;           // ctx columns of a warp
    static constexpr int DS = D + 8, PS2 = B + 8;
};

template <int D>
constexpr size_t tc_smem_bytes() {
    // Q [B][DS]; 2 stages of K, V [B][DS]; at SP 2 the groups' P [B][PS2],
    // all b16; qpos [B], 2 stages of kpos [B] int; at SP 2 each warp's row
    // max / sum [16] f32
    using SPL = Split<D>;
    return 2 * (size_t)(5 * B * SPL::DS + (SPL::SP > 1 ? B * SPL::PS2 : 0)) + 4 * (3 * B) +
           (SPL::SP > 1 ? 4 * (size_t)SPL::NW * 16 : 0);
}

// BIAS: the layer has a self bias (self_bias != 0: the LSH layers)
template <typename E, int D, bool BIAS>
__global__ void __launch_bounds__(Split<D>::NT, Split<D>::SP == 1 ? 3 : 2)
k3_union_tc(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
            const int* __restrict__ qpos, const int* __restrict__ kpos, E* __restrict__ out,
            float* __restrict__ lse, int T_, int C, float scale, float self_bias) {
    using namespace mma_bf16;
    using SPL = Split<D>;
    constexpr int DS = SPL::DS, PS2 = SPL::PS2, KW = SPL::KW, DW = SPL::DW, SP = SPL::SP;
    constexpr int NT = SPL::NT, STAGE = 2 * B * DS;      // K, V
    constexpr float kLog2e = 1.4426950408889634f;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    E* sQ = reinterpret_cast<E*>(smem_raw);
    E* sKV = sQ + B * DS;                           // stage b: K, V
    E* sP = sKV + 2 * STAGE;                        // [B][PS2] (SP 2)
    int* sQp = reinterpret_cast<int*>(sP + (SP > 1 ? B * PS2 : 0));
    int* sKp = sQp + B;                             // stage b: [B]
    float* sRows = reinterpret_cast<float*>(sKp + 2 * B);   // [NW][16] (SP 2)

    const int g = blockIdx.y;
    const int q0 = blockIdx.x * B;
    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
    const int p = w / SP, c = w % SP;               // 16-row group, warp in the group
    const int gq = lane >> 2, t = lane & 3;
    const size_t base = (size_t)g * T_;
    const E* k_g = k + base * D;
    const E* v_g = v + base * D;
    float* sRow = sRows + w * 16;
    const float* mate = sRows + (w ^ (SP - 1)) * 16;

    const int q_last = min(q0 + B, T_) - 1;
    const int w_lo = (q0 / C - 1) * C, w_hi = (q_last / C + 1) * C;
    // K, V and the key positions of the tile at k0 into stage b (a key
    // outside [0, T): zeros at INT_MAX, never visible)
    auto load_k = [&](int k0, int b) {
        E* st = sKV + b * STAGE;
        stage_rows<D>(st, k_g, k0, B, T_, tid, NT);
        stage_rows<D>(st + B * DS, v_g, k0, B, T_, tid, NT);
        cp_commit();
        if (tid < B) {
            const int wk = k0 + tid;
            sKp[b * B + tid] = (wk >= 0 && wk < T_) ? kpos[base + wk] : INT_MAX;
        }
    };
    stage_rows<D>(sQ, q + base * D, q0, B, T_, tid, NT);
    if (tid < B) sQp[tid] = q0 + tid < T_ ? qpos[base + q0 + tid] : INT_MIN;
    load_k(w_lo, 0);

    // rows 16p + gq (+8): first window key, positions (read once staged),
    // running max / sums
    int lo[2], qp[2] = {INT_MIN, INT_MIN};
#pragma unroll
    for (int h = 0; h < 2; ++h) lo[h] = ((q0 + 16 * p + gq + 8 * h) / C - 1) * C;
    float m[2] = {kNone, kNone}, l[2] = {0.f, 0.f};
    float o[DW / 8][4] = {};                        // ctx columns DW c + 8n + 2t
    for (int k0 = w_lo, it = 0; k0 < w_hi; k0 += B, ++it) {
        const int b = it & 1;
        cp_wait<0>();
        __syncthreads();                // tile it landed; every warp is done with tile it - 1
        if (k0 + B < w_hi) load_k(k0 + B, b ^ 1);
        if (it == 0) {
            qp[0] = sQp[16 * p + gq];
            qp[1] = sQp[16 * p + gq + 8];
        }
        const E* tK = sKV + b * STAGE;
        const E* tV = tK + B * DS;
        const int* kp_t = sKp + b * B;

        // S = Q . K^T over the warp's keys: key columns KW c + 8j .. +7
        float s[KW / 8][4] = {};
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t a[4];
            load_a(a, sQ, DS, 16 * p, 16 * kk, lane);
#pragma unroll
            for (int np = 0; np < KW / 16; ++np) {
                uint32_t bk[4];
                load_b(bk, tK, DS, KW * c + 16 * np, 16 * kk, lane);
                mma<E>(s[2 * np], a, bk[0], bk[1]);
                mma<E>(s[2 * np + 1], a, bk[2], bk[3]);
            }
        }
        // the window, the masks and the self bias; own[h]: this lane's column
        // holding row h's own key, if any
        int own[2] = {-1, -1};
#pragma unroll
        for (int j = 0; j < KW / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int h = e >> 1, kj = KW * c + 8 * j + 2 * t + (e & 1), wk = k0 + kj;
                const int kpv = kp_t[kj];
                float x = s[j][e] * scale;
                if (BIAS && kpv == qp[h]) {
                    x += self_bias;
                    own[h] = kj;
                }
                if (kpv > qp[h]) x = kNegInf;
                if (wk < lo[h] || wk >= lo[h] + 2 * C) {
                    x = -INFINITY;
                    if (BIAS && own[h] == kj) own[h] = -1;
                }
                s[j][e] = x;
            }
        if (BIAS && __any_sync(0xffffffffu, own[0] >= 0 || own[1] >= 0)) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                if (own[h] < 0) continue;
                const float x = tc::self_score<E, D>(sQ + (16 * p + gq + 8 * h) * DS,
                                                     tK + own[h] * DS, scale, self_bias);
#pragma unroll
                for (int j = 0; j < KW / 8; ++j)
#pragma unroll
                    for (int e = 2 * h; e < 2 * h + 2; ++e)
                        if (KW * c + 8 * j + 2 * t + (e & 1) == own[h]) s[j][e] = x;
            }
        }
        // the online softmax on the fragments
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < KW / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        }
        if constexpr (SP > 1) {         // the max over both key halves
            if (t == 0) {
                sRow[gq] = mx[0];
                sRow[gq + 8] = mx[1];
            }
            group_sync<SP>(p);
            mx[0] = fmaxf(mx[0], mate[gq]);
            mx[1] = fmaxf(mx[1], mate[gq + 8]);
        }
        float alpha[2];
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
                const float pr = exp2f((s[j][e] - mx[e >> 1]) * kLog2e);
                l[e >> 1] += pr;
                s[j][e] = pr;           // rounded to E where it enters PV
            }
#pragma unroll
        for (int n = 0; n < DW / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];

        // o += P . V[:, DW c, + DW) over the tile's 64 keys
        if constexpr (SP == 1) {        // P from the accumulators
#pragma unroll
            for (int kb = 0; kb < B / 16; ++kb) {
                uint32_t a[4];
                c_to_a<E>(a, s[2 * kb], s[2 * kb + 1]);
#pragma unroll
                for (int np = 0; np < D / 16; ++np) {
                    uint32_t bv[4];
                    load_bt(bv, tV, DS, 16 * np, 16 * kb, lane);
                    mma<E>(o[2 * np], a, bv[0], bv[1]);
                    mma<E>(o[2 * np + 1], a, bv[2], bv[3]);
                }
            }
        } else {                        // the group's P rows through shared memory
#pragma unroll
            for (int j = 0; j < KW / 8; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    *reinterpret_cast<uint32_t*>(sP + (16 * p + gq + 8 * h) * PS2 + KW * c +
                                                 8 * j + 2 * t) =
                        pack<E>(s[j][2 * h], s[j][2 * h + 1]);
            group_sync<SP>(p);
#pragma unroll
            for (int kb = 0; kb < B / 16; ++kb) {
                uint32_t a[4];
                load_a(a, sP, PS2, 16 * p, 16 * kb, lane);
#pragma unroll
                for (int np = 0; np < DW / 16; ++np) {
                    uint32_t bv[4];
                    load_bt(bv, tV, DS, DW * c + 16 * np, 16 * kb, lane);
                    mma<E>(o[2 * np], a, bv[0], bv[1]);
                    mma<E>(o[2 * np + 1], a, bv[2], bv[3]);
                }
            }
        }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
    if constexpr (SP > 1) {             // the sum over both key halves
        if (t == 0) {                   // the mate has read the last max (it passed P's barrier)
            sRow[gq] = l[0];
            sRow[gq + 8] = l[1];
        }
        group_sync<SP>(p);
        l[0] += mate[gq];
        l[1] += mate[gq + 8];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = q0 + 16 * p + gq + 8 * h;
        if (r >= T_) continue;
        const float lc = fmaxf(l[h], 1e-30f), inv = 1.f / lc;
        E* o_r = out + (base + r) * D + DW * c;
#pragma unroll
        for (int n = 0; n < DW / 8; ++n)
            *reinterpret_cast<uint32_t*>(o_r + 8 * n + 2 * t) =
                pack<E>(o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
        if (c == 0 && t == 0) lse[base + r] = m[h] + logf(lc);
    }
}

template <typename E, int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const int* qpos,
                      const int* kpos, void* out, float* lse, int G, int T_, int C,
                      float scale, float self_bias, cudaStream_t stream) {
    const size_t smem = tc_smem_bytes<D>();
    auto kern = self_bias != 0.f ? k3_union_tc<E, D, true> : k3_union_tc<E, D, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<dim3((T_ + B - 1) / B, G), Split<D>::NT, smem, stream>>>(
        (const E*)q, (const E*)k, (const E*)v, qpos, kpos, (E*)out, lse, T_, C, scale,
        self_bias);
    return cudaGetLastError();
}

}  // namespace tiled

// ------------------------------- every f32 call, and 16 bits above D 128: k3_slab
// k3_union_tc's walk over the 64-key tiles of the union of a 64-row
// block's windows, over slabs of the head dim: H = W ns, the slab width W =
// min(H, 64).  A block per (g, 64 rows, group of up to ZS output slabs).
// Eight warps, two per 16-row group: warp c of group p sums S = Q . K^T for
// its 16 rows over keys [32c, 32c + 32) and owns columns [OW c, OW c + OW)
// of each of the block's output slabs (OW = W / 2).  Per tile pair the head
// dim streams through a ring of two cp.async stages of three 64-row tiles
// (Q, K, V; slab i + 1 loads while slab i's products run): each slab's S is
// summed apart (a zeroed fragment per slab, its k-blocks added in f32) and
// added to the pair's sums, slab 0 first, so the scores are computed once
// per tile pair; then the window, the masks, the self bias and the online
// softmax (k3_union_tc's; the max of both key halves through shared
// memory), the ctx sums of every output slab rescaled, and the group's P
// rows (rounded to E; f32 as they are) into shared memory.  The last score
// slab's stage also holds V's slab of the block's last output slab, which
// the group applies in place; the other output slabs follow as items of
// their own: ctx[:, slab z] += P . V_slab, the warp's columns, the tile
// pair's products summed apart, then added.  The sums of up to ZS output
// slabs stay in registers (16 f32 per slab and lane): `with_cfg` keeps
// every slab in one block up to H 256 (ZS 4) and 512 (ZS 8); above, grid z
// splits the output slabs, each block recomputing the scores.  At one slab
// (f32 up to D 64) Q is staged once, in stage 0, and a tile pair is one
// item.  The LSH own key is the key of a row's own index (kpos == qpos
// there): in a tile pair that holds own keys, lane l of each warp continues
// the sequential f32 FMA chain of row 16p + l % 16 against it one k-block
// at a time inside the product loop, from the staged tiles, in d order
// (slab_product's CHAIN), and the row takes fl(fl(chain scale) +
// self_bias) by a shuffle, so that a row that sees only its own key keeps
// lse = fl(s + self_bias) exactly, as the reference's f32 product gives it.
// The products are slab_mma.cuh's: bf16 / f16 mma.sync, f32 3xTF32.  What
// bounds it: at the 22-04 shapes the bytes (each q, k, v row read about
// twice: the look-back), in f32 the products and the operand splits.
// Shared memory at W 64: 120 KB (f32) / 64 KB (16 bits); one block of
// eight warps per SM.
namespace slabs {

using namespace slab;
using tiled::B;
using tiled::kNone;

constexpr int SP = 2;                   // warps per 16-row group
constexpr int NT = 32 * SP * (B / 16);  // eight warps
constexpr int NW = NT / 32;
constexpr int KW = B / SP;              // keys of a warp's S
constexpr float kLog2e = 1.4426950408889634f;

template <typename E, int W>
struct Lay {
    static constexpr int RS = W + PAD<E>, PS = B + PAD<E>;
    static constexpr int TILE = B * RS;                      // one staged [64][W] tile
    static constexpr int OW = W / SP < 16 ? 16 : W / SP;     // a warp's columns of an output slab
    static constexpr int QQ = 0, KK = 1, VV = 2, NTILE = 3;  // a ring stage: Q, K, V
    static constexpr size_t RING = (size_t)2 * NTILE * TILE * sizeof(E);
    // the ring; P [B][PS]; each warp's row max / sum [16] f32
    static constexpr size_t bytes() {
        return RING + (size_t)B * PS * sizeof(E) + (size_t)NW * 16 * 4;
    }
};

// a slab instance: width W, output slabs a block holds ZS
template <int W_, int ZS_>
struct Cfg {
    static constexpr int W = W_, ZS = ZS_;
};

// f(Cfg) for the instance a call at head dim D runs: f32 in slabs of
// min(D, 64), 16 bits (D above 128) of 64; every output slab in one block
// up to 256 columns, then up to 512
template <typename E, typename F>
cudaError_t with_cfg(int D, F&& f) {
    if constexpr (kF32<E>) {
        switch (D) {
            case 16: return f(Cfg<16, 1>{});
            case 32: return f(Cfg<32, 1>{});
            case 64: return f(Cfg<64, 1>{});
            case 128: return f(Cfg<64, 2>{});
        }
    }
    if (D <= 128 || D % 128) return cudaErrorInvalidValue;
    return D <= 256 ? f(Cfg<64, 4>{}) : f(Cfg<64, 8>{});
}

template <typename E, int W, int ZS>
__global__ void __launch_bounds__(NT, 1)
k3_slab(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
        const int* __restrict__ qpos, const int* __restrict__ kpos, E* __restrict__ out,
        float* __restrict__ lse, int T_, int C, float scale, float self_bias, int ns) {
    using L = Lay<E, W>;
    constexpr int RS = L::RS, PS = L::PS, TILE = L::TILE, OW = L::OW, K8 = KS<E>;
    // k-blocks of a product unrolled at a time: all of a slab's where the
    // registers allow without a spill (ptxas: ZS 8 spilled at 2)
    constexpr int UNR = ZS > 4 ? 1 : W / K8;
    const int H = W * ns;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    E* ring = reinterpret_cast<E*>(smem_raw);    // stage b: Q, K, V at ring + (3 b + i) TILE
    E* sP = ring + 2 * L::NTILE * TILE;          // [B][PS]
    float* sRows = reinterpret_cast<float*>(sP + B * PS);   // [NW][16]

    const int g = blockIdx.y, z0 = blockIdx.z * ZS, nz = min(ZS, ns - z0);
    const int q0 = blockIdx.x * B;
    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
    const int p = w / SP, c = w % SP, gq = lane >> 2, t = lane & 3;
    const bool bias = self_bias != 0.f, once = ns == 1;
    float* sRow = sRows + w * 16;
    const float* mate = sRows + (w ^ 1) * 16;
    const size_t base = (size_t)g * T_;
    const E *q_g = q + base * H, *k_g = k + base * H, *v_g = v + base * H;

    // the union of the windows of rows [q0, q_last], from the first
    // window's look-back (chunk 0's: zeros at INT_MAX, masked but terms of
    // a fully masked row's uniform average)
    const int q_last = min(q0 + B, T_) - 1;
    const int w_lo = (q0 / C - 1) * C, w_hi = (q_last / C + 1) * C;
    const int n_kt = (w_hi - w_lo + B - 1) / B;
    // the items of a key tile: its ns score slabs (the last also staging V's
    // slab of the block's last output slab), then the block's other output slabs
    const int per = ns + nz - 1, n_items = n_kt * per;
    auto issue = [&](int n) {                    // item n's tiles into stage n % 2
        const int m = n % per, k0 = w_lo + n / per * B;
        E* st = ring + (n & 1) * L::NTILE * TILE;
        if (m < ns) {
            if (!once) stage<W>(st + L::QQ * TILE, q_g, q0, B, T_, H, W * m, tid, NT);
            stage<W>(st + L::KK * TILE, k_g, k0, B, T_, H, W * m, tid, NT);
            if (m == ns - 1)
                stage<W>(st + L::VV * TILE, v_g, k0, B, T_, H, W * (z0 + nz - 1), tid, NT);
        } else {
            stage<W>(st + L::VV * TILE, v_g, k0, B, T_, H, W * (z0 + m - ns), tid, NT);
        }
        mma_bf16::cp_commit();
    };
    if (once)                                    // Q: stage 0's first tile, for good
        stage<W>(ring + L::QQ * TILE, q_g, q0, B, T_, H, 0, tid, NT);
    issue(0);

    // rows 16p + gq (+8): position (INT_MIN past T), first window key
    int qp[2], lo[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = q0 + 16 * p + gq + 8 * h;
        qp[h] = r < T_ ? __ldg(qpos + base + r) : INT_MIN;
        lo[h] = (r / C - 1) * C;
    }
    float m_r[2] = {kNone, kNone}, l_r[2] = {0.f, 0.f};
    // ctx rows 16p + gq (+8), columns W (z0 + zz) + OW c + 8n + 2t
    float o[ZS][OW / 8][4] = {};
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
                for (int kb = 0; kb < B / K8; ++kb) {
                    FragA<E> a;
                    load_a(a, sP, PS, 16 * p, K8 * kb, lane);
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
    int kp[KW / 8][2];
    float own = 0.f;                     // lane l: the own score's chain of row 16p + l % 16
    const int ol = 16 * p + (lane & 15), ro = q0 + ol;
    for (int n = 0; n < n_items; ++n) {
        const int m = n % per, k0 = w_lo + n / per * B;
        mma_bf16::cp_wait<0>();
        __syncthreads();                         // item n landed; item n - 1 is done
        if (n + 1 < n_items) issue(n + 1);
        const E* st = ring + (n & 1) * L::NTILE * TILE;
        if (m >= ns) {
            apply(m - ns, st + L::VV * TILE);
            continue;
        }
        const E* tQ = (once ? ring : st) + L::QQ * TILE;
        const E* tK = st + L::KK * TILE;
        if (m == ns - 1) load_keys(kp, kpos, base, k0 + KW * c + 2 * t, T_);
        if (m == 0) own = 0.f;
        // S over the warp's keys, the slab's sum apart, then added; a pair
        // that holds own keys: lane l also chains row 16p + l % 16 against
        // its own key (clamped into the key tile)
        float sm[KW / 8][4] = {};
        if (bias && k0 < q0 + B && q0 < k0 + B)
            slab_product<E, W, CH, true, UNR>(sm, tQ, 16 * p, tK, KW * c, RS, lane, &own,
                                                 tQ + ol * RS,
                                                 tK + min(max(ro - k0, 0), B - 1) * RS);
        else
            slab_product<E, W, CH, false, UNR>(sm, tQ, 16 * p, tK, KW * c, RS, lane);
#pragma unroll
        for (int j = 0; j < KW / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = m ? s[j][e] + sm[j][e] : sm[j][e];
        if (m < ns - 1) continue;

        // the window, the masks and the self bias (k3_union_tc's), the own
        // key's chained score, which lane gq + 8h holds for row gq + 8h
        float own_h[2], mx[2] = {m_r[0], m_r[1]};
        const float own_v = __fadd_rn(__fmul_rn(own, scale), self_bias);
#pragma unroll
        for (int h = 0; h < 2; ++h) own_h[h] = __shfl_sync(0xffffffffu, own_v, gq + 8 * h);
#pragma unroll
        for (int j = 0; j < KW / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int h = e >> 1, r = q0 + 16 * p + gq + 8 * h;
                const int wk = k0 + KW * c + 8 * j + 2 * t + (e & 1), kpe = kp[j][e & 1];
                float x = s[j][e] * scale;
                x = bias && kpe == qp[h] ? x + self_bias : x;
                x = kpe > qp[h] ? kNegInf : x;
                x = bias && wk == r && kpe == qp[h] ? own_h[h] : x;
                x = wk < lo[h] || wk >= lo[h] + 2 * C ? -INFINITY : x;
                s[j][e] = x;
                mx[h] = fmaxf(mx[h], x);
            }
        // the online softmax on the fragments: the max over both key halves
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        }
        if (t == 0) {
            sRow[gq] = mx[0];
            sRow[gq + 8] = mx[1];
        }
        mma_bf16::group_sync<SP>(p);
        float alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            mx[h] = fmaxf(mx[h], mate[gq + 8 * h]);
            alpha[h] = exp2f((m_r[h] - mx[h]) * kLog2e);
            m_r[h] = mx[h];
            l_r[h] *= alpha[h];
        }
#pragma unroll
        for (int j = 0; j < KW / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float pr = exp2f((s[j][e] - mx[e >> 1]) * kLog2e);
                l_r[e >> 1] += pr;
                s[j][e] = pr;            // rounded to E where it enters PV (16 bits)
            }
#pragma unroll
        for (int zz = 0; zz < ZS; ++zz)
#pragma unroll
            for (int nn = 0; nn < OW / 8; ++nn)
#pragma unroll
                for (int e = 0; e < 4; ++e) o[zz][nn][e] *= alpha[e >> 1];
        put_frags<E, false>(sP, s, PS, 16 * p, KW * c, lane);
        mma_bf16::group_sync<SP>(p);             // the group's P rows are written
        apply(nz - 1, st + L::VV * TILE);
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
        sRow[gq] = l_row[0];                     // read the last max before P's barrier)
        sRow[gq + 8] = l_row[1];
    }
    mma_bf16::group_sync<SP>(p);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = q0 + 16 * p + gq + 8 * h;
        if (r >= T_) continue;
        const float lc = fmaxf(l_row[h] + mate[gq + 8 * h], 1e-30f), inv = 1.f / lc;
#pragma unroll
        for (int zz = 0; zz < ZS; ++zz) {
            if (zz >= nz || OW * c >= W) continue;
            E* o_r = out + (base + r) * H + W * (z0 + zz) + OW * c;
#pragma unroll
            for (int nn = 0; nn < OW / 8; ++nn)
                put2<E>(o_r + 8 * nn + 2 * t, o[zz][nn][2 * h] * inv, o[zz][nn][2 * h + 1] * inv);
        }
        if (z0 == 0 && c == 0 && t == 0) lse[base + r] = m_r[h] + logf(lc);
    }
}

template <typename E, int W, int ZS>
cudaError_t launch(const void* q, const void* k, const void* v, const int* qpos,
                   const int* kpos, void* out, float* lse, int G, int T_, int C, int ns,
                   float scale, float self_bias, cudaStream_t stream) {
    const size_t smem = Lay<E, W>::bytes();
    auto kern = k3_slab<E, W, ZS>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<dim3((T_ + B - 1) / B, G, (ns + ZS - 1) / ZS), NT, smem, stream>>>(
        (const E*)q, (const E*)k, (const E*)v, qpos, kpos, (E*)out, lse, T_, C, scale,
        self_bias, ns);
    return cudaGetLastError();
}

}  // namespace slabs

template <typename E, int C>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, const int* qpos,
                     const int* kpos, void* out, float* lse, int G, int T_, float scale,
                     float self_bias, cudaStream_t st) {
    switch (D) {
        case 16: return tc::launch<E, C, 16>(q, k, v, qpos, kpos, out, lse, G, T_, scale,
                                             self_bias, st);
        case 32: return tc::launch<E, C, 32>(q, k, v, qpos, kpos, out, lse, G, T_, scale,
                                             self_bias, st);
        case 64: return tc::launch<E, C, 64>(q, k, v, qpos, kpos, out, lse, G, T_, scale,
                                             self_bias, st);
        default: return cudaErrorInvalidValue;
    }
}

template <typename E>
cudaError_t launch_tiled_d(int D, const void* q, const void* k, const void* v,
                           const int* qpos, const int* kpos, void* out, float* lse, int G,
                           int T_, int C, float scale, float self_bias, cudaStream_t st) {
    switch (D) {
        case 16: return tiled::launch_tc<E, 16>(q, k, v, qpos, kpos, out, lse, G, T_, C, scale,
                                                self_bias, st);
        case 32: return tiled::launch_tc<E, 32>(q, k, v, qpos, kpos, out, lse, G, T_, C, scale,
                                                self_bias, st);
        case 64: return tiled::launch_tc<E, 64>(q, k, v, qpos, kpos, out, lse, G, T_, C, scale,
                                                self_bias, st);
        case 128: return tiled::launch_tc<E, 128>(q, k, v, qpos, kpos, out, lse, G, T_, C,
                                                  scale, self_bias, st);
        default: return cudaErrorInvalidValue;
    }
}

// the head dims a call takes: 16, 32, 64 and 128, and every multiple of 128
constexpr bool takes(int D) { return D == 16 || D == 32 || D == 64 || (D > 0 && D % 128 == 0); }

template <typename E>
cudaError_t route(int C, int D, const void* q, const void* k, const void* v, const int* qpos,
                  const int* kpos, void* out, float* lse, int G, int T_, float scale,
                  float self_bias, cudaStream_t st) {
    // f32 and D above 128: the slab walk; 16 bits up to D 128: chunks 32 /
    // 64 at D <= 64 on the per-chunk kernel, the rest on the tiled walk
    if (!takes(D)) return cudaErrorInvalidValue;
    if constexpr (sizeof(E) == 2) {
        if (D <= 128) {
            if (C == 32 && D <= 64)
                return launch_d<E, 32>(D, q, k, v, qpos, kpos, out, lse, G, T_, scale,
                                       self_bias, st);
            if (C == 64 && D <= 64)
                return launch_d<E, 64>(D, q, k, v, qpos, kpos, out, lse, G, T_, scale,
                                       self_bias, st);
            return launch_tiled_d<E>(D, q, k, v, qpos, kpos, out, lse, G, T_, C, scale,
                                     self_bias, st);
        }
    }
    return slabs::with_cfg<E>(D, [&](auto cfg) {
        using F = decltype(cfg);
        return slabs::launch<E, F::W, F::ZS>(q, k, v, qpos, kpos, out, lse, G, T_, C, D / F::W,
                                             scale, self_bias, st);
    });
}

// the resources of the tensor-core kernel of a 16-bit call up to D 128 (its
// self-bias instance): k3_tc at chunks 32 / 64 and D <= 64, else k3_union_tc
template <typename E, int D>
cudaError_t resources_d(int C, int* out) {
    if constexpr (D <= 64) {
        if (C == 32)
            return resources(tc::k3_tc<E, 32, D, true>, tc::smem_bytes<32, D>(), 64, out);
        if (C == 64)
            return resources(tc::k3_tc<E, 64, D, true>, tc::smem_bytes<64, D>(), 128, out);
    }
    return resources(tiled::k3_union_tc<E, D, true>, tiled::tc_smem_bytes<D>(),
                     tiled::Split<D>::NT, out);
}

template <typename E>
cudaError_t resources_c(int C, int D, int* out) {
    if (!takes(D)) return cudaErrorInvalidValue;
    if constexpr (sizeof(E) == 2) {
        switch (D) {
            case 16: return resources_d<E, 16>(C, out);
            case 32: return resources_d<E, 32>(C, out);
            case 64: return resources_d<E, 64>(C, out);
            case 128: return resources_d<E, 128>(C, out);
        }
    }
    return slabs::with_cfg<E>(D, [&](auto cfg) {
        using F = decltype(cfg);
        return resources(slabs::k3_slab<E, F::W, F::ZS>, slabs::Lay<E, F::W>::bytes(),
                         slabs::NT, out);
    });
}

}  // namespace

// q/k/v [G, T, D] (dtype 0 = f32, 1 = bf16, 2 = f16), qpos/kpos int32 [G, T];
// out [G, T, D] in that dtype, lse [G, T] f32.  T % chunk == 0; D 16, 32, 64,
// 128 or a multiple of 128.  bf16 and f16 up to D 128 run k3_tc (chunks 32
// and 64 at D <= 64) or the tiled walk k3_union_tc; f32 at every D and
// every dtype above D 128 run k3_slab (f32 in 3xTF32).  Launches on
// `stream`; returns cudaGetLastError() of the launch.
extern "C" int chunked_window_attn_fwd(const void* q, const void* k, const void* v,
                                       const void* qpos, const void* kpos, void* out,
                                       void* lse, int G, int T, int D, int chunk, int dtype,
                                       float scale, float self_bias, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int* qp = (const int*)qpos;
    const int* kp = (const int*)kpos;
    float* l = (float*)lse;
    if (chunk <= 0 || T % chunk) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
        return (int)route<float>(chunk, D, q, k, v, qp, kp, out, l, G, T, scale, self_bias, st);
    if (dtype == 1)
        return (int)route<__nv_bfloat16>(chunk, D, q, k, v, qp, kp, out, l, G, T, scale,
                                         self_bias, st);
    if (dtype == 2)
        return (int)route<__half>(chunk, D, q, k, v, qp, kp, out, l, G, T, scale, self_bias,
                                  st);
    return (int)cudaErrorInvalidValue;
}

// The resources of the kernel a call of this dtype (0 = f32, 1 = bf16, 2 =
// f16) at this chunk and D runs, as the loaded library reports them:
// out[0..4] = registers, local (spill) bytes, dynamic shared bytes, resident
// blocks per SM and threads per block of k3_tc, k3_union_tc (their
// self-bias instances) or k3_slab.  Returns a cudaError_t
// (cudaErrorInvalidValue for a D it does not take).
extern "C" int chunked_window_attn_fwd_resources(int chunk, int D, int dtype, int* out) {
    if (chunk <= 0) return (int)cudaErrorInvalidValue;
    if (dtype == 0) return (int)resources_c<float>(chunk, D, out);
    if (dtype == 1) return (int)resources_c<__nv_bfloat16>(chunk, D, out);
    if (dtype == 2) return (int)resources_c<__half>(chunk, D, out);
    return (int)cudaErrorInvalidValue;
}
