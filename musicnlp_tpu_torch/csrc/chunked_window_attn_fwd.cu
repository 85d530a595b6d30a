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
// f32 (chunked_window_attn_fwd_kernel): one 256-thread block per (g, chunk)
// stages the query chunk and the 2C-key window as f32 rows of stride D+1,
// computes the [C, 2C] scores with f32 FMAs, takes the row softmax with
// 16-lane shuffles and runs PV from shared memory; every chunk's K and V is
// read by two blocks.  Kept as it is: the f32 parity checks rest on it.
//
// bf16 (k3_tc), the training and scoring path: K4's run layout
// (chunked_window_attn_bwd.cu).  One block of C / 16 warps per (g, run of
// RUN = 16 consecutive chunks) walks its run in order and keeps the previous
// chunk's K / V / kpos resident, so each chunk is loaded once per run, by
// cp.async, while the chunk before it computes; only a run's first chunk
// loads its look-back (chunk 0's is zeros with kpos INT_MAX: never
// visible).  Warp w owns query rows 16w..16w+15.  S = Q . [K_{i-1}; K_i]^T
// is 2C / 8 n-blocks of mma.sync m16n8k16 (bf16 in, f32 accumulate;
// mma_bf16.cuh) in registers: the whole 2C-wide row fits, so no online
// softmax.  The element chain runs on the accumulator fragments and is kept
// lean: the positions are staged once per chunk (kpos read as int2 pairs,
// qpos in registers), scale and self_bias are hoisted, the layers without a
// self bias run an instance without its compare, row max and sum are quad
// shuffles, p = exp2f((x - max) * log2(e)) with x and max in natural units
// (so the masks, the max and lse are the f32 values of the reference), and
// each output row takes one reciprocal.  P becomes bf16 A fragments by RNE
// (c_to_a) for PV against V read by ldmatrix.trans.  One exception keeps
// lse exact: a row that sees only its own key (the LSH layers' self bias,
// -1e5, makes it the max) has lse = fl(s + self_bias), whose f32 steps are
// 2^-7; a tensor-core sum of s, in another order than the f32 product of
// the reference, can round it to a neighbouring step, so that one score is
// recomputed as the sequential f32 FMA chain over d, the reference's order
// (only warps that hold such a row take that branch).  Shared memory at
// C = D = 64: K, V x 3 slots 54 KB, Q x 2 slots 18 KB, positions 1.3 KB --
// 74 KB per block.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "elem.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int NT = 256;          // threads: a 16 x 16 grid
constexpr float kNegInf = -1e9f;

using namespace elem;

template <int C, int D>
struct Fwd {
    static constexpr int W = 2 * C;                       // window keys
    static constexpr int DP = D + 1;                      // padded row
    static constexpr int PS = W + 1;                      // P row stride
    static constexpr int KBUF = (W * DP > C * PS) ? W * DP : C * PS;   // K, then P
    static constexpr size_t smem_bytes() {
        return (size_t)(C * DP + KBUF + W * DP) * sizeof(float) + (size_t)(C + W) * sizeof(int);
    }
};

template <typename T, int C, int D>
__global__ void __launch_bounds__(NT, 2)
chunked_window_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const int* __restrict__ qpos,
                               const int* __restrict__ kpos, T* __restrict__ out,
                               float* __restrict__ lse, int T_, float scale, float self_bias) {
    using F = Fwd<C, D>;
    constexpr int W = F::W, DP = F::DP, PS = F::PS;
    constexpr int RQ = C / 16;          // query rows per thread
    constexpr int CK = W / 16;          // window columns per thread
    constexpr int CD = D / 16;          // context columns per thread
    extern __shared__ float smem[];
    float* sQ = smem;                   // [C][DP]
    float* sK = sQ + C * DP;            // [W][DP], then P [C][PS]
    float* sV = sK + F::KBUF;           // [W][DP]
    int* sQp = (int*)(sV + W * DP);     // [C]
    int* sKp = sQp + C;                 // [W]
    float* sP = sK;

    const int g = blockIdx.y;
    const int r0 = blockIdx.x * C;      // first query row of the chunk
    const int w0 = r0 - C;              // first row of the window (the look-back)
    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const size_t base = (size_t)g * T_;

    for (int e = tid; e < C * D; e += NT) {
        const int r = e / D, c = e % D;
        sQ[r * DP + c] = to_f(q[(base + r0 + r) * D + c]);
    }
    for (int e = tid; e < W * D; e += NT) {
        const int r = e / D, c = e % D, row = w0 + r;
        const bool ok = row >= 0;
        sK[r * DP + c] = ok ? to_f(k[(base + row) * D + c]) : 0.f;
        sV[r * DP + c] = ok ? to_f(v[(base + row) * D + c]) : 0.f;
    }
    for (int e = tid; e < C; e += NT) sQp[e] = qpos[base + r0 + e];
    for (int e = tid; e < W; e += NT) {
        const int row = w0 + e;
        sKp[e] = row >= 0 ? kpos[base + row] : INT_MAX;  // no look-back: never visible
    }
    __syncthreads();

    // scores: query row ty + 16 i, window column tx + 16 j
    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int h = 0; h < D; ++h) {
        float a[RQ], b[CK];
#pragma unroll
        for (int i = 0; i < RQ; ++i) a[i] = sQ[(ty + 16 * i) * DP + h];
#pragma unroll
        for (int j = 0; j < CK; ++j) b[j] = sK[(tx + 16 * j) * DP + h];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
            for (int j = 0; j < CK; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
    __syncthreads();                     // every K read done: P may overwrite it

    float l_i[RQ], lse_i[RQ];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
        const int qr = ty + 16 * i;
        const int qp = sQp[qr];
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < CK; ++j) {
            const int kp = sKp[tx + 16 * j];
            float x = s[i][j] * scale;
            if (kp <= qp) {
                if (kp == qp) x += self_bias;
            } else {
                x = kNegInf;
            }
            s[i][j] = x;
            mx = fmaxf(mx, x);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < CK; ++j) {
            const float p = expf(s[i][j] - mx);
            sum += p;
            sP[qr * PS + tx + 16 * j] = round_to<T>(p);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
        l_i[i] = fmaxf(sum, 1e-30f);
        lse_i[i] = mx + logf(l_i[i]);
    }
    __syncthreads();

    float acc[RQ][CD];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
#pragma unroll 4
    for (int w = 0; w < W; ++w) {
        float vw[CD];
#pragma unroll
        for (int c = 0; c < CD; ++c) vw[c] = sV[w * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
            const float p = sP[(ty + 16 * i) * PS + w];
#pragma unroll
            for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(p, vw[c], acc[i][c]);
        }
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
        const size_t row = base + r0 + ty + 16 * i;
#pragma unroll
        for (int c = 0; c < CD; ++c) out[row * D + tx + 16 * c] = from_f<T>(acc[i][c] / l_i[i]);
        if (tx == 0) lse[row] = lse_i[i];
    }
}

// ------------------------------------------------- bf16 on the tensor cores
namespace tc {

using bf16 = __nv_bfloat16;
using namespace mma_bf16;

constexpr int RUN = 16;                 // consecutive chunks per block
constexpr float kLog2e = 1.4426950408889634f;

template <int C, int D>
constexpr size_t smem_bytes() {
    // K, V [3 slots][C][D+8] and Q [2 slots][C][D+8] bf16; kpos [3][C] and
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
template <int C, int D, bool BIAS>
__device__ __forceinline__ void window_softmax(float (&s)[C / 4][4], float (&mx)[2],
                                               float (&l)[2], const int* const (&kp)[2],
                                               const int (&qp)[2], const bf16* qrow,
                                               const bf16* const (&kw)[2], int gq, int t,
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
                const uint4* qr = reinterpret_cast<const uint4*>(qrow + (gq + 8 * h) * DS);
                const uint4* kr =
                    reinterpret_cast<const uint4*>((c < C ? kw[0] : kw[1]) + (c % C) * DS);
                uint4 qv[D / 8], kv[D / 8];          // every load issued before the chain
#pragma unroll
                for (int d = 0; d < D / 8; ++d) {
                    qv[d] = qr[d];
                    kv[d] = kr[d];
                }
                float acc = 0.f;
#pragma unroll
                for (int d = 0; d < D / 8; ++d) {
                    const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&qv[d]);
                    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&kv[d]);
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const float2 x = __bfloat1622float2(a[j]), y = __bfloat1622float2(b[j]);
                        acc = fmaf(x.x, y.x, acc);
                        acc = fmaf(x.y, y.y, acc);
                    }
                }
                const float x = __fadd_rn(__fmul_rn(acc, scale), self_bias);
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
            s[b][e] = p;                 // rounded to bf16 by c_to_a
        }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        l[h] = fmaxf(l[h], 1e-30f);
    }
}

// BIAS: the layer has a self bias (self_bias != 0: the LSH layers)
template <int C, int D, bool BIAS>
__global__ void __launch_bounds__(2 * C, 2)
k3_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
      const int* __restrict__ qpos, const int* __restrict__ kpos, bf16* __restrict__ out,
      float* __restrict__ lse, int T_, float scale, float self_bias) {
    constexpr int NT = 2 * C;           // C / 16 warps
    constexpr int DS = D + 8;
    constexpr int NB = C / 4;           // window columns: 2C in n-blocks of 8
    constexpr int HB = C / 8;           // n-blocks per chunk of the window
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sK = reinterpret_cast<bf16*>(smem_raw);   // [3][C][DS]: key chunk c in slot (c + 3) % 3
    bf16* sV = sK + 3 * C * DS;
    bf16* sQ = sV + 3 * C * DS;                     // [2][C][DS]: query chunk c in slot c % 2
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
        const bf16* tQ = sQ + (i & 1) * C * DS;
        const bf16* const kw[2] = {sK + kslot(i - 1) * C * DS, sK + kslot(i) * C * DS};
        const bf16* const vw[2] = {sV + kslot(i - 1) * C * DS, sV + kslot(i) * C * DS};
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
                    mma(s[hf * HB + 2 * np], a, b[0], b[1]);
                    mma(s[hf * HB + 2 * np + 1], a, b[2], b[3]);
                }
        }
        float mx[2], l[2];
        window_softmax<C, D, BIAS>(s, mx, l, kp, qp, tQ + 16 * w * DS, kw, gq, t, scale,
                                   self_bias);

        // ctx = P . [V_{i-1}; V_i]
        float o[D / 8][4] = {};
#pragma unroll
        for (int kb = 0; kb < C / 8; ++kb) {
            uint32_t a[4];
            c_to_a(a, s[2 * kb], s[2 * kb + 1]);
            const bf16* vt = vw[kb / (C / 16)];
#pragma unroll
            for (int np = 0; np < D / 16; ++np) {
                uint32_t b[4];
                load_bt(b, vt, DS, 16 * np, 16 * (kb % (C / 16)), lane);
                mma(o[2 * np], a, b[0], b[1]);
                mma(o[2 * np + 1], a, b[2], b[3]);
            }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const float inv = 1.f / l[h];
            const size_t row = base + (size_t)i * C + 16 * w + gq + 8 * h;
#pragma unroll
            for (int nb = 0; nb < D / 8; ++nb)
                *reinterpret_cast<uint32_t*>(out + row * D + 8 * nb + 2 * t) =
                    pack(o[nb][2 * h] * inv, o[nb][2 * h + 1] * inv);
            if (t == 0) lse[row] = mx[h] + logf(l[h]);
        }
    }
}

template <int C, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* qpos,
                   const int* kpos, void* out, float* lse, int G, int T_, float scale,
                   float self_bias, cudaStream_t stream) {
    const size_t smem = smem_bytes<C, D>();
    auto kern = self_bias != 0.f ? k3_tc<C, D, true> : k3_tc<C, D, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<dim3((T_ / C + RUN - 1) / RUN, G), 2 * C, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, qpos, kpos, (bf16*)out, lse, T_, scale,
        self_bias);
    return cudaGetLastError();
}

}  // namespace tc

// ------------------------------------ any chunk, D 128 and f16: the tiled form
// k3_tiled: what the two kernels above do not take -- a chunk other than 32
// or 64, D = 128 (their [C, 2C] tiles would not fit in shared memory at C
// 128), and f16 -- as flash attention over the windows.  One 256-thread
// block per (g, 64 query rows), which may span several chunks (C < 64) or
// part of one (C > 64), walks the 64-key tiles of the union of its rows'
// windows with an online softmax; operands are f32 rows of stride D+1 in
// shared memory and every product an f32 FMA, as in the f32 kernel.  A key
// outside a row's window is no term of its softmax; a key inside it that the
// query may not see (a later position, or chunk 0's zero look-back) scores
// NEG_INF, as above.  p is rounded to v's dtype against the running max
// before PV, as K1 does.  A row that sees only its own key keeps lse =
// fl(s + self_bias) exactly: the other terms are exp(-1e9 - max) = 0 and l =
// 1.  Shared memory at D = 128: 116 KB.
namespace tiled {

constexpr int B = 64;              // query rows per block, keys per tile
constexpr int R = B / 16;          // rows and columns per thread
constexpr int PS = B + 1;          // P row stride
constexpr float kNone = -3e38f;    // running max before any key of the window

template <int D>
constexpr size_t smem_bytes() {
    return ((size_t)3 * B * (D + 1) + (size_t)B * PS) * sizeof(float) + 2 * B * sizeof(int);
}

// rows [r0, r0 + B) of a [T_, D] matrix into f32 rows of stride D+1, zero
// outside [0, T_)
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0, int T_) {
    for (int e = threadIdx.x; e < B * D; e += NT) {
        const int r = e / D, c = e % D, row = r0 + r;
        dst[r * (D + 1) + c] = (row >= 0 && row < T_) ? to_f(src[(size_t)row * D + c]) : 0.f;
    }
}

// query row r (chunk r / C) sees key rows [(r / C - 1) C, (r / C + 1) C)
__device__ __forceinline__ bool in_window(int r, int w, int C) {
    const int lo = (r / C - 1) * C;
    return w >= lo && w < lo + 2 * C;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, 2)
k3_tiled(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         const int* __restrict__ qpos, const int* __restrict__ kpos, T* __restrict__ out,
         float* __restrict__ lse, int T_, int C, float scale, float self_bias) {
    constexpr int DP = D + 1;
    constexpr int CD = D / 16;          // context columns per thread
    extern __shared__ float smem[];
    float* sQ = smem;                   // [B][DP]
    float* sK = sQ + B * DP;            // [B][DP]
    float* sV = sK + B * DP;            // [B][DP]
    float* sP = sV + B * DP;            // [B][PS]
    int* sQp = (int*)(sP + B * PS);     // [B]
    int* sKp = sQp + B;                 // [B]

    const int g = blockIdx.y;
    const int q0 = blockIdx.x * B;
    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const size_t base = (size_t)g * T_;
    const T* k_g = k + base * D;
    const T* v_g = v + base * D;

    stage<T, D>(sQ, q + base * D, q0, T_);
    if (tid < B) sQp[tid] = q0 + tid < T_ ? qpos[base + q0 + tid] : INT_MIN;

    float m_i[R], l_i[R], acc[R][CD];
#pragma unroll
    for (int i = 0; i < R; ++i) {
        m_i[i] = kNone;
        l_i[i] = 0.f;
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
    }

    // the union of the windows of rows [q0, q_last]
    const int q_last = min(q0 + B, T_) - 1;
    const int w_lo = (q0 / C - 1) * C, w_hi = (q_last / C + 1) * C;
    for (int k0 = w_lo; k0 < w_hi; k0 += B) {
        __syncthreads();                                 // previous tile's P / V reads done
        stage<T, D>(sK, k_g, k0, T_);
        stage<T, D>(sV, v_g, k0, T_);
        if (tid < B) {
            const int w = k0 + tid;
            sKp[tid] = (w >= 0 && w < T_) ? kpos[base + w] : INT_MAX;  // look-back of chunk 0
        }
        __syncthreads();

        // scores: query row ty + 16 i, key column tx + 16 j
        float s[R][R];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
            for (int j = 0; j < R; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int h = 0; h < D; ++h) {
            float a[R], b[R];
#pragma unroll
            for (int i = 0; i < R; ++i) a[i] = sQ[(ty + 16 * i) * DP + h];
#pragma unroll
            for (int j = 0; j < R; ++j) b[j] = sK[(tx + 16 * j) * DP + h];
#pragma unroll
            for (int i = 0; i < R; ++i)
#pragma unroll
                for (int j = 0; j < R; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
        }

#pragma unroll
        for (int i = 0; i < R; ++i) {
            const int qi = ty + 16 * i, r = q0 + qi, qp = sQp[qi];
            bool in[R];
            float mx = kNone;
#pragma unroll
            for (int j = 0; j < R; ++j) {
                const int kp = sKp[tx + 16 * j];
                float x = s[i][j] * scale;
                if (kp <= qp) {
                    if (kp == qp) x += self_bias;
                } else {
                    x = kNegInf;
                }
                s[i][j] = x;
                in[j] = in_window(r, k0 + tx + 16 * j, C);
                if (in[j]) mx = fmaxf(mx, x);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m_i[i], mx);
            const float alpha = expf(m_i[i] - m_new);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < R; ++j) {
                const float p = in[j] ? expf(s[i][j] - m_new) : 0.f;
                sum += p;
                sP[qi * PS + tx + 16 * j] = round_to<T>(p);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            l_i[i] = l_i[i] * alpha + sum;
            m_i[i] = m_new;
#pragma unroll
            for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
        }
        __syncthreads();

#pragma unroll 4
        for (int kx = 0; kx < B; ++kx) {
            float vk[CD];
#pragma unroll
            for (int c = 0; c < CD; ++c) vk[c] = sV[kx * DP + tx + 16 * c];
#pragma unroll
            for (int i = 0; i < R; ++i) {
                const float p = sP[(ty + 16 * i) * PS + kx];
#pragma unroll
                for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(p, vk[c], acc[i][c]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
        const int r = q0 + ty + 16 * i;
        if (r >= T_) continue;
        const float l = fmaxf(l_i[i], 1e-30f);
        T* o = out + (base + r) * D;
#pragma unroll
        for (int c = 0; c < CD; ++c) o[tx + 16 * c] = from_f<T>(acc[i][c] / l);
        if (tx == 0) lse[base + r] = m_i[i] + logf(l);
    }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* qpos,
                   const int* kpos, void* out, float* lse, int G, int T_, int C, float scale,
                   float self_bias, cudaStream_t stream) {
    const size_t smem = smem_bytes<D>();
    auto kern = k3_tiled<T, D>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<dim3((T_ + B - 1) / B, G), NT, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, qpos, kpos, (T*)out, lse, T_, C, scale,
        self_bias);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, const int* qpos,
                     const int* kpos, void* out, float* lse, int G, int T_, int C,
                     float scale, float self_bias, cudaStream_t st) {
    switch (D) {
        case 16: return launch<T, 16>(q, k, v, qpos, kpos, out, lse, G, T_, C, scale,
                                      self_bias, st);
        case 32: return launch<T, 32>(q, k, v, qpos, kpos, out, lse, G, T_, C, scale,
                                      self_bias, st);
        case 64: return launch<T, 64>(q, k, v, qpos, kpos, out, lse, G, T_, C, scale,
                                      self_bias, st);
        case 128: return launch<T, 128>(q, k, v, qpos, kpos, out, lse, G, T_, C, scale,
                                        self_bias, st);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace tiled

template <typename T, int C, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* qpos,
                   const int* kpos, void* out, float* lse, int G, int T_, float scale,
                   float self_bias, cudaStream_t stream) {
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {    // the tensor-core kernel
        return tc::launch<C, D>(q, k, v, qpos, kpos, out, lse, G, T_, scale, self_bias, stream);
    } else {
        const size_t smem = Fwd<C, D>::smem_bytes();
        auto kern = chunked_window_attn_fwd_kernel<T, C, D>;
        cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        dim3 grid(T_ / C, G);
        kern<<<grid, NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, qpos, kpos,
                                         (T*)out, lse, T_, scale, self_bias);
        return cudaGetLastError();
    }
}

template <typename T, int C>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, const int* qpos,
                     const int* kpos, void* out, float* lse, int G, int T_, float scale,
                     float self_bias, cudaStream_t st) {
    switch (D) {
        case 16: return launch<T, C, 16>(q, k, v, qpos, kpos, out, lse, G, T_, scale,
                                         self_bias, st);
        case 32: return launch<T, C, 32>(q, k, v, qpos, kpos, out, lse, G, T_, scale,
                                         self_bias, st);
        case 64: return launch<T, C, 64>(q, k, v, qpos, kpos, out, lse, G, T_, scale,
                                         self_bias, st);
        default: return cudaErrorInvalidValue;
    }
}

template <typename T>
cudaError_t launch_c(int C, int D, const void* q, const void* k, const void* v,
                     const int* qpos, const int* kpos, void* out, float* lse, int G, int T_,
                     float scale, float self_bias, cudaStream_t st) {
    switch (C) {
        case 32: return launch_d<T, 32>(D, q, k, v, qpos, kpos, out, lse, G, T_, scale,
                                        self_bias, st);
        case 64: return launch_d<T, 64>(D, q, k, v, qpos, kpos, out, lse, G, T_, scale,
                                        self_bias, st);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// q/k/v [G, T, D] (dtype 0 = f32, 1 = bf16, 2 = f16), qpos/kpos int32 [G, T];
// out [G, T, D] in that dtype, lse [G, T] f32.  T % chunk == 0; D 16, 32, 64
// or 128.  Chunks 32 and 64 at D <= 64 run the FMA kernel in f32 and the
// tensor-core one in bf16; every other chunk, D 128 and f16 run k3_tiled.
// Launches on `stream`; returns cudaGetLastError() of the launch.
extern "C" int chunked_window_attn_fwd(const void* q, const void* k, const void* v,
                                       const void* qpos, const void* kpos, void* out,
                                       void* lse, int G, int T, int D, int chunk, int dtype,
                                       float scale, float self_bias, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int* qp = (const int*)qpos;
    const int* kp = (const int*)kpos;
    float* l = (float*)lse;
    if (chunk <= 0 || T % chunk) return (int)cudaErrorInvalidValue;
    const bool fixed = (chunk == 32 || chunk == 64) && D <= 64;
    if (fixed && dtype == 0)
        return (int)launch_c<float>(chunk, D, q, k, v, qp, kp, out, l, G, T, scale, self_bias,
                                    st);
    if (fixed && dtype == 1)
        return (int)launch_c<__nv_bfloat16>(chunk, D, q, k, v, qp, kp, out, l, G, T, scale,
                                            self_bias, st);
    if (dtype == 0)
        return (int)tiled::launch_d<float>(D, q, k, v, qp, kp, out, l, G, T, chunk, scale,
                                           self_bias, st);
    if (dtype == 1)
        return (int)tiled::launch_d<__nv_bfloat16>(D, q, k, v, qp, kp, out, l, G, T, chunk,
                                                   scale, self_bias, st);
    if (dtype == 2)
        return (int)tiled::launch_d<__half>(D, q, k, v, qp, kp, out, l, G, T, chunk, scale,
                                            self_bias, st);
    return (int)cudaErrorInvalidValue;
}
