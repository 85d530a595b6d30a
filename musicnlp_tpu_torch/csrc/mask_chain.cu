// K5: the chunked-attention kernel's mask / softmax chain, repeated K times
// with no dot products -- a roofline microbenchmark for Hopper (sm_90a).
// Replaces the Pallas TPU kernel scripts/vpu_roofline.py::_mask_chain_kernel
// (called through run_chain).
//
// What it computes, per row (g, m, c) of s [G, M, C, W] f32, with the key
// positions kp [G, M, W] and the query position qp [G, M, C] (int32), from
// acc = s0 = s[g, m, c, :]:
//   K times:  x = (s0 + acc * 1e-6) * 0.125  (the previous pass folded back in,
//                                             so no pass can be hoisted)
//             x = kp <= qp ? (kp == qp ? x + 1e4 : x) : -1e9
//             p = exp(x - max_W x),  l = max(sum_W p, 1e-30)
//             acc = f32(bf16(p / l))
//   out[g, m, c, :] = acc.
//
// The arithmetic per element and pass is the bf16 K3's (`k3_tc`,
// chunked_window_attn_fwd.cu), which runs the same chain once per score, so
// that the roofline tool's time per pass is a share of K3's time:
//   * fold and scale in one FFMA, fma(acc, 1e-6 / 8, s0 / 8): 1/8 is a power
//     of two, so s0 / 8 (once, before the loop) and 1e-6 / 8 are exact;
//   * the causal and the self compare and their selects in every pass, for
//     every element (K3 pays for them in every program).  The compares read
//     q through the sign bit of the previous pass's reciprocal, which is
//     always 0: no compiler can prove it, so none can hoist them;
//   * the max by two quad shuffles; p = exp2f((x - max) * log2 e), the
//     difference taken first, as in K3 (one FFMA x * log2 e - max * log2 e is
//     not 0 at x = max when |max| is large: at max = -1e9 its rounding
//     reaches 64, so p = 1 would read 2^e; p / l cancels it, p does not);
//   * the sum by two quad shuffles, one reciprocal of l per row and pass
//     (rcp.approx: l lies in [1, 128]), then p * r: no division per element;
//   * the bf16 round trip as one cvt.rn.bf16x2.f32 per value with a zero low
//     half, whose 32 bits are the rounded value as f32 (packing two values
//     per conversion would need two more instructions to unpack them).
// No -use_fast_math, no ftz: a subnormal p stays nonzero (exp2f carries its
// range fixup, as in K3).
//
// Design (GPU, not the TPU's blocks): the rows are independent and only the
// max and the sum run along W, so a quad of lanes owns a row of W = 128, lane
// t of the quad the 32 columns 16j + 4t + i (j < 8, i < 4, float4 loads), and
// s0, acc and the 32 key positions stay in registers for all K passes; each
// lane reduces its 32 values as a pairwise tree (five levels, not a chain of
// 31), then the quad by shuffles.  No shared memory, no device-memory traffic
// inside the loop.  K is a runtime argument under `#pragma unroll 1`: one
// trip of the loop in the SASS is one pass.
//
// Bound on the H100, per element and pass (tools/vpu_roofline.py counts it by
// pipe): 5 FMA-pipe (fold, self add, sub, sum, * r; 128 lanes per SM per
// clock), 5 ALU-pipe (two compares, the mask select, the max, the
// conversion; 64 lanes) and 1 MUFU (ex2; 16 lanes) instructions; the four
// schedulers of an SM dispatch 128 lanes of instructions per clock in all,
// so the 11 instructions bound it.  log2 e could fold into the pre-scaled
// constants; this kernel multiplies by it after the difference, as K3 does,
// one FMUL per element more than the bound.  The bytes (s in, out out,
// once) are three orders of magnitude below.
#include <cuda_runtime.h>
#include <stdint.h>
#include <climits>

namespace {

constexpr int kW = 128;                  // keys per row: 2C of the 22-04 LSH kernel
constexpr int kQuad = 4;                 // lanes per row
constexpr int kPer = kW / kQuad;         // 32 values per lane
constexpr int kThreads = 128;            // 32 rows per block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kFold = 1e-6f * 0.125f;  // exact: 0.125 is a power of two
constexpr float kSelf = 1e4f;
constexpr float kMasked = -1e9f;

__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// every lane of the quad ends with the same bits: a + b == b + a
__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// op over the lane's 32 values as a pairwise tree: (v0 op v1), (v2 op v3), ...
// then pairs of those, five levels, each a loop of constant trip count (so
// every index is a register, never a local-memory array)
template <typename Op>
__device__ __forceinline__ float tree(const float (&v)[kPer], Op op) {
    static_assert(kPer == 32, "five levels");
    float a[16], b[8], c[4];
#pragma unroll
    for (int i = 0; i < 16; ++i) a[i] = op(v[2 * i], v[2 * i + 1]);
#pragma unroll
    for (int i = 0; i < 8; ++i) b[i] = op(a[2 * i], a[2 * i + 1]);
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = op(b[2 * i], b[2 * i + 1]);
    return op(op(c[0], c[1]), op(c[2], c[3]));
}

// f32(bf16(v)), round to nearest even: the high half of the pair is bf16(v),
// the low half bf16(0) = 0
__device__ __forceinline__ float round_bf16(float v) {
    uint32_t u;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(u) : "f"(v), "f"(0.f));
    return __uint_as_float(u);
}

__global__ void __launch_bounds__(kThreads)
mask_chain_kernel(const float* __restrict__ s, const int* __restrict__ kp,
                  const int* __restrict__ qp, float* __restrict__ out, int rows, int C,
                  int K) {
    const int quad = (blockIdx.x * kThreads + threadIdx.x) / kQuad;
    const int t = threadIdx.x % kQuad;
    // a quad past the last row runs the last row's chain and stores nothing:
    // the quad shuffles name every lane of the warp
    const int row = min(quad, rows - 1);
    const float4* srow = reinterpret_cast<const float4*>(s + (size_t)row * kW);
    const int4* krow = reinterpret_cast<const int4*>(kp + (size_t)(row / C) * kW);
    const int q = qp[row];
    float s0[kPer], acc[kPer];
    int kpos[kPer];
#pragma unroll
    for (int j = 0; j < kPer / 4; ++j) {
        const float4 v = srow[kQuad * j + t];
        const int4 k = krow[kQuad * j + t];
        const float sv[4] = {v.x, v.y, v.z, v.w};
        const int kv[4] = {k.x, k.y, k.z, k.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            s0[4 * j + i] = sv[i] * 0.125f;
            acc[4 * j + i] = sv[i];
            kpos[4 * j + i] = kv[i];
        }
    }
    float r = 1.f;                           // the previous pass's 1 / l: > 0
#pragma unroll 1
    for (int it = 0; it < K; ++it) {
        const int qi = q | (__float_as_int(r) & INT_MIN);      // == q
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
            float x = fmaf(acc[e], kFold, s0[e]);
            if (kpos[e] == qi) x += kSelf;
            if (kpos[e] > qi) x = kMasked;
            acc[e] = x;
        }
        const float mx = quad_max(tree(acc, [](float a, float b) { return fmaxf(a, b); }));
#pragma unroll
        for (int e = 0; e < kPer; ++e) acc[e] = exp2f((acc[e] - mx) * kLog2e);
        const float l =
            fmaxf(quad_sum(tree(acc, [](float a, float b) { return a + b; })), 1e-30f);
        asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(l));
#pragma unroll
        for (int e = 0; e < kPer; ++e) acc[e] = round_bf16(acc[e] * r);
    }
    if (quad < rows) {
        float4* orow = reinterpret_cast<float4*>(out + (size_t)row * kW);
#pragma unroll
        for (int j = 0; j < kPer / 4; ++j)
            orow[kQuad * j + t] =
                make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
    }
}

}  // namespace

// s and out [G, M, C, 128] f32, kp [G, M, 128] and qp [G, M, C] int32, all
// contiguous and 16-byte aligned; K >= 0 passes.  Launches on `stream`;
// returns cudaGetLastError() of the launch.
extern "C" int mask_chain(const void* s, const void* kp, const void* qp, void* out, int G,
                          int M, int C, int W, int K, void* stream) {
    if (W != kW || G <= 0 || M <= 0 || C <= 0 || K < 0) return (int)cudaErrorInvalidValue;
    const long long rows = (long long)G * M * C;
    if (rows * kQuad > INT_MAX) return (int)cudaErrorInvalidValue;
    const int blocks = (int)((rows * kQuad + kThreads - 1) / kThreads);
    mask_chain_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)s, (const int*)kp, (const int*)qp, (float*)out, (int)rows, C, K);
    return (int)cudaGetLastError();
}

// The kernel's resources on the current device: res[0] registers per thread,
// res[1] local-memory bytes per thread (stack and spills), res[2] blocks
// resident on one SM at once (its occupancy).  Returns the CUDA error.
extern "C" int mask_chain_resources(int* res) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, mask_chain_kernel);
    if (err != cudaSuccess) return (int)err;
    res[0] = attr.numRegs;
    res[1] = (int)attr.localSizeBytes;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&res[2], mask_chain_kernel, kThreads, 0);
    return (int)err;
}
