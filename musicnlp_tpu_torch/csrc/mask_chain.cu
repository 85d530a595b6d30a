// K5: the chunked-attention kernel's mask / softmax chain, repeated K times
// with no dot products -- a roofline microbenchmark for Hopper (sm_90a).
// Replaces the Pallas TPU kernel scripts/vpu_roofline.py::_mask_chain_kernel
// (called through run_chain).
//
// What it computes, per row (g, m, c) of s [G, M, C, W] f32, with the key
// positions kp [G, M, W] and the query position qp [G, M, C] (int32), from
// acc = s0 = s[g, m, c, :]:
//   K times:  x = s0 + acc * 1e-6           (the previous pass folded back in,
//                                            so no pass can be hoisted)
//             x = x * 0.125
//             x = kp <= qp ? (kp == qp ? x + 1e4 : x) : -1e9
//             p = exp(x - max_W x),  l = max(sum_W p, 1e-30)
//             acc = f32(bf16(p / l))
//   out[g, m, c, :] = acc.
// The arithmetic is the TPU kernel's, operation by operation: a multiply and
// an add where it writes them (__fmul_rn / __fadd_rn: nvcc may not contract
// them into one FMA), the accurate expf (not __expf), a correctly rounded
// division, round-to-nearest-even to bf16.  No -use_fast_math.
//
// Design (GPU, not the TPU's blocks): the rows are independent and only the
// max and the sum run along W, so one warp owns one row of W = 128, four f32
// per lane in registers, and runs all K passes in registers: two warp-shuffle
// butterflies per pass (max, then sum; every lane ends with the same bits),
// no shared memory and no device-memory traffic inside the loop.  At the
// tool's shape the 64 * 8 * 64 = 32,768 rows are 32,768 warps (4,096 blocks
// of 256 threads), enough to fill all 132 SMs; a block per TPU program would
// launch 64 blocks for 132 SMs.  K is a runtime argument and the loop carries
// `#pragma unroll 1`, so nvcc can neither fold nor unroll it: one trip of the
// loop in the SASS is one pass.
//
// Bound on the H100: no matrix unit; per element and pass about 12 FP32-pipe
// operations (mul, add, mul, add 1e4, two selects, max, sub, the exp's scale,
// the sum's add, the division as a reciprocal product) and one ex2 on the
// special-function units -- 128 FP32 lanes and 16 SFU lanes per SM per clock.
// The FP32 pipes bound it (12/128 > 1/16); the bytes (s in, out out, once) are
// three orders of magnitude below.  chip_smoke.py reckons the bound from the
// card's SM count and clock.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kW = 128;                  // keys per row: 2C of the 22-04 LSH kernel
constexpr int kPerLane = kW / 32;        // 4 values per lane
constexpr int kThreads = 256;            // 8 rows per block

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__global__ void __launch_bounds__(kThreads)
mask_chain_kernel(const float* __restrict__ s, const int* __restrict__ kp,
                  const int* __restrict__ qp, float* __restrict__ out, int rows, int C,
                  int K) {
    const int row = (blockIdx.x * kThreads + threadIdx.x) >> 5;    // (g * M + m) * C + c
    const int lane = threadIdx.x & 31;
    if (row >= rows) return;
    const float4 sv = reinterpret_cast<const float4*>(s + (size_t)row * kW)[lane];
    const int4 kv = reinterpret_cast<const int4*>(kp + (size_t)(row / C) * kW)[lane];
    const int q = qp[row];
    const float s0[kPerLane] = {sv.x, sv.y, sv.z, sv.w};
    const int kpos[kPerLane] = {kv.x, kv.y, kv.z, kv.w};
    float acc[kPerLane] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll 1
    for (int it = 0; it < K; ++it) {
        float x[kPerLane];
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
            float v = __fmul_rn(__fadd_rn(s0[j], __fmul_rn(acc[j], 1e-6f)), 0.125f);
            v = kpos[j] <= q ? (kpos[j] == q ? __fadd_rn(v, 1e4f) : v) : -1e9f;
            x[j] = v;
            mx = fmaxf(mx, v);
        }
        mx = warp_max(mx);
        float l = 0.f;
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
            x[j] = expf(__fsub_rn(x[j], mx));
            l = __fadd_rn(l, x[j]);
        }
        l = fmaxf(warp_sum(l), 1e-30f);
#pragma unroll
        for (int j = 0; j < kPerLane; ++j)
            acc[j] = __bfloat162float(__float2bfloat16_rn(__fdiv_rn(x[j], l)));
    }
    reinterpret_cast<float4*>(out + (size_t)row * kW)[lane] =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
}

}  // namespace

// s and out [G, M, C, 128] f32, kp [G, M, 128] and qp [G, M, C] int32, all
// contiguous; K >= 0 passes.  Launches on `stream`; returns
// cudaGetLastError() of the launch.
extern "C" int mask_chain(const void* s, const void* kp, const void* qp, void* out, int G,
                          int M, int C, int W, int K, void* stream) {
    if (W != kW || G <= 0 || M <= 0 || C <= 0 || K < 0) return (int)cudaErrorInvalidValue;
    const int rows = G * M * C;
    const int blocks = (rows * 32 + kThreads - 1) / kThreads;
    mask_chain_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)s, (const int*)kp, (const int*)qp, (float*)out, rows, C, K);
    return (int)cudaGetLastError();
}
