// K6: K dependent fused multiply-adds per element -- the card's raw
// elementwise rate, a roofline microbenchmark for Hopper (sm_90a).  Replaces
// the Pallas TPU kernel scripts/vpu_roofline.py::_muladd_kernel (called
// through run_muladd).
//
// What it computes, for every element of s (f32, any shape), from
// acc = s0 = s[i]:   K times  acc = acc * 1.0000001 + s0   ->   out[i] = acc.
// Each pass is one FFMA (fmaf: one rounding).
//
// Design: one dependent FMA chain per element is bound by the FMA's latency
// (about 4 cycles), not by the pipe's rate.  Each thread therefore carries
// kIlp = 8 independent elements (eight chains interleaved in one loop), so a
// warp scheduler always has an FMA ready and the figure reads the FP32 pipe's
// rate.  Element j of thread t is t + j * n_threads: every load and store of
// a warp is coalesced.  K is a runtime argument and the loop carries
// `#pragma unroll 1`, so nvcc can neither fold nor unroll it.
//
// Bound on the H100: K FMAs per element on 128 FP32 lanes per SM per clock
// (132 SMs at 1.98 GHz: ~33.5 T FMA/s); s read once and out written once are
// negligible beside it for K >= 4.
#include <cuda_runtime.h>

namespace {

constexpr int kIlp = 8;                  // independent chains per thread
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
muladd_chain_kernel(const float* __restrict__ s, float* __restrict__ out, long long n,
                    long long n_threads, int K) {
    const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (t >= n_threads) return;
    float s0[kIlp], acc[kIlp];
#pragma unroll
    for (int j = 0; j < kIlp; ++j) {
        const long long i = t + j * n_threads;
        s0[j] = i < n ? s[i] : 0.f;
        acc[j] = s0[j];
    }
#pragma unroll 1
    for (int it = 0; it < K; ++it) {
#pragma unroll
        for (int j = 0; j < kIlp; ++j) acc[j] = fmaf(acc[j], 1.0000001f, s0[j]);
    }
#pragma unroll
    for (int j = 0; j < kIlp; ++j) {
        const long long i = t + j * n_threads;
        if (i < n) out[i] = acc[j];
    }
}

}  // namespace

// s and out: n contiguous f32; K >= 0 passes.  Launches on `stream`; returns
// cudaGetLastError() of the launch.
extern "C" int muladd_chain(const void* s, void* out, long long n, int K, void* stream) {
    if (n <= 0 || K < 0) return (int)cudaErrorInvalidValue;
    const long long n_threads = (n + kIlp - 1) / kIlp;
    const long long blocks = (n_threads + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    muladd_chain_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)s, (float*)out, n, n_threads, K);
    return (int)cudaGetLastError();
}
