// delta[r] = sum_d a[r, d] * b[r, d] in f32 over rows of D values (bf16,
// f16 or f32): the dO . O term of an attention backward, which K2 and K4 take
// as an input.  Each thread takes one 16-byte piece of a row (D / 8 bf16 or
// f16, or D / 4 f32 lanes per row, so a warp reads whole rows, coalesced),
// sums it with f32 FMAs (a bf16 or f16 product is exact in f32, so each
// step rounds once, as a multiply then an add would), and the row's lanes
// add their sums by shuffles.  Bound by bytes: 2 * rows * D elements read
// once, rows f32 written.  Included by flash_rel_attn_bwd.cu and chunked_window_attn_bwd.cu,
// each exporting it beside its backward.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace row_dot {

__device__ __forceinline__ float dot8(const uint4& x, const uint4& y, float acc,
                                      __nv_bfloat16) {
    const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 fa = __bfloat1622float2(a[i]), fb = __bfloat1622float2(b[i]);
        acc = fmaf(fa.x, fb.x, acc);
        acc = fmaf(fa.y, fb.y, acc);
    }
    return acc;
}

__device__ __forceinline__ float dot8(const uint4& x, const uint4& y, float acc, __half) {
    const __half2* a = reinterpret_cast<const __half2*>(&x);
    const __half2* b = reinterpret_cast<const __half2*>(&y);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 fa = __half22float2(a[i]), fb = __half22float2(b[i]);
        acc = fmaf(fa.x, fb.x, acc);
        acc = fmaf(fa.y, fb.y, acc);
    }
    return acc;
}

__device__ __forceinline__ float dot8(const uint4& x, const uint4& y, float acc, float) {
    const float* a = reinterpret_cast<const float*>(&x);
    const float* b = reinterpret_cast<const float*>(&y);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc = fmaf(a[i], b[i], acc);
    return acc;
}

template <typename T, int L>
__global__ void __launch_bounds__(256)
row_dot_kernel(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ out,
               long long rows) {
    // L lanes per row, one 16-byte piece each (L = 2..32, a power of two)
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long r = i / L;
    const bool ok = r < rows;
    float acc = 0.f;
    if (ok) acc = dot8(__ldg(reinterpret_cast<const uint4*>(a) + i),
                       __ldg(reinterpret_cast<const uint4*>(b) + i), 0.f, T());
#pragma unroll
    for (int m = L / 2; m > 0; m /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, m);
    if (ok && i % L == 0) out[r] = acc;
}

// rows of more than 32 pieces (a head dim above 128): one warp per row, lane
// i taking pieces i, i + 32, ...
template <typename T>
__global__ void __launch_bounds__(256)
row_dot_wide(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ out,
             long long rows, int L) {
    const long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
    const int lane = threadIdx.x & 31;
    float acc = 0.f;
    if (r < rows)
        for (int i = lane; i < L; i += 32)
            acc = dot8(__ldg(reinterpret_cast<const uint4*>(a) + r * L + i),
                       __ldg(reinterpret_cast<const uint4*>(b) + r * L + i), acc, T());
#pragma unroll
    for (int m = 16; m > 0; m /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, m);
    if (r < rows && lane == 0) out[r] = acc;
}

template <typename T>
cudaError_t launch_t(const T* a, const T* b, float* out, long long rows, int D,
                     cudaStream_t stream) {
    const int L = D * (int)sizeof(T) / 16;         // 16-byte pieces per row
    const unsigned blocks = (unsigned)((rows * L + 255) / 256);
    if (L > 32 && D % 128 == 0) {
        row_dot_wide<T><<<(unsigned)((rows * 32 + 255) / 256), 256, 0, stream>>>(a, b, out,
                                                                               rows, L);
        return cudaGetLastError();
    }
    switch (L) {
        case 2: row_dot_kernel<T, 2><<<blocks, 256, 0, stream>>>(a, b, out, rows); break;
        case 4: row_dot_kernel<T, 4><<<blocks, 256, 0, stream>>>(a, b, out, rows); break;
        case 8: row_dot_kernel<T, 8><<<blocks, 256, 0, stream>>>(a, b, out, rows); break;
        case 16: row_dot_kernel<T, 16><<<blocks, 256, 0, stream>>>(a, b, out, rows); break;
        case 32: row_dot_kernel<T, 32><<<blocks, 256, 0, stream>>>(a, b, out, rows); break;
        default: return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

// a, b [rows, D] of one dtype (0 = f32, 1 = bf16, 2 = f16), D 16, 32, 64 or a
// multiple of 128; out
// [rows] f32.  Launches on `stream`; returns cudaGetLastError().
inline cudaError_t launch(const void* a, const void* b, float* out, long long rows, int D,
                          int dtype, cudaStream_t stream) {
    if (rows <= 0) return rows < 0 ? cudaErrorInvalidValue : cudaSuccess;
    if (dtype == 0) return launch_t((const float*)a, (const float*)b, out, rows, D, stream);
    if (dtype == 1)
        return launch_t((const __nv_bfloat16*)a, (const __nv_bfloat16*)b, out, rows, D, stream);
    if (dtype == 2) return launch_t((const __half*)a, (const __half*)b, out, rows, D, stream);
    return cudaErrorInvalidValue;
}

}  // namespace row_dot
