// Element conversions of the FMA kernels of K1-K4: inputs in f32, bf16 or
// f16 are staged as f32, results are rounded back to the input dtype (RNE),
// and p is rounded to v's dtype where it enters the PV product (`round_to`),
// as the TPU kernels do.  Included by flash_rel_attn_fwd.cu,
// flash_rel_attn_bwd.cu, chunked_window_attn_fwd.cu and
// chunked_window_attn_bwd.cu.
#pragma once
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace elem {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
    return __float2half_rn(x);
}

template <typename T> __device__ __forceinline__ float round_to(float x) {
    return to_f(from_f<T>(x));
}

}  // namespace elem
