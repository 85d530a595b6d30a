// bias_act: the epilogue of a dense layer, out = act(y + b) rounded once to
// out's dtype, over the f32 product y [N, D] and the f32 bias b [D] (or none).
//
// Replaces no Pallas kernel.  On the TPU the JAX package's `ops/layers.py::
// dense` leaves `x @ w` (with `preferred_element_type=f32`), the f32 bias add,
// the rounding to the activation's dtype and the FFN's relu to XLA, which
// fuses them into the product.  The port takes the product from cuBLAS with
// an f32 output (`torch.mm(..., out_dtype=float32)`) and does the rest here
// in one pass: the JAX arithmetic (f32 product + f32 bias, one rounding), with
// no second rounding of a bf16 product and no f32 copies of it.
//
// Bound: bytes.  One f32 read and one write of the output per element (4 + 2
// bytes in bf16 / f16, 4 + 4 in f32) and one add; at the FFN's [65536, 3072]
// in bf16 that is 1.21 GB, 0.36 ms at 3.35 TB/s.
//
// Design: a warp owns 256 consecutive columns of a row, each lane 8 of them:
// two 16-byte f32 loads (through the read-only path), one 16-byte store in
// bf16 / f16 (two in f32).  A block is 8 warps on 8 rows of one 256-wide
// column tile; the grid is column tiles x row blocks, each block walking rows
// with a grid stride, so a lane reads its 8 bias values once.  No shared
// memory, no atomics.  Both loads of a lane must be in flight together, so
// rows whose width is not a multiple of 8, or pointers not 16-byte aligned,
// take a second, plain elementwise kernel: inside this one, the ragged form's
// predicates push the relu form to 32 registers, where ptxas reuses the first
// load's registers for the second and serialises them (0.60 ms against 0.41
// at [65536, 3072] on an H100).  Rounding is round-to-nearest-even, as torch's
// casts; relu keeps a NaN (torch.relu does).  No -use_fast_math.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;                  // columns per lane
constexpr int kTileCols = 32 * kVec;     // columns per warp (one column tile)
constexpr int kWarps = 8;                // rows a block works on at a time
constexpr int kRowsPerWarp = 4;          // the grid's rows: kWarps * kRowsPerWarp a block

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store1(__half* p, float v) { *p = __float2half_rn(v); }

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16*, float a, float b) {
    __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack2(__half*, float a, float b) {
    __half2 h = __floats2half2_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&h);
}

// 8 values to 8 consecutive outputs, 16-byte aligned
__device__ __forceinline__ void store8(float* p, const float* v) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
template <typename T>
__device__ __forceinline__ void store8(T* p, const float* v) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack2(p, v[0], v[1]), pack2(p, v[2], v[3]),
                                              pack2(p, v[4], v[5]), pack2(p, v[6], v[7]));
}

template <typename OutT, bool kRelu>
__global__ void __launch_bounds__(32 * kWarps)
bias_act_vec(const float* __restrict__ y, const float* __restrict__ bias,
             OutT* __restrict__ out, long long n_rows, int d) {
    const int c0 = (blockIdx.x * 32 + threadIdx.x) * kVec;
    if (c0 >= d) return;
    float b[kVec] = {};
    if (bias) {
        const float4 lo = __ldg(reinterpret_cast<const float4*>(bias + c0));
        const float4 hi = __ldg(reinterpret_cast<const float4*>(bias + c0) + 1);
        b[0] = lo.x; b[1] = lo.y; b[2] = lo.z; b[3] = lo.w;
        b[4] = hi.x; b[5] = hi.y; b[6] = hi.z; b[7] = hi.w;
    }
    const long long stride = (long long)gridDim.y * kWarps;
    for (long long r = (long long)blockIdx.y * kWarps + threadIdx.y; r < n_rows; r += stride) {
        const float4* src = reinterpret_cast<const float4*>(y + r * d + c0);
        const float4 lo = __ldg(src);
        const float4 hi = __ldg(src + 1);
        float v[kVec] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
            v[i] += b[i];
            if (kRelu) v[i] = relu(v[i]);
        }
        store8(out + r * d + c0, v);
    }
}

// any width and alignment: one element a thread, grid-stride
template <typename OutT, bool kRelu>
__global__ void __launch_bounds__(256)
bias_act_any(const float* __restrict__ y, const float* __restrict__ bias,
             OutT* __restrict__ out, long long n, int d) {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x) {
        const float v = y[i] + (bias ? bias[i % d] : 0.f);
        store1(out + i, kRelu ? relu(v) : v);
    }
}

template <typename OutT, bool kRelu>
void run(const float* y, const float* bias, OutT* out, long long n_rows, int d,
         cudaStream_t stream) {
    if (d % kVec == 0 && ((uintptr_t)y | (uintptr_t)bias | (uintptr_t)out) % 16 == 0) {
        const long long row_blocks = (n_rows + kWarps * kRowsPerWarp - 1) / (kWarps * kRowsPerWarp);
        const dim3 grid((d + kTileCols - 1) / kTileCols,
                        (unsigned)(row_blocks < 65535 ? row_blocks : 65535));
        bias_act_vec<OutT, kRelu><<<grid, dim3(32, kWarps), 0, stream>>>(y, bias, out, n_rows, d);
    } else {
        const long long n = n_rows * d, blocks = (n + 255) / 256;
        bias_act_any<OutT, kRelu><<<(unsigned)(blocks < 65535 ? blocks : 65535), 256, 0, stream>>>(
            y, bias, out, n, d);
    }
}

template <typename OutT>
void launch(const float* y, const float* bias, void* out, long long n_rows, int d, bool relu,
            cudaStream_t stream) {
    OutT* o = static_cast<OutT*>(out);
    if (relu)
        run<OutT, true>(y, bias, o, n_rows, d, stream);
    else
        run<OutT, false>(y, bias, o, n_rows, d, stream);
}

}  // namespace

// y [n_rows, d] f32, bias [d] f32 or null, out [n_rows, d] in dtype code
// (0 f32, 1 bf16, 2 f16), all contiguous on one device; relu 0 / 1.
// Returns the launch's CUDA error (0 on success), cudaErrorInvalidValue for
// an unknown code or a negative size.
extern "C" int bias_act(const void* y, const void* bias, void* out, long long n_rows, int d,
                        int code, int relu, void* stream) {
    if (n_rows < 0 || d < 0) return (int)cudaErrorInvalidValue;
    if (n_rows == 0 || d == 0) return 0;
    const float* yf = static_cast<const float*>(y);
    const float* bf = static_cast<const float*>(bias);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (code) {
        case 0: launch<float>(yf, bf, out, n_rows, d, relu != 0, s); break;
        case 1: launch<__nv_bfloat16>(yf, bf, out, n_rows, d, relu != 0, s); break;
        case 2: launch<__half>(yf, bf, out, n_rows, d, relu != 0, s); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
