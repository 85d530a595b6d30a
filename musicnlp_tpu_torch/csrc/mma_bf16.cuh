// Tensor-core helpers for the 16-bit kernels of the port (sm_80+ PTX, built
// for sm_90a): ldmatrix, mma.sync m16n8k16 (bf16 or f16 in, f32 accumulate),
// cp.async with zero fill and the named barrier of a 16-row group of warps.
// Included by the tensor-core kernels of K1-K4 (flash_rel_attn_fwd.cu,
// flash_rel_attn_bwd.cu, chunked_window_attn_fwd.cu,
// chunked_window_attn_bwd.cu).  The element type E (__nv_bfloat16 by
// default, or __half) picks the product's input type and the rounding of
// `pack` / `c_to_a`; ldmatrix and cp.async move b16 and take either.
//
// Fragment layouts of mma.sync.m16n8k16.row.col (lane = 4 g + t):
//   A [16 x 16]: a0 = A[g][2t, 2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..],
//                a3 = A[g+8][2t+8..]                       (bf16 pairs)
//   B [16 x 8]:  b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g]
//   C [16 x 8]:  c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1]  (f32)
// Two C tiles that are neighbours along n make one A tile along k (the
// accumulator of one product feeds the next without shared memory:
// `c_to_a`).  Operands live in shared memory as bf16 rows with a stride of
// 16-byte units; each lane hands ldmatrix the address of one 8-element row,
// which the `*_addr` functions compute:
//   a_addr  A stored [m][k] (k contiguous)              -> a0..a3
//   at_addr A stored [k][m] (m contiguous; A = stored^T) -> a0..a3 (.trans)
//   b_addr  B stored [n][k] (C = X . stored^T)           -> b of n-blocks n0, n0+8
//   bt_addr B stored [k][n] (C = X . stored)             -> b of n-blocks n0, n0+8 (.trans)
#pragma once
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace mma_bf16 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// four 8 x 8 b16 matrices; lanes 8i..8i+7 address the rows of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
}

// d += a . b, with a and b of element type E
template <typename E = __nv_bfloat16>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
    if constexpr (std::is_same_v<E, __half>)
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// lane addresses (b16 element offsets are turned into pointers by the
// caller: base + row * stride + col)
__device__ __forceinline__ int a_row(int lane) { return lane & 15; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) << 3; }
__device__ __forceinline__ int at_row(int lane) { return (lane & 7) + ((lane >> 4) << 3); }
__device__ __forceinline__ int at_col(int lane) { return ((lane >> 3) & 1) << 3; }
__device__ __forceinline__ int b_row(int lane) { return (lane & 7) + ((lane >> 4) << 3); }
__device__ __forceinline__ int b_col(int lane) { return ((lane >> 3) & 1) << 3; }
__device__ __forceinline__ int bt_row(int lane) { return lane & 15; }
__device__ __forceinline__ int bt_col(int lane) { return (lane >> 4) << 3; }

// A fragment of the 16 x 16 tile [m0, m0+16) x [k0, k0+16) of a matrix
// stored [m][k] with row stride `ld` elements (a_addr) or stored [k][m] (at)
template <typename E>
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const E* base, int ld,
                                       int m0, int k0, int lane) {
    ldsm_x4(r, base + (m0 + a_row(lane)) * ld + k0 + a_col(lane));
}
template <typename E>
__device__ __forceinline__ void load_at(uint32_t (&r)[4], const E* base, int ld,
                                        int m0, int k0, int lane) {
    ldsm_x4_t(r, base + (k0 + at_row(lane)) * ld + m0 + at_col(lane));
}
// B fragments of n-blocks [n0, n0+8) (r[0], r[1]) and [n0+8, n0+16) (r[2],
// r[3]) over k [k0, k0+16), from a matrix stored [n][k] (load_b) or [k][n]
template <typename E>
__device__ __forceinline__ void load_b(uint32_t (&r)[4], const E* base, int ld,
                                       int n0, int k0, int lane) {
    ldsm_x4(r, base + (n0 + b_row(lane)) * ld + k0 + b_col(lane));
}
template <typename E>
__device__ __forceinline__ void load_bt(uint32_t (&r)[4], const E* base, int ld,
                                        int n0, int k0, int lane) {
    ldsm_x4_t(r, base + (k0 + bt_row(lane)) * ld + n0 + bt_col(lane));
}

// two floats rounded to E (RNE), low half first
template <typename E = __nv_bfloat16>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
    if constexpr (std::is_same_v<E, __half>) {
        __half2 v = __floats2half2_rn(lo, hi);
        return *reinterpret_cast<uint32_t*>(&v);
    } else {
        __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
        return *reinterpret_cast<uint32_t*>(&v);
    }
}

// the A fragment (k-block kk) of a [16 x 8 n] accumulator row held as C
// tiles c[2kk], c[2kk+1], rounded to E
template <typename E = __nv_bfloat16>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
    a[0] = pack<E>(c0[0], c0[1]);
    a[1] = pack<E>(c0[2], c0[3]);
    a[2] = pack<E>(c1[0], c1[1]);
    a[3] = pack<E>(c1[2], c1[3]);
}

// two E values (low half first) as f32
template <typename E = __nv_bfloat16>
__device__ __forceinline__ float2 unpack(uint32_t v) {
    if constexpr (std::is_same_v<E, __half>)
        return __half22float2(*reinterpret_cast<const __half2*>(&v));
    else
        return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// the SP warps of 16-row group `grp` wait for each other: __syncwarp for one
// warp, else the named barrier 1 + grp (0 is __syncthreads')
template <int SP>
__device__ __forceinline__ void group_sync(int grp) {
    if constexpr (SP == 1)
        __syncwarp();
    else
        asm volatile("bar.sync %0, %1;\n" :: "r"(grp + 1), "n"(32 * SP) : "memory");
}

// 16 bytes global -> shared; zero fill when !valid (src-size 0: nothing read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}
// 4 bytes global -> shared; zero fill when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N)); }

// rows [r0, r0 + n) of a [len, H] b16 matrix into shared rows of stride
// H + 8, zero outside [0, len); nt threads, thread `tid`
template <int H, typename E>
__device__ __forceinline__ void stage_rows(E* dst, const E* src,
                                           int r0, int n, int len, int tid, int nt) {
    constexpr int CPR = H / 8;                       // 16-byte chunks per row
    for (int e = tid; e < n * CPR; e += nt) {
        const int r = e / CPR, c = (e % CPR) * 8, row = r0 + r;
        const bool ok = row >= 0 && row < len;
        cp_async16(dst + r * (H + 8) + c, src + (ok ? (size_t)row * H + c : 0), ok);
    }
}

}  // namespace mma_bf16
