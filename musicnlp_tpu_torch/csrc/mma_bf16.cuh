// Tensor-core helpers for the bf16 kernels of the port (sm_80+ PTX, built
// for sm_90a): ldmatrix, mma.sync m16n8k16 (bf16 in, f32 accumulate) and
// cp.async with zero fill.  Included by flash_rel_attn_bwd.cu (K2) and
// chunked_window_attn_bwd.cu (K4).
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
#include <stdint.h>

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

// d += a . b
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// lane addresses (bf16 element offsets are turned into pointers by the
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
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const __nv_bfloat16* base, int ld,
                                       int m0, int k0, int lane) {
    ldsm_x4(r, base + (m0 + a_row(lane)) * ld + k0 + a_col(lane));
}
__device__ __forceinline__ void load_at(uint32_t (&r)[4], const __nv_bfloat16* base, int ld,
                                        int m0, int k0, int lane) {
    ldsm_x4_t(r, base + (k0 + at_row(lane)) * ld + m0 + at_col(lane));
}
// B fragments of n-blocks [n0, n0+8) (r[0], r[1]) and [n0+8, n0+16) (r[2],
// r[3]) over k [k0, k0+16), from a matrix stored [n][k] (load_b) or [k][n]
__device__ __forceinline__ void load_b(uint32_t (&r)[4], const __nv_bfloat16* base, int ld,
                                       int n0, int k0, int lane) {
    ldsm_x4(r, base + (n0 + b_row(lane)) * ld + k0 + b_col(lane));
}
__device__ __forceinline__ void load_bt(uint32_t (&r)[4], const __nv_bfloat16* base, int ld,
                                        int n0, int k0, int lane) {
    ldsm_x4_t(r, base + (k0 + bt_row(lane)) * ld + n0 + bt_col(lane));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragment (k-block kk) of a [16 x 8 n] accumulator row held as C
// tiles c[2kk], c[2kk+1], rounded to bf16
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
    a[0] = pack(c0[0], c0[1]);
    a[1] = pack(c0[2], c0[3]);
    a[2] = pack(c1[0], c1[1]);
    a[3] = pack(c1[2], c1[3]);
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

// rows [r0, r0 + n) of a [len, H] bf16 matrix into shared rows of stride
// H + 8, zero outside [0, len); nt threads, thread `tid`
template <int H>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int r0, int n, int len, int tid, int nt) {
    constexpr int CPR = H / 8;                       // 16-byte chunks per row
    for (int e = tid; e < n * CPR; e += nt) {
        const int r = e / CPR, c = (e % CPR) * 8, row = r0 + r;
        const bool ok = row >= 0 && row < len;
        cp_async16(dst + r * (H + 8) + c, src + (ok ? (size_t)row * H + c : 0), ok);
    }
}

}  // namespace mma_bf16
