// The resources of a loaded kernel as the runtime reports them, for the
// `*_resources` C entries of the backward libraries (flash_rel_attn_bwd.cu,
// chunked_window_attn_bwd.cu) that chip_smoke.py reads: registers, local
// bytes, dynamic shared memory and resident blocks per SM.
#pragma once
#include <cuda_runtime.h>

namespace kernel_resources {

// registers, local bytes, dynamic shared bytes, resident blocks per SM and
// threads per block of kernel `kern` launched with `smem` bytes and `nt`
// threads, into out[0..4]
template <typename K>
inline cudaError_t resources(K kern, size_t smem, int nt, int* out) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes at;
    err = cudaFuncGetAttributes(&at, kern);
    if (err != cudaSuccess) return err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, nt, smem);
    out[0] = at.numRegs;
    out[1] = (int)at.localSizeBytes;
    out[2] = (int)smem;
    out[3] = blocks;
    out[4] = nt;
    return err;
}

}  // namespace kernel_resources
