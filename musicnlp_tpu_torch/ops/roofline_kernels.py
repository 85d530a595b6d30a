"""The roofline microbenchmark kernels: K5 (the mask / softmax chain) and K6
(the multiply-add chain).

Counterpart of the two Pallas TPU kernels of `scripts/vpu_roofline.py`: K5
replaces `_mask_chain_kernel` (reached through `run_chain`) with the
hand-written CUDA C++ kernel `csrc/mask_chain.cu`, K6 replaces
`_muladd_kernel` (reached through `run_muladd`) with `csrc/muladd_chain.cu`.
Neither is on a training or inference path: `tools/vpu_roofline.py` runs them
to ask what share of K3's time its softmax chain takes on this card (K5 runs
the chain with the bf16 K3's arithmetic per element, within one bf16 ulp of
the plain version).

  * `mask_chain(s, kp, qp, K)`: K passes of K3's mask / softmax chain over
    s [G, M, C, 128] f32 with key positions kp [G, M, 128] and query
    positions qp [G, M, C] (int32), no dot products (see `mask_chain_plain`).
  * `muladd_chain(s, K)`: K dependent passes of acc = acc * 1.0000001 + s0.
  * `mask_chain_resources(device)`: K5's registers, local memory and
    occupancy on the card.
  The first two are wrappers: CPU tensors take the plain PyTorch versions
  (`*_plain`, the same per-pass arithmetic in a Python loop), CUDA tensors
  launch the kernel or raise, and any other device raises.  Each launch adds one to
  `LAUNCHES[<name>]`.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

__all__ = ['mask_chain', 'mask_chain_plain', 'mask_chain_resources', 'muladd_chain',
           'muladd_chain_plain', 'LAUNCHES', 'MULADD_FACTOR', 'W']

LAUNCHES = {'mask_chain': 0, 'muladd_chain': 0}
W = 128                                          # keys per row (2C of the 22-04 LSH kernel)
MULADD_FACTOR = float(np.float32(1.0000001))     # the f32 the TPU kernel multiplies by
_MASK_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_MULADD_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


# ------------------------------------------------------------- plain versions
def mask_chain_plain(s: torch.Tensor, kp: torch.Tensor, qp: torch.Tensor, K: int
                     ) -> torch.Tensor:
    """K5's function in plain PyTorch: from acc = s, K times
        x = (s + acc * 1e-6) * 0.125;  x += 1e4 where kp == qp;  x = -1e9 where kp > qp
        p = exp(x - max_W x);  l = max(sum_W p, 1e-30);  acc = f32(bf16(p / l))."""
    valid = kp[:, :, None, :] <= qp[:, :, :, None]
    self_ = kp[:, :, None, :] == qp[:, :, :, None]
    acc = s
    for _ in range(K):
        x = (s + acc * 1e-6) * 0.125
        x = torch.where(valid, torch.where(self_, x + 1e4, x), -1e9)
        p = torch.exp(x - x.amax(dim=-1, keepdim=True))
        l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        acc = (p / l).to(torch.bfloat16).float()
    return acc


def muladd_chain_plain(s: torch.Tensor, K: int) -> torch.Tensor:
    """K6's function in plain PyTorch: from acc = s, K times acc = acc * 1.0000001 + s,
    each pass one fused multiply-add.  The f32 product is exact in f64, and so
    is its sum with s (acc and s share a sign and |acc| is about (K+1)|s|, so
    the sum spans under 53 bits): the one rounding to f32 is the FMA's, bit
    for bit."""
    s64 = s.double()
    acc = s
    for _ in range(K):
        acc = (acc.double() * MULADD_FACTOR + s64).float()
    return acc


# ----------------------------------------------------------------- wrappers
def _cuda_ready(name: str, tensors, dtypes) -> torch.device:
    """Checks CUDA inputs for a launch -> their device."""
    dev = tensors[0].device
    if dev.type != 'cuda' or any(t.device != dev for t in tensors):
        raise ValueError(f'{name}: all inputs on one CUDA device, or all on CPU')
    if any(t.dtype != d for t, d in zip(tensors, dtypes)):
        raise TypeError(f'{name} takes {dtypes}, got {[t.dtype for t in tensors]}')
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError(f'{name} takes contiguous, 16-byte aligned inputs')
    return dev


def mask_chain(s: torch.Tensor, kp: torch.Tensor, qp: torch.Tensor, K: int) -> torch.Tensor:
    """K5: K passes of the mask / softmax chain -> acc [G, M, C, 128] f32.

    s [G, M, C, 128] f32; kp int32 [G, M, 128]; qp int32 [G, M, C]; K >= 0."""
    if s.dim() != 4 or s.shape[-1] != W:
        raise ValueError(f's is [G, M, C, {W}], got {tuple(s.shape)}')
    G, M, C, _ = s.shape
    if kp.shape != (G, M, W) or qp.shape != (G, M, C):
        raise ValueError(f'kp is [G, M, {W}] and qp [G, M, C] for s {tuple(s.shape)}: '
                         f'{tuple(kp.shape)} {tuple(qp.shape)}')
    if K < 0:
        raise ValueError(f'K = {K} passes')
    if all(t.device.type == 'cpu' for t in (s, kp, qp)):
        return mask_chain_plain(s, kp, qp, K)
    dev = _cuda_ready('K5', (s, kp, qp), (torch.float32, torch.int32, torch.int32))
    out = torch.empty_like(s)
    from musicnlp_tpu_torch.kernels.build import load
    lib = load('mask_chain', _MASK_ARGTYPES)
    with torch.cuda.device(dev):
        err = lib.mask_chain(s.data_ptr(), kp.data_ptr(), qp.data_ptr(), out.data_ptr(), G, M,
                             C, W, int(K), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'mask_chain launch failed: CUDA error {err}')
    LAUNCHES['mask_chain'] += 1
    return out


def mask_chain_resources(device) -> dict:
    """K5's kernel on a CUDA device: registers per thread, local-memory bytes
    per thread (stack and spills; 0 when nothing spills) and blocks resident
    on one SM at once, as the loaded library reports them."""
    from musicnlp_tpu_torch.kernels.build import load
    fn = load('mask_chain', _MASK_ARGTYPES).mask_chain_resources
    fn.argtypes, fn.restype = [ctypes.POINTER(ctypes.c_int)], ctypes.c_int
    res = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        err = fn(res)
    if err:
        raise RuntimeError(f'mask_chain resource query failed: CUDA error {err}')
    return dict(registers=res[0], local_bytes=res[1], blocks_per_sm=res[2])


def muladd_chain(s: torch.Tensor, K: int) -> torch.Tensor:
    """K6: K dependent passes of acc = acc * 1.0000001 + s -> acc, f32 of s's shape."""
    if K < 0 or s.numel() == 0:
        raise ValueError(f'K = {K} passes over {s.numel()} elements')
    if s.device.type == 'cpu':
        return muladd_chain_plain(s, K)
    dev = _cuda_ready('K6', (s,), (torch.float32,))
    out = torch.empty_like(s)
    from musicnlp_tpu_torch.kernels.build import load
    lib = load('muladd_chain', _MULADD_ARGTYPES)
    with torch.cuda.device(dev):
        err = lib.muladd_chain(s.data_ptr(), out.data_ptr(), s.numel(), int(K),
                               torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'muladd_chain launch failed: CUDA error {err}')
    LAUNCHES['muladd_chain'] += 1
    return out
