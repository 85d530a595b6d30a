"""Chunked-window attention (the Reformer's local and LSH windows): kernels K3 and K4.

Counterpart of `musicnlp_tpu/ops/pallas/chunked_attention_kernel.py`.  K3
replaces the Pallas TPU kernel `_make_fwd` (reached through `_fwd_call` and
`chunked_window_attn`) with a hand-written CUDA C++ kernel for Hopper,
`csrc/chunked_window_attn_fwd.cu`; K4 replaces its backward `_make_bwd`
(reached through `_core_bwd`) with `csrc/chunked_window_attn_bwd.cu`.  The
TPU's second staging of the same math (`form='twodot'`) is not ported.

What both compute, per row g of G and query t (chunk c, n = T / c chunks):
each query of chunk i attends the keys of chunks i-1 and i (the window;
chunk 0 has no look-back: zero keys and values, masked);
    s = (q . k) * scale,   valid where kpos <= qpos, self_bias added where
    kpos == qpos, masked entries set to NEG_INF = -1e9 (finite: a query whose
    whole window is masked gets the window's uniform average, not NaN);
    ctx = softmax(s) @ v  (p rounded to v's dtype before the product),
    lse = max + log(sum)  (f32, kept f32: the TPU packs it into bf16 lanes).
Padding is the caller's: kpos = T for a pad key makes it invisible to every
query; pad queries keep their positions.

  * `chunked_window_attn_fwd` / `chunked_window_attn_bwd` are the kernel
    wrappers.  For CPU tensors they compute the plain PyTorch versions
    (`*_plain`); for CUDA tensors they launch the kernel or raise -- they
    never fall back.  Each call that launches adds one to `LAUNCHES[<name>]`.
  * `ChunkedWindowAttn` is the autograd Function (K3 forward, K4 backward);
    `chunked_window_attn` applies it with the JAX package's signature.  Both
    outputs carry gradients: the LSH round combine differentiates lse.
  * The kernels take any chunk that divides T and the head dims of K1 / K2
    (`flash_attention.takes_head_dim`: 16, 32, 64, 128 and every multiple of
    128) in f32, bf16 and f16, which covers every call the JAX `_kernel_ok`
    sends to its TPU kernel (chunk and head dim multiples of 8) once
    `ops/chunked_attention` zero-pads a head dim to the next of them
    (`kernel_head_dim`).

Bound on the H100 (SXM, 700 W): at the 22-04 LSH shape (G = 32*12*2 = 768,
T 2048, D 64, c 64, bf16) K3 moves ~0.82 GB (q, k, v, positions in; ctx and
lse out: 0.25 ms at 3.35 TB/s) for ~52 GFLOP (0.05 ms at 989 TFLOP/s), and
K4 ~1.8 GB (0.55 ms): both are bound by bytes.  K3 and K4 run every call
on the tensor cores.  bf16 and f16 up to head dim 128: at chunks 32 and 64
and head dims up to 64 over runs of consecutive chunks, each chunk loaded
once per run (mma.sync; `k3_tc`, `k4_tc`); every other chunk and head dim
128 over 64-row tiles of the windows (`k3_union_tc`; `k4_dq_tc` /
`k4_dkdv_tc`).  f32 at every head dim, and every dtype above 128, on the
slab walk (`k3_slab`; `k4_dq_slab` / `k4_dkdv_slab`; f32 in 3xTF32): the
tiled walk with the head dim streamed in slabs of up to 64 columns, the
scores summed once per tile pair and applied to each of the block's output
slabs, with each row's own key in the LSH layers scored as one sequential
f32 FMA chain over the whole head dim.
`chip_smoke.py` measures them against that bound.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from musicnlp_tpu_torch.ops.flash_attention import (LANE, SMALL_HEAD_DIMS, kernel_head_dim,
                                                   takes_head_dim)

__all__ = ['chunked_window_attn', 'chunked_window_attn_fwd', 'chunked_window_attn_fwd_plain',
           'chunked_window_attn_bwd', 'chunked_window_attn_bwd_plain', 'ChunkedWindowAttn',
           'kernel_head_dim', 'visible_pairs', 'LAUNCHES', 'NEG_INF']

LAUNCHES = {'chunked_window_attn_fwd': 0, 'chunked_window_attn_bwd': 0}
NEG_INF = -1e9
_NO_LOOKBACK = torch.iinfo(torch.int32).max
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_FWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [
    ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [
    ctypes.c_void_p]
_DELTA_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]


# ------------------------------------------------------------- plain versions
def _windows(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """[G, T, D] -> [G, n, 2c, D]: each chunk after the one before it
    (zeros before the first)."""
    G, T, D = x.shape
    xc = x.reshape(G, T // chunk, chunk, D)
    prev = torch.cat([torch.zeros_like(xc[:, :1]), xc[:, :-1]], dim=1)
    return torch.cat([prev, xc], dim=2)


def _pos_windows(kpos: torch.Tensor, chunk: int) -> torch.Tensor:
    """int [G, T] -> [G, n, 2c]; the missing look-back is INT32_MAX (masked)."""
    G, T = kpos.shape
    kc = kpos.reshape(G, T // chunk, chunk)
    prev = torch.cat([torch.full_like(kc[:, :1], _NO_LOOKBACK), kc[:, :-1]], dim=1)
    return torch.cat([prev, kc], dim=2)


def _masked_scores(q, k, qpos, kpos, chunk: int, scale: float, self_bias: float):
    """f32 [G, n, c, 2c] masked, scaled scores, as K3 and K4 compute them."""
    G, T, D = q.shape
    qc = q.reshape(G, T // chunk, chunk, D).float()
    s = qc @ _windows(k, chunk).float().transpose(-1, -2) * scale
    qp = qpos.reshape(G, T // chunk, chunk)[..., :, None]
    kp = _pos_windows(kpos, chunk)[..., None, :]
    if self_bias:
        s = torch.where(kp == qp, s + self_bias, s)       # kpos == qpos is always valid
    return torch.where(kp <= qp, s, torch.full_like(s, NEG_INF))


def visible_pairs(qpos: torch.Tensor, kpos: torch.Tensor, chunk: int) -> int:
    """Number of (query, key) pairs K3 and K4 attend for these positions."""
    G, T = qpos.shape
    qp = qpos.reshape(G, T // chunk, chunk)[..., :, None]
    return int((_pos_windows(kpos, chunk)[..., None, :] <= qp).sum())


def chunked_window_attn_fwd_plain(q, k, v, qpos, kpos, *, chunk: int, scale: float,
                                  self_bias: float = 0.0
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's function in plain PyTorch -> (ctx [G, T, D] in q's dtype, lse [G, T] f32)."""
    G, T, D = q.shape
    s = _masked_scores(q, k, qpos, kpos, chunk, scale, self_bias)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    ctx = (p.to(v.dtype).float() @ _windows(v, chunk).float()) / l
    return ctx.reshape(G, T, D).to(q.dtype), (m + torch.log(l)).reshape(G, T)


def chunked_window_attn_bwd_plain(q, k, v, qpos, kpos, out, d_out, lse, d_lse, *, chunk: int,
                                  scale: float, self_bias: float = 0.0):
    """K4's function in plain PyTorch -> (dq [G, T, D] in q's dtype, dk, dv f32).

    With p = exp(s - lse), delta = sum(dO * O), ds = p (dO.v - delta + dlse)
    scale: dq = ds k, dk = ds^T q, dv = p^T dO, each key's dk / dv summed
    over the two windows it belongs to.  p and ds are rounded to the input
    dtype before the products, as the kernel (and the TPU kernel) does."""
    G, T, D = q.shape
    n = T // chunk
    dtype = q.dtype
    p = torch.exp(_masked_scores(q, k, qpos, kpos, chunk, scale, self_bias)
                  - lse.reshape(G, n, chunk, 1))
    do = d_out.float().reshape(G, n, chunk, D)
    delta = (do * out.float().reshape(G, n, chunk, D)).sum(-1, keepdim=True)
    dp = do @ _windows(v, chunk).float().transpose(-1, -2)
    ds = p * (dp - delta + d_lse.float().reshape(G, n, chunk, 1)) * scale
    dsg, pg = ds.to(dtype).float(), p.to(dtype).float()
    dq = (dsg @ _windows(k, chunk).float()).reshape(G, T, D).to(dtype)
    dkw = dsg.transpose(-1, -2) @ q.float().reshape(G, n, chunk, D)     # [G, n, 2c, D]
    dvw = pg.transpose(-1, -2) @ do

    def fold(w):               # own half, plus the next chunk's look-back half
        own = w[:, :, chunk:].clone()
        own[:, :-1] += w[:, 1:, :chunk]
        return own.reshape(G, T, D)
    return dq, fold(dkw), fold(dvw)


# ----------------------------------------------------------------- wrappers
def _check(q, k, v, qpos, kpos, chunk: int):
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f'q, k, v are [G, T, D] of one shape: {tuple(q.shape)} '
                         f'{tuple(k.shape)} {tuple(v.shape)}')
    G, T, _ = q.shape
    if qpos.shape != (G, T) or kpos.shape != (G, T):
        raise ValueError(f'qpos / kpos are [G, T] = {(G, T)}: {tuple(qpos.shape)} '
                         f'{tuple(kpos.shape)}')
    if chunk <= 0 or T % chunk:
        raise ValueError(f'T = {T} is not a multiple of the chunk {chunk}')


def _cuda_args(name: str, floats, ints):
    """Checks CUDA inputs for a launch -> (device, dtype code)."""
    dev = floats[0].device
    if dev.type != 'cuda' or any(t.device != dev for t in floats + ints):
        raise ValueError(f'{name}: all inputs on one CUDA device, or all on CPU')
    dtype = floats[0].dtype
    if dtype not in _DTYPE_CODE or any(t.dtype != dtype for t in floats):
        raise TypeError(f'{name} takes float32, bfloat16 or float16 inputs of one dtype, got '
                        f'{[t.dtype for t in floats]}')
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError(f'{name} takes int32 positions')
    if not takes_head_dim(floats[0].shape[-1]):
        raise ValueError(f'{name} takes head dims {SMALL_HEAD_DIMS} and multiples of {LANE}, '
                         f'got {floats[0].shape[-1]}')
    if not all(t.is_contiguous() for t in floats + ints):
        raise ValueError(f'{name} takes contiguous inputs')
    return dev, _DTYPE_CODE[dtype]


def chunked_window_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            qpos: torch.Tensor, kpos: torch.Tensor, *, chunk: int,
                            scale: float, self_bias: float = 0.0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: windowed causal attention -> (ctx [G, T, D] in q's dtype, lse [G, T] f32).

    q/k/v [G, T, D]; qpos/kpos int32 [G, T] (kpos = T for a pad key).  No
    gradient flows through this call: `ChunkedWindowAttn` pairs it with K4."""
    _check(q, k, v, qpos, kpos, chunk)
    if all(t.device.type == 'cpu' for t in (q, k, v, qpos, kpos)):
        return chunked_window_attn_fwd_plain(q, k, v, qpos, kpos, chunk=chunk, scale=scale,
                                             self_bias=self_bias)
    dev, code = _cuda_args('K3', (q, k, v), (qpos, kpos))
    G, T, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(G, T, dtype=torch.float32, device=dev)
    from musicnlp_tpu_torch.kernels.build import load
    lib = load('chunked_window_attn_fwd', _FWD_ARGTYPES)
    with torch.cuda.device(dev):
        err = lib.chunked_window_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(), kpos.data_ptr(),
            out.data_ptr(), lse.data_ptr(), G, T, D, chunk, code, float(scale),
            float(self_bias), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'chunked_window_attn_fwd launch failed: CUDA error {err}')
    LAUNCHES['chunked_window_attn_fwd'] += 1
    return out, lse


def chunked_window_attn_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            qpos: torch.Tensor, kpos: torch.Tensor, out: torch.Tensor,
                            d_out: torch.Tensor, lse: torch.Tensor, d_lse: torch.Tensor, *,
                            chunk: int, scale: float, self_bias: float = 0.0):
    """K4: backward of `chunked_window_attn_fwd` -> (dq [G, T, D] in q's
    dtype, dk, dv [G, T, D] f32).  out is K3's ctx and d_out its gradient
    (both in q's dtype); lse K3's f32 [G, T] and d_lse its gradient."""
    _check(q, k, v, qpos, kpos, chunk)
    if out.shape != q.shape or d_out.shape != q.shape or lse.shape != qpos.shape or \
            d_lse.shape != qpos.shape:
        raise ValueError(f'out {tuple(out.shape)}, d_out {tuple(d_out.shape)}, lse '
                         f'{tuple(lse.shape)} and d_lse {tuple(d_lse.shape)} do not fit '
                         f'q {tuple(q.shape)}')
    tensors = (q, k, v, qpos, kpos, out, d_out, lse, d_lse)
    if all(t.device.type == 'cpu' for t in tensors):
        return chunked_window_attn_bwd_plain(q, k, v, qpos, kpos, out, d_out, lse, d_lse,
                                             chunk=chunk, scale=scale, self_bias=self_bias)
    dev, code = _cuda_args('K4', (q, k, v, out, d_out), (qpos, kpos))
    if any(t.device != dev or t.dtype != torch.float32 or not t.is_contiguous()
           for t in (lse, d_lse)):
        raise ValueError('K4 takes lse and d_lse as contiguous f32 on the inputs\' device')
    G, T, D = q.shape
    delta = torch.empty(G, T, dtype=torch.float32, device=dev)            # dO . O, f32
    dq = torch.empty_like(q)
    dk = torch.empty(G, T, D, dtype=torch.float32, device=dev)
    dv = torch.empty_like(dk)
    from musicnlp_tpu_torch.kernels.build import load
    lib = load('chunked_window_attn_bwd', _BWD_ARGTYPES)
    lib.chunked_window_attn_bwd_delta.argtypes = _DELTA_ARGTYPES
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.chunked_window_attn_bwd_delta(d_out.data_ptr(), out.data_ptr(),
                                                delta.data_ptr(), G * T, D, code, stream)
        err = err or lib.chunked_window_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), d_out.data_ptr(), qpos.data_ptr(),
            kpos.data_ptr(), lse.data_ptr(), delta.data_ptr(), d_lse.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), G, T, D, chunk, code,
            float(scale), float(self_bias), stream)
    if err != 0:
        raise RuntimeError(f'chunked_window_attn_bwd launch failed: CUDA error {err}')
    LAUNCHES['chunked_window_attn_bwd'] += 1
    return dq, dk, dv


class ChunkedWindowAttn(torch.autograd.Function):
    """(ctx, lse) = the windowed attention, K3 forward and K4 backward.
    Gradients flow to q, k and v from both outputs."""

    @staticmethod
    def forward(ctx, q, k, v, qpos, kpos, chunk: int, scale: float, self_bias: float):
        out, lse = chunked_window_attn_fwd(q, k, v, qpos, kpos, chunk=chunk, scale=scale,
                                           self_bias=self_bias)
        ctx.save_for_backward(q, k, v, qpos, kpos, out, lse)
        ctx.chunk, ctx.scale, ctx.self_bias = chunk, scale, self_bias
        return out, lse

    @staticmethod
    def backward(ctx, d_out, d_lse):
        q, k, v, qpos, kpos, out, lse = ctx.saved_tensors
        dq, dk, dv = chunked_window_attn_bwd(
            q, k, v, qpos, kpos, out, d_out.to(q.dtype).contiguous(), lse,
            d_lse.float().contiguous(), chunk=ctx.chunk, scale=ctx.scale,
            self_bias=ctx.self_bias)
        return dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None, None, None


def chunked_window_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        qpos: torch.Tensor, kpos: torch.Tensor, *, chunk: int, scale: float,
                        self_bias: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Windowed (own + look-back chunk) causal attention, differentiable
    through K3 / K4 (the JAX package's signature).

    q/k/v: [G, T, D]; qpos/kpos: int32 [G, T] (kpos = T for padding).
    Returns (ctx [G, T, D], lse f32 [G, T])."""
    return ChunkedWindowAttn.apply(q, k, v, qpos, kpos, chunk, float(scale), float(self_bias))

