"""Fused Transformer-XL relative attention: kernels K1 and K2 and their wrappers.

Counterpart of `musicnlp_tpu/ops/pallas/flash_attention.py`.  K1 replaces the
Pallas TPU kernel `flash_attention.py::_make_fwd` (reached through `_fwd_call`,
`flash_rel_attn` and `fused_rel_attn`) with a hand-written CUDA C++ kernel for
Hopper, `csrc/flash_rel_attn_fwd.cu`: an online-softmax (flash) forward that
never writes a [T, S] score tensor to device memory.  K2 replaces the fused
backward `_make_bwd_fused` (reached through `_flash_bwd`) with
`csrc/flash_rel_attn_bwd.cu`.

  * `flash_rel_attn_fwd` / `flash_rel_attn_bwd` are the wrappers.  For CPU
    tensors they compute the plain PyTorch versions (`*_plain`); for CUDA
    tensors they launch the kernel or raise -- they never fall back.  Each
    call that launches adds one to `LAUNCHES[<name>]`.
  * `FlashRelAttn` is the autograd Function: K1 forward, K2 backward.
  * `fused_rel_attn` is the drop-in for `ops.attention.rel_attn` around it:
    projections, the distance table, output projection, residual, layer norm.
  * The kernels take head dims 16, 32, 64 and 128 (`SMALL_HEAD_DIMS`) and
    every multiple of 128 (`takes_head_dim`) in f32, bf16 and f16.
    `fused_rel_attn` zero-pads any other head dim to the next of them
    (`kernel_head_dim`: up to 128 the next small one, above it the next
    multiple of 128, the TPU kernels' lane padding; the scale stays the
    layer's), so every layer the JAX model's `_flash_ok` sends to its TPU
    kernel launches K1 / K2 here.

Bound on the H100 (SXM, 700 W): at the TF-XL base scoring shape (B*N = 96,
T = S = 1024, H = 64, bf16, causal) K1 must move ~66 MB (inputs read once,
ctx and lse written once: 0.0198 ms at 3.35 TB/s) and do ~19.3 GFLOP (three
H-long products per visible (q, k) pair: AC, BD and PV; 0.0196 ms at 989
TFLOP/s), so bytes and tensor-core operations bound it about equally.  K2
does 8 H-long products per visible pair, so operations bound it (see its
source).  K1 and K2 run every call on the tensor cores: bf16 and f16 up
to H 128 on `k1_tc`, `k2_dkdv_tc` / `k2_dq_tc` (mma.sync, 16-bit shared
tiles, cp.async; at H 128 two warps per 16-row group); f32 at every H, and
bf16 / f16 above 128, on the slab kernels `k1_slab`, `k2_dkdv_slab` /
`k2_dq_slab`, which stream the head dim in slabs of up to 64 columns, sum
the scores once per tile pair and apply them to each output slab a block
holds, f32 in 3xTF32 (each operand split into two TF32 parts, three
products: about f32 accuracy).
dtype and H pick the kernel inside each C entry point.

The distance table g_tab [N, T+S, H] stays a plain matmul outside the kernels
(as on the TPU): row u holds W_r^T R(clip((M+T-1) - u, 0, clamp_len)), so the
clamp is exact by construction, and BD[q, k] = rr[q] . g_tab[T-1-q+k].  K2
returns the table's gradient dG (summed over the batch); W_r's gradient
follows by autograd through `distance_table`.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from musicnlp_tpu_torch.ops.attention import NEG_INF, project_qkv
from musicnlp_tpu_torch.ops.layers import Params, dropout, layer_norm, sinusoid_pos_emb
from musicnlp_tpu_torch.parallel.mesh import Mesh, copy_to_model, sum_over_model

__all__ = ['flash_rel_attn_fwd', 'flash_rel_attn_fwd_plain', 'flash_rel_attn_bwd',
           'flash_rel_attn_bwd_plain', 'FlashRelAttn', 'fused_rel_attn', 'distance_table',
           'kernel_head_dim', 'takes_head_dim', 'LAUNCHES', 'SMALL_HEAD_DIMS', 'LANE',
           'gqa_attn_fwd', 'gqa_attn_fwd_plain', 'gqa_attn_bwd', 'gqa_attn_bwd_plain', 'GqaAttn']

LAUNCHES = {'flash_rel_attn_fwd': 0, 'flash_rel_attn_bwd': 0, 'gqa_attn_fwd': 0,
            'gqa_attn_bwd': 0}
SMALL_HEAD_DIMS = (16, 32, 64, 128)      # the head dims up to 128 the kernels take
LANE = 128                               # above 128, the kernels take multiples of it
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
                                                           ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 8
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_DELTA_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]

_GQA_FWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                                                   ctypes.c_void_p]
_GQA_BWD_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                                                   ctypes.c_void_p]

MemValid = Union[int, torch.Tensor]


def takes_head_dim(h: int) -> bool:
    """Whether K1-K4 take head dim h: 16, 32, 64, 128 or a multiple of 128."""
    return h in SMALL_HEAD_DIMS or (h > 0 and h % LANE == 0)


def kernel_head_dim(d_head: int) -> int:
    """The head dim the kernels run `d_head` at, the rest zero-padded: the
    smallest of `SMALL_HEAD_DIMS` that holds it, or above 128 the next
    multiple of 128 (the TPU kernels pad every head dim to lanes of 128)."""
    if d_head <= LANE:
        return next(h for h in SMALL_HEAD_DIMS if h >= d_head)
    return -(-d_head // LANE) * LANE


def _key_mask(T: int, S: int, M: int, mem_valid: MemValid, window: int, device):
    q = torch.arange(T, device=device)[:, None]
    k = torch.arange(S, device=device)[None, :]
    d = M + q - k
    ok = (d >= 0) & (k >= M - torch.as_tensor(mem_valid, device=device))
    if window:
        ok = ok & (d < window)
    return ok                                                          # [T, S]


def _scores_plain(rw3, rr3, k3, g_tab, mem_valid: MemValid, M: int, scale: float,
                  window: int):
    """The masked, scaled f32 scores [BN, T, S] K1 and K2 compute, and the
    gather index u [T, S] into the distance table."""
    BN, T, H = rw3.shape
    N = g_tab.shape[0]
    S = k3.shape[1]
    dev = rw3.device
    g = g_tab.float()[torch.arange(BN, device=dev) % N]               # [BN, T+S, H]
    s1 = rr3.float() @ g.transpose(1, 2)                              # [BN, T, T+S]
    u = (T - 1 - torch.arange(T, device=dev)[:, None]
         + torch.arange(S, device=dev)[None, :])
    bd = torch.gather(s1, 2, u.expand(BN, T, S))
    s = (rw3.float() @ k3.float().transpose(1, 2) + bd) * scale
    s = torch.where(_key_mask(T, S, M, mem_valid, window, dev), s,
                    torch.full_like(s, NEG_INF))
    return s, u


def flash_rel_attn_fwd_plain(rw3, rr3, k3, v3, g_tab, mem_valid: MemValid, *, M: int,
                             scale: float, window: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's function in plain PyTorch: (ctx [BN, T, H] in rw3's dtype, lse
    [BN, T] f32).  Products are exact f32 products of the inputs; p is rounded
    to v's dtype before the PV product, as the kernel does."""
    s, _ = _scores_plain(rw3, rr3, k3, g_tab, mem_valid, M, scale, window)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1), min=1e-30)
    ctx = (p.to(v3.dtype).float() @ v3.float()) / l[..., None]
    return ctx.to(rw3.dtype), m[..., 0] + torch.log(l)


def flash_rel_attn_bwd_plain(rw3, rr3, k3, v3, g_tab, out, d_out, lse, mem_valid: MemValid,
                             *, M: int, scale: float, window: int = 0):
    """K2's function in plain PyTorch -> (drw, drr [BN, T, H] in rw3's dtype,
    dk, dv [BN, S, H] f32, dG [N, T+S, H] f32 summed over the batch).

    With p = exp(s - lse), delta = sum(dO * O), ds = p (dO.v - delta) scale:
    drw = ds k, dk = ds^T rw, dv = p^T dO, drr[q] = sum_k ds G[u], dG[u] +=
    ds rr[q].  p and ds are rounded to the input dtype before the products,
    as the kernel (and the TPU kernel) does; sums are f32."""
    BN, T, H = rw3.shape
    N = g_tab.shape[0]
    S = k3.shape[1]
    dtype = rw3.dtype
    s, u = _scores_plain(rw3, rr3, k3, g_tab, mem_valid, M, scale, window)
    p = torch.exp(s - lse[..., None])
    do = d_out.float()
    delta = (do * out.float()).sum(-1, keepdim=True)
    ds = p * (do @ v3.float().transpose(1, 2) - delta) * scale
    dsg = ds.to(dtype).float()
    drw = dsg @ k3.float()
    dk = dsg.transpose(1, 2) @ rw3.float()
    dv = p.to(dtype).float().transpose(1, 2) @ do
    # ds on the distance axis: row q of dS1 holds ds[q, k] at column u(q, k)
    ds1 = torch.zeros(BN, T, T + S, dtype=torch.float32, device=rw3.device)
    ds1.scatter_(2, u.expand(BN, T, S), dsg)
    g = g_tab.float()[torch.arange(BN, device=rw3.device) % N]
    drr = ds1 @ g
    dg = (ds1.transpose(1, 2) @ rr3.float()).reshape(BN // N, N, T + S, H).sum(0)
    return drw.to(dtype), drr.to(dtype), dk, dv, dg


def _check(rw3, rr3, k3, v3, g_tab, M: int):
    if rw3.dim() != 3 or k3.dim() != 3 or g_tab.dim() != 3:
        raise ValueError('rw3/rr3 [BN, T, H], k3/v3 [BN, S, H], g_tab [N, T+S, H]')
    BN, T, H = rw3.shape
    S = k3.shape[1]
    N = g_tab.shape[0]
    if rr3.shape != rw3.shape or v3.shape != k3.shape or k3.shape[::2] != (BN, H):
        raise ValueError(f'shape mismatch: rw {tuple(rw3.shape)} rr {tuple(rr3.shape)} '
                         f'k {tuple(k3.shape)} v {tuple(v3.shape)}')
    if g_tab.shape[1:] != (T + S, H) or BN % N:
        raise ValueError(f'g_tab {tuple(g_tab.shape)} does not fit BN={BN} T={T} S={S}')
    if not 0 <= M <= S:
        raise ValueError(f'memory length M={M} outside [0, S={S}]')


def _launch_args(name: str, tensors, mem_valid: MemValid):
    """Checks CUDA inputs for a kernel launch -> (device, dtype code, mv_ptr,
    mv_const)."""
    dev = tensors[0].device
    if dev.type != 'cuda' or any(t.device != dev for t in tensors):
        raise ValueError(f'{name}: all inputs on one CUDA device, or all on CPU')
    dtype = tensors[0].dtype
    if dtype not in _DTYPE_CODE or any(t.dtype != dtype for t in tensors):
        raise TypeError(f'{name} takes float32, bfloat16 or float16 inputs of one dtype, got '
                        f'{[t.dtype for t in tensors]}')
    H = tensors[0].shape[-1]
    if not takes_head_dim(H):
        raise ValueError(f'{name} takes head dims {SMALL_HEAD_DIMS} and multiples of {LANE}, '
                         f'got {H}')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f'{name} takes contiguous inputs')
    if isinstance(mem_valid, torch.Tensor):
        if mem_valid.device != dev or mem_valid.dtype != torch.int32 or mem_valid.numel() != 1:
            raise ValueError('a tensor mem_valid is one int32 on the inputs\' device')
        return dev, _DTYPE_CODE[dtype], mem_valid.data_ptr(), 0
    return dev, _DTYPE_CODE[dtype], None, int(mem_valid)


def flash_rel_attn_fwd(rw3: torch.Tensor, rr3: torch.Tensor, k3: torch.Tensor,
                       v3: torch.Tensor, g_tab: torch.Tensor, mem_valid: MemValid, *,
                       M: int, scale: float, window: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: fused TF-XL attention core -> (ctx [BN, T, H], lse [BN, T] f32).

    rw3/rr3 [BN, T, H] queries plus r_w_bias / r_r_bias; k3/v3 [BN, S, H]
    (S = M + T with memory); g_tab [N, T+S, H] (`distance_table`);
    mem_valid an int or a 0-d int tensor on the inputs' device (read inside
    the kernel, never synchronised); window 0 = none.  No gradient flows
    through this call: `FlashRelAttn` pairs it with K2."""
    _check(rw3, rr3, k3, v3, g_tab, M)
    tensors = (rw3, rr3, k3, v3, g_tab)
    if all(t.device.type == 'cpu' for t in tensors):
        return flash_rel_attn_fwd_plain(rw3, rr3, k3, v3, g_tab, mem_valid, M=M,
                                         scale=scale, window=window)
    dev, code, mv_ptr, mv_const = _launch_args('K1', tensors, mem_valid)
    BN, T, H = rw3.shape
    S = k3.shape[1]
    out = torch.empty_like(rw3)
    lse = torch.empty(BN, T, dtype=torch.float32, device=dev)
    from musicnlp_tpu_torch.kernels.build import load
    lib = load('flash_rel_attn_fwd', _ARGTYPES)
    with torch.cuda.device(dev):     # launch on the inputs' device and its stream
        err = lib.flash_rel_attn_fwd(
            rw3.data_ptr(), rr3.data_ptr(), k3.data_ptr(), v3.data_ptr(), g_tab.data_ptr(),
            out.data_ptr(), lse.data_ptr(), mv_ptr, mv_const, BN, g_tab.shape[0], T, S, M,
            H, code, float(scale), int(window or 0),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'flash_rel_attn_fwd launch failed: CUDA error {err}')
    LAUNCHES['flash_rel_attn_fwd'] += 1
    return out, lse


def flash_rel_attn_bwd(rw3: torch.Tensor, rr3: torch.Tensor, k3: torch.Tensor,
                       v3: torch.Tensor, g_tab: torch.Tensor, out: torch.Tensor,
                       d_out: torch.Tensor, lse: torch.Tensor, mem_valid: MemValid, *,
                       M: int, scale: float, window: int = 0):
    """K2: backward of `flash_rel_attn_fwd` -> (drw, drr [BN, T, H] in the
    inputs' dtype, dk, dv [BN, S, H] f32, dG [N, T+S, H] f32 summed over the
    batch).  out is K1's ctx, d_out its gradient (both [BN, T, H] in the
    inputs' dtype), lse K1's f32 [BN, T]."""
    _check(rw3, rr3, k3, v3, g_tab, M)
    tensors = (rw3, rr3, k3, v3, g_tab, out, d_out)
    if out.shape != rw3.shape or d_out.shape != rw3.shape or lse.shape != rw3.shape[:2]:
        raise ValueError(f'out {tuple(out.shape)}, d_out {tuple(d_out.shape)} and lse '
                         f'{tuple(lse.shape)} do not fit rw {tuple(rw3.shape)}')
    if all(t.device.type == 'cpu' for t in tensors + (lse,)):
        return flash_rel_attn_bwd_plain(rw3, rr3, k3, v3, g_tab, out, d_out, lse, mem_valid,
                                        M=M, scale=scale, window=window)
    dev, code, mv_ptr, mv_const = _launch_args('K2', tensors, mem_valid)
    if lse.device != dev or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError('K2 takes lse as contiguous f32 on the inputs\' device')
    BN, T, H = rw3.shape
    N = g_tab.shape[0]
    S = k3.shape[1]
    delta = torch.empty(BN, T, dtype=torch.float32, device=dev)        # dO . O, f32
    drw, drr = torch.empty_like(rw3), torch.empty_like(rw3)
    dk = torch.empty(BN, S, H, dtype=torch.float32, device=dev)
    dv = torch.empty_like(dk)
    dg = torch.zeros(N, T + S, H, dtype=torch.float32, device=dev)
    from musicnlp_tpu_torch.kernels.build import load
    lib = load('flash_rel_attn_bwd', _BWD_ARGTYPES)
    lib.flash_rel_attn_bwd_delta.argtypes = _DELTA_ARGTYPES
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_rel_attn_bwd_delta(d_out.data_ptr(), out.data_ptr(), delta.data_ptr(),
                                           BN * T, H, code, stream)
        err = err or lib.flash_rel_attn_bwd(
            rw3.data_ptr(), rr3.data_ptr(), k3.data_ptr(), v3.data_ptr(), g_tab.data_ptr(),
            d_out.data_ptr(), lse.data_ptr(), delta.data_ptr(), drw.data_ptr(),
            drr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dg.data_ptr(), mv_ptr, mv_const,
            BN, N, T, S, M, H, code, float(scale), int(window or 0), stream)
    if err != 0:
        raise RuntimeError(f'flash_rel_attn_bwd launch failed: CUDA error {err}')
    LAUNCHES['flash_rel_attn_bwd'] += 1
    return drw, drr, dk, dv, dg


class FlashRelAttn(torch.autograd.Function):
    """ctx [BN, T, H] = the TF-XL attention core, K1 forward and K2 backward.
    Gradients flow to rw3, rr3, k3, v3 and g_tab."""

    @staticmethod
    def forward(ctx, rw3, rr3, k3, v3, g_tab, mem_valid, M: int, scale: float, window: int):
        out, lse = flash_rel_attn_fwd(rw3, rr3, k3, v3, g_tab, mem_valid, M=M, scale=scale,
                                      window=window)
        ctx.save_for_backward(rw3, rr3, k3, v3, g_tab, out, lse)
        ctx.mem_valid, ctx.M, ctx.scale, ctx.window = mem_valid, M, scale, window
        return out

    @staticmethod
    def backward(ctx, d_out):
        rw3, rr3, k3, v3, g_tab, out, lse = ctx.saved_tensors
        # autograd hands a strided view (the head transpose after the call)
        d_out = d_out.to(rw3.dtype).contiguous()
        drw, drr, dk, dv, dg = flash_rel_attn_bwd(
            rw3, rr3, k3, v3, g_tab, out, d_out, lse, ctx.mem_valid, M=ctx.M,
            scale=ctx.scale, window=ctx.window)
        return (drw, drr, dk.to(k3.dtype), dv.to(v3.dtype), dg.to(g_tab.dtype),
                None, None, None, None)


# ------------------------------------------------- the grouped-query form
# K1 / K2 without the distance term, for G query heads that share one key /
# value head (grouped-query attention): q [BN, T, H] (row bn = b N + h), k /
# v [BN / G, T, H], query row bn reading key row bn / G; causal, no memory;
# `window` > 0 keeps 0 <= q - k < window (a sliding layer), 0 the causal mask
# alone (a full layer).  On the card the kernels `k1_gqa_tc` (forward) and
# `k2_gqa_dkdv_tc` / `k2_gqa_dq_tc` (backward) in the K1 / K2 sources for
# bf16 and f16 up to head dim 128, their slab forms (`k1_gqa_slab`,
# `k2_gqa_dkdv_slab` / `k2_gqa_dq_slab`) for f32 (3xTF32) and for multiples
# of 128 above it, the head dims K1 / K2 take; each key head's dk / dv are
# summed over its G query heads inside the dk / dv kernel.
def _gqa_check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, G: int):
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f'q [BN, T, H], k / v [BN / G, T, H], got q {tuple(q.shape)} '
                         f'k {tuple(k.shape)} v {tuple(v.shape)}')
    BN, T, H = q.shape
    if G < 1 or BN % G or k.shape != (BN // G, T, H):
        raise ValueError(f'k {tuple(k.shape)} does not fit q {tuple(q.shape)} at group {G}')


def _gqa_scores_plain(q, k, G: int, scale: float, window: int):
    """The masked, scaled f32 scores [BN, T, T] of the grouped-query form."""
    T = q.shape[1]
    s = (q.float() @ k.float().repeat_interleave(G, dim=0).transpose(1, 2)) * scale
    return torch.where(_key_mask(T, T, 0, 0, window, q.device), s, torch.full_like(s, NEG_INF))


def gqa_attn_fwd_plain(q, k, v, *, G: int, scale: float, window: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The grouped-query forward in plain PyTorch: (ctx [BN, T, H] in q's
    dtype, lse [BN, T] f32); p rounded to v's dtype before the PV product,
    as the kernel does."""
    s = _gqa_scores_plain(q, k, G, scale, window)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1), min=1e-30)
    ctx = (p.to(v.dtype).float() @ v.float().repeat_interleave(G, dim=0)) / l[..., None]
    return ctx.to(q.dtype), m[..., 0] + torch.log(l)


def gqa_attn_bwd_plain(q, k, v, out, d_out, lse, *, G: int, scale: float, window: int = 0):
    """The grouped-query backward in plain PyTorch -> (dq [BN, T, H] in q's
    dtype, dk, dv [BN / G, T, H] f32, each the sum over the key head's G
    query heads).  p and ds rounded to the input dtype before the products,
    as the kernels do; sums are f32."""
    BN, T, H = q.shape
    dtype = q.dtype
    s = _gqa_scores_plain(q, k, G, scale, window)
    p = torch.exp(s - lse[..., None])
    do = d_out.float()
    delta = (do * out.float()).sum(-1, keepdim=True)
    ds = p * (do @ v.float().repeat_interleave(G, dim=0).transpose(1, 2) - delta) * scale
    dsg = ds.to(dtype).float()
    dq = dsg @ k.float().repeat_interleave(G, dim=0)
    dk = (dsg.transpose(1, 2) @ q.float()).reshape(BN // G, G, T, H).sum(1)
    dv = (p.to(dtype).float().transpose(1, 2) @ do).reshape(BN // G, G, T, H).sum(1)
    return dq.to(dtype), dk, dv


def gqa_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, G: int, scale: float,
                 window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The grouped-query forward -> (ctx [BN, T, H], lse [BN, T] f32): the
    plain version for CPU tensors, `k1_gqa_tc` / `k1_gqa_slab` for CUDA
    tensors (or it raises).  No gradient flows through this call: `GqaAttn` pairs it with
    `gqa_attn_bwd`."""
    _gqa_check(q, k, v, G)
    if all(t.device.type == 'cpu' for t in (q, k, v)):
        return gqa_attn_fwd_plain(q, k, v, G=G, scale=scale, window=window)
    dev, code, _, _ = _launch_args('gqa_attn_fwd', (q, k, v), 0)
    BN, T, H = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(BN, T, dtype=torch.float32, device=dev)
    from musicnlp_tpu_torch.kernels.build import load
    lib = load('flash_rel_attn_fwd', _ARGTYPES)
    lib.gqa_attn_fwd.argtypes = _GQA_FWD_ARGTYPES
    with torch.cuda.device(dev):
        err = lib.gqa_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                               lse.data_ptr(), BN, G, T, H, code, float(scale),
                               int(window or 0), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'gqa_attn_fwd launch failed: CUDA error {err}')
    LAUNCHES['gqa_attn_fwd'] += 1
    return out, lse


def gqa_attn_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                 d_out: torch.Tensor, lse: torch.Tensor, *, G: int, scale: float,
                 window: int = 0):
    """The grouped-query backward -> (dq [BN, T, H] in q's dtype, dk, dv
    [BN / G, T, H] f32): the plain version for CPU tensors, the dk / dv and dq
    kernels (`k2_gqa_*_tc`, `k2_gqa_*_slab`) for CUDA tensors (or it raises).  out is the
    forward's ctx, d_out its gradient, lse its f32 [BN, T]."""
    _gqa_check(q, k, v, G)
    if out.shape != q.shape or d_out.shape != q.shape or lse.shape != q.shape[:2]:
        raise ValueError(f'out {tuple(out.shape)}, d_out {tuple(d_out.shape)} and lse '
                         f'{tuple(lse.shape)} do not fit q {tuple(q.shape)}')
    tensors = (q, k, v, out, d_out)
    if all(t.device.type == 'cpu' for t in tensors + (lse,)):
        return gqa_attn_bwd_plain(q, k, v, out, d_out, lse, G=G, scale=scale, window=window)
    dev, code, _, _ = _launch_args('gqa_attn_bwd', tensors, 0)
    if lse.device != dev or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError('gqa_attn_bwd takes lse as contiguous f32 on the inputs\' device')
    BN, T, H = q.shape
    delta = torch.empty(BN, T, dtype=torch.float32, device=dev)        # dO . O, f32
    dq = torch.empty_like(q)
    dk = torch.empty(BN // G, T, H, dtype=torch.float32, device=dev)
    dv = torch.empty_like(dk)
    from musicnlp_tpu_torch.kernels.build import load
    lib = load('flash_rel_attn_bwd', _BWD_ARGTYPES)
    lib.flash_rel_attn_bwd_delta.argtypes = _DELTA_ARGTYPES
    lib.gqa_attn_bwd.argtypes = _GQA_BWD_ARGTYPES
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_rel_attn_bwd_delta(d_out.data_ptr(), out.data_ptr(), delta.data_ptr(),
                                           BN * T, H, code, stream)
        err = err or lib.gqa_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), d_out.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), BN, G, T, H, code,
            float(scale), int(window or 0), stream)
    if err != 0:
        raise RuntimeError(f'gqa_attn_bwd launch failed: CUDA error {err}')
    LAUNCHES['gqa_attn_bwd'] += 1
    return dq, dk, dv


class GqaAttn(torch.autograd.Function):
    """ctx [BN, T, H] = causal grouped-query attention (query row bn reads
    key / value row bn / G), `gqa_attn_fwd` forward and `gqa_attn_bwd`
    backward.  Gradients flow to q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, G: int, scale: float, window: int):
        out, lse = gqa_attn_fwd(q, k, v, G=G, scale=scale, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.G, ctx.scale, ctx.window = G, scale, window
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        d_out = d_out.to(q.dtype).contiguous()
        dq, dk, dv = gqa_attn_bwd(q, k, v, out, d_out, lse, G=ctx.G, scale=ctx.scale,
                                  window=ctx.window)
        return dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None


def distance_table(Wr: torch.Tensor, T: int, S: int, M: int, clamp_len: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """g_tab [N, T+S, H]: row u = W_r^T R(d), d = clip((M+T-1) - u, 0, clamp_len)
    (rows ordered by decreasing distance; rows with d < 0 are masked)."""
    d_model, n_head, d_head = Wr.shape
    d = (M + T - 1) - torch.arange(T + S, device=Wr.device)
    d = torch.clamp(d, min=0, max=clamp_len if clamp_len > 0 else None)
    r = sinusoid_pos_emb(d.float(), d_model, dtype)                      # [T+S, D]
    g = (r @ Wr.to(dtype).reshape(d_model, -1)).reshape(T + S, n_head, d_head)
    return g.permute(1, 0, 2).contiguous()


def fused_rel_attn(
        p: Params, x: torch.Tensor, mems: Optional[torch.Tensor], mem_valid: MemValid,
        *, clamp_len: int, pre_lnorm: bool = False, scale: Optional[float] = None,
        dropout_rate: float = 0.0, generator: Optional[torch.Generator] = None,
        deterministic: bool = True, window: Optional[int] = None,
        mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """Drop-in fused replacement for ops.attention.rel_attn, differentiable
    through K1 / K2.  Over `mesh`'s model axis K1 / K2 run this rank's
    heads (the leaves' shapes say how many) and the output projection's
    partial products are summed over `model`, as in `rel_attn`.  Like the TPU kernels it has no attention-probability
    dropout and no key padding mask (the JAX model sends those cases to the
    plain `rel_attn`).  A head dim the kernels do not take runs zero-padded
    to `kernel_head_dim` at the layer's own scale 1/sqrt(d_head): the padded
    columns add nothing to a score, their context columns are dropped, and
    their gradients are zero."""
    dtype = x.dtype
    B, T, d_model = x.shape
    n_head, d_head = p['r_w_bias'].shape
    scale = scale if scale is not None else 1.0 / (d_head ** 0.5)

    inp = x
    if pre_lnorm:
        x = layer_norm(p['ln'], x)
    if mems is not None:
        M = mems.shape[1]
        cat = torch.cat([mems.to(dtype), x], dim=1)
    else:
        M = 0
        cat = x
    S = M + T
    q, k, v = project_qkv(p, copy_to_model(cat, mesh), T, dtype)
    rw = q + p['r_w_bias'].to(dtype)
    rr = q + p['r_r_bias'].to(dtype)

    BN = B * n_head
    # reshape alone may return a strided view (B = 1); the kernel takes dense rows
    rw3 = rw.transpose(1, 2).reshape(BN, T, d_head).contiguous()
    rr3 = rr.transpose(1, 2).reshape(BN, T, d_head).contiguous()
    k3 = k.transpose(1, 2).reshape(BN, S, d_head).contiguous()
    v3 = v.transpose(1, 2).reshape(BN, S, d_head).contiguous()
    g_tab = distance_table(p['r'], T, S, M, clamp_len, dtype)
    pad = kernel_head_dim(d_head) - d_head
    if pad:
        rw3, rr3, k3, v3, g_tab = (F.pad(t, (0, pad)) for t in (rw3, rr3, k3, v3, g_tab))

    ctx3 = FlashRelAttn.apply(rw3, rr3, k3, v3, g_tab, mem_valid, M, scale, int(window or 0))
    if pad:
        ctx3 = ctx3[..., :d_head]
    ctx = ctx3.reshape(B, n_head, T, d_head).transpose(1, 2).reshape(B, T, -1)
    out = sum_over_model((ctx @ p['o'].to(dtype).reshape(-1, d_model)).to(dtype), mesh)
    out = dropout(out, dropout_rate, generator, deterministic)
    out = inp + out
    if not pre_lnorm:
        out = layer_norm(p['ln'], out)
    return out
