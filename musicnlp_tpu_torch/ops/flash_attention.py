"""Fused Transformer-XL relative attention: kernel K1 and its wrapper.

Counterpart of `musicnlp_tpu/ops/pallas/flash_attention.py`.  K1 replaces the
Pallas TPU kernel `flash_attention.py::_make_fwd` (reached through `_fwd_call`,
`flash_rel_attn` and `fused_rel_attn`) with a hand-written CUDA C++ kernel for
Hopper, `csrc/flash_rel_attn_fwd.cu`: an online-softmax (flash) forward that
never writes a [T, S] score tensor to device memory.

  * `flash_rel_attn_fwd` is the wrapper.  For CPU tensors it computes the
    plain PyTorch version, `flash_rel_attn_fwd_plain`; for CUDA tensors it
    launches K1 or raises -- it never falls back.  Each launch adds one to
    `LAUNCHES['flash_rel_attn_fwd']`.
  * `fused_rel_attn` is the drop-in for `ops.attention.rel_attn` around it:
    projections, the distance table, output projection, residual, layer norm.

Bound on the H100 (SXM, 700 W): at the TF-XL base scoring shape (B*N = 96,
T = S = 1024, H = 64, bf16, causal) the kernel must move ~66 MB (inputs read
once, ctx and lse written once: 0.0198 ms at 3.35 TB/s) and do ~19.3 GFLOP
(three H-long products per visible (q, k) pair: AC, BD and PV; 0.0196 ms at
989 TFLOP/s), so bytes and tensor-core operations bound it about equally.
The first version computes with f32 FMAs from shared memory and is limited
by shared-memory reads (see the source note); moving the three contractions
onto mma/wgmma tiles is the step toward the bound.

The distance table g_tab [N, T+S, H] stays a plain matmul outside the kernel
(as on the TPU): row u holds W_r^T R(clip((M+T-1) - u, 0, clamp_len)), so the
clamp is exact by construction, and BD[q, k] = rr[q] . g_tab[T-1-q+k].
The backward (K2) comes with the training slice: the wrapper raises when a
gradient is asked for on CUDA.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from musicnlp_tpu_torch.ops.attention import NEG_INF, project_qkv
from musicnlp_tpu_torch.ops.layers import Params, dropout, layer_norm, sinusoid_pos_emb

__all__ = ['flash_rel_attn_fwd', 'flash_rel_attn_fwd_plain', 'fused_rel_attn',
           'distance_table', 'LAUNCHES', 'SUPPORTED_HEAD_DIMS']

LAUNCHES = {'flash_rel_attn_fwd': 0}
SUPPORTED_HEAD_DIMS = (16, 32, 64)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
                                                           ctypes.c_void_p])

MemValid = Union[int, torch.Tensor]


def _key_mask(T: int, S: int, M: int, mem_valid: MemValid, window: int, device):
    q = torch.arange(T, device=device)[:, None]
    k = torch.arange(S, device=device)[None, :]
    d = M + q - k
    ok = (d >= 0) & (k >= M - torch.as_tensor(mem_valid, device=device))
    if window:
        ok = ok & (d < window)
    return ok                                                          # [T, S]


def flash_rel_attn_fwd_plain(rw3, rr3, k3, v3, g_tab, mem_valid: MemValid, *, M: int,
                             scale: float, window: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's function in plain PyTorch: (ctx [BN, T, H] in rw3's dtype, lse
    [BN, T] f32).  Products are exact f32 products of the inputs; p is rounded
    to v's dtype before the PV product, as the kernel does."""
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
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1), min=1e-30)
    ctx = (p.to(v3.dtype).float() @ v3.float()) / l[..., None]
    return ctx.to(rw3.dtype), m[..., 0] + torch.log(l)


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


def flash_rel_attn_fwd(rw3: torch.Tensor, rr3: torch.Tensor, k3: torch.Tensor,
                       v3: torch.Tensor, g_tab: torch.Tensor, mem_valid: MemValid, *,
                       M: int, scale: float, window: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: fused TF-XL attention core -> (ctx [BN, T, H], lse [BN, T] f32).

    rw3/rr3 [BN, T, H] queries plus r_w_bias / r_r_bias; k3/v3 [BN, S, H]
    (S = M + T with memory); g_tab [N, T+S, H] (`distance_table`);
    mem_valid an int or a 0-d int tensor on the inputs' device (read inside
    the kernel, never synchronised); window 0 = none."""
    _check(rw3, rr3, k3, v3, g_tab, M)
    tensors = (rw3, rr3, k3, v3, g_tab)
    if all(t.device.type == 'cpu' for t in tensors):
        return flash_rel_attn_fwd_plain(rw3, rr3, k3, v3, g_tab, mem_valid, M=M,
                                         scale=scale, window=window)
    dev = rw3.device
    if dev.type != 'cuda' or any(t.device != dev for t in tensors):
        raise ValueError('flash_rel_attn_fwd: all inputs on one CUDA device, or all on CPU')
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError('K1 has no backward yet (K2 comes with the training '
                                  'slice); call it under torch.no_grad()')
    dtype = rw3.dtype
    if dtype not in _DTYPE_CODE or any(t.dtype != dtype for t in tensors):
        raise TypeError(f'K1 takes float32 or bfloat16 inputs of one dtype, got '
                        f'{[t.dtype for t in tensors]}')
    BN, T, H = rw3.shape
    if H not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f'K1 takes head dims {SUPPORTED_HEAD_DIMS}, got {H}')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('K1 takes contiguous inputs')
    if isinstance(mem_valid, torch.Tensor):
        if mem_valid.device != dev or mem_valid.dtype != torch.int32 or mem_valid.numel() != 1:
            raise ValueError('a tensor mem_valid is one int32 on the inputs\' device')
        mv_ptr, mv_const = mem_valid.data_ptr(), 0
    else:
        mv_ptr, mv_const = None, int(mem_valid)
    S = k3.shape[1]
    out = torch.empty_like(rw3)
    lse = torch.empty(BN, T, dtype=torch.float32, device=dev)
    from musicnlp_tpu_torch.kernels.build import load
    lib = load('flash_rel_attn_fwd', _ARGTYPES)
    with torch.cuda.device(dev):     # launch on the inputs' device and its stream
        err = lib.flash_rel_attn_fwd(
            rw3.data_ptr(), rr3.data_ptr(), k3.data_ptr(), v3.data_ptr(), g_tab.data_ptr(),
            out.data_ptr(), lse.data_ptr(), mv_ptr, mv_const, BN, g_tab.shape[0], T, S, M,
            H, _DTYPE_CODE[dtype], float(scale), int(window or 0),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'flash_rel_attn_fwd launch failed: CUDA error {err}')
    LAUNCHES['flash_rel_attn_fwd'] += 1
    return out, lse


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
) -> torch.Tensor:
    """Drop-in fused replacement for ops.attention.rel_attn (no attention-
    probability dropout, no key padding mask)."""
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
    q, k, v = project_qkv(p, cat, T, dtype)
    rw = q + p['r_w_bias'].to(dtype)
    rr = q + p['r_r_bias'].to(dtype)

    BN = B * n_head
    # reshape alone may return a strided view (B = 1); the kernel takes dense rows
    rw3 = rw.transpose(1, 2).reshape(BN, T, d_head).contiguous()
    rr3 = rr.transpose(1, 2).reshape(BN, T, d_head).contiguous()
    k3 = k.transpose(1, 2).reshape(BN, S, d_head).contiguous()
    v3 = v.transpose(1, 2).reshape(BN, S, d_head).contiguous()
    g_tab = distance_table(p['r'], T, S, M, clamp_len, dtype)

    ctx3, _ = flash_rel_attn_fwd(rw3, rr3, k3, v3, g_tab, mem_valid, M=M, scale=scale,
                                 window=int(window or 0))
    ctx = ctx3.reshape(B, n_head, T, d_head).transpose(1, 2).reshape(B, T, -1)
    out = (ctx @ p['o'].to(dtype).reshape(-1, d_model)).to(dtype)
    out = dropout(out, dropout_rate, generator, deterministic)
    out = inp + out
    if not pre_lnorm:
        out = layer_norm(p['ln'], out)
    return out
