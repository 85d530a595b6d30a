"""Relative-position attention with segment memory (Transformer-XL style).

Counterpart of `musicnlp_tpu/ops/attention.py`, in plain PyTorch:
  * `rel_attn` is the full-sequence attention with the rel-shift trick; it
    materializes the [B, N, Q, K] scores and is the oracle that the fused
    path (`ops/flash_attention.py`, kernel K1) is held against;
  * `rel_attn_decode_step` is the one-token step against a KV ring cache,
    bf16 or int8 (per-row scales folded into the scores and probabilities).

Memory is a fixed-shape right-aligned buffer [B, M, d] with a `mem_valid`
count (an int or a 0-d integer tensor); NEG_INF is -1e30 as in the reference.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from musicnlp_tpu_torch.ops.layers import Params, dropout, layer_norm, sinusoid_pos_emb
from musicnlp_tpu_torch.parallel.mesh import Mesh, copy_to_model, model_shard, sum_over_model

__all__ = ['rel_attn', 'rel_attn_decode_step', 'rel_shift', 'quantize_kv_rows',
           'project_qkv', 'NEG_INF']

NEG_INF = -1e30


def quantize_kv_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization over the last axis (d_head).

    Returns (q int8 same shape, scale f32 without the last axis)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.round(xf / scale).to(torch.int8)
    return q, scale[..., 0]


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """TF-XL relative shift of [B, N, Q, K] scores against distances K-1..0."""
    b, n, q, k = x.shape
    x = torch.nn.functional.pad(x, (1, 0))
    x = x.reshape(b, n, k + 1, q)[:, :, 1:, :]
    return x.reshape(b, n, q, k)


def project_qkv(p: Params, cat: torch.Tensor, qlen: int, dtype: torch.dtype):
    """cat [B, K, d] (memory ++ current) -> q [B, Q, N, H], k/v [B, K, N, H]."""
    w = p['qkv'].to(dtype)                                   # [d, 3, N, H]
    d = w.shape[0]
    heads = (cat.to(dtype) @ w.reshape(d, -1)).reshape(*cat.shape[:2], *w.shape[1:])
    return heads[:, -qlen:, 0], heads[:, :, 1], heads[:, :, 2]


def rel_attn(
        p: Params, x: torch.Tensor, mems: Optional[torch.Tensor],
        mem_valid: Union[int, torch.Tensor], *, clamp_len: int = -1,
        pre_lnorm: bool = False, scale: Optional[float] = None,
        dropout_rate: float = 0.0, dropatt_rate: float = 0.0,
        generator: Optional[torch.Generator] = None, deterministic: bool = True,
        attn_mask: Optional[torch.Tensor] = None, window: Optional[int] = None,
        mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """Full-sequence relative attention with optional fixed-size memory.

    x [B, Q, d_model]; mems [B, M, d_model] or None; attn_mask [B, Q] bool
    (True = real token); window masks keys at distance >= window.
    Returns [B, Q, d_model] (residual + layer norm applied).  Over `mesh`'s
    model axis the heads are this rank's (the leaves' shapes say how many)
    and the output projection's partial products are summed over `model`."""
    dtype, dev = x.dtype, x.device
    B, Q, d_model = x.shape
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
    K = M + Q
    q, k, v = project_qkv(p, copy_to_model(cat, mesh), Q, dtype)

    pos_seq = torch.arange(K - 1, -1, -1, dtype=torch.float32, device=dev)
    if clamp_len > 0:
        pos_seq = torch.clamp(pos_seq, max=float(clamp_len))
    r = sinusoid_pos_emb(pos_seq, d_model, dtype)                        # [K, d]
    r_head = (r @ p['r'].to(dtype).reshape(d_model, -1)).reshape(K, n_head, d_head)

    rw = q + p['r_w_bias'].to(dtype)
    rr = q + p['r_r_bias'].to(dtype)
    AC = torch.einsum('bqnh,bknh->bnqk', rw.float(), k.float())
    BD = rel_shift(torch.einsum('bqnh,knh->bnqk', rr.float(), r_head.float()))
    score = (AC + BD) * scale

    i = torch.arange(Q, device=dev)[:, None]
    j = torch.arange(K, device=dev)[None, :]
    mask = (j <= i + M) & (j >= M - torch.as_tensor(mem_valid, device=dev))
    if window is not None:
        mask = mask & ((i + M - j) < window)
    mask = mask[None, None].expand(B, 1, Q, K)
    if attn_mask is not None:
        key_ok = torch.cat([torch.ones(B, M, dtype=torch.bool, device=dev),
                            attn_mask.bool()], dim=1)
        mask = mask & key_ok[:, None, None, :]
    score = torch.where(mask, score, torch.full_like(score, NEG_INF))

    probs = torch.softmax(score, dim=-1)
    probs = dropout(probs, dropatt_rate, generator, deterministic,
                    shard=model_shard(mesh, 1)).to(dtype)
    ctx = torch.einsum('bnqk,bknh->bqnh', probs.float(), v.float()).to(dtype)
    out = sum_over_model((ctx.reshape(B, Q, -1) @ p['o'].to(dtype).reshape(-1, d_model))
                         .to(dtype), mesh)
    out = dropout(out, dropout_rate, generator, deterministic)
    out = inp + out
    if not pre_lnorm:
        out = layer_norm(p['ln'], out)
    return out


def rel_attn_decode_step(
        p: Params, x: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
        cache_pos: torch.Tensor, step: Union[int, torch.Tensor], *,
        clamp_len: int = -1, pre_lnorm: bool = False, scale: Optional[float] = None,
        window: Optional[int] = None, cache_k_scale: Optional[torch.Tensor] = None,
        cache_v_scale: Optional[torch.Tensor] = None,
        r_head_all: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode attention against a KV ring-buffer cache.

    x [B, 1, d_model]; cache_k/v [B, M, N, H] (int8 with per-row f32 scales
    cache_k_scale/cache_v_scale [B, M, N], or the compute dtype); cache_pos
    int32 [M] absolute position per slot (-1 = empty); step = the absolute
    position of the current token.  `r_head_all` [C+1, N, H] is the
    distance-indexed positional table (`decode_pos_table`); built here when
    not given.  Returns (out [B, 1, d], k_cur [B, 1, N, H], v_cur [B, 1, N, H]);
    the caller writes k_cur/v_cur into slot `step % M`."""
    dtype = x.dtype
    B, _, d_model = x.shape
    n_head, d_head = p['r_w_bias'].shape
    scale = scale if scale is not None else 1.0 / (d_head ** 0.5)
    M = cache_k.shape[1]

    inp = x
    if pre_lnorm:
        x = layer_norm(p['ln'], x)
    q, k_cur, v_cur = project_qkv(p, x, 1, dtype)                      # [B,1,N,H]

    C = int(clamp_len) if clamp_len > 0 else M
    if r_head_all is None:
        r_head_all = decode_pos_table(p, C, d_model, dtype, x.device)
    idx = torch.clamp(step - cache_pos, 0, C).long()                      # [M]
    r_head = r_head_all[idx]                                              # [M,N,H]

    rw = (q + p['r_w_bias'].to(dtype))[:, 0]                              # [B,N,H]
    rr = (q + p['r_r_bias'].to(dtype))[:, 0]
    # int8 codes and bf16 values are exact in f32: one upcast, no round trip
    AC = torch.einsum('bnh,bknh->bnk', rw.float(), cache_k.float())
    if cache_k_scale is not None:
        AC = AC * cache_k_scale.transpose(1, 2)
    BD = torch.einsum('bnh,knh->bnk', rr.float(), r_head.float())
    score_c = (AC + BD) * scale                                           # [B,N,M]
    slot_ok = cache_pos >= 0
    if window is not None:
        slot_ok = slot_ok & ((step - cache_pos) < window)
    score_c = torch.where(slot_ok[None, None, :], score_c,
                          torch.full_like(score_c, NEG_INF))
    s_self = ((rw.float() * k_cur[:, 0].float()).sum(-1)
              + (rr.float() * r_head_all[0].float()).sum(-1)) * scale   # [B,N]
    score = torch.cat([score_c, s_self[..., None]], dim=-1)               # [B,N,M+1]

    probs = torch.softmax(score, dim=-1).to(dtype)
    p_mem = probs[..., :M]
    if cache_v_scale is not None:
        p_mem = p_mem * cache_v_scale.transpose(1, 2).to(dtype)
    ctx = torch.einsum('bnk,bknh->bnh', p_mem.float(), cache_v.float())
    ctx = (ctx + probs[..., M:].float() * v_cur[:, 0].float()).to(dtype)  # [B,N,H]
    out = (ctx.reshape(B, 1, -1) @ p['o'].to(dtype).reshape(-1, d_model)).to(dtype)
    out = inp + out
    if not pre_lnorm:
        out = layer_norm(p['ln'], out)
    return out, k_cur, v_cur


def decode_pos_table(p: Params, C: int, d_model: int, dtype: torch.dtype,
                     device) -> torch.Tensor:
    """R_head[d] = W_r^T R(d) for d in [0, C]: [C+1, N, H] (params only, so a
    decode loop builds it once per layer and reuses it every step)."""
    n_head, d_head = p['r_w_bias'].shape
    r_all = sinusoid_pos_emb(torch.arange(C + 1, dtype=torch.float32, device=device),
                             d_model, dtype)
    return (r_all @ p['r'].to(dtype).reshape(d_model, -1)).reshape(C + 1, n_head, d_head)
