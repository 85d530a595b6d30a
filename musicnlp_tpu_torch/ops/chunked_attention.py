"""Chunked local attention and LSH attention (the Reformer's two layer kinds).

Counterpart of `musicnlp_tpu/ops/chunked_attention.py`.  Both run their
window attention through `chunked_window_attn` (K3 forward, K4 backward; on
CPU tensors the plain versions), so no [n, c, 2c] score tensor reaches device
memory on the card.  A head dim outside the kernels' 16 / 32 / 64 / 128 runs
zero-padded to the next of them (`_window_attn`).

LSH attention hashes shared query-keys by an argmax over random rotations
(`lsh_rotations`: JAX's own draws, reproduced in numpy), sorts each hash
round by (bucket, position), attends within sorted chunks, and combines the
rounds with softmax weights of their log-sum-exps.  The sort's permutation
moves rows by index gathers whose backward is the inverse-permutation
gather (`_GatherRounds`, `_UnpermuteRounds`): exact, and free of scatters.
The JAX package lowers the same permutations as one-hot matmuls for the
TPU's matrix unit; on the card those would build a [G, R, T, T] one-hot.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from musicnlp_tpu_torch.ops.chunked_attention_kernel import (
    NEG_INF, chunked_window_attn, kernel_head_dim,
)
from musicnlp_tpu_torch.utils import jax_rng

__all__ = ['local_attention', 'lsh_attention', 'lsh_rotations', 'lsh_buckets', 'NEG_INF',
           'SELF_BIAS']

SELF_BIAS = -1e5   # shared-QK: a query attends itself only as a last resort


@functools.lru_cache(maxsize=None)
def _rotations_np(seed: int, layer_idx: int, n_hashes: int, d_head: int,
                  n_buckets: int) -> np.ndarray:
    key = jax_rng.fold_in(jax_rng.prng_key(seed), layer_idx)
    return jax_rng.normal(key, (n_hashes, d_head, n_buckets // 2))


def lsh_rotations(seed: int, layer_idx: int, n_hashes: int, d_head: int, n_buckets: int,
                  device=None) -> torch.Tensor:
    """f32 [R, D, nb // 2] = `jax.random.normal(fold_in(PRNGKey(seed),
    layer_idx), (R, D, nb // 2))`, the JAX model's fixed rotations."""
    return torch.from_numpy(_rotations_np(seed, layer_idx, n_hashes, d_head,
                                          n_buckets)).to(device)


def lsh_buckets(x: torch.Tensor, rots: torch.Tensor) -> torch.Tensor:
    """Angular LSH: argmax of [proj; -proj] over buckets.  x [..., D] (any
    float dtype, hashed in f32), rots [R, D, nb // 2] -> int64 [R, ...]."""
    proj = torch.einsum('...d,rdb->r...b', x.float(), rots.float())
    return torch.cat([proj, -proj], dim=-1).argmax(dim=-1)


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [G, R', T, C] (R' = 1 broadcasts), idx [G, R, T] -> [G, R, T, C]."""
    G, R, T = idx.shape
    x = x.expand(G, R, T, x.shape[-1])
    return torch.take_along_dim(x, idx[..., None], dim=2)


class _GatherRounds(torch.autograd.Function):
    """x [G, T, C] -> its rows in each round's sorted order [G, R, T, C].
    idx / inv [G, R, T] are mutually inverse permutations, so the gradient is
    the inverse-permutation gather summed over rounds."""

    @staticmethod
    def forward(ctx, x, idx, inv):
        ctx.save_for_backward(idx, inv)
        return _take_rows(x[:, None], idx)

    @staticmethod
    def backward(ctx, g):
        idx, inv = ctx.saved_tensors
        return _take_rows(g, inv).sum(dim=1), None, None


class _UnpermuteRounds(torch.autograd.Function):
    """y [G, R, T, C] in each round's sorted order -> original order."""

    @staticmethod
    def forward(ctx, y, idx, inv):
        ctx.save_for_backward(idx, inv)
        return _take_rows(y, inv)

    @staticmethod
    def backward(ctx, g):
        idx, inv = ctx.saved_tensors
        return _take_rows(g, idx), None, None


def _window_attn(q, k, v, qpos, kpos, *, chunk: int, scale: float, self_bias: float = 0.0):
    """`chunked_window_attn` at the head dim K3 / K4 run: zero columns add
    nothing to a score, and the context's padded columns are dropped."""
    D = q.shape[-1]
    pad = kernel_head_dim(D) - D
    if pad:
        q, k, v = (F.pad(t, (0, pad)) for t in (q, k, v))
    ctx, lse = chunked_window_attn(q, k, v, qpos, kpos, chunk=chunk, scale=scale,
                                   self_bias=self_bias)
    return (ctx[..., :D] if pad else ctx), lse


def _heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, D] -> dense [B*H, T, D] rows."""
    B, H, T, D = x.shape
    return x.reshape(B * H, T, D).contiguous()


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, chunk: int,
                    pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal chunked local attention with one look-back chunk.

    q/k/v: [B, H, T, D] with T % chunk == 0.  pad_mask: bool [B, T] True=real.
    Each query attends to the keys in its own and the previous chunk, causally;
    pad keys (kpos = T) are invisible."""
    B, H, T, D = q.shape
    if T % chunk:
        raise ValueError(f'T = {T} is not a multiple of the chunk {chunk}')
    t = torch.arange(T, dtype=torch.int32, device=q.device)
    qpos = t.expand(B * H, T).contiguous()
    if pad_mask is not None:
        kp1 = torch.where(pad_mask.to(q.device), t, torch.full_like(t, T))
        kpos = kp1.repeat_interleave(H, dim=0).to(torch.int32).contiguous()
    else:
        kpos = qpos
    ctx, _ = _window_attn(_heads(q), _heads(k), _heads(v), qpos, kpos, chunk=chunk,
                          scale=1.0 / (D ** 0.5))
    return ctx.reshape(B, H, T, D)


def lsh_attention(qk: torch.Tensor, v: torch.Tensor, *, chunk: int, n_hashes: int,
                  n_buckets: int, rots: torch.Tensor,
                  pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-round LSH attention, causal, shared-QK.

    qk/v: [B, H, T, D] with T % chunk == 0; rots f32 [n_hashes, D,
    n_buckets // 2] (`lsh_rotations`).  Rounds are combined with softmax
    weights of their log-sum-exps (the Reformer estimator)."""
    B, H, T, D = qk.shape
    if T % chunk or n_buckets % 2:
        raise ValueError(f'T = {T} must be a multiple of the chunk {chunk}, n_buckets '
                         f'{n_buckets} even')
    R, G = n_hashes, B * H
    dev = qk.device
    x = qk.reshape(G, T, D)
    buckets = lsh_buckets(x, rots.to(dev)).permute(1, 0, 2)              # [G, R, T]
    pm = None
    if pad_mask is not None:
        pm = pad_mask.to(dev).repeat_interleave(H, dim=0)                # [G, T]
        # pads go to a trailing pseudo-bucket: pad content never shifts real
        # tokens across sorted-chunk boundaries
        buckets = torch.where(pm[:, None, :], buckets, torch.full_like(buckets, n_buckets))
    # sort by (bucket, position); the keys are distinct, so any sort is stable
    t = torch.arange(T, device=dev)
    s_idx = torch.argsort(buckets * T + t, dim=-1)                       # [G, R, T]
    undo = torch.empty_like(s_idx).scatter_(-1, s_idx, t.expand(G, R, T))

    xs = _GatherRounds.apply(torch.cat([x, v.reshape(G, T, D)], dim=-1), s_idx, undo)
    qk_s, v_s = xs[..., :D], xs[..., D:]                                 # [G, R, T, D]
    # shared-QK key normalization, HF Reformer's `_len_and_dim_norm`: keys
    # carry 1/sqrt(D), so the scores take no further scale
    qk_f = qk_s.float()
    k_s = (qk_f * torch.rsqrt((qk_f * qk_f).mean(dim=-1, keepdim=True) + 1e-6)
           * (1.0 / (D ** 0.5))).to(qk.dtype)
    qpos = s_idx.to(torch.int32).reshape(G * R, T)                       # t[s_idx] == s_idx
    if pm is not None:
        pm_s = torch.take_along_dim(pm[:, None, :].expand(G, R, T), s_idx, dim=-1)
        kpos = torch.where(pm_s, s_idx, torch.full_like(s_idx, T)).to(torch.int32)
        kpos = kpos.reshape(G * R, T)
    else:
        kpos = qpos
    out_s, lse = _window_attn(
        qk_s.reshape(G * R, T, D).contiguous(), k_s.reshape(G * R, T, D).contiguous(),
        v_s.reshape(G * R, T, D).contiguous(), qpos, kpos, chunk=chunk, scale=1.0,
        self_bias=SELF_BIAS)
    # back to the original order; lse stays f32 (the TPU rounds it to the
    # compute dtype to ride the context's lane padding)
    out_o = _UnpermuteRounds.apply(out_s.reshape(G, R, T, D), s_idx, undo)
    lse_o = _UnpermuteRounds.apply(lse.reshape(G, R, T, 1), s_idx, undo)[..., 0]
    w = torch.softmax(lse_o, dim=1)[..., None].to(qk.dtype)
    return (out_o * w).sum(dim=1).reshape(B, H, T, D)
