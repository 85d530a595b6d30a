"""Reformer language model, plain PyTorch: the benchmark's reference.

Kitaev et al. 2020 (arXiv:2001.04451), as the 22-04 recipe trains it: a
token embedding plus an axial position embedding ([n1, 1, d/4] and
[1, n2, 3d/4] broadcast, concatenated, flattened); pre-norm residual layers
alternating chunked local attention and LSH attention, each followed by a
relu feed-forward; a final layer norm and an untied head.  Dropout (rate
`dropout`) on each attention and each feed-forward output, in that order.

Local attention: queries q = x W_qk and keys k = x W_k; each query attends
causally to its own chunk and the chunk before it (the first chunk has no
look-back), scale 1/sqrt(d_head).

LSH attention (shared query-key qk = x W_qk): each of `n_hashes` rounds
hashes qk by the argmax over [qk R; -qk R] with the round's fixed rotations
R [d_head, n_buckets / 2] (JAX's `random.normal` draws for the layer, worked
out by the frozen numpy threefry in `jax_rng.py`), sorts positions by
(bucket, position), and lets each sorted chunk attend its own and the
previous sorted chunk: keys are qk normalised to unit root-mean-square and
divided by sqrt(d_head), a key is visible where its position is at most the
query's, and a query's own key takes -1e5 (it is chosen only where nothing
else is visible).  The rounds are combined by the softmax of their
log-sum-exps.

Parameters are float32 under the program's flat keys (`layers/<i>/attn/qk`,
`k` (local layers), `v` [d, N, H], `o` [N, H, d], `ln`; `ffn/w1|w2/w|b`,
`ln`; `embed/weight`, `axial1`, `axial2`, `ln_f`, `lm_head/w|b`).
"""
from __future__ import annotations

import functools
from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import jax_rng
from benchmark.reference.common import Dropout, layer_norm, lookup as table_rows, mm

LOOKUP_LEAVES = ('embed/weight',)     # tables whose gradient is a sum over gathered rows

NEG = -1e9            # a masked score: finite, as in the recipe's kernels
SELF = -1e5           # a query's own key under shared query-keys


def n_buckets(cfg: Dict, T: int) -> int:
    """~2 T / chunk, rounded up to a power of two (at least 2)."""
    target, n = max(2, 2 * T // cfg['lsh_chunk']), 2
    while n < target:
        n *= 2
    return n


@functools.lru_cache(maxsize=None)
def _rotations(seed: int, layer: int, rounds: int, d_head: int, nb: int) -> np.ndarray:
    return jax_rng.normal(jax_rng.fold_in(jax_rng.prng_key(seed), layer), (rounds, d_head, nb // 2))


def dropout_shapes(cfg: Dict, B: int, T: int) -> List[List[int]]:
    return [[B, T, cfg['d_model']]] * (2 * len(cfg['attn_layers']))


def _chunk_attend(q, k, v, qpos, kpos, c: int, scale: float, self_bias: float, prec: str):
    """q, k, v [G, T, H], positions [G, T] -> (ctx [G, T, H], lse [G, T]):
    each chunk of c queries against the keys of its chunk and the one before
    (none before the first); visible where kpos <= qpos."""
    G, T, H = q.shape
    n = T // c
    qc = q.reshape(G, n, c, H)

    def look_back(x, fill):
        xc = x.reshape(G, n, c, *x.shape[2:])
        prev = torch.cat([torch.full_like(xc[:, :1], fill), xc[:, :-1]], dim=1)
        return torch.cat([prev, xc], dim=2)
    kw, vw = look_back(k, 0.0), look_back(v, 0.0)
    kp = look_back(kpos, torch.iinfo(torch.int64).max)[:, :, None, :]
    qp = qpos.reshape(G, n, c)[..., None]
    s = mm(qc, kw.transpose(-1, -2), prec) * scale
    if self_bias:
        s = torch.where(kp == qp, s + self_bias, s)
    s = torch.where(kp <= qp, s, torch.full_like(s, NEG))
    lse = torch.logsumexp(s, dim=-1)
    ctx = mm(torch.exp(s - lse[..., None]), vw, prec)
    return ctx.reshape(G, T, H), lse.reshape(G, T)


def _local(p, x, cfg, prec):
    b, T, D = x.shape
    N, H = cfg['n_head'], cfg['d_head']

    def proj(w):
        return mm(x, w.reshape(D, N * H), prec).reshape(b, T, N, H).transpose(1, 2).reshape(
            b * N, T, H)
    pos = torch.arange(T, device=x.device).expand(b * N, T)
    ctx, _ = _chunk_attend(proj(p['qk']), proj(p['k']), proj(p['v']), pos, pos,
                           cfg['local_chunk'], H ** -0.5, 0.0, prec)
    return ctx.reshape(b, N, T, H)


def _lsh(p, x, cfg, layer: int, prec):
    b, T, D = x.shape
    N, H, R, c = cfg['n_head'], cfg['d_head'], cfg['n_hashes'], cfg['lsh_chunk']
    G = b * N
    qk = mm(x, p['qk'].reshape(D, N * H), prec).reshape(b, T, N, H).transpose(1, 2).reshape(G, T, H)
    v = mm(x, p['v'].reshape(D, N * H), prec).reshape(b, T, N, H).transpose(1, 2).reshape(G, T, H)
    nb = n_buckets(cfg, T)
    rots = torch.from_numpy(_rotations(cfg['lsh_seed'], layer, R, H, nb)).to(x.device)
    with torch.no_grad():
        proj = torch.einsum('gth,rhb->grtb', qk.detach(), rots)
        bucket = torch.cat([proj, -proj], dim=-1).argmax(dim=-1)          # [G, R, T]
    t = torch.arange(T, device=x.device)
    order = torch.argsort(bucket * T + t, dim=-1)                          # [G, R, T]
    ctxs, lses = [], []
    for r in range(R):
        idx = order[:, r]
        qs = torch.gather(qk, 1, idx[..., None].expand(G, T, H))
        vs = torch.gather(v, 1, idx[..., None].expand(G, T, H))
        ks = qs * torch.rsqrt(qs.square().mean(dim=-1, keepdim=True) + 1e-6) / H ** 0.5
        ctx_s, lse_s = _chunk_attend(qs, ks, vs, idx, idx, c, 1.0, SELF, prec)
        undo = torch.argsort(idx, dim=-1)
        ctxs.append(torch.gather(ctx_s, 1, undo[..., None].expand(G, T, H)))
        lses.append(torch.gather(lse_s, 1, undo))
    w = torch.softmax(torch.stack(lses), dim=0)[..., None]                # [R, G, T, 1]
    return (torch.stack(ctxs) * w).sum(0).reshape(b, N, T, H)


def logits(params: Dict[str, torch.Tensor], ids: torch.Tensor, cfg: Dict, prec: str = 'f32',
           drop: Dropout = None, lookup=table_rows) -> torch.Tensor:
    """ids [b, T] -> float32 logits [b, T, V]; `lookup(table, ids)` gathers
    the embedding's rows."""
    drop = drop or Dropout(0.0)
    b, T = ids.shape
    D, N, H, eps = cfg['d_model'], cfg['n_head'], cfg['d_head'], cfg['ln_eps']
    n1, n2 = cfg['axial_pos_shape']
    pos = torch.cat([params['axial1'].expand(n1, n2, -1), params['axial2'].expand(n1, n2, -1)],
                    dim=-1).reshape(n1 * n2, D)[:T]
    h = lookup(params['embed/weight'], ids) + pos
    for li, kind in enumerate(cfg['attn_layers']):
        a, f = f'layers/{li}/attn/', f'layers/{li}/ffn/'
        pa = {k[len(a):]: v for k, v in params.items() if k.startswith(a)}
        pf = {k[len(f):]: v for k, v in params.items() if k.startswith(f)}
        x = layer_norm(h, pa['ln/scale'], pa['ln/bias'], eps)
        ctx = _local(pa, x, cfg, prec) if kind == 'local' else _lsh(pa, x, cfg, li, prec)
        out = mm(ctx.transpose(1, 2).reshape(b, T, N * H), pa['o'].reshape(N * H, D), prec)
        h = h + drop(out)
        x = layer_norm(h, pf['ln/scale'], pf['ln/bias'], eps)
        h = h + drop(mm(torch.relu(mm(x, pf['w1/w'], prec) + pf['w1/b']), pf['w2/w'], prec)
                     + pf['w2/b'])
    h = layer_norm(h, params['ln_f/scale'], params['ln_f/bias'], eps)
    return mm(h, params['lm_head/w'], prec) + params['lm_head/b']
