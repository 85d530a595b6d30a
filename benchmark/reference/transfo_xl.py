"""Transformer-XL language model, plain PyTorch: the benchmark's reference.

Dai et al. 2019 (arXiv:1901.02860), as the 22-11 recipe trains it: a tied
embedding scaled by sqrt(d_model); in each of the layers relative-position
attention (content term (q + u) . k, position term (q + v) . W_r R(i - j)
with the sinusoid R of the distance clamped at `clamp_len`, causal, scale
1/sqrt(d_head)), an output projection, residual and post layer norm, then a
relu feed-forward with residual and post layer norm; the head is the tied
embedding plus a bias.  Dropout (rate `dropout`) after the embedding, on the
attention output, on the feed-forward's hidden and on its output, in that
order; no attention dropout (`dropatt` 0).  Without memory, as a training
step and a scoring batch run.

Parameters are float32 under the flat keys the program uses
(`layers/<i>/attn/qkv` [d, 3, N, H], `r` [d, N, H], `o` [N, H, d],
`r_w_bias` / `r_r_bias` [N, H], `ln/scale|bias`; `layers/<i>/ffn/w1|w2/w|b`,
`ln`; `embed/weight` [V, d], `out_bias` [V]).
"""
from __future__ import annotations

from typing import Dict, List

import torch

from benchmark.reference.common import Dropout, layer_norm, lookup as table_rows, mm, sinusoid

LOOKUP_LEAVES = ('embed/weight',)     # tables whose gradient is a sum over gathered rows


def dropout_shapes(cfg: Dict, B: int, T: int) -> List[List[int]]:
    """The shapes of the model's dropout draws in one forward, in order."""
    D, F = cfg['d_model'], cfg['d_inner']
    return [[B, T, D]] + [[B, T, D], [B, T, F], [B, T, D]] * cfg['n_layer']


def _attention(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: Dict, prec: str,
               drop: Dropout) -> torch.Tensor:
    b, T, D = x.shape
    N, H = cfg['n_head'], cfg['d_head']
    heads = mm(x, p['qkv'].reshape(D, 3 * N * H), prec).reshape(b, T, 3, N, H)
    q, k, v = (heads[:, :, i].transpose(1, 2) for i in range(3))          # [b, N, T, H]
    dist = torch.clamp(torch.arange(T, device=x.device), max=cfg['clamp_len'])
    rk = mm(sinusoid(dist, D), p['r'].reshape(D, N * H), prec).reshape(T, N, H)
    rk = rk.permute(1, 2, 0)                                              # [N, H, T]
    ac = mm(q + p['r_w_bias'][None, :, None], k.transpose(-1, -2), prec)
    bd_dist = mm(q + p['r_r_bias'][None, :, None], rk.expand(b, N, H, T), prec)
    i = torch.arange(T, device=x.device)
    rel = torch.clamp(i[:, None] - i[None, :], min=0)                    # i - j
    bd = torch.gather(bd_dist, 3, rel.expand(b, N, T, T))
    s = (ac + bd) / (H ** 0.5)
    s = s.masked_fill(i[None, :] > i[:, None], float('-inf'))
    ctx = mm(torch.softmax(s, dim=-1), v, prec)                           # [b, N, T, H]
    out = mm(ctx.transpose(1, 2).reshape(b, T, N * H), p['o'].reshape(N * H, D), prec)
    return layer_norm(x + drop(out), p['ln/scale'], p['ln/bias'])


def _ffn(p: Dict[str, torch.Tensor], x: torch.Tensor, prec: str, drop: Dropout) -> torch.Tensor:
    h = drop(torch.relu(mm(x, p['w1/w'], prec) + p['w1/b']))
    h = drop(mm(h, p['w2/w'], prec) + p['w2/b'])
    return layer_norm(x + h, p['ln/scale'], p['ln/bias'])


def logits(params: Dict[str, torch.Tensor], ids: torch.Tensor, cfg: Dict, prec: str = 'f32',
           drop: Dropout = None, lookup=table_rows) -> torch.Tensor:
    """ids [b, T] -> float32 logits [b, T, V]; `lookup(table, ids)` gathers
    the embedding's rows."""
    drop = drop or Dropout(0.0)
    emb = params['embed/weight']
    h = drop(lookup(emb, ids) * cfg['d_model'] ** 0.5)
    for li in range(cfg['n_layer']):
        sub = f'layers/{li}/'
        attn = {k[len(sub) + 5:]: v for k, v in params.items() if k.startswith(sub + 'attn/')}
        ffn = {k[len(sub) + 4:]: v for k, v in params.items() if k.startswith(sub + 'ffn/')}
        h = _attention(attn, h, cfg, prec, drop)
        h = _ffn(ffn, h, prec, drop)
    return mm(h, emb.T, prec) + params['out_bias']
