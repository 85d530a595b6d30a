"""The Trinity sparse-expert block (`model_type` 'afmoe'), plain PyTorch: the
benchmark's reference, and the tier-1 tests' (they import it).

Source: Arcee's Trinity-Mini, https://huggingface.co/arcee-ai/Trinity-Mini
(its config.json), with the layer equations of the public `afmoe` model code
in HF transformers: a muP embedding scale sqrt(d); per layer the sandwich
norms h = h + RMSNorm(Attn(RMSNorm(h))), h = h + RMSNorm(MLP(RMSNorm(h)));
a final RMSNorm and an untied head.  Attn: bias-free q / k / v projections
(query heads, fewer key / value heads), RMSNorm over the head dim on q and
k, rotary positions (halves rotated, theta `rope_theta`) in the sliding
layers only, causal softmax at 1 / sqrt(head_dim), query head h reading key
head h // (heads per key head), keys within `sliding_window` in the sliding
layers; the context times sigmoid(x W_gate), then the output projection.
MLP: SwiGLU in the first `num_dense_layers` layers; then sigmoid router
scores over `num_experts`, the top `num_experts_per_tok` by score plus
expert bias, weights = chosen scores / (their sum + 1e-20) * route_scale,
the weighted SwiGLUs of the chosen experts plus the shared expert.

Departures, each also the program's: the layer holds `n_experts_held`
experts from `expert_offset` (the chip's share of an expert-parallel
deployment; the part the other experts would add is left out); the
vocabulary is the port's music vocabulary (`vocab_size`), not the text one;
the expert bias is zero (model state that no rule moves here).  Attention is
an explicit masked softmax over one key head's group of query heads at a
time, and each layer is checkpointed (`torch.utils.checkpoint`), so that
one 8,192-long row's float32 backward fits on the card.  Every product goes
through `common.mm` (float32 with TF32 off, or the float8 control).

Parameters are float32 under the program's flat keys: `embed/weight` [V,
d], `lm_head/w` [d, V], `norm` [d]; per layer `layers/<i>/attn/q|gate` [d,
N H], `k|v` [d, NK H], `o` [N H, d], `q_norm|k_norm` [H],
`input_norm|post_attn_norm|pre_mlp_norm|post_mlp_norm` [d], and
`mlp/gate|up` [d, F], `mlp/down` [F, d] (dense) or `moe/router` [d, E],
`moe/experts/gate|up` [held, d, Fe], `moe/experts/down` [held, Fe, d],
`moe/shared/gate|up|down` (expert layers).
"""
from __future__ import annotations

from typing import Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from benchmark.reference.common import Dropout, lookup as table_rows, mm

LOOKUP_LEAVES = ('embed/weight',)     # tables whose gradient is a sum over gathered rows
SLIDING = 'sliding_attention'
NORM_EPS = 1e-20


def dropout_shapes(cfg: Dict, B: int, T: int) -> List[List[int]]:
    """The model draws no dropout."""
    return []


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [b, heads, T, H] at positions 0..T-1."""
    T, H = x.shape[-2:]
    inv = 1.0 / (theta ** (torch.arange(0, H, 2, dtype=torch.float32, device=x.device) / H))
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    rot = torch.cat([-x[..., H // 2:], x[..., :H // 2]], dim=-1)
    return x * torch.cos(ang) + rot * torch.sin(ang)


def _swiglu(gate, up, down, x, prec):
    return mm(torch.nn.functional.silu(mm(x, gate, prec)) * mm(x, up, prec), down, prec)


def _attention(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: Dict, sliding: bool,
               prec: str) -> torch.Tensor:
    b, T, D = x.shape
    N, NK, H = cfg['num_attention_heads'], cfg['num_key_value_heads'], cfg['head_dim']
    G, eps = N // NK, cfg['rms_norm_eps']
    q = _rms(mm(x, p['q'], prec).view(b, T, N, H), p['q_norm'], eps).transpose(1, 2)
    k = _rms(mm(x, p['k'], prec).view(b, T, NK, H), p['k_norm'], eps).transpose(1, 2)
    v = mm(x, p['v'], prec).view(b, T, NK, H).transpose(1, 2)
    if sliding:
        q, k = _rope(q, cfg['rope_theta']), _rope(k, cfg['rope_theta'])
    i = torch.arange(T, device=x.device)
    d = i[:, None] - i[None, :]                                       # q - k
    ok = (d >= 0) & (d < cfg['sliding_window']) if sliding else d >= 0
    ctx = []
    for kh in range(NK):                      # one key head's group of query heads
        kg = k[:, kh:kh + 1].expand(b, G, T, H)
        vg = v[:, kh:kh + 1].expand(b, G, T, H)
        s = mm(q[:, kh * G:(kh + 1) * G], kg.transpose(-1, -2), prec) / (H ** 0.5)
        s = s.masked_fill(~ok, float('-inf'))
        ctx.append(mm(torch.softmax(s, dim=-1), vg, prec))
    ctx = torch.cat(ctx, dim=1).transpose(1, 2).reshape(b, T, N * H)
    return mm(ctx * torch.sigmoid(mm(x, p['gate'], prec)), p['o'], prec)


def _moe(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: Dict, prec: str) -> torch.Tensor:
    b, T, D = x.shape
    x2 = x.reshape(b * T, D)
    s = torch.sigmoid(mm(x2, p['router'], prec))
    bias = torch.zeros(cfg['num_experts'], device=x.device)          # expert_bias: zeros
    idx = torch.topk(s.detach() + bias, cfg['num_experts_per_tok'], dim=-1).indices
    w = s.gather(-1, idx)
    w = w / (w.sum(dim=-1, keepdim=True) + NORM_EPS) * cfg['route_scale']
    out = torch.zeros_like(x2)
    for e in range(cfg['n_experts_held']):
        hit = idx == cfg['expert_offset'] + e                         # [n, k], one slot at most
        rows = hit.any(dim=-1).nonzero()[:, 0]
        if not len(rows):
            continue
        y = _swiglu(p['experts/gate'][e], p['experts/up'][e], p['experts/down'][e], x2[rows],
                    prec)
        out = out.index_add(0, rows, y * (w * hit).sum(dim=-1)[rows, None])
    out = out + _swiglu(p['shared/gate'], p['shared/up'], p['shared/down'], x2, prec)
    return out.view(b, T, D)


def _layer(p: Dict[str, torch.Tensor], h: torch.Tensor, li: int, cfg: Dict,
           prec: str) -> torch.Tensor:
    eps = cfg['rms_norm_eps']
    sliding = cfg['layer_types'][li] == SLIDING
    a = _attention({k[5:]: v for k, v in p.items() if k.startswith('attn/')},
                   _rms(h, p['input_norm'], eps), cfg, sliding, prec)
    h = h + _rms(a, p['post_attn_norm'], eps)
    x = _rms(h, p['pre_mlp_norm'], eps)
    if li < cfg['num_dense_layers']:
        f = _swiglu(p['mlp/gate'], p['mlp/up'], p['mlp/down'], x, prec)
    else:
        f = _moe({k[4:]: v for k, v in p.items() if k.startswith('moe/')}, x, cfg, prec)
    return h + _rms(f, p['post_mlp_norm'], eps)


def logits(params: Dict[str, torch.Tensor], ids: torch.Tensor, cfg: Dict, prec: str = 'f32',
           drop: Dropout = None, lookup=table_rows) -> torch.Tensor:
    """ids [b, T] -> float32 logits [b, T, V]; `lookup(table, ids)` gathers
    the embedding's rows."""
    h = lookup(params['embed/weight'], ids)
    if cfg['mup_enabled']:
        h = h * cfg['hidden_size'] ** 0.5
    for li in range(cfg['num_hidden_layers']):
        sub = f'layers/{li}/'
        p = {k[len(sub):]: v for k, v in params.items() if k.startswith(sub)}

        def run(x, p=p, li=li):
            return _layer(p, x, li, cfg, prec)
        h = checkpoint(run, h, use_reentrant=False) if torch.is_grad_enabled() else run(h)
    h = _rms(h, params['norm'], cfg['rms_norm_eps'])
    return mm(h, params['lm_head/w'], prec)
