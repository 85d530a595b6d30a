"""Trinity's sparse-expert block (`family` 'afmoe'): sliding-window and full
grouped-query attention through the grouped-query form of K1 / K2
(`gqa_attn_fwd` / `gqa_attn_bwd`), leading dense SwiGLU layers, then expert
layers that hold a share of the router's experts; an untied head.

What the harness knows of the family (`harness/families.py`): its weight
layout, its work counts and the program's classes.  `expert_bias` is the
model's state, not a weight: it is in no layout.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, List

from benchmark.harness import work
from benchmark.harness.weights import Layout

PROGRAM = ('musicnlp_tpu_torch.models.afmoe.AfmoeLM',
           'musicnlp_tpu_torch.models.afmoe.AfmoeConfig')
TINY = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
            intermediate_size=128, moe_intermediate_size=32, num_hidden_layers=4,
            num_dense_layers=1, num_experts=16, n_experts_held=4, expert_offset=4,
            num_experts_per_tok=2, sliding_window=8, max_length=32,
            layer_types=['sliding_attention'] * 3 + ['full_attention'])
SLIDING = 'sliding_attention'


def layout(m: Dict) -> Layout:
    D, N, NK, H = m['hidden_size'], m['num_attention_heads'], m['num_key_value_heads'], m['head_dim']
    V, Fe = m['vocab_size'], m['moe_intermediate_size']

    def swiglu(prefix, F, lead=()):
        return [(f'{prefix}/gate', (*lead, D, F), 'normal'), (f'{prefix}/up', (*lead, D, F), 'normal'),
                (f'{prefix}/down', (*lead, F, D), 'normal')]
    out = [('embed/weight', (V, D), 'normal'), ('lm_head/w', (D, V), 'normal'),
           ('norm', (D,), 'ones')]
    for li in range(m['num_hidden_layers']):
        a = f'layers/{li}/attn'
        out += [(f'{a}/q', (D, N * H), 'normal'), (f'{a}/k', (D, NK * H), 'normal'),
                (f'{a}/v', (D, NK * H), 'normal'), (f'{a}/gate', (D, N * H), 'normal'),
                (f'{a}/o', (N * H, D), 'normal'), (f'{a}/q_norm', (H,), 'ones'),
                (f'{a}/k_norm', (H,), 'ones')]
        out += [(f'layers/{li}/{k}', (D,), 'ones')
                for k in ('input_norm', 'post_attn_norm', 'pre_mlp_norm', 'post_mlp_norm')]
        if li < m['num_dense_layers']:
            out += swiglu(f'layers/{li}/mlp', m['intermediate_size'])
        else:
            out.append((f'layers/{li}/moe/router', (D, m['num_experts']), 'normal'))
            out += swiglu(f'layers/{li}/moe/experts', Fe, (m['n_experts_held'],))
            out += swiglu(f'layers/{li}/moe/shared', Fe * m['num_shared_experts'])
    return out


@lru_cache(maxsize=None)
def _pairs(T: int, window: int) -> int:
    """Visible (q, k) pairs of a causal row of T with keys q - k < window
    (0: none cut): K1 / K2's count without memory."""
    return work.causal_pairs(T, T, 0, 0, window)


def gqa_attn_fwd(BN: int, G: int, T: int, H: int, window: int, dtype: str) -> work.Call:
    """k1_gqa_tc: QK and PV per visible pair; q read once, k and v once per
    key head (BN / G rows), ctx written once, lse f32."""
    e = work.ELEMENT[dtype]
    flops = 2 * 2 * H * _pairs(T, window) * BN
    nbytes = e * (2 * BN * T * H + 2 * (BN // G) * T * H) + 4 * BN * T
    return flops, nbytes, dtype


def gqa_attn_bwd(BN: int, G: int, T: int, H: int, window: int, dtype: str) -> work.Call:
    """k2_gqa_dkdv_tc and k2_gqa_dq_tc: 5 products per visible pair (the
    scores, dP, dV, dK, dQ; the dq kernel's recomputed scores and dP not
    counted); q, out, dO, k, v in the input dtype and lse read once, dq in
    the input dtype and dk, dv in f32 (per key head) written once."""
    e = work.ELEMENT[dtype]
    kv = (BN // G) * T * H
    flops = 5 * 2 * H * _pairs(T, window) * BN
    nbytes = e * (3 * BN * T * H + 2 * kv) + 4 * BN * T + e * BN * T * H + 4 * 2 * kv
    return flops, nbytes, dtype


def attention_calls(config: Dict, B: int, T: int, backward: bool) -> Dict[str, List[work.Call]]:
    """One call a layer (and one in the backward): B x query heads rows,
    the sliding layers' keys within the window, the full layers' all earlier
    keys."""
    m = config['model']
    N, NK = m['num_attention_heads'], m['num_key_value_heads']
    args = [(B * N, N // NK, T, m['head_dim'],
             m['sliding_window'] if kind == SLIDING else 0, m['dtype']) for kind in m['layer_types']]
    out = {'gqa_attn_fwd': [gqa_attn_fwd(*a) for a in args]}
    if backward:
        out['gqa_attn_bwd'] = [gqa_attn_bwd(*a) for a in args]
    return out


def roofline_readable(calls: Dict[str, List[work.Call]]) -> bool:
    """The pairs are counted exactly: the bound always reads."""
    return True


def matmul_params(config: Dict) -> int:
    """Per token: the attention projections and output gate, the dense
    SwiGLUs, each expert layer's router and shared expert and, of its routed
    experts, the expected held share (top-k x held / experts of one
    expert's weights), and the head."""
    m = config['model']
    D, NH, KH = m['hidden_size'], m['num_attention_heads'] * m['head_dim'], \
        m['num_key_value_heads'] * m['head_dim']
    Fe = m['moe_intermediate_size']
    attn = D * NH * 3 + 2 * D * KH
    n_dense = m['num_dense_layers']
    n_moe = m['num_hidden_layers'] - n_dense
    routed = m['num_experts_per_tok'] * m['n_experts_held'] * 3 * D * Fe // m['num_experts']
    per_moe = D * m['num_experts'] + 3 * D * Fe * m['num_shared_experts'] + routed
    return (m['num_hidden_layers'] * attn + n_dense * 3 * D * m['intermediate_size']
            + n_moe * per_moe + D * m['vocab_size'])


def forward_flops(config: Dict, B: int, T: int) -> float:
    """The weights' products (the held experts' at their expected share)
    and the attention's."""
    return work.weight_and_attention_flops(matmul_params(config),
                                           attention_calls(config, B, T, False), B, T)
