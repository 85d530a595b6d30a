"""Transformer-XL (`family` 'transfo_xl'): relative-position attention
through K1 (forward) and K2 (backward) in every layer, a tied head.

What the harness knows of the family (`harness/families.py`): its weight
layout, its work counts and the program's classes.
"""
from __future__ import annotations

from typing import Dict, List

from benchmark.harness import work
from benchmark.harness.weights import Layout, ffn, norm

PROGRAM = ('musicnlp_tpu_torch.models.transformer_xl.TransfoXL',
           'musicnlp_tpu_torch.models.transformer_xl.TransfoXLConfig')
TINY = dict(d_model=64, n_head=4, d_head=16, d_inner=128, n_layer=2, max_length=64, clamp_len=64,
            mem_len=32)


def layout(m: Dict) -> Layout:
    D, N, H, V = m['d_model'], m['n_head'], m['d_head'], m['vocab_size']
    out = [('embed/weight', (V, D), 'normal'), ('out_bias', (V,), 'zeros')]
    for li in range(m['n_layer']):
        a = f'layers/{li}/attn'
        out += [(f'{a}/qkv', (D, 3, N, H), 'normal'), (f'{a}/r', (D, N, H), 'normal'),
                (f'{a}/o', (N, H, D), 'normal'), (f'{a}/r_w_bias', (N, H), 'zeros'),
                (f'{a}/r_r_bias', (N, H), 'zeros'), *norm(f'{a}/ln', D),
                *ffn(f'layers/{li}/ffn', D, m['d_inner'])]
    return out


def attention_calls(config: Dict, B: int, T: int, backward: bool) -> Dict[str, List[work.Call]]:
    """One causal K1 call a layer (and one K2), without memory, as a
    training step and a scoring batch run."""
    m = config['model']
    args = (B * m['n_head'], T, T, 0, m['d_head'], m['n_head'], m['dtype'])
    out = {'rel_attn_fwd': [work.rel_attn_fwd(*args)] * m['n_layer']}
    if backward:
        out['rel_attn_bwd'] = [work.rel_attn_bwd(*args)] * m['n_layer']
    return out


def roofline_readable(calls: Dict[str, List[work.Call]]) -> bool:
    """K1's and K2's pairs are counted exactly: their bound always reads."""
    return True


def matmul_params(config: Dict) -> int:
    m = config['model']
    D, NH = m['d_model'], m['n_head'] * m['d_head']
    per = D * 3 * NH + NH * D + 2 * D * m['d_inner']
    return m['n_layer'] * per + D * m['vocab_size']


def forward_flops(config: Dict, B: int, T: int) -> float:
    """The weights' and attention's products, and the distance tables (one
    [2T, d] x [d, N H] product per layer and batch)."""
    m = config['model']
    flops = work.weight_and_attention_flops(matmul_params(config),
                                            attention_calls(config, B, T, False), B, T)
    return flops + m['n_layer'] * 2.0 * 2 * T * m['d_model'] * m['n_head'] * m['d_head']
