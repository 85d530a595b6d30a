"""Reformer (`family` 'reformer'): alternating chunked local and LSH
attention through K3 (forward) and K4 (backward), axial positions, an
untied head.

What the harness knows of the family (`harness/families.py`): its weight
layout, its work counts and the program's classes.
"""
from __future__ import annotations

from typing import Dict, List

from benchmark.harness import work
from benchmark.harness.weights import Layout, ffn, norm

PROGRAM = ('musicnlp_tpu_torch.models.reformer.Reformer',
           'musicnlp_tpu_torch.models.reformer.ReformerConfig')
TINY = dict(d_model=64, n_head=4, d_head=16, d_ff=128, attn_layers=['local', 'lsh'],
            max_length=128, axial_pos_shape=[8, 16], local_chunk=16, lsh_chunk=16)


def layout(m: Dict) -> Layout:
    D, N, H, V = m['d_model'], m['n_head'], m['d_head'], m['vocab_size']
    n1, n2 = m['axial_pos_shape']
    d1 = D // 4
    out = [('embed/weight', (V, D), 'normal'), ('axial1', (n1, 1, d1), 'normal'),
           ('axial2', (1, n2, D - d1), 'normal'), ('lm_head/w', (D, V), 'normal'),
           ('lm_head/b', (V,), 'zeros'), *norm('ln_f', D)]
    for li, kind in enumerate(m['attn_layers']):
        a = f'layers/{li}/attn'
        out += [(f'{a}/qk', (D, N, H), 'normal'), (f'{a}/v', (D, N, H), 'normal'),
                (f'{a}/o', (N, H, D), 'normal'), *norm(f'{a}/ln', D),
                *ffn(f'layers/{li}/ffn', D, m['d_ff'])]
        if kind == 'local':
            out.append((f'{a}/k', (D, N, H), 'normal'))
    return out


def attention_calls(config: Dict, B: int, T: int, backward: bool) -> Dict[str, List[work.Call]]:
    """One K3 call a layer (and one K4): G = B x heads in a local layer,
    B x heads x rounds in an LSH layer.  The LSH layers' calls are counted
    with positions in order within the sorted rows, an estimate of the pairs
    the hash leaves visible; `roofline_readable` checks that the estimate
    cannot move their bound."""
    m = config['model']
    dt = m['dtype']
    calls_f, calls_b = [], []
    for kind in m['attn_layers']:
        G = B * m['n_head'] * (1 if kind == 'local' else m['n_hashes'])
        chunk = m['local_chunk'] if kind == 'local' else m['lsh_chunk']
        calls_f.append(work.window_attn_fwd(G, T, m['d_head'], chunk, dt))
        calls_b.append(work.window_attn_bwd(G, T, m['d_head'], chunk, dt))
    out = {'window_attn_fwd': calls_f}
    if backward:
        out['window_attn_bwd'] = calls_b
    return out


def roofline_readable(calls: Dict[str, List[work.Call]]) -> bool:
    """Whether every call is bound by its bytes even were every pair of its
    windows visible (`work.bytes_bound_lsh`)."""
    return all(work.bytes_bound_lsh(c) for cs in calls.values() for c in cs)


def matmul_params(config: Dict) -> int:
    m = config['model']
    D, NH = m['d_model'], m['n_head'] * m['d_head']
    n = 0
    for kind in m['attn_layers']:
        n += D * NH * (3 if kind == 'local' else 2) + NH * D + 2 * D * m['d_ff']
    return n + D * m['vocab_size']


def forward_flops(config: Dict, B: int, T: int) -> float:
    """The weights' and attention's products."""
    return work.weight_and_attention_flops(matmul_params(config),
                                           attention_calls(config, B, T, False), B, T)
