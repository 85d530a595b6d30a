"""Seeded weights on the device, in the layouts the program reads.

Both sides get the same numbers: the program its nested dict of float32
tensors, the reference the flat dict.  Every matrix and axial table is one
slice of a single `torch.randn` draw on the device (a `torch.Generator` on
it, seeded from the run's seed) times `init_std`; biases are zeros and
layer-norm scales ones, as the program's own initialisation makes them.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def layout(family: str, m: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """[(flat key, shape, 'normal' | 'zeros' | 'ones')] in a fixed order."""
    D, N, H, V = m['d_model'], m['n_head'], m['d_head'], m['vocab_size']

    def ln(prefix, width=D):
        return [(f'{prefix}/scale', (width,), 'ones'), (f'{prefix}/bias', (width,), 'zeros')]

    def ffn(prefix, F):
        return [(f'{prefix}/w1/w', (D, F), 'normal'), (f'{prefix}/w1/b', (F,), 'zeros'),
                (f'{prefix}/w2/w', (F, D), 'normal'), (f'{prefix}/w2/b', (D,), 'zeros'),
                *ln(f'{prefix}/ln')]
    if family == 'transfo_xl':
        out = [('embed/weight', (V, D), 'normal'), ('out_bias', (V,), 'zeros')]
        for li in range(m['n_layer']):
            a = f'layers/{li}/attn'
            out += [(f'{a}/qkv', (D, 3, N, H), 'normal'), (f'{a}/r', (D, N, H), 'normal'),
                    (f'{a}/o', (N, H, D), 'normal'), (f'{a}/r_w_bias', (N, H), 'zeros'),
                    (f'{a}/r_r_bias', (N, H), 'zeros'), *ln(f'{a}/ln'),
                    *ffn(f'layers/{li}/ffn', m['d_inner'])]
        return out
    if family == 'reformer':
        n1, n2 = m['axial_pos_shape']
        d1 = D // 4
        out = [('embed/weight', (V, D), 'normal'), ('axial1', (n1, 1, d1), 'normal'),
               ('axial2', (1, n2, D - d1), 'normal'), ('lm_head/w', (D, V), 'normal'),
               ('lm_head/b', (V,), 'zeros'), *ln('ln_f')]
        for li, kind in enumerate(m['attn_layers']):
            a = f'layers/{li}/attn'
            out += [(f'{a}/qk', (D, N, H), 'normal'), (f'{a}/v', (D, N, H), 'normal'),
                    (f'{a}/o', (N, H, D), 'normal'), *ln(f'{a}/ln'),
                    *ffn(f'layers/{li}/ffn', m['d_ff'])]
            if kind == 'local':
                out.append((f'{a}/k', (D, N, H), 'normal'))
        return out
    raise ValueError(f'unknown model family {family!r}')


def make_flat(family: str, m: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{flat key: float32 tensor on `device`} from `seed`."""
    spec = layout(family, m)
    n = sum(torch.Size(s).numel() for _, s, kind in spec if kind == 'normal')
    g = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randn(n, generator=g, device=device).mul_(m['init_std'])
    out, at = {}, 0
    for key, shape, kind in spec:
        if kind == 'normal':
            k = torch.Size(shape).numel()
            out[key] = draw[at:at + k].view(shape).clone()
            at += k
        else:
            out[key] = (torch.ones if kind == 'ones' else torch.zeros)(shape, device=device)
    return out


def nest(flat: Dict[str, torch.Tensor]):
    """{'a/0/b': x} -> {'a': [{'b': x}]}: numbered levels become lists."""
    root: Dict = {}
    for key, leaf in flat.items():
        node = root
        *parents, last = key.split('/')
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node
    return listify(root)


def flatten(tree, prefix: str = '') -> Dict[str, torch.Tensor]:
    """The inverse of `nest`."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, torch.Tensor] = {}
    for k, v in items:
        out.update(flatten(v, f'{prefix}/{k}' if prefix else str(k)))
    return out
