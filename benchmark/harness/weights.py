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

from benchmark.harness import families

Layout = List[Tuple[str, Tuple[int, ...], str]]


def norm(prefix: str, width: int) -> Layout:
    """A layer norm's scale and bias."""
    return [(f'{prefix}/scale', (width,), 'ones'), (f'{prefix}/bias', (width,), 'zeros')]


def ffn(prefix: str, D: int, F: int) -> Layout:
    """A feed-forward block: w1 [D, F], w2 [F, D], their biases, its norm."""
    return [(f'{prefix}/w1/w', (D, F), 'normal'), (f'{prefix}/w1/b', (F,), 'zeros'),
            (f'{prefix}/w2/w', (F, D), 'normal'), (f'{prefix}/w2/b', (D,), 'zeros'),
            *norm(f'{prefix}/ln', D)]


def layout(family: str, m: Dict) -> Layout:
    """[(flat key, shape, 'normal' | 'zeros' | 'ones')] in a fixed order:
    `layout` of `families/<family>.py`."""
    return families.get(family).layout(m)


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
