"""musicnlp_tpu_torch: the PyTorch / CUDA (Hopper) port of `musicnlp_tpu`.

The JAX package `musicnlp_tpu` is the reference; this package keeps its
module paths and function names so that each counterpart is easy to find,
and imports nothing from it (nor `jax`).  What it needs of the JAX package's
numpy-only modules (the vocabulary) is copied, not imported.

Entry points run on CUDA unless the caller passes `device='cpu'`; with no
GPU and no explicit 'cpu' they raise -- there is no silent CPU fallback.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ['resolve_device']

__version__ = '0.1.0'


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: `device` when given, else 'cuda'.

    Raises when CUDA is asked for (explicitly or by default) and absent."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'CUDA is not available; pass device="cpu" to run on the CPU')
    return dev
