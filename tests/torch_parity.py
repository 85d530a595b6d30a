"""Helpers shared by the tests that hold `musicnlp_tpu_torch` against `musicnlp_tpu`:
inputs are made with numpy from a seed and handed to both packages."""
import jax
import numpy as np
import torch

from musicnlp_tpu.utils.checkpoint import _flatten
from musicnlp_tpu_torch.utils.checkpoint import params_from_jax


def to_torch(tree):
    """JAX parameter pytree -> the port's parameters on the CPU (via numpy)."""
    return params_from_jax(_flatten(tree), device='cpu')


def randn(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def np_of(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jax.device_get(x), dtype=np.float32)
