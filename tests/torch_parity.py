"""Helpers shared by the tests that hold `musicnlp_tpu_torch` against `musicnlp_tpu`:
inputs are made with numpy from a seed and handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from musicnlp_tpu.utils.checkpoint import _flatten, _path_key
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


def perturb(params, seed):
    """Non-zero biases and layer-norm params (JAX pytree) so every term is exercised."""
    flat = _flatten(params)
    rng = np.random.default_rng(seed)
    for k, v in flat.items():
        if k.endswith(('bias', 'r_w_bias', 'r_r_bias', '/b')):
            flat[k] = rng.standard_normal(v.shape).astype(np.float32) * 0.05
        elif k.endswith('scale'):
            flat[k] = 1.0 + rng.standard_normal(v.shape).astype(np.float32) * 0.05
    leaves, treedef = jax.tree_util.tree_flatten_with_path(params)
    keys = ['/'.join(_path_key(p) for p in path) for path, _ in leaves]
    return jax.tree_util.tree_unflatten(treedef, [jnp.asarray(flat[k]) for k in keys])
