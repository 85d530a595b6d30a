"""Core layers as plain functions over parameter dicts of tensors.

Counterpart of `musicnlp_tpu/ops/layers.py`.  Parameters live in float32 in
the JAX package's layouts (dense `w` [d_in, d_out], `b` [d_out]; layer norm
`scale`/`bias`); compute runs at the dtype of the activations, with float32
layer norms and float32 bias adds.  Given a `Mesh` whose `model` axis is
larger than 1 (`parallel/mesh.py`), `ffn` runs Megatron-style: its w1
columns and w2 rows are this rank's block, the partial w2 products are
summed over `model` before the replicated bias, and the dropout of the
sharded hidden draws the full width and keeps its block.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from musicnlp_tpu_torch.parallel.mesh import Mesh, copy_to_model, model_shard, sum_over_model

__all__ = ['Params', 'dense', 'layer_norm', 'ffn', 'sinusoid_pos_emb', 'dropout', 'remat']

Params = Dict[str, Any]


def dense(p: Params, x: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """x @ w + b.  With `mesh`, a row-parallel product: the partial products
    are summed over `model` before the bias is added once."""
    y = sum_over_model(x @ p['w'].to(x.dtype), mesh)
    if 'b' in p:
        y = y.float() + p['b'].float()
    return y.to(x.dtype)


def layer_norm(p: Params, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32 (population variance), cast back to x.dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p['scale'].float() + p['bias'].float()).to(x.dtype)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            deterministic: bool, shard: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Inverted dropout; draws come only from the explicit `generator`.
    `shard` = (dim, index, count): x is block `index` of `count` along
    `dim` of a wider activation; the mask is drawn at the full width and
    this block kept, so every rank's generator stays in step and the masks
    are those of the unsharded activation."""
    if deterministic or rate == 0.0 or generator is None:
        return x
    if shard is None:
        u = torch.rand(x.shape, generator=generator, device=x.device)
    else:
        dim, index, count = shard
        dim %= x.dim()
        full = list(x.shape)
        full[dim] *= count
        u = torch.rand(full, generator=generator, device=x.device).narrow(
            dim, index * x.shape[dim], x.shape[dim])
    keep = u < (1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def remat(fn: Callable[..., torch.Tensor], *args,
          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """fn(*args) with its activations dropped after the forward and
    recomputed in the backward (`torch.utils.checkpoint`, non-reentrant), the
    counterpart of `jax.checkpoint`; without autograd, fn(*args).

    `torch.utils.checkpoint` replays the global RNG, not a `torch.Generator`,
    and every draw here comes from an explicit generator: the recompute
    rewinds `generator` to where the forward found it, so fn's dropout masks
    are drawn again bit for bit, and then puts it back where the forward
    left it, so the step's later draws do not move."""
    if not torch.is_grad_enabled():
        return fn(*args)
    if generator is None:
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    start = generator.get_state()
    calls = 0

    def run(*a):
        nonlocal calls
        calls += 1
        if calls == 1:
            return fn(*a)
        after = generator.get_state()
        generator.set_state(start)
        try:              # the recompute may stop early, by an exception
            return fn(*a)
        finally:
            generator.set_state(after)
    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


def ffn(p: Params, x: torch.Tensor, *, pre_lnorm: bool = False,
        dropout_rate: float = 0.0, generator: Optional[torch.Generator] = None,
        deterministic: bool = True, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Position-wise relu FFN with residual + layer norm (post-norm by
    default); tensor-parallel over `mesh`'s model axis (module docstring)."""
    inp = x
    if pre_lnorm:
        x = layer_norm(p['ln'], x)
    h = dense(p['w1'], copy_to_model(x, mesh))
    h = torch.relu(h)
    h = dropout(h, dropout_rate, generator, deterministic, shard=model_shard(mesh, -1))
    h = dense(p['w2'], h, mesh)
    h = dropout(h, dropout_rate, generator, deterministic)
    out = inp + h
    if not pre_lnorm:
        out = layer_norm(p['ln'], out)
    return out


def sinusoid_pos_emb(pos_seq: torch.Tensor, d_model: int,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[K] distances -> [K, d_model] = [sin(d * inv_freq) ; cos(d * inv_freq)]."""
    dev = pos_seq.device
    inv_freq = 1.0 / (10000.0 ** (torch.arange(0, d_model, 2, dtype=torch.float32,
                                               device=dev) / d_model))
    sinusoid = pos_seq.float()[:, None] * inv_freq[None, :]
    return torch.cat([torch.sin(sinusoid), torch.cos(sinusoid)], dim=-1).to(dtype)
