"""Core layers as plain functions over parameter dicts of tensors.

Counterpart of `musicnlp_tpu/ops/layers.py`.  Parameters live in float32 in
the JAX package's layouts (dense `w` [d_in, d_out], `b` [d_out]; layer norm
`scale`/`bias`); compute runs at the dtype of the activations, with float32
layer norms.  `dense` takes its product in float32, adds the float32 bias
and rounds once to the activations' dtype, as the JAX `dense` does; the
bias, the FFN's relu and the rounding are one pass, `bias_act` (on the card
the kernel `csrc/bias_act.cu`).  Given a `Mesh` whose `model` axis is
larger than 1 (`parallel/mesh.py`), `ffn` runs Megatron-style: its w1
columns and w2 rows are this rank's block, the float32 partial w2 products
are summed over `model` before the replicated bias, and the dropout of the
sharded hidden draws the full width and keeps its block.
"""
from __future__ import annotations

import ctypes
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from musicnlp_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, copy_to_model, model_shard

__all__ = ['Params', 'dense', 'f32_product', 'bias_act', 'bias_act_plain', 'LAUNCHES',
           'layer_norm', 'ffn', 'sinusoid_pos_emb', 'dropout', 'remat']

Params = Dict[str, Any]

LAUNCHES = {'bias_act': 0}
ACTS = (None, 'relu')
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_BIAS_ACT_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [
    ctypes.c_void_p]


def f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [n, d] @ b [d, m] with f32 accumulation and an f32 result, operands
    in a's dtype: on the card a bf16 / f16 product runs on the tensor cores
    with an f32 output (`torch.mm(..., out_dtype=float32)`, which has no CPU
    kernel); on the CPU the same products are taken in f32, where a product
    of two bf16 values is exact.  Never a rounded bf16 result upcast."""
    b = b.to(a.dtype)
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def bias_act_plain(y: torch.Tensor, b: Optional[torch.Tensor], act: Optional[str],
                   dtype: torch.dtype) -> torch.Tensor:
    """act(y + b) rounded once to `dtype`, y [..., D] and b [D] in f32: the
    plain version of `bias_act`'s kernel, the same arithmetic."""
    if b is not None:
        y = y + b
    if act == 'relu':
        y = torch.relu(y)
    return y.to(dtype)


def bias_act(y: torch.Tensor, b: Optional[torch.Tensor], act: Optional[str],
             dtype: torch.dtype) -> torch.Tensor:
    """A dense layer's epilogue: act(y + b) rounded once to `dtype` (f32,
    bf16 or f16), over its f32 product y [..., D] and f32 bias b [D] (or
    None), act None or 'relu'.  For CPU tensors the plain version; for CUDA
    tensors the kernel `csrc/bias_act.cu` (one pass: the f32 product read
    once, the output written once; bound by those bytes), or it raises.
    Each launch adds one to `LAUNCHES['bias_act']`."""
    if act not in ACTS:
        raise ValueError(f'bias_act takes act in {ACTS}, got {act!r}')
    if dtype not in _DTYPE_CODE:
        raise TypeError(f'bias_act writes float32, bfloat16 or float16, got {dtype}')
    D = y.shape[-1]
    if y.dtype != torch.float32 or (b is not None and (
            b.dtype != torch.float32 or tuple(b.shape) != (D,))):
        raise ValueError(f'bias_act takes an f32 y [..., D] and an f32 b [D], got y '
                         f'{y.dtype} {tuple(y.shape)}, b '
                         f'{None if b is None else (b.dtype, tuple(b.shape))}')
    if y.device.type == 'cpu' and (b is None or b.device.type == 'cpu'):
        return bias_act_plain(y, b, act, dtype)
    if y.device.type != 'cuda' or (b is not None and b.device != y.device):
        raise ValueError('bias_act: y and b on one CUDA device, or both on the CPU')
    y = y.contiguous()
    b = None if b is None else b.contiguous()
    out = torch.empty(y.shape, dtype=dtype, device=y.device)
    from musicnlp_tpu_torch.kernels.build import load
    lib = load('bias_act', _BIAS_ACT_ARGTYPES)
    with torch.cuda.device(y.device):    # launch on the inputs' device and its stream
        err = lib.bias_act(y.data_ptr(), None if b is None else b.data_ptr(), out.data_ptr(),
                           y.numel() // max(D, 1), D, _DTYPE_CODE[dtype], int(act == 'relu'),
                           torch.cuda.current_stream(y.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'bias_act launch failed: CUDA error {err}')
    LAUNCHES['bias_act'] += 1
    return out


class _Dense(torch.autograd.Function):
    """act(x @ w + b): the f32 product (summed over `model` in f32 for a
    row-parallel block), then `bias_act`.  The backward keeps the gradient
    in the activations' dtype, as autograd of x @ w does: g = grad where the
    relu's output is positive, db = g summed in f32, dx = g @ w^T, dw = x^T g
    (cast to w's dtype).  It saves x, w in the activations' dtype and, with
    the relu, its output: what autograd of the unfused layer keeps."""

    @staticmethod
    def forward(ctx, x, w, b, mesh, act):
        wc = w.to(x.dtype)
        x2 = x.reshape(-1, x.shape[-1])
        y = f32_product(x2, wc)
        if mesh is not None:
            mesh.all_reduce(y, MODEL_AXIS)       # in place; nothing at model size 1
        out = bias_act(y.view(*x.shape[:-1], y.shape[-1]), b, act, x.dtype)
        ctx.act, ctx.w_dtype = act, w.dtype
        ctx.save_for_backward(x2, wc, out if act == 'relu' else None)
        return out

    @staticmethod
    def backward(ctx, grad):
        x2, wc, out = ctx.saved_tensors
        g = grad.reshape(-1, grad.shape[-1])
        if ctx.act == 'relu':
            g = torch.ops.aten.threshold_backward(g, out.reshape(g.shape), 0)
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx = (g @ wc.T).view(*grad.shape[:-1], wc.shape[0]) if need_x else None
        dw = (x2.T @ g).to(ctx.w_dtype) if need_w else None
        db = g.sum(0, dtype=torch.float32) if need_b else None
        return dx, dw, db, None, None


def dense(p: Params, x: torch.Tensor, mesh: Optional[Mesh] = None, *,
          act: Optional[str] = None) -> torch.Tensor:
    """act(x @ w + b), act None or 'relu': the product in f32, the f32 bias
    added and the result rounded once to x's dtype, as the JAX `dense`.
    With `mesh`, a row-parallel product: the f32 partial products are
    summed over `model` before the bias is added once."""
    return _Dense.apply(x, p['w'], p.get('b'), mesh, act)


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
    h = dense(p['w1'], copy_to_model(x, mesh), act='relu')
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
