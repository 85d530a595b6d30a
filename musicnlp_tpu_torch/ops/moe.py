"""The sparse-expert layer of the Trinity family (`models/afmoe.py`).

The layer is told which experts it holds: `n_held` of the router's
`n_experts`, from `offset`.  It routes every token over all of them (sigmoid
scores in f32 from an f32-accumulated product, the top `top_k` chosen by
score plus `expert_bias`, weighted by the chosen scores without the bias,
normalised and scaled), keeps the (token, slot) pairs whose expert it holds,
sorts them by expert, gathers their rows, runs the held experts' SwiGLU as
grouped products, scatter-adds the weighted outputs in f32, adds the
shared expert and rounds once.  No row is dropped: there is no capacity
limit.  The experts held elsewhere in an expert-parallel deployment would
add their part to the same tokens; on one chip the layer runs without that
exchange and hands its own part on.

The grouped products run as one `torch._grouped_mm` per weight on the card
in 16 bits (offsets from the dispatch's counts, no host copy of them), and as
one product per held expert over its sorted rows elsewhere.  They run
`CHUNK` rows at a time, and again in the backward (`_HeldExperts` keeps only
the layer's input, the rows' tokens and weights, and the offsets), so that
the memory a step holds does not grow with the rows the router sends here:
that number changes with the data and the router, and a deployment sizes
its memory for the worst.  The layer syncs the host once, for the number of
rows it keeps.  The rows each held expert computed are the counter
`moe_rows` (`utils/profiling.count`).
"""
from __future__ import annotations

import bisect
import itertools
from typing import Tuple

import torch
import torch.nn.functional as F

from musicnlp_tpu_torch.ops.layers import Params, f32_matmul, mlp
from musicnlp_tpu_torch.utils.profiling import count, span

__all__ = ['route', 'dispatch', 'moe']

NORM_EPS = 1e-20            # added to the sum of the chosen scores before the division
CHUNK = 8192                # held rows computed at once, forward and backward


def route(x: torch.Tensor, w_router: torch.Tensor, expert_bias: torch.Tensor, *, top_k: int,
          route_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [n, d] -> (idx [n, top_k] int64, weights [n, top_k] f32): sigmoid
    scores over the router's experts, the top `top_k` of score + bias, and
    the chosen scores (without the bias), divided by their sum and times
    `route_scale`."""
    s = torch.sigmoid(f32_matmul(x, w_router))
    idx = torch.topk(s.detach() + expert_bias, top_k, dim=-1).indices
    w = s.gather(-1, idx)
    return idx, w / (w.sum(dim=-1, keepdim=True) + NORM_EPS) * route_scale


def dispatch(idx: torch.Tensor, w: torch.Tensor, n_held: int, offset: int):
    """The pairs of held experts, sorted by expert -> (token of each row
    [m], its weight [m] f32, rows per held expert [n_held] on the device and
    as a list)."""
    top_k = idx.shape[1]
    eid = idx - offset
    flat = torch.where((eid >= 0) & (eid < n_held), eid, n_held).reshape(-1)
    counts = torch.bincount(flat, minlength=n_held + 1)[:n_held]
    order = torch.argsort(flat, stable=True)
    rows = counts.tolist()                    # the layer's one host sync
    sel = order[:sum(rows)]
    return sel // top_k, w.reshape(-1)[sel], counts, rows


def _swiglu_rows(xs: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
                 offs: torch.Tensor) -> torch.Tensor:
    """The SwiGLU of experts wg / wu [E, d, F], wd [E, F, d] over sorted rows
    xs [m, d]: rows [offs[e - 1], offs[e]) are expert e's (offs int32,
    cumulative, offs[-1] = m)."""
    if xs.is_cuda and xs.dtype in (torch.bfloat16, torch.float16):
        return torch._grouped_mm(F.silu(torch._grouped_mm(xs, wg, offs=offs))
                                 * torch._grouped_mm(xs, wu, offs=offs), wd, offs=offs)
    out, at = [], 0
    for e, end in enumerate(offs.tolist()):   # every expert of the range, rows or none
        x_e = xs[at:end]
        out.append((F.silu(x_e @ wg[e]) * (x_e @ wu[e])) @ wd[e])
        at = end
    return torch.cat(out)


def _chunks(rows, offs: torch.Tensor):
    """(start, stop, e0, e1, offsets) of each CHUNK of the sorted rows: the
    experts [e0, e1) that have rows in it and their offsets in it (offs:
    the cumulative rows per held expert, on the device)."""
    ends = list(itertools.accumulate(rows))
    m = ends[-1] if ends else 0
    for c0 in range(0, m, CHUNK):
        c1 = min(c0 + CHUNK, m)
        e0 = bisect.bisect_right(ends, c0)
        e1 = bisect.bisect_left(ends, c1) + 1
        yield c0, c1, e0, e1, (offs[e0:e1] - c0).clamp(max=c1 - c0).to(torch.int32)


class _HeldExperts(torch.autograd.Function):
    """out [n, d] f32: row r's weight ws[r] times its expert's SwiGLU of
    x[tok[r]], added at token tok[r], over rows sorted by expert (`rows` of
    each held expert, offs their cumulative sums on the device), CHUNK rows
    at a time, each chunk over the experts that have rows in it.  The
    backward recomputes each chunk's products from x (which the router keeps
    anyway): dws = dout . y, dy = ws dout rounded to y's dtype, and the
    products' gradients by autograd, summed over the chunks in f32."""

    @staticmethod
    def forward(ctx, x, tok, ws, offs, rows, wg, wu, wd):
        out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        for c0, c1, e0, e1, oc in _chunks(rows, offs):
            y = _swiglu_rows(x[tok[c0:c1]], wg[e0:e1], wu[e0:e1], wd[e0:e1], oc)
            out.index_add_(0, tok[c0:c1], y.float() * ws[c0:c1, None])
        ctx.rows = rows
        ctx.save_for_backward(x, tok, ws, offs, wg, wu, wd)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, tok, ws, offs, *w = ctx.saved_tensors
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dws = torch.empty_like(ws)
        dw = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in w]
        for c0, c1, e0, e1, oc in _chunks(ctx.rows, offs):
            with torch.enable_grad():
                xs = x[tok[c0:c1]].detach().requires_grad_(True)
                wr = [t[e0:e1].detach().requires_grad_(True) for t in w]
                y = _swiglu_rows(xs, *wr, oc)
            g = dout[tok[c0:c1]]
            dws[c0:c1] = (g * y.float()).sum(dim=-1)
            gx, *gw = torch.autograd.grad(y, [xs, *wr], (g * ws[c0:c1, None]).to(y.dtype))
            dx.index_add_(0, tok[c0:c1], gx.float())
            for acc, d in zip(dw, gw):
                acc[e0:e1] += d
        return (dx.to(x.dtype), None, dws, None, None,
                *(a.to(t.dtype) for a, t in zip(dw, w)))


def moe(p: Params, x: torch.Tensor, expert_bias: torch.Tensor, *, top_k: int,
        route_scale: float, n_held: int, offset: int) -> torch.Tensor:
    """The expert layer over tokens x [n, d]: the held experts' weighted
    outputs plus the shared expert (p['shared'], `ops/layers.mlp`), rounded
    once to x's dtype.  p holds 'router' [d, n_experts], 'experts' and
    'shared'."""
    with span('model.route'):
        idx, w = route(x, p['router'], expert_bias, top_k=top_k, route_scale=route_scale)
        tok, ws, counts, rows = dispatch(idx, w, n_held, offset)
    count('moe_rows', counts)
    offs = torch.cumsum(counts, 0, dtype=torch.int32)
    routed = _HeldExperts.apply(x, tok, ws, offs, rows,
                                *(p['experts'][k].to(x.dtype) for k in ('gate', 'up', 'down')))
    return (routed + mlp(p['shared'], x).float()).to(x.dtype)
