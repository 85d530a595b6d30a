"""Vocab-sharded tied embedding and CE head (the 262k learned-tokenizer tier).

Counterpart of `musicnlp_tpu/ops/sharded_head.py`.  The [V, d] tied table
and its bias are row-sharded over the mesh's `model` axis: rank k holds rows
[k * Vl, (k + 1) * Vl), so neither the table nor its gradient is ever
replicated or all-reduced in full.  The lookup masks the ids outside the
block and sums over `model`; the CE is the tiled full softmax of
`ops/losses.py::ce_tile_scan` over the local block, combined with a few
[B, T] collectives: a max-shifted logsumexp, the target logit and the
argmax (lowest index wins, as in the replicated head).

Gradients: the hiddens enter the CE through `copy_to_model` (each rank's
block gives a partial input gradient); the summed lse and target logit are
replicated results, so their backward is identity -- an all-reduce there
would scale the gradients by the model size.  At model size 1 every
collective is skipped.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from musicnlp_tpu_torch.ops.losses import BIG_ARG, PT_LOSS_PAD, ce_tile_scan
from musicnlp_tpu_torch.parallel.mesh import (
    MODEL_AXIS, Mesh, batch_sum, copy_to_model, reduce_from_model,
)

__all__ = ['vocab_sharded_embed', 'vocab_sharded_ce_loss']


def _block(embed_w: torch.Tensor, mesh: Mesh) -> int:
    """The local block's first row (the table is the rank's [V / mp, d])."""
    return mesh.model_index * embed_w.shape[0]


def vocab_sharded_embed(input_ids: torch.Tensor, embed_w: torch.Tensor, *, mesh: Mesh,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Row lookup into the [Vl, d] block of a table row-sharded over
    `model`: ids outside the block give zeros, and one sum over `model`
    assembles the [B, T, d] embeddings.  The backward is a local
    scatter-add into the block."""
    vl = embed_w.shape[0]
    lo = _block(embed_w, mesh)
    in_block = (input_ids >= lo) & (input_ids < lo + vl)
    idx = torch.clamp(input_ids.long() - lo, 0, vl - 1)
    emb = embed_w.to(dtype)[idx]
    emb = torch.where(in_block[..., None], emb, torch.zeros((), dtype=dtype, device=emb.device))
    return reduce_from_model(emb, mesh)


def vocab_sharded_ce_loss(h: torch.Tensor, labels: torch.Tensor, embed_w: torch.Tensor,
                          out_bias: torch.Tensor, *, mesh: Mesh, chunk: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact tied-head CE with the [V, d] table row-sharded over `model`.

    The contract of `losses.chunked_shifted_ce_loss` -- (mean loss, n_valid,
    preds [B, T]) with the CLM shift and -100 masking -- over the global
    batch: the loss sum and the count are summed over the batch axes (the
    loss carries the gradient of this rank's rows of the global mean), the
    preds are this rank's rows, the argmax over the full vocab.  h [B, T, d]
    (this rank's rows, replicated over `model`), embed_w [Vl, d] and
    out_bias [Vl] the local blocks."""
    lb = labels[:, 1:]
    valid = lb != PT_LOSS_PAD
    lb_safe = torch.where(valid, lb, torch.zeros_like(lb))
    h = copy_to_model(h, mesh)
    lse_l, tgt_l, mx_l, arg_l = ce_tile_scan(
        h[:, :-1], lb_safe, embed_w.to(h.dtype), out_bias, chunk=chunk,
        lo_base=_block(embed_w, mesh))
    if mesh.n_model > 1:
        # the shift only keeps exp in range: any constant is exact, so it
        # takes no gradient
        m = mesh.all_reduce(lse_l.detach().clone(), MODEL_AXIS, op=dist.ReduceOp.MAX)
        lse = torch.log(reduce_from_model(torch.exp(lse_l - m), mesh)) + m
        tgt = reduce_from_model(tgt_l, mesh)
        gmax = mesh.all_reduce(mx_l.clone(), MODEL_AXIS, op=dist.ReduceOp.MAX)
        arg = torch.where(mx_l >= gmax, arg_l, torch.full_like(arg_l, BIG_ARG))
        arg = mesh.all_reduce(arg, MODEL_AXIS, op=dist.ReduceOp.MIN)
    else:
        lse, tgt, arg = lse_l, tgt_l, arg_l
    nll = torch.where(valid, lse - tgt, torch.zeros_like(lse))
    n = torch.clamp(batch_sum(valid.sum().float(), mesh), min=1.0)
    loss = batch_sum(nll.sum(), mesh, grad=True) / n
    preds = torch.cat([arg, arg[:, -1:]], dim=1)
    return loss, n, preds
