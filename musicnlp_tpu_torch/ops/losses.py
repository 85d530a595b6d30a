"""Loss and metric ops: masked next-token CE (over dense logits, or tiled
over the vocab for large vocabularies), NTP accuracy, in-key ratio.

Counterpart of `musicnlp_tpu/ops/losses.py`.  Labels use PT_LOSS_PAD = -100.
`chunked_shifted_ce_loss` computes the exact tied-head CE of a large vocab
(the 262,144-unit WordPiece tier) in `chunk`-row tiles of the embedding, so
no [B, T, V] logits tensor exists in the forward or the backward.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from musicnlp_tpu_torch.ops.layers import f32_product

__all__ = ['PT_LOSS_PAD', 'BIG_ARG', 'shifted_ce_loss', 'ce_tile_scan',
           'chunked_shifted_ce_loss', 'ntp_accuracy', 'ikr_from_ids']

PT_LOSS_PAD = -100
# the running argmax's initial index: larger than any vocab id, and never
# left after the first tile (every tile has a finite max)
BIG_ARG = 2 ** 30
_PAD_BIAS = -1e30


def shifted_ce_loss(logits: torch.Tensor, labels: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CE(logits[:, :-1], labels[:, 1:]) with -100 masked -> (mean loss, n_valid)."""
    lg = logits[:, :-1].float()
    lb = labels[:, 1:]
    valid = lb != PT_LOSS_PAD
    lb_safe = torch.where(valid, lb, torch.zeros_like(lb)).long()
    logz = torch.logsumexp(lg, dim=-1)
    tok_logit = torch.gather(lg, -1, lb_safe[..., None])[..., 0]
    nll = logz - tok_logit
    n = torch.clamp(valid.sum(), min=1).float()
    loss = torch.where(valid, nll, torch.zeros_like(nll)).sum() / n
    return loss, n


def _tile(hq: torch.Tensor, w: torch.Tensor, b: torch.Tensor, lo: int, chunk: int):
    """Rows [lo, lo + chunk) of the head: (f32 logits [n, chunk], the tile's
    rows [chunk, d]); a tile past the last row is padded
    with zero rows whose bias is -1e30, so they never win the max or add to
    the sum."""
    w_c, b_c = w[lo:lo + chunk], b[lo:lo + chunk].float()
    pad = chunk - w_c.shape[0]
    if pad:
        w_c = torch.cat([w_c, w_c.new_zeros(pad, w_c.shape[1])])
        b_c = torch.cat([b_c, b_c.new_full((pad,), _PAD_BIAS)])
    return f32_product(hq, w_c.T) + b_c, w_c


class _TiledHead(torch.autograd.Function):
    """The running (logsumexp, target logit, max, argmax) of `ce_tile_scan`
    over [n, d] hiddens and a [Vl, d] row block.  Only the per-row running
    values are kept for the backward, which recomputes each tile's logits:
    forward and backward hold one [n, chunk] f32 tile at a time (the JAX
    package's `jax.checkpoint` on the tile body).  The backward's products
    take operands in the hiddens' dtype (the logits' gradient rounded to it)
    with f32 accumulation."""

    @staticmethod
    def forward(ctx, hq, w, b, lb, chunk: int, lo_base: int):
        n = hq.shape[0]
        vl = w.shape[0]
        hi_cap = lo_base + vl              # pad rows never claim a label past the block
        dev = hq.device
        lse = torch.full((n,), float('-inf'), device=dev)
        tgt = torch.zeros(n, device=dev)
        run_max = torch.full((n,), float('-inf'), device=dev)
        run_arg = torch.full((n,), BIG_ARG, dtype=torch.long, device=dev)
        for lo in range(0, vl, chunk):
            lg, _ = _tile(hq, w, b, lo, chunk)
            lse = torch.logaddexp(lse, torch.logsumexp(lg, dim=-1))
            glo = lo_base + lo
            in_c = (lb >= glo) & (lb < glo + chunk) & (lb < hi_cap)
            idx = torch.clamp(lb - glo, 0, chunk - 1)
            tgt = torch.where(in_c, torch.gather(lg, 1, idx[:, None])[:, 0], tgt)
            c_max, c_arg = lg.max(dim=-1)
            better = c_max > run_max              # strict: the first tile wins a tie
            run_max = torch.where(better, c_max, run_max)
            run_arg = torch.where(better, c_arg + glo, run_arg)
        ctx.save_for_backward(hq, w, b, lb, lse)
        ctx.chunk, ctx.lo_base = chunk, lo_base
        ctx.mark_non_differentiable(run_max, run_arg)
        return lse, tgt, run_max, run_arg

    @staticmethod
    def backward(ctx, g_lse, g_tgt, _g_max, _g_arg):
        hq, w, b, lb, lse = ctx.saved_tensors
        chunk, lo_base = ctx.chunk, ctx.lo_base
        vl = w.shape[0]
        g_lse = torch.zeros_like(lse) if g_lse is None else g_lse
        g_tgt = torch.zeros_like(lse) if g_tgt is None else g_tgt
        dh = torch.zeros(hq.shape, dtype=torch.float32, device=hq.device)
        dw = torch.empty_like(w)
        db = torch.empty_like(b)
        for lo in range(0, vl, chunk):
            lg, w_c = _tile(hq, w, b, lo, chunk)
            dlg = torch.exp(lg - lse[:, None]) * g_lse[:, None]
            glo = lo_base + lo
            in_c = (lb >= glo) & (lb < glo + chunk) & (lb < lo_base + vl)
            idx = torch.clamp(lb - glo, 0, chunk - 1)
            dlg.scatter_add_(1, idx[:, None], torch.where(in_c, g_tgt, 0.0)[:, None])
            dlg_c = dlg.to(hq.dtype)
            dh += f32_product(dlg_c, w_c)
            hi = min(lo + chunk, vl)
            dw[lo:hi] = f32_product(dlg_c.T, hq)[:hi - lo].to(w.dtype)
            db[lo:hi] = dlg[:, :hi - lo].sum(0).to(b.dtype)
        return dh.to(hq.dtype), dw, db, None, None, None


def ce_tile_scan(hq: torch.Tensor, lb_safe: torch.Tensor, embed_w: torch.Tensor,
                 out_bias: torch.Tensor, *, chunk: Optional[int], lo_base: int = 0):
    """Running (logsumexp, target logit, max, argmax) of the tied head over
    the [Vl, d] row block `embed_w`, scanned in `chunk`-row tiles; hq
    [B, Tq, d], lb_safe [B, Tq] labels (no -100).  Each tile is one
    [B*Tq, d] x [d, chunk] product with an f32 result, its operands in hq's
    dtype; rows padded up to a chunk multiple get a bias of -1e30; labels
    outside [lo_base, lo_base + Vl) add 0 to the target; the argmax is in
    global vocab ids (`lo_base` is the block's first row), and a later tile
    replaces it only with a strictly larger max.  Returns four [B, Tq]
    tensors; lse and tgt carry gradients to hq, embed_w and out_bias."""
    B, Tq, d = hq.shape
    vl = embed_w.shape[0]
    chunk = min(chunk or vl, vl)
    outs = _TiledHead.apply(hq.reshape(B * Tq, d), embed_w, out_bias,
                            lb_safe.reshape(-1).long(), chunk, lo_base)
    return tuple(x.reshape(B, Tq) for x in outs)


def chunked_shifted_ce_loss(h: torch.Tensor, labels: torch.Tensor, embed_w: torch.Tensor,
                            out_bias: torch.Tensor, *, chunk: int = 8192
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`shifted_ce_loss` of the tied head's logits h @ embed_w^T + out_bias,
    computed tile by tile (`ce_tile_scan`) without a [B, T, V] logits tensor:
    h [B, T, d], labels [B, T] (-100 = ignore), embed_w [V, d], out_bias [V]
    -> (mean loss, n_valid, preds [B, T]), preds the argmax over the full
    vocab at every position (the last column repeats the one before it)."""
    lb = labels[:, 1:]
    valid = lb != PT_LOSS_PAD
    lb_safe = torch.where(valid, lb, torch.zeros_like(lb))
    lse, tgt, _, run_arg = ce_tile_scan(h[:, :-1], lb_safe, embed_w, out_bias, chunk=chunk)
    nll = lse - tgt
    n = torch.clamp(valid.sum(), min=1).float()
    loss = torch.where(valid, nll, torch.zeros_like(nll)).sum() / n
    preds = torch.cat([run_arg, run_arg[:, -1:]], dim=1)
    return loss, n, preds


def ntp_accuracy(logits_or_preds: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Next-token accuracy with the CLM shift; -100 labels excluded.  Takes
    logits [B, T, V] or argmaxed predictions [B, T]."""
    preds = (logits_or_preds.argmax(dim=-1) if logits_or_preds.dim() == 3
             else logits_or_preds)
    preds = preds[:, :-1]
    lb = labels[:, 1:]
    valid = lb != PT_LOSS_PAD
    correct = (preds == lb) & valid
    n = torch.clamp(valid.sum(), min=1).float()
    return correct.sum().float() / n


def ikr_from_ids(ids: torch.Tensor, key_scores: torch.Tensor, id_pitch_class: torch.Tensor,
                 key_inkey_mask: torch.Tensor, *, valid: Optional[torch.Tensor] = None,
                 key_ordinal: Optional[torch.Tensor] = None, with_count: bool = False):
    """Batched in-key ratio: mean over songs with >= 1 pitch of the per-song
    share of pitches diatonic to the song's key ('ins-key': `key_ordinal`
    [B]; 'vanilla': confidence-weighted over the 24 `key_scores`).  With
    `with_count`, (ratio, number of songs with a pitch)."""
    V = id_pitch_class.shape[0]
    pc = id_pitch_class[torch.clamp(ids, 0, V - 1).long()]                # [B, T]
    is_pitch = pc >= 0
    if valid is not None:
        is_pitch = is_pitch & valid
    pc_safe = torch.where(is_pitch, pc, torch.zeros_like(pc)).long()
    inkey = key_inkey_mask.bool().T[pc_safe] & is_pitch[..., None]        # [B, T, 24]
    n_pitch = is_pitch.sum(dim=1).float()                                 # [B]
    per_key = inkey.sum(dim=1).float() / torch.clamp(n_pitch[:, None], min=1.0)
    if key_ordinal is not None:
        ratio = torch.gather(per_key, 1, key_ordinal.long()[:, None])[:, 0]
    else:
        w = torch.clamp(key_scores.float(), min=0.0)
        w = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-9)
        ratio = (per_key * w).sum(dim=1)
    has_pitch = n_pitch > 0
    n_song = torch.clamp(has_pitch.sum(), min=1).float()
    ikr = torch.where(has_pitch, ratio, torch.zeros_like(ratio)).sum() / n_song
    return (ikr, has_pitch.sum().float()) if with_count else ikr
