"""Loss and metric ops: masked next-token CE, NTP accuracy, in-key ratio.

Counterpart of `musicnlp_tpu/ops/losses.py` (the dense-head path; the tiled
large-vocab CE comes with a later slice).  Labels use PT_LOSS_PAD = -100.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ['PT_LOSS_PAD', 'shifted_ce_loss', 'ntp_accuracy', 'ikr_from_ids']

PT_LOSS_PAD = -100


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
                 key_ordinal: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched in-key ratio: mean over songs with >= 1 pitch of the per-song
    share of pitches diatonic to the song's key ('ins-key': `key_ordinal`
    [B]; 'vanilla': confidence-weighted over the 24 `key_scores`)."""
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
    return torch.where(has_pitch, ratio, torch.zeros_like(ratio)).sum() / n_song
