"""Eval metrics: next-token accuracy and the in-key ratio (IKR).

Counterpart of `musicnlp_tpu/trainer/metrics.py`.  Modes: 'vanilla'
(confidence-weighted over the 24 candidate keys) and 'ins-key' (the key read
from the 3rd label token, the `Key_*` token the KeyInsert augmentation puts
there).  Inputs may be numpy arrays or tensors.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from musicnlp_tpu_torch.ops.losses import PT_LOSS_PAD, ikr_from_ids, ntp_accuracy
from musicnlp_tpu_torch.vocab import MusicTokenizer, N_KEY, key_inkey_mask, key_ordinal2str

__all__ = ['IkrMetric', 'ComputeMetrics']


def _t(x, device=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                           device=device)


class IkrMetric:
    def __init__(self, tokenizer: MusicTokenizer, mode: str = 'vanilla'):
        if mode not in ('vanilla', 'ins-key'):
            raise ValueError(f'IKR mode {mode!r}')
        self.tokenizer = tokenizer
        self.mode = mode
        vocab = tokenizer.vocab
        self.id_pitch_class = np.asarray(vocab.id_pitch_class_table, np.int32)
        self.key_inkey_mask = np.asarray(key_inkey_mask)
        # id -> key ordinal ('ins-key' key extraction); -1 = not a key token
        self.id2key_ordinal = np.full(len(vocab), -1, np.int32)
        for o in range(N_KEY):
            tok = f'Key_{key_ordinal2str[o]}'
            if tok in vocab.tok2id:
                self.id2key_ordinal[vocab.tok2id[tok]] = o

    def key_ordinals(self, labels: torch.Tensor) -> torch.Tensor:
        """int [B]: key ordinal of the 3rd label token, 0 where absent."""
        table = torch.as_tensor(self.id2key_ordinal, device=labels.device)
        ids = torch.clamp(labels[:, 2], 0, len(self.id2key_ordinal) - 1).long()
        return torch.clamp(table[ids], min=0)

    def key_ordinals_from_labels(self, labels) -> np.ndarray:
        """int32 [B] numpy: `key_ordinals` under the JAX package's name and
        types (numpy or tensor labels in, numpy out)."""
        return self.key_ordinals(_t(labels)).cpu().numpy().astype(np.int32)

    def on_device(self, preds: torch.Tensor, labels: torch.Tensor,
                  key_scores: Optional[torch.Tensor] = None, with_count: bool = False):
        """IKR as a 0-d tensor on the inputs' device (no host sync); with
        `with_count`, (IKR, the number of songs it averages over)."""
        dev = preds.device
        p, l = preds[:, :-1], labels[:, 1:]
        key_ordinal = None
        if self.mode == 'ins-key':
            key_ordinal = self.key_ordinals(labels)
            key_scores = torch.zeros(preds.shape[0], N_KEY, device=dev)
        elif key_scores is None:
            raise ValueError('vanilla IKR needs key_scores')
        return ikr_from_ids(p, key_scores.to(dev), torch.as_tensor(self.id_pitch_class, device=dev),
                            torch.as_tensor(self.key_inkey_mask, device=dev),
                            valid=l != PT_LOSS_PAD, key_ordinal=key_ordinal,
                            with_count=with_count)

    def __call__(self, preds, labels, key_scores=None) -> float:
        """preds [B, T] argmaxed ids, labels [B, T] with -100 pads, key_scores [B, 24]."""
        preds, labels = _t(preds), _t(labels)
        ks = None if key_scores is None else _t(key_scores).float()
        return float(self.on_device(preds, labels.to(preds.device), ks))

    def ground_truth_ikr(self, ids, key_scores, best_key_only: bool = False) -> float:
        """IKR of the data itself (reference metrics.py:207-247 sanity anchor,
        ~0.95 on POP909): ids [B, T], key_scores [B, 24]; with best_key_only
        each song takes its highest-scored key alone."""
        ids = _t(ids)
        ks = _t(key_scores).float().to(ids.device)
        if best_key_only:
            ks = torch.nn.functional.one_hot(ks.argmax(dim=1), ks.shape[1]).float()
        return float(ikr_from_ids(ids, ks, torch.as_tensor(self.id_pitch_class, device=ids.device),
                                  torch.as_tensor(self.key_inkey_mask, device=ids.device)))


class ComputeMetrics:
    """Eval-loop metric bundle: NTP accuracy + IKR."""

    def __init__(self, tokenizer: MusicTokenizer, mode: str = 'vanilla'):
        self.ikr = IkrMetric(tokenizer, mode=mode)

    def __call__(self, preds, labels, key_scores=None) -> Dict[str, float]:
        acc = float(ntp_accuracy(_t(preds), _t(labels)))
        return dict(ntp_acc=acc, ikr=self.ikr(preds, labels, key_scores))
