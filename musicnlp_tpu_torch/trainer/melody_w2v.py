"""Pitch embeddings over the time-slot melody representation.

Counterpart of `musicnlp_tpu/trainer/melody_w2v.py` (a rebuild of the
reference's gensim `PitchEmbeddingModel`, reference
musicnlp/trainer/melody_w2v.py:19-82): skip-gram with negative sampling over
`MelodyGridExtractor` id sequences, moved from one jitted JAX step to torch
on an explicit device.

The step keeps the JAX semantics: a loss summed over the batch's pairs; SGD
in which each row takes the mean of its per-pair gradients (counted from the
centers for `emb_in`, from the contexts plus the negatives for `emb_out`);
one fixed batch shape whose tail wraps around the permuted order; and the
mean loss of each epoch.  It gathers rows and adds their gradients back with
`index_add_`, where the TPU step used one-hot matmuls.  All randomness is
numpy (`np.random.default_rng(seed)`), drawn in the JAX class's order (the
init normal, a permutation per epoch, the negatives per batch), so the two
classes agree value by value; `save` / `load` use the same `.npz` layout, so
each package reads the other's file.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from musicnlp_tpu_torch import resolve_device
from musicnlp_tpu_torch.preprocess.melody_grid import GridVocab

__all__ = ['PitchEmbedding']


def _pairs_from_seq(ids: np.ndarray, window: int) -> np.ndarray:
    """All (center, context) pairs within +-window, vectorized."""
    n = len(ids)
    if n < 2:
        return np.empty((0, 2), dtype=np.int32)
    out = []
    for d in range(1, window + 1):
        if d >= n:
            break
        a, b = ids[:-d], ids[d:]
        out.append(np.stack([a, b], axis=1))
        out.append(np.stack([b, a], axis=1))
    return np.concatenate(out, axis=0).astype(np.int32)


def _sgns_step(emb_in: torch.Tensor, emb_out: torch.Tensor, centers: torch.Tensor,
               contexts: torch.Tensor, negatives: torch.Tensor, lr: float) -> torch.Tensor:
    """One skip-gram negative-sampling SGD step over a pair batch, in place.

    [B] centers / contexts, [B, K] negatives (int64).  Returns the loss per
    pair (0-d, on the device)."""
    V, D = emb_in.shape
    ec, eo, en = emb_in[centers], emb_out[contexts], emb_out[negatives]  # [B, D], [B, K, D]
    pos = (ec * eo).sum(-1)
    neg = torch.einsum('bd,bkd->bk', ec, en)
    # sum, not mean: classic SGNS applies lr PER PAIR (gensim semantics)
    loss = (F.softplus(-pos) + F.softplus(neg).sum(-1)).sum()
    g_pos = -torch.sigmoid(-pos)[:, None]          # d softplus(-pos) / d pos
    g_neg = torch.sigmoid(neg)                      # d softplus(neg) / d neg
    grad_in = torch.zeros_like(emb_in).index_add_(
        0, centers, g_pos * eo + torch.einsum('bk,bkd->bd', g_neg, en))
    grad_out = torch.zeros_like(emb_out).index_add_(0, contexts, g_pos * ec).index_add_(
        0, negatives.reshape(-1), (g_neg[..., None] * ec[:, None]).reshape(-1, D))
    # per-ROW mean: a row hit k times gets the average of its k per-pair
    # gradients, keeping updates batch-size invariant
    cnt_in = torch.bincount(centers, minlength=V).clamp(min=1)[:, None]
    cnt_out = (torch.bincount(contexts, minlength=V)
               + torch.bincount(negatives.reshape(-1), minlength=V)).clamp(min=1)[:, None]
    emb_in -= lr * grad_in / cnt_in
    emb_out -= lr * grad_out / cnt_out
    return loss / len(centers)


class PitchEmbedding:
    """Skip-gram pitch embeddings (the reference's `PitchEmbeddingModel`),
    trained on `device` (CUDA unless the caller passes 'cpu')."""

    def __init__(self, vector_size: int = 64, window: int = 10,
                 negatives: int = 5, lr: float = 0.05,
                 vocab_size: int = GridVocab.SIZE, seed: int = 77,
                 device: Optional[Union[str, torch.device]] = None):
        self.dim = vector_size
        self.window = window
        self.k = negatives
        self.lr = lr
        self.vocab_size = vocab_size
        self.rng = np.random.default_rng(seed)
        self.device = resolve_device(device)
        self.emb_in: Optional[np.ndarray] = None
        self.emb_out: Optional[np.ndarray] = None
        self.losses: List[float] = []

    def __call__(self, songs: Iterable[Sequence[int]], epochs: int = 4,
                 batch_size: int = 4096) -> np.ndarray:
        """Train and return the [vocab, dim] input-embedding matrix."""
        seqs = [np.asarray(s, dtype=np.int32) for s in songs]
        seqs = [s[s != GridVocab.PAD] for s in seqs]
        pairs = [_pairs_from_seq(s, self.window) for s in seqs if len(s) >= 2]
        if not pairs or not sum(map(len, pairs)):
            raise ValueError('no training pairs')
        pairs = np.concatenate(pairs, axis=0)

        # unigram^0.75 negative-sampling table (word2vec's standard choice)
        counts = np.bincount(
            np.concatenate(seqs), minlength=self.vocab_size).astype(np.float64)
        probs = counts ** 0.75
        probs /= probs.sum()

        dev = self.device
        scale = 1.0 / self.dim
        emb_in = torch.as_tensor(self.rng.normal(0, scale, (self.vocab_size, self.dim)),
                                 dtype=torch.float32, device=dev)
        emb_out = torch.zeros(self.vocab_size, self.dim, dtype=torch.float32, device=dev)
        pairs_dev = torch.as_tensor(pairs, dtype=torch.int64, device=dev)

        n = len(pairs)
        # one fixed batch shape: small corpora train whole-corpus batches, and
        # the tail wraps around the permuted order rather than being dropped
        bsz = min(batch_size, n)
        for _ in range(epochs):
            order = self.rng.permutation(n)
            epoch_losses = []
            for lo in range(0, n, bsz):
                idx = order[lo:lo + bsz]
                if len(idx) < bsz:
                    idx = np.concatenate([idx, order[:bsz - len(idx)]])
                batch = pairs_dev[torch.as_tensor(idx, device=dev)]
                negs = self.rng.choice(self.vocab_size, size=(bsz, self.k), p=probs)
                epoch_losses.append(_sgns_step(
                    emb_in, emb_out, batch[:, 0], batch[:, 1],
                    torch.as_tensor(negs, dtype=torch.int64, device=dev), self.lr))
            # aggregate over the epoch (a single final-batch sample is noise)
            self.losses.append(float(np.mean(
                torch.stack(epoch_losses).cpu().numpy().astype(np.float64))))
        self.emb_in = emb_in.cpu().numpy()
        self.emb_out = emb_out.cpu().numpy()
        return self.emb_in

    # ------------------------------------------------------------ persistence
    def save(self, path: str):
        """npz snapshot (the reference's gensim `Word2Vec.save` analog), in
        the JAX package's layout."""
        if self.emb_in is None:
            raise ValueError('train before saving')
        np.savez(path, emb_in=self.emb_in, emb_out=self.emb_out,
                 losses=np.asarray(self.losses, dtype=np.float64),
                 meta=np.asarray([self.dim, self.window, self.k,
                                  self.vocab_size], dtype=np.int64))

    @classmethod
    def load(cls, path: str, device: Optional[Union[str, torch.device]] = None
             ) -> 'PitchEmbedding':
        z = np.load(path)
        dim, window, k, vocab = (int(x) for x in z['meta'])
        pe = cls(vector_size=dim, window=window, negatives=k, vocab_size=vocab, device=device)
        pe.emb_in, pe.emb_out = z['emb_in'], z['emb_out']
        pe.losses = [float(x) for x in z['losses']]
        return pe

    # ------------------------------------------------------------------ query
    def vector(self, id_: int) -> np.ndarray:
        if self.emb_in is None:
            raise ValueError('call the trainer first')
        return self.emb_in[id_]

    def similarity(self, a: int, b: int) -> float:
        va, vb = self.vector(a), self.vector(b)
        return float(va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb) + 1e-12))

    def most_similar(self, id_: int, topn: int = 10) -> List[Tuple[int, float]]:
        if self.emb_in is None:
            raise ValueError('call the trainer first')
        e = self.emb_in / (np.linalg.norm(self.emb_in, axis=1, keepdims=True) + 1e-12)
        sims = e @ e[id_]
        order = np.argsort(-sims)
        return [(int(i), float(sims[i])) for i in order if i != id_][:topn]
