"""Copy of `musicnlp_tpu/native/_py_wordpiece.py` (pure Python): the port keeps its own copy
and imports nothing from the JAX package.

Pure-Python WordPiece trainer/encoder, semantics-identical to wordpiece.cpp.

In the port it is the plain version of the native library, which the tests
hold equal to it; the tokenizer never falls back to it.  Same objective as
HF's WordPiece trainer: repeatedly merge the adjacent unit pair maximizing
count(ab) / (count(a) * count(b)).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ['py_train', 'PyEncoder']

Unit = Tuple[bool, Tuple[int, ...]]   # (continuing?, symbol sequence)


def py_train(words: Sequence[Sequence[int]], counts: Sequence[int],
             n_base: int, n_merges: int) -> List[Unit]:
    """Returns the full unit table: 2*n_base alphabet units (initial forms
    then continuing forms, in symbol order) followed by merges in creation
    order.  Reference implementation -- O(#pairs) scan per merge; fine for
    tests and small corpora, use the C++ lib for real training."""
    units: List[Unit] = [(False, (s,)) for s in range(n_base)]
    units += [(True, (s,)) for s in range(n_base)]
    unit_count = [0] * len(units)
    seqs: List[List[int]] = []
    for w in words:
        seq = [w[0] if i == 0 else w[i] + n_base for i in range(len(w))]
        seqs.append(seq)
    for seq, c in zip(seqs, counts):
        for u in seq:
            unit_count[u] += c

    for _ in range(n_merges):
        pair_count: Dict[Tuple[int, int], int] = {}
        for seq, c in zip(seqs, counts):
            for a, b in zip(seq[:-1], seq[1:]):
                pair_count[(a, b)] = pair_count.get((a, b), 0) + c
        best, best_score = None, 0.0
        for (a, b) in sorted(pair_count):    # deterministic tie-break:
            c = pair_count[(a, b)]           # smaller (a, b) wins on equal score
            if c <= 0:
                continue
            s = c / (unit_count[a] * unit_count[b])
            if s > best_score:
                best, best_score = (a, b), s
        if best is None:
            break
        a, b = best
        nid = len(units)
        units.append((units[a][0], units[a][1] + units[b][1]))
        unit_count.append(0)
        for seq, c in zip(seqs, counts):
            i = 0
            while i < len(seq) - 1:
                if seq[i] == a and seq[i + 1] == b:
                    seq[i:i + 2] = [nid]
                    unit_count[a] -= c
                    unit_count[b] -= c
                    unit_count[nid] += c
                else:
                    i += 1
    return units


class PyEncoder:
    """Greedy longest-match encoder over a unit table."""

    def __init__(self, units: Sequence[Unit]):
        self.init_map: Dict[Tuple[int, ...], int] = {}
        self.cont_map: Dict[Tuple[int, ...], int] = {}
        self.max_len = 1
        for uid, (cont, syms) in enumerate(units):
            (self.cont_map if cont else self.init_map)[tuple(syms)] = uid
            self.max_len = max(self.max_len, len(syms))

    def encode(self, word: Sequence[int]) -> Optional[List[int]]:
        out: List[int] = []
        pos, first = 0, True
        n = len(word)
        while pos < n:
            table = self.init_map if first else self.cont_map
            match = None
            for ln in range(min(self.max_len, n - pos), 0, -1):
                uid = table.get(tuple(word[pos:pos + ln]))
                if uid is not None:
                    match = (uid, ln)
                    break
            if match is None:
                return None
            out.append(match[0])
            pos += match[1]
            first = False
        return out
