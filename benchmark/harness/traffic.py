"""The general generator of the benchmark's rows.

A traffic mix (`traffic/<mix>.json`) names the entry it drives and gives
its batch, row length and how many distinct batches are made: `pool`
batches of `batch` rows, cycled through the window in order.  Rows are
`SyntheticSongs` (a copy of the bring-up smoke test's generator): each row
is TimeSig_4/4, Tempo_120, a Key_* token where the recipe inserts keys, then
bars of a repeated 8-note (pitch, duration) motif up to a random length
between half the row and the row, </s>, and a pad tail whose labels are
-100; `key_scores` is one-hot on the song's key.  Token ids come from the
benchmark's frozen copy of the vocabulary (`data/vocab_<pitch_kind>.json`).
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List

import numpy as np

from benchmark.harness.manifest import BENCH_DIR

LOSS_PAD = -100
N_KEY = 24


@dataclass(frozen=True)
class Vocab:
    tokens: tuple
    pad_id: int
    eos_id: int
    pitch_class: np.ndarray      # int [V], -1 where the token has no pitch
    key_of_id: np.ndarray        # int [V], the key ordinal of a Key_* token, else -1
    key_names: tuple
    inkey: np.ndarray            # bool [12, 24]: pitch class in key

    @property
    def tok2id(self) -> Dict[str, int]:
        return {t: i for i, t in enumerate(self.tokens)}


@lru_cache(maxsize=None)
def vocab(pitch_kind: str) -> Vocab:
    with open(BENCH_DIR / 'data' / f'vocab_{pitch_kind}.json') as f:
        d = json.load(f)
    return Vocab(tuple(d['tokens']), d['pad_id'], d['eos_id'],
                 np.asarray(d['pitch_class'], np.int64), np.asarray(d['key_of_id'], np.int64),
                 tuple(d['key_names']), np.asarray(d['key_inkey_mask'], bool).T.copy())


class SyntheticSongs:
    """Seeded synthetic songs: `ids`, `labels` [n, length] int32 and
    `key_scores` [n, 24] float32 (see the module docstring)."""

    def __init__(self, v: Vocab, n: int, seed: int, length: int, insert_key: bool):
        rng = np.random.default_rng(seed)
        t2i = v.tok2id
        pitches = [i for t, i in t2i.items() if t.startswith('p_')]
        durs = [i for t, i in t2i.items() if t.startswith('d_')]
        self.ids = np.full((n, length), v.pad_id, np.int32)
        self.key_scores = np.zeros((n, N_KEY), np.float32)
        for r in range(n):
            key = int(rng.integers(N_KEY))
            motif = [x for _ in range(8) for x in (rng.choice(pitches), rng.choice(durs))]
            body = []
            while len(body) < int(rng.integers(length // 2, length - 8)):
                body += [t2i['<bar>']] + motif
            row = [t2i['TimeSig_4/4'], t2i['Tempo_120']]
            if insert_key:
                row.append(t2i[f'Key_{v.key_names[key]}'])
            row = (row + body)[:length - 1] + [v.eos_id]
            self.ids[r, :len(row)] = row
            self.key_scores[r, key] = 1.0
        self.labels = np.where(self.ids == v.pad_id, LOSS_PAD, self.ids).astype(np.int32)


def make_pool(traffic: Dict, config: Dict, seed: int) -> List[Dict[str, np.ndarray]]:
    """`traffic['pool']` batches of distinct rows, from `seed`."""
    rec = config['recipe']
    B, T, P = traffic['batch'], traffic['seq_len'], traffic['pool']
    songs = SyntheticSongs(vocab(rec['pitch_kind']), B * P, seed, T, rec['insert_key'])
    return [dict(input_ids=songs.ids[i * B:(i + 1) * B], labels=songs.labels[i * B:(i + 1) * B],
                 key_scores=songs.key_scores[i * B:(i + 1) * B]) for i in range(P)]
