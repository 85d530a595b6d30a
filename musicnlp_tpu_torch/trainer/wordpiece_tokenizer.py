"""WordPiece music tokenizer: learned merges over note-token runs.

Counterpart of `musicnlp_tpu/trainer/wordpiece_tokenizer.py` (pure Python,
numpy and the native library; the port imports nothing from the JAX
package): `Score2Word` splits a token string into words (global tokens and
structural markers stand alone, the note runs between them are one word
each), `WordPieceMusicTrainer` trains a unit table over a corpus (the key
-augmented one of the reference, `key_augmented_corpus`), and
`WordPieceMusicTokenizer` is the `MusicTokenizer` API over a trained table
(`from_file` reads `.json` and the shipped `.json.gz`).  The "characters"
are the base-vocabulary ids; training and encoding run in the port's own
build of `native/wordpiece.cpp` and raise when it cannot be built, where the
JAX package falls back to its Python copy (`native/_py_wordpiece.py` here is
the plain version the tests hold the library against).
"""
from __future__ import annotations

import ctypes
import gzip
import json
import os
from collections import Counter
from typing import Dict, Iterable, List, Sequence, Tuple, Union

import numpy as np

from musicnlp_tpu_torch.native import load_wordpiece_lib
from musicnlp_tpu_torch.vocab import (
    MusicTokenizer, MusicVocabulary, VocabType, WORDPIECE_CONTINUING_PREFIX,
)

__all__ = ['Score2Word', 'WordPieceMusicTrainer', 'WordPieceMusicTokenizer']

Unit = Tuple[bool, Tuple[int, ...]]      # (continuing?, symbol sequence)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_longlong)
_I8P = ctypes.POINTER(ctypes.c_int8)


class Score2Word:
    """Token string -> words (lists of base tokens): global tokens (time-sig,
    tempo, key, [OMIT]) and structural markers (<bar>, <melody>, <bass>,
    <tup>, </tup>, </s>) are standalone words; note runs in between are one
    word each."""

    def __init__(self, vocab: MusicVocabulary):
        self.vocab = vocab
        v = vocab
        self.spec_toks = {v.start_of_bar, v.start_of_melody, v.start_of_bass,
                          v.start_of_tuplet, v.end_of_tuplet, v.end_of_song,
                          v.omitted_segment}

    def __call__(self, text: Union[str, List[str]]) -> List[List[str]]:
        toks = text.split() if isinstance(text, str) else list(text)
        words: List[List[str]] = []
        cur: List[str] = []
        for t in toks:
            typ = self.vocab.type(t)
            standalone = (t in self.spec_toks
                          or typ in (VocabType.time_sig, VocabType.tempo, VocabType.key))
            if standalone:
                if cur:
                    words.append(cur)
                    cur = []
                words.append([t])
            else:
                cur.append(t)
        if cur:
            words.append(cur)
        return words


def _train_native(words: Sequence[Sequence[int]], counts: Sequence[int], n_base: int,
                  n_merges: int) -> List[Unit]:
    """The native trainer: the full unit table (2 * n_base alphabet units,
    initial then continuing forms, then the merges in creation order)."""
    lib = load_wordpiece_lib()
    syms = (np.concatenate([np.asarray(w, np.int32) for w in words]) if words
            else np.zeros(0, np.int32))
    offs = np.zeros(len(words) + 1, np.int64)
    np.cumsum([len(w) for w in words], out=offs[1:])
    cnts = np.asarray(counts, np.int64)
    out_cap = 2 * n_base + n_merges + 1
    out_offs = np.zeros(out_cap + 1, np.int64)
    out_cont = np.zeros(out_cap, np.int8)
    # merged units carry their full symbol expansion, so the emitted symbol
    # count depends on the corpus; retry with doubled capacity on overflow (-1)
    sym_cap = int(syms.size + out_cap * 8 + 4 * n_base)
    n_units = -1
    for _ in range(6):
        out_syms = np.zeros(sym_cap, np.int32)
        n_units = lib.wp_train(
            syms.ctypes.data_as(_I32P), offs.ctypes.data_as(_I64P), cnts.ctypes.data_as(_I64P),
            len(words), n_base, n_merges, out_syms.ctypes.data_as(_I32P), out_syms.size,
            out_offs.ctypes.data_as(_I64P), out_cont.ctypes.data_as(_I8P), out_cap)
        if n_units > 0:
            break
        sym_cap *= 2
    if n_units <= 0:
        raise RuntimeError(f'native WordPiece training failed (capacity {sym_cap} symbols)')
    return [(bool(out_cont[u]), tuple(int(x) for x in out_syms[out_offs[u]:out_offs[u + 1]]))
            for u in range(n_units)]


class WordPieceMusicTrainer:
    """Corpus -> trained WordPiece unit table."""

    def __init__(self, pitch_kind: str = 'degree', precision: int = 5):
        self.vocab = MusicVocabulary(precision=precision, pitch_kind=pitch_kind)
        self.s2w = Score2Word(self.vocab)

    @staticmethod
    def key_augmented_corpus(songs):
        """Each song once per candidate key, rare-sanitized, key-inserted and
        degree-shifted: the reference's training corpus.  SanitizeRare runs
        first, as in the train-time `StringAugmentedDataset` chain, so the
        table never mints units of off-lattice durations the model cannot
        emit."""
        from musicnlp_tpu_torch.preprocess import transform as tsf
        from musicnlp_tpu_torch.preprocess.dataset import iter_song_w_all_keys
        ak = tsf.AugmentKey()
        san = tsf.SanitizeRare()
        for score, key in iter_song_w_all_keys(list(songs)).generator:
            yield ak((san(score), key))

    def __call__(self, songs: Iterable[Union[str, Dict]], vocab_size: int,
                 save: str = None) -> 'WordPieceMusicTokenizer':
        n_base = len(self.vocab)
        n_merges = vocab_size - 2 * n_base
        if n_merges <= 0:
            raise ValueError(f'vocab_size must exceed {2 * n_base}')
        wc: Counter = Counter()
        for s in songs:
            text = s['score'] if isinstance(s, dict) else s
            for w in self.s2w(text):
                wc[tuple(self.vocab.t2i(t) for t in w)] += 1
        units = _train_native([list(w) for w in wc], list(wc.values()), n_base, n_merges)
        meta = dict(
            units=[[int(c), list(sy)] for c, sy in units],
            music_vocab=dict(precision=self.vocab.precision, pitch_kind=self.vocab.pitch_kind),
            vocab_size=len(units), n_base=n_base,
            continuing_prefix=WORDPIECE_CONTINUING_PREFIX,
        )
        if save:
            os.makedirs(os.path.dirname(save) or '.', exist_ok=True)
            with open(save, 'w') as f:
                json.dump(meta, f)
        return WordPieceMusicTokenizer(meta)


class _NativeEncoder:
    """The native greedy longest-match encoder over a unit table.  It owns
    the library's handle and frees it once; a copy or a pickle rebuilds it
    from the units, so no two objects share a handle."""

    def __init__(self, units: Sequence[Unit]):
        self.units = units
        self._lib = load_wordpiece_lib()
        us = np.concatenate([np.asarray(sy, np.int32) for _, sy in units])
        uo = np.zeros(len(units) + 1, np.int64)
        np.cumsum([len(sy) for _, sy in units], out=uo[1:])
        uc = np.asarray([int(c) for c, _ in units], np.int8)
        # the encoder copies the table into its tries
        self._handle = self._lib.wp_encoder_new(us.ctypes.data_as(_I32P), uo.ctypes.data_as(_I64P),
                                                uc.ctypes.data_as(_I8P), len(units))
        if not self._handle:
            raise RuntimeError('wp_encoder_new returned no encoder')

    def __reduce__(self):
        return _NativeEncoder, (self.units,)

    def __del__(self):
        handle, self._handle = getattr(self, '_handle', None), None
        if handle:
            self._lib.wp_encoder_free(handle)

    def encode(self, sym_ids: Sequence[int]) -> List[int]:
        arr = np.asarray(sym_ids, np.int32)
        out = np.zeros(len(sym_ids) + 1, np.int32)
        n = self._lib.wp_encode(self._handle, arr.ctypes.data_as(_I32P), len(sym_ids),
                                out.ctypes.data_as(_I32P), out.size)
        if n < 0:
            raise ValueError(f'the unit table cannot encode the word {list(sym_ids)}')
        return [int(x) for x in out[:n]]


class WordPieceMusicTokenizer(MusicTokenizer):
    """The MusicTokenizer API over a trained unit table: a unit id is the
    token id; pad and eos are the initial alphabet forms of the base ids."""

    def __init__(self, meta: Dict, model_max_length: int = 4096):
        mv = meta['music_vocab']
        super().__init__(precision=mv['precision'], pitch_kind=mv['pitch_kind'],
                         model_max_length=model_max_length, is_wordpiece=True)
        self.meta = meta
        self.units: List[Unit] = [(bool(c), tuple(sy)) for c, sy in meta['units']]
        self.s2w = Score2Word(self.vocab)
        self._enc = _NativeEncoder(self.units)
        self.pad_token_id = self.vocab.tok2id[self.pad_token]
        self.eos_token_id = self.vocab.tok2id[self.eos_token]
        self._id2pitches_cache: Dict[int, List[int]] = {}

    @classmethod
    def from_file(cls, path: str, **kwargs) -> 'WordPieceMusicTokenizer':
        opener = gzip.open if path.endswith('.gz') else open
        with opener(path, 'rt') as f:
            return cls(json.load(f), **kwargs)

    @property
    def vocab_size(self) -> int:
        return len(self.units)

    def __len__(self):
        return self.vocab_size

    # ------------------------------------------------------------------ core
    def tokenize(self, text: Union[str, List[str]]) -> List[str]:
        return [self._unit2str(u) for u in self._encode_units(text)]

    def _encode_units(self, text: Union[str, List[str]]) -> List[int]:
        out: List[int] = []
        for w in self.s2w(text):
            out += self._enc.encode([self.vocab.t2i(t) for t in w])
        return out

    def _unit2str(self, uid: int) -> str:
        cont, syms = self.units[uid]
        s = ' '.join(self.vocab.i2t(i) for i in syms)
        return f'{WORDPIECE_CONTINUING_PREFIX}{s}' if cont else s

    def encode(self, text: Union[str, List[str]], padding=False, truncation: bool = False,
               max_length: int = None) -> List[int]:
        ids = self._encode_units(text)
        max_length = max_length or self.model_max_length
        if truncation and len(ids) > max_length:
            ids = ids[:max_length]
        if padding in (True, 'max_length') and len(ids) < max_length:
            ids = ids + [self.pad_token_id] * (max_length - len(ids))
        return ids

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        if isinstance(ids, (int, np.integer)):
            ids = [ids]
        toks: List[str] = []
        for i in np.asarray(ids).reshape(-1):
            base = [self.vocab.i2t(s) for s in self.units[int(i)][1]]
            if skip_special_tokens:
                base = [t for t in base if t != self.pad_token]
            toks += base
        return ' '.join(toks)

    # ------------------------------------------------------------------ metrics
    def ids2pitches(self, ids, include_rest_pitch: bool = True) -> List[int]:
        tbl = self.vocab.id_midi_table
        lo = -1 if include_rest_pitch else 0
        out: List[int] = []
        for i in np.asarray(ids).reshape(-1):
            i = int(i)
            if i not in self._id2pitches_cache:
                self._id2pitches_cache[i] = [int(tbl[s]) for s in self.units[i][1]
                                             if int(tbl[s]) >= -1]
            out += [p for p in self._id2pitches_cache[i] if p >= lo]
        return out
