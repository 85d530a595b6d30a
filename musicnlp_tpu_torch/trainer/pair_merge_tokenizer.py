"""Copy of `musicnlp_tpu/trainer/pair_merge_tokenizer.py` (pure Python / numpy): the port keeps
its own copy over its own `preprocess/music_converter.py` and imports nothing
from the JAX package; only the import paths differ.

Pair-merge tokenizer: whole music elements as single merged tokens.

Rebuild of the reference (reference musicnlp/trainer/pair_merge_tokenizer.py:41-153
trainer, :241-266 tokenizer): count whole music elements (a note = its
pitch+duration pair, a tuplet = the full <tup>...</tup> group) over a corpus,
add the top-N most frequent as single vocabulary entries until `vocab_size`
or `coverage_ratio` (e.g. 0.95 -> 4642 added tokens on the reference corpora),
then tokenize greedily: a bar's element emits its merged token when trained,
else falls back to the base tokens.  decode(encode(x)) == x by construction.

The trained artifact is a JSON (added_tok2id + meta), mirroring the
reference's checkpoint format (:110-134).
"""
from __future__ import annotations

import json
import logging
import os
from collections import Counter
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

logger = logging.getLogger(__name__)

from musicnlp_tpu_torch.preprocess.music_converter import MusicConverter
from musicnlp_tpu_torch.vocab import MusicTokenizer, MusicVocabulary

__all__ = ['PairMergeTokenizerTrainer', 'PairMergeTokenizer']


class PairMergeTokenizerTrainer:
    def __init__(self, pitch_kind: str = 'degree', mode: str = 'full',
                 precision: int = 5):
        self.pitch_kind = pitch_kind
        self.mode = mode
        self.vocab = MusicVocabulary(precision=precision, pitch_kind=pitch_kind)
        self.mc = MusicConverter(mode=mode, precision=precision)

    def _song2uniq_elms(self, song: str) -> List[str]:
        """One song's element strings, channel markers excluded
        (reference :135-143)."""
        v = self.vocab
        out = self.mc.str2tok_elms(song)
        ret = []
        for elms in out.elms_by_bar:
            for me in elms:
                if me != [v.start_of_melody] and me != [v.start_of_bass]:
                    ret.append(' '.join(me))
        return ret

    @staticmethod
    def _counter2ratio(counter: Counter) -> Tuple[np.ndarray, np.ndarray]:
        counts = np.sort(np.fromiter(counter.values(), dtype=np.int64))[::-1]
        return counts, np.cumsum(counts) / counts.sum()

    def __call__(
            self, songs: Sequence[Union[str, Dict]], vocab_size: int = None,
            coverage_ratio: float = None, save: str = None,
    ) -> 'PairMergeTokenizer':
        """songs: token strings or song dicts with a 'score' field.  Exactly
        one of vocab_size / coverage_ratio must be given (reference :56-60)."""
        if bool(vocab_size) == bool(coverage_ratio):
            raise ValueError('Specify exactly one of vocab_size / coverage_ratio')
        c: Counter = Counter()
        for s in songs:
            text = s['score'] if isinstance(s, dict) else s
            c.update(self._song2uniq_elms(text))
        n_uniq = len(c)
        counts, ratio = self._counter2ratio(c)
        if vocab_size:
            vsz_add = vocab_size - len(self.vocab)
            if vsz_add >= n_uniq:
                vsz_add, coverage_ratio = n_uniq, 1.0
            else:
                coverage_ratio = float(ratio[vsz_add - 1]) if vsz_add > 0 else 0.0
        else:
            vsz_add = int(np.searchsorted(ratio, coverage_ratio, side='left')) + 1
            vsz_add = min(vsz_add, n_uniq)
        mc = c.most_common(vsz_add)
        n_base = len(self.vocab)
        added_tok2id = {tok: i + n_base for i, (tok, _) in enumerate(mc)}
        meta = dict(
            added_tok2id=added_tok2id, n_unique=n_uniq, n_added=vsz_add,
            occurrence_count=dict(mc), original_vocab_size=n_base,
            coverage_ratio=coverage_ratio,
            music_vocab=dict(precision=self.vocab.precision,
                             pitch_kind=self.pitch_kind), mode=self.mode,
        )
        if save:
            os.makedirs(os.path.dirname(save) or '.', exist_ok=True)
            with open(save, 'w') as f:
                json.dump(meta, f, indent=2)
        return PairMergeTokenizer(meta)


class PairMergeTokenizer(MusicTokenizer):
    """MusicTokenizer-compatible tokenizer with merged element tokens."""

    def __init__(self, meta: Dict, model_max_length: int = 4096):
        mv = meta['music_vocab']
        super().__init__(precision=mv['precision'], pitch_kind=mv['pitch_kind'],
                         model_max_length=model_max_length)
        self.meta = meta
        self.mode = meta.get('mode', 'full')
        self.added_tok2id: Dict[str, int] = dict(meta['added_tok2id'])
        self.added_id2tok: Dict[int, str] = {v: k for k, v in self.added_tok2id.items()}
        self.mc = MusicConverter(mode=self.mode, precision=mv['precision'])
        self._id2pitches_cache: Dict[int, List[int]] = {}
        # observability for the ungrammatical-input fallback: if a parser
        # regression ever made GRAMMATICAL corpus text take this path, every
        # training sample would silently train without merged tokens
        self.fallback_count = 0

    @classmethod
    def from_file(cls, path: str, **kwargs) -> 'PairMergeTokenizer':
        with open(path) as f:
            return cls(json.load(f), **kwargs)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab) + len(self.added_tok2id)

    def __len__(self):
        return self.vocab_size

    # ------------------------------------------------------------------ core
    def tokenize(self, text: Union[str, List[str]]) -> List[str]:
        """Greedy merged-element tokenization (reference :241-266).

        Input that violates the song grammar (e.g. a RAW model sample where a
        duration follows a duration) cannot be segmented into elements; it
        falls back to unmerged base tokens instead of raising, so encode()
        is total over model output.  Grammar-repaired text always parses."""
        if isinstance(text, list):
            text = ' '.join(text)
        v = self.vocab
        try:
            out = self.mc.str2tok_elms(text)
        except Exception as e:
            # expected for RAW model samples only; on this path merged tokens
            # are unused and off-lattice tokens sanitize (decode∘encode is
            # not exact), so count + warn once rather than stay silent
            self.fallback_count += 1
            if self.fallback_count == 1:
                logger.warning(
                    'PairMergeTokenizer: input did not parse as a song '
                    '(%s: %s); falling back to unmerged base tokens. '
                    'Expected for raw generated text -- if this fires on '
                    'corpus text, merged tokens are silently unused '
                    '(see .fallback_count).', type(e).__name__, e)
            return [v.sanitize_rare_token(t) for t in text.split()]
        ret: List[str] = [out.time_sig, out.tempo]
        if out.key:
            ret.append(out.key)
        if out.omit:
            ret.append(out.omit)
        for elms in out.elms_by_bar:
            ret.append(v.start_of_bar)
            for me in elms:
                merged = ' '.join(me)
                if merged in self.added_tok2id:
                    ret.append(merged)
                else:
                    ret.extend(me)
        if out.end_of_song:
            ret.append(out.end_of_song)
        return ret

    def convert_tokens_to_ids(self, toks: Union[str, List[str]]):
        if isinstance(toks, str):
            return self.added_tok2id.get(toks, None) \
                if ' ' in toks else self.vocab.t2i(toks)
        return [self.convert_tokens_to_ids(t) for t in toks]

    def convert_ids_to_tokens(self, ids):
        if isinstance(ids, (int, np.integer)):
            i = int(ids)
            return self.added_id2tok[i] if i >= len(self.vocab) else self.vocab.i2t(i)
        return [self.convert_ids_to_tokens(i) for i in ids]

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        if isinstance(ids, (int, np.integer)):
            ids = [ids]
        ids = [int(i) for i in np.asarray(ids).reshape(-1)]
        toks = [self.convert_ids_to_tokens(i) for i in ids]
        if skip_special_tokens:
            toks = [t for t in toks if t != self.pad_token]
        return ' '.join(toks)

    # ------------------------------------------------------------------ metrics
    def ids2pitches(self, ids, include_rest_pitch: bool = True) -> List[int]:
        """Merged ids expand to their constituent pitches (reference's id ->
        pitch cache, wordpiece_tokenizer.py:372-379 analog)."""
        n_base = len(self.vocab)
        out: List[int] = []
        base_tbl = self.vocab.id_midi_table
        lo = -1 if include_rest_pitch else 0
        for i in np.asarray(ids).reshape(-1):
            i = int(i)
            if i < n_base:
                m = int(base_tbl[i])
                if m >= lo:
                    out.append(m)
            else:
                if i not in self._id2pitches_cache:
                    toks = self.added_id2tok[i].split()
                    self._id2pitches_cache[i] = [
                        int(base_tbl[self.vocab.tok2id[t]])
                        for t in toks if t in self.vocab.tok2id
                        and int(base_tbl[self.vocab.tok2id[t]]) >= -1]
                out.extend(p for p in self._id2pitches_cache[i] if p >= lo)
        return out
