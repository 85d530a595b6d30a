"""Copy of `musicnlp_tpu/vocab/music_tokenizer.py` (numpy only): the port keeps its own copy
and imports nothing from the JAX package.  Ids and tables must stay identical
(tests/test_torch_vocab.py).

Whitespace music tokenizer over the fixed `MusicVocabulary`.

First-party, HF-free rebuild of the reference tokenizer (reference
musicnlp/vocab/music_tokenizer.py:15-107): whitespace `_tokenize`, default
`model_max_length=4096`, pad/truncate to fixed shapes, and a *vectorized*
`ids2pitches` built on the vocabulary's dense id->midi table (a single numpy
gather instead of a per-token Python loop) so the IKR metric path stays
array-native end to end.
"""
from __future__ import annotations

from typing import Dict, List, Union

import numpy as np

from musicnlp_tpu_torch.vocab.music_vocab import MusicVocabulary

__all__ = ['MusicTokenizer']


class MusicTokenizer:
    def __init__(
            self, precision: int = 5, pitch_kind: str = 'midi', model_max_length: int = 4096,
            vocab: MusicVocabulary = None, **vocab_kwargs,
    ):
        self.precision = precision
        self.vocab = vocab or MusicVocabulary(precision=precision, pitch_kind=pitch_kind, **vocab_kwargs)
        self.pitch_kind = self.vocab.pitch_kind
        self.model_max_length = model_max_length

        self.pad_token = MusicVocabulary.pad
        self.eos_token = MusicVocabulary.end_of_song
        self.pad_token_id = self.vocab.tok2id[self.pad_token]
        self.eos_token_id = self.vocab.tok2id[self.eos_token]

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def __len__(self) -> int:
        return len(self.vocab)

    # ------------------------------------------------------------------ core
    def tokenize(self, text: Union[str, List[str]]) -> List[str]:
        return text if isinstance(text, list) else text.split()

    def convert_tokens_to_ids(self, toks: Union[str, List[str]]):
        if isinstance(toks, str):
            return self.vocab.t2i(toks)
        return [self.vocab.t2i(t) for t in toks]

    def convert_ids_to_tokens(self, ids) -> Union[str, List[str]]:
        if isinstance(ids, (int, np.integer)):
            return self.vocab.i2t(ids)
        return [self.vocab.i2t(i) for i in ids]

    def encode(self, text: Union[str, List[str]], padding: Union[bool, str] = False,
               truncation: bool = False, max_length: int = None) -> List[int]:
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        max_length = max_length or self.model_max_length
        if truncation and len(ids) > max_length:
            ids = ids[:max_length]
        if padding in (True, 'max_length') and len(ids) < max_length:
            ids = ids + [self.pad_token_id] * (max_length - len(ids))
        return ids

    def colorize(self, song: str) -> str:
        """ANSI-colorized token string for terminal display (reference
        music_tokenizer.py:109-110; the `viz_train_aug` writing chore)."""
        return ' '.join(self.vocab.colorize_token(t)
                        for t in self.tokenize(song))

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        if isinstance(ids, (int, np.integer)):
            ids = [ids]
        ids = [int(i) for i in np.asarray(ids).reshape(-1)]
        toks = [self.vocab.i2t(i) for i in ids]
        if skip_special_tokens:
            toks = [t for t in toks if t != self.pad_token]
        return ' '.join(toks)

    def __call__(
            self, text: Union[str, List[str], List[List[str]]],
            padding: Union[bool, str] = False, truncation: bool = False, max_length: int = None,
    ) -> Dict[str, Union[List[int], List[List[int]]]]:
        if isinstance(text, str) or (isinstance(text, list) and text and isinstance(text[0], str)
                                     and self._looks_like_tokens(text)):
            ids = self.encode(text, padding=padding, truncation=truncation, max_length=max_length)
            return dict(input_ids=ids, attention_mask=[int(i != self.pad_token_id) for i in ids])
        # batch of strings / token lists
        out = [self.encode(t, padding=padding, truncation=truncation, max_length=max_length) for t in text]
        return dict(
            input_ids=out,
            attention_mask=[[int(i != self.pad_token_id) for i in ids] for ids in out],
        )

    def _looks_like_tokens(self, lst: List[str]) -> bool:
        """Heuristic: a list of single tokens (no spaces) is one pre-tokenized sequence."""
        return all(' ' not in t for t in lst)

    # ------------------------------------------------------------------ metric support
    def ids2pitches(self, ids, include_rest_pitch: bool = True) -> List[int]:
        """Token ids -> midi pitch values, vectorized (reference music_tokenizer.py:94-107).

        Tuplet pitches are all included; rest pitch is -1.
        """
        ids = np.asarray(ids).reshape(-1)
        midi = self.vocab.id_midi_table[ids]
        lo = -1 if include_rest_pitch else 0
        return midi[midi >= lo].tolist()
