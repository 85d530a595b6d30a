"""Copy of `musicnlp_tpu/postprocess/music_stats.py` (pure Python): the port keeps its own copy
and imports nothing from the JAX package; only the import paths differ
(held against the original by tests/test_torch_postprocess.py).

Corpus statistics over token sequences.

Rebuild of the reference `MusicStats` (reference musicnlp/postprocess/music_stats.py:12-68):
per-type token-meta counters and duration-weighted pitch histograms (tuplet
pitches get an even split of the tuplet duration).
"""
from __future__ import annotations

import itertools
from collections import Counter
from fractions import Fraction
from typing import Dict, Iterable, List, Union

from musicnlp_tpu_torch.preprocess.music_converter import MusicConverter
from musicnlp_tpu_torch.vocab import ElmType, MusicVocabulary, VocabType

__all__ = ['MusicStats']


class MusicStats:
    def __init__(self, prec: int = 5, converter_kw: Dict = None,
                 pitch_kind: str = 'midi'):
        self.prec = prec
        self.converter = MusicConverter(precision=prec, **(converter_kw or {}))
        self.pitch_kind = pitch_kind
        self.vocab: MusicVocabulary = self.converter.pk2v[pitch_kind]

    def vocab_type_counts(self, toks: Iterable[str], strict: bool = True
                          ) -> Dict[str, Counter]:
        """Counter over token metas, grouped by vocab type (reference :21-33)."""
        out: Dict[str, Counter] = {}
        for tok in toks:
            typ = self.vocab.type(tok)
            if typ == VocabType.special:
                continue
            meta = self.vocab.tok2meta(tok, strict=strict)
            if isinstance(meta, list):
                meta = tuple(meta)
            out.setdefault(typ.name, Counter())[meta] += 1
        return out

    def weighted_pitch_counts(self, toks: Union[str, List[str]]
                              ) -> Dict[int, Fraction]:
        """Pitch counts weighted by duration in quarterLength (reference :35-68)."""
        out = self.converter.str2music_elms(toks, pitch_kind=self.pitch_kind)
        rare_p = self.vocab.rare_pitch_meta
        pch2dur: Dict[int, Fraction] = {}
        for elm in out.elms:
            if elm.type == ElmType.note:
                m_p, m_d = elm.meta
                if self.pitch_kind != 'midi' and m_p != rare_p:
                    m_p = m_p[0]
                pairs = [(m_p, m_d)]
            elif elm.type == ElmType.tuplets:
                ms_p, m_d = elm.meta
                if self.pitch_kind != 'midi':
                    ms_p = [(p if p == rare_p else p[0]) for p in ms_p]
                share = Fraction(m_d) / len(ms_p)
                pairs = [(p, share) for p in ms_p]
            else:
                continue
            for p, d in pairs:
                if p == rare_p or d is None:
                    continue
                pch2dur[p] = pch2dur.get(p, Fraction(0)) + Fraction(d)
        return pch2dur

    def song_stats(self, text: Union[str, List[str]]) -> Dict:
        """Summary dict for one song: token/bar counts, tuplet/rare ratios."""
        toks = text.split() if isinstance(text, str) else list(text)
        v = self.vocab
        n_bar = sum(1 for t in toks if t == v.start_of_bar)
        n_tup = sum(1 for t in toks if t == v.start_of_tuplet)
        n_rare = sum(1 for t in toks if t in MusicVocabulary.rare_tokens)
        n_pitch = sum(1 for t in toks if v.type(t) == VocabType.pitch)
        return dict(n_token=len(toks), n_bar=n_bar, n_tuplet=n_tup,
                    n_pitch=n_pitch,
                    rare_ratio=n_rare / max(len(toks), 1))
