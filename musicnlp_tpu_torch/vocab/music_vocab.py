"""Copy of `musicnlp_tpu/vocab/music_vocab.py` (numpy only): the port keeps its own copy
and imports nothing from the JAX package.  Ids and tables must stay identical
(tests/test_torch_vocab.py).

The music token language: fixed closed vocabulary over 6 token types.

TPU-native rebuild of the reference vocabulary (reference musicnlp/vocab/music_vocab.py:112).
Token inventory, ordering, and ids reproduce the reference construction rules exactly:
  special(8) | time_sig(1+7) | tempo(1+201+1) | key(24) | pitch | duration(1+48)
with three pitch kinds (reference music_vocab.py:273-295):
  midi   - 130 pitch tokens (rest + rare + 128 midi values)            -> vocab 422
  step   - letter-name spelling `p_<idx>/<octave>_<step>`              -> vocab ~560
  degree - scale degree in [1,7] x 128 midi `p_<idx>/<octave>_<deg>`   -> vocab 1190

Differences from the reference implementation (not from its behavior): no music21
objects anywhere; on top of the string API this class *compiles dense numpy lookup
tables* (id -> type / midi / pitch-class / duration slot) so that augmentation and
metrics downstream run as integer array ops on fixed-shape tensors (TPU-friendly),
instead of per-token Python string processing.
"""
from __future__ import annotations

import math
import re
from enum import Enum
from fractions import Fraction
from functools import cached_property
from typing import Dict, List, Optional, Set, Tuple, Union

import numpy as np

from musicnlp_tpu_torch.vocab.elm_type import (
    ElmType, MusicElement, Key, key_str2enum, enum2key_str,
)

__all__ = [
    'COMMON_TEMPOS', 'is_common_tempo', 'COMMON_TIME_SIGS', 'is_common_time_sig',
    'get_common_time_sig_duration_bound', 'TEMPO_LOW_EDGE', 'TEMPO_HIGH_EDGE',
    'WORDPIECE_CONTINUING_PREFIX', 'VocabType', 'MusicVocabulary', 'nrp',
]

# Sorted first by denominator then numerator (reference music_vocab.py:29-32)
COMMON_TIME_SIGS: List[Tuple[int, int]] = sorted(
    [(4, 4), (2, 4), (2, 2), (3, 4), (6, 8), (5, 4), (12, 8)],
    key=lambda t: tuple(reversed(t)),
)
TEMPO_LOW_EDGE, TEMPO_HIGH_EDGE = 40, 240  # inclusive
COMMON_TEMPOS: List[int] = list(range(TEMPO_LOW_EDGE, TEMPO_HIGH_EDGE + 1))

_COMMON_TS_SET = set(COMMON_TIME_SIGS)
_COMMON_TEMPO_SET = set(COMMON_TEMPOS)

WORDPIECE_CONTINUING_PREFIX = '##'


def is_common_time_sig(ts: Tuple[int, int]) -> bool:
    return tuple(ts) in _COMMON_TS_SET


def is_common_tempo(tempo: int) -> bool:
    return tempo in _COMMON_TEMPO_SET


def get_common_time_sig_duration_bound() -> float:
    return max(n / d for n, d in COMMON_TIME_SIGS) * 4


class VocabType(Enum):
    time_sig, tempo, key, duration, pitch, special = range(6)

    @classmethod
    def with_meta(cls):
        for i in range(5):
            yield cls(i)


# music21-compatible letter-name -> pitch class
STEP2PC: Dict[str, int] = dict(C=0, D=2, E=4, F=5, G=7, A=9, B=11)

TokenMeta = Union[Tuple[int, int], int, Fraction, Key, Tuple[None, None], None]


def _frac_str(f: Fraction) -> str:
    return str(f.numerator) if f.denominator == 1 else f'{f.numerator}/{f.denominator}'


class MusicVocabulary:
    """String token <-> integer id mapping plus dense id-indexed tables."""

    pad = '[PAD]'
    omitted_segment = '[OMIT]'
    start_of_bar = '<bar>'
    start_of_melody = '<melody>'
    start_of_bass = '<bass>'
    end_of_song = '</s>'
    start_of_tuplet = '<tup>'
    end_of_tuplet = '</tup>'

    sep = '_'
    time_sig_pref = 'TimeSig'
    tempo_pref = 'Tempo'
    key_pref = 'Key'
    pitch_pref = 'p'
    dur_pref = 'd'
    rare_time_sig = 'TimeSig_rare'
    rare_low_tempo = 'Tempo_low'
    rare_high_tempo = 'Tempo_high'
    rare_pitch = 'p_rare'
    rare_duration = 'd_rare'
    rare_tokens = [rare_time_sig, rare_low_tempo, rare_high_tempo, rare_pitch, rare_duration]

    rare_time_sig_meta: Tuple[None, None] = (None, None)
    low_tempo_meta = TEMPO_LOW_EDGE - 1
    high_tempo_meta = TEMPO_HIGH_EDGE + 1
    rare_pitch_meta = None
    rare_duration_meta = None

    special_elm_type2tok = {
        ElmType.seg_omit: omitted_segment,
        ElmType.bar_start: start_of_bar,
        ElmType.melody: start_of_melody,
        ElmType.bass: start_of_bass,
        ElmType.song_end: end_of_song,
    }

    midi_rest_pitch_meta = _rest_pitch_meta = -1
    step_rest_pitch_meta = degree_rest_pitch_meta = (_rest_pitch_meta, None)
    pitch_kind2rest_pitch_meta = dict(
        midi=_rest_pitch_meta, step=step_rest_pitch_meta, degree=degree_rest_pitch_meta)

    # Possible pitch step names per local (1-based) pitch index (reference music_vocab.py:191-205)
    _atonal_pitch_index2name: Dict[int, Tuple[List[str], List[str]]] = {
        1: (['C'], ['B#']),
        2: (['C#', 'D-'], []),
        3: (['D'], ['C##']),
        4: (['D#', 'E-'], []),
        5: (['E'], ['F-']),
        6: (['F'], ['E#']),
        7: (['F#', 'G-'], []),
        8: (['G'], ['F##']),
        9: (['G#', 'A-'], []),
        10: (['A'], ['B--', 'G##']),
        11: (['A#', 'B-'], []),
        12: (['B'], ['C-']),
    }
    # (local index, step letter) pairs considered rarest, excluded from step vocab
    # (reference music_vocab.py:211-225)
    _rarest_pitch_index_n_names: Set[Tuple[int, str]] = {(11, 'C'), (3, 'E'), (5, 'D')}
    _rarest_pitch_tokens: Set[str] = {
        'p_12/10_C', 'p_8/10_G', 'p_5/10_E', 'p_9/9_A', 'p_10/9_A', 'p_6/10_F',
        'p_1/10_C', 'p_9/9_G', 'p_7/10_F', 'p_11/9_A', 'p_4/10_D', 'p_1/-2_C',
        'p_1/-3_C', 'p_11/9_B', 'p_4/10_E', 'p_4/-2_E', 'p_3/-2_D', 'p_3/10_D',
        'p_10/10_A', 'p_2/10_C', 'p_2/-2_D', 'p_12/-1_C', 'p_1/9_B',
    }

    RE_INT = r'[-]?\d*'
    _re_pitch_midi = re.compile(rf'^p_(?P<numer>{RE_INT})/(?P<denom>{RE_INT})$')
    _re_pitch_step = re.compile(rf'^p_(?P<numer>{RE_INT})/(?P<denom>{RE_INT})_(?P<step>[A-G])$')
    _re_pitch_degree = re.compile(rf'^p_(?P<numer>{RE_INT})/(?P<denom>{RE_INT})_(?P<step>[1-7])$')
    _re_dur_int = re.compile(rf'^d_(?P<num>{RE_INT})$')
    _re_dur_frac = re.compile(rf'^d_(?P<numer>{RE_INT})/(?P<denom>{RE_INT})$')
    _re_time_sig = re.compile(rf'^TimeSig_(?P<numer>{RE_INT})/(?P<denom>{RE_INT})$')
    _re_tempo_int = re.compile(rf'^Tempo_(?P<num>{RE_INT})$')
    _re_tempo_bin = re.compile(rf'^Tempo_(?P<numer>{RE_INT})/(?P<denom>{RE_INT})$')
    _re_key = re.compile(r'^Key_(?P<key>.*)$')

    def __init__(
            self, precision: int = 5, pitch_kind: str = 'midi', with_rare_step: bool = True,
            tempo_bin: Union[bool, int, None] = None, is_wordpiece: bool = False,
    ):
        if pitch_kind not in ('midi', 'step', 'degree'):
            raise ValueError(f'Unknown pitch kind {pitch_kind!r}')
        self.precision = precision
        self.pitch_kind = pitch_kind
        self.with_rare_step = with_rare_step
        self.is_wordpiece = is_wordpiece
        self.tempo_bin: Optional[int] = (5 if tempo_bin is True else tempo_bin) or None
        self.tempo_bin_map = self.tempo_meta2tok_map = self.tempo_meta_map = None

        self.rest = 'p_r'
        self._pitch_kind2pattern = dict(
            midi=MusicVocabulary._re_pitch_midi,
            step=MusicVocabulary._re_pitch_step,
            degree=MusicVocabulary._re_pitch_degree,
        )
        self.rare_tok2meta = {
            MusicVocabulary.rare_time_sig: MusicVocabulary.rare_time_sig_meta,
            MusicVocabulary.rare_low_tempo: MusicVocabulary.low_tempo_meta,
            MusicVocabulary.rare_high_tempo: MusicVocabulary.high_tempo_meta,
            MusicVocabulary.rare_duration: MusicVocabulary.rare_duration_meta,
            MusicVocabulary.rare_pitch: MusicVocabulary.rare_pitch_meta,
        }

        # Token inventory; ordering matches reference music_vocab.py:354-370
        tss = [f'TimeSig_{n}/{d}' for (n, d) in
               (tuple(reversed(t)) for t in sorted(tuple(reversed(ts)) for ts in COMMON_TIME_SIGS))]
        keys = [f'Key_{k}' for k in sorted(key_str2enum.keys())]
        special = [
            MusicVocabulary.omitted_segment, MusicVocabulary.pad, MusicVocabulary.start_of_bar,
            MusicVocabulary.end_of_song, MusicVocabulary.start_of_melody, MusicVocabulary.start_of_bass,
            MusicVocabulary.start_of_tuplet, MusicVocabulary.end_of_tuplet,
        ]
        self.toks: Dict[str, List[str]] = dict(
            special=special,
            time_sig=[MusicVocabulary.rare_time_sig, *tss],
            tempo=[MusicVocabulary.rare_low_tempo, *self._get_all_unique_tempos(),
                   MusicVocabulary.rare_high_tempo],
            key=keys,
            pitch=self._get_all_unique_pitches(),
            duration=[MusicVocabulary.rare_duration, *self.get_durations(exp='str')],
        )
        for toks in self.toks.values():
            assert len(set(toks)) == len(toks)
        self.tok2id: Dict[str, int] = {
            tok: i for i, tok in enumerate(t for toks in self.toks.values() for t in toks)
        }
        self.id2tok: Dict[int, str] = {v: k for k, v in self.tok2id.items()}
        assert len(self.tok2id) == len(self.id2tok)

        self.id2type: Dict[int, VocabType] = {i: self.type(t) for i, t in self.id2tok.items()}
        self.id2meta: Dict[int, TokenMeta] = {
            i: self.tok2meta(t) for i, t in self.id2tok.items() if self.with_meta(t)
        }

    # ------------------------------------------------------------------ inventory
    def _get_all_unique_tempos(self) -> List[str]:
        if self.tempo_bin:
            assert (TEMPO_HIGH_EDGE - TEMPO_LOW_EDGE) % self.tempo_bin == 0
            self.tempo_bin_map: Dict[Tuple[int, ...], Tuple[str, int]] = {}
            self.tempo_meta_map: Dict[int, int] = {}
            self.tempo_meta2tok_map: Dict[int, str] = {}
            bin_strt = TEMPO_LOW_EDGE
            while bin_strt + self.tempo_bin <= TEMPO_HIGH_EDGE:
                bin_end = bin_strt + self.tempo_bin  # exclusive
                if bin_strt + self.tempo_bin * 2 > TEMPO_HIGH_EDGE:  # last group gets the edge
                    assert bin_end == TEMPO_HIGH_EDGE
                    bin_end += 1
                key = tuple(range(bin_strt, bin_end))
                tok = f'Tempo_{bin_strt}/{bin_end - 1}'
                meta = MusicVocabulary._tempo_bin2meta(bin_strt, bin_end - 1)
                self.tempo_bin_map[key] = (tok, meta)
                self.tempo_meta2tok_map[meta] = tok
                for tp in key:
                    self.tempo_meta_map[tp] = meta
                bin_strt = bin_end
            self.tempo_meta_map[MusicVocabulary.low_tempo_meta] = MusicVocabulary.low_tempo_meta
            self.tempo_meta_map[MusicVocabulary.high_tempo_meta] = MusicVocabulary.high_tempo_meta
            return [tok for tok, _ in self.tempo_bin_map.values()]
        return [f'Tempo_{tp}' for tp in COMMON_TEMPOS]

    @staticmethod
    def _tempo_bin2meta(start: int, end: int) -> int:
        n = end - start + 1
        return round(sum(range(start, end + 1)) / n)

    @staticmethod
    def pitch2local_index(midi: int) -> int:
        return (midi % 12) + 1

    @staticmethod
    def pitch_midi2octave(midi: int) -> int:
        return midi // 12 - 1

    def _get_all_unique_pitches(self) -> List[str]:
        ret = [self.rest, MusicVocabulary.rare_pitch]
        if self.pitch_kind == 'midi':
            ret += [f'p_{i % 12 + 1}/{i // 12 - 1}' for i in range(128)]
        elif self.pitch_kind == 'step':
            for i in range(128):
                idx = MusicVocabulary.pitch2local_index(i)
                normal, rare = MusicVocabulary._atonal_pitch_index2name[idx]
                names = normal + rare if self.with_rare_step else list(normal)
                for name in names:
                    otv = MusicVocabulary.pitch_midi2octave(i)
                    # Spelled-octave adjustment: B# and C- live in the neighboring octave
                    # (reference music_vocab.py:455-459)
                    if idx == 1 and name == 'B#':
                        otv -= 1
                    elif idx == 12 and name == 'C-':
                        otv += 1
                    step = name[0]
                    # sanity: letter + accidental reproduces midi i
                    alter = name.count('#') - name.count('-')
                    assert (otv + 1) * 12 + STEP2PC[step] + alter == i
                    ret.append(f'p_{idx}/{otv}_{step}')
        else:  # degree
            ret += [f'p_{i % 12 + 1}/{i // 12 - 1}_{d}' for i in range(128) for d in range(1, 8)]
        assert len(ret) == len(set(ret))
        return ret

    def get_durations(self, bound: int = None, exp: str = 'str'):
        """Quantized durations up to `bound` quarterLength (default 6; reference :495-518)."""
        if bound is None:
            bound = max(n / d for n, d in COMMON_TIME_SIGS) * 4
            assert float(bound).is_integer()
            bound = int(bound)
        dur_slot = Fraction(4, 2 ** self.precision)
        n_slots = math.ceil(bound / dur_slot)
        fracs = [(i + 1) * dur_slot for i in range(n_slots)]
        if exp == 'str':
            return [f'd_{_frac_str(f)}' for f in fracs]
        assert exp == 'dur'
        return [int(f) if f.denominator == 1 else f for f in fracs]

    # ------------------------------------------------------------------ queries
    def __len__(self):
        return len(self.tok2id)

    def __contains__(self, tok: str) -> bool:
        return tok in self.tok2id

    def __getitem__(self, k: str) -> str:
        specs = dict(
            sep=self.sep, rest='r', prefix_pitch=self.pitch_pref, prefix_duration=self.dur_pref,
            omitted_segment=self.omitted_segment, pad=self.pad, start_of_tuplet=self.start_of_tuplet,
            end_of_tuplet=self.end_of_tuplet, start_of_bar=self.start_of_bar,
            end_of_song=self.end_of_song, prefix_time_sig=self.time_sig_pref,
            prefix_tempo=self.tempo_pref, prefix_key=self.key_pref,
            start_of_melody=self.start_of_melody, start_of_bass=self.start_of_bass,
        )
        return specs[k]

    @property
    def rest_pitch_meta(self):
        return MusicVocabulary.pitch_kind2rest_pitch_meta[self.pitch_kind]

    @property
    def pitch_pattern(self) -> re.Pattern:
        return self._pitch_kind2pattern[self.pitch_kind]

    @property
    def tempo_pattern(self) -> re.Pattern:
        return self._re_tempo_bin if self.tempo_bin else self._re_tempo_int

    # terminal colors by token type (reference music_vocab.py:177-184:
    # red = meta (time sig/tempo/key), green = duration, blue = pitch,
    # magenta = structural specials)
    _TYPE2ANSI = {VocabType.time_sig: '31', VocabType.tempo: '31',
                  VocabType.key: '31', VocabType.duration: '32',
                  VocabType.pitch: '34', VocabType.special: '35'}

    def colorize_token(self, tok: str) -> str:
        """ANSI-colorize one token by its type for terminal output
        (reference music_vocab.py:749-763; WordPiece merges split first)."""
        toks = tok.replace(WORDPIECE_CONTINUING_PREFIX, '').split()
        return ' '.join(
            f'\x1b[{self._TYPE2ANSI[self.type(t)]}m{t}\x1b[0m' for t in toks)

    def colorize_tokens(self, toks: Union[str, List[str]]) -> str:
        toks = toks if isinstance(toks, list) else toks.split()
        return ' '.join(self.colorize_token(t) for t in toks)

    def with_meta(self, tok: Union[str, int]) -> bool:
        return self.type(tok) != VocabType.special

    def type(self, tok: Union[str, int, np.integer]) -> VocabType:
        if isinstance(tok, (int, np.integer)):
            return self.id2type[int(tok)]
        if 'p_' in tok:
            return VocabType.pitch
        if 'd_' in tok:
            return VocabType.duration
        if 'TimeSig_' in tok:
            return VocabType.time_sig
        if 'Tempo_' in tok:
            return VocabType.tempo
        if 'Key_' in tok:
            return VocabType.key
        return VocabType.special

    def is_rarest_step_pitch(self, tok: str) -> bool:
        assert self.pitch_kind == 'step'
        mid, step = self.tok2meta(tok, strict=False)
        return ((MusicVocabulary.pitch2local_index(mid), step)
                in MusicVocabulary._rarest_pitch_index_n_names
                or tok in MusicVocabulary._rarest_pitch_tokens)

    def tok2meta(self, token: Union[str, int, np.integer], strict: bool = True) -> TokenMeta:
        """Token -> numeric meta (reference music_vocab.py:553-629)."""
        assert self.with_meta(token), f'{token!r} does not have a compact representation'
        if isinstance(token, (int, np.integer)):
            return self.id2meta[int(token)]
        if token in self.rare_tok2meta:
            return self.rare_tok2meta[token]
        typ = self.type(token)
        if typ == VocabType.pitch:
            if token == self.rest:
                return self.rest_pitch_meta
            m = self.pitch_pattern.match(token)
            idx, octave = int(m.group('numer')), int(m.group('denom'))
            if self.pitch_kind == 'step' and self.with_rare_step:
                # out-of-[0,128) spelled pitches kept in vocab (reference :588-598)
                if octave == -2:
                    assert not strict or token == 'p_1/-2_B'
                    strict = False
                elif (idx, octave) == (12, 9):
                    assert not strict or token == 'p_12/9_C'
                    strict = False
            mid = idx - 1 + (octave + 1) * 12
            if strict:
                assert 0 <= mid < 128
            if self.pitch_kind == 'midi':
                return mid
            step = m.group('step')
            if self.pitch_kind == 'degree':
                step = int(step)
            return mid, step
        if typ == VocabType.duration:
            if '/' in token:
                m = MusicVocabulary._re_dur_frac.match(token)
                numer, denom = int(m.group('numer')), int(m.group('denom'))
                if strict and not math.log2(denom).is_integer():
                    raise ValueError(f'Duration token not quantizable: {token!r}')
                return Fraction(numer, denom)
            return int(MusicVocabulary._re_dur_int.match(token).group('num'))
        if typ == VocabType.time_sig:
            m = MusicVocabulary._re_time_sig.match(token)
            return int(m.group('numer')), int(m.group('denom'))
        if typ == VocabType.tempo:
            if self.tempo_bin:
                m = MusicVocabulary._re_tempo_bin.match(token)
                return MusicVocabulary._tempo_bin2meta(int(m.group('numer')), int(m.group('denom')))
            return int(MusicVocabulary._re_tempo_int.match(token).group('num'))
        assert typ == VocabType.key
        return key_str2enum[MusicVocabulary._re_key.match(token)['key']]

    def meta2tok(self, kind: VocabType, meta: Optional[TokenMeta] = None) -> str:
        """Numeric meta -> token (reference music_vocab.py:631-690)."""
        assert kind != VocabType.special
        if kind == VocabType.duration:
            if meta == MusicVocabulary.rare_duration_meta:
                return MusicVocabulary.rare_duration
            f = Fraction(meta)
            return f'd_{_frac_str(f)}'
        if kind == VocabType.pitch:
            if meta == MusicVocabulary.rare_pitch_meta:
                return MusicVocabulary.rare_pitch
            if self.pitch_kind == 'midi':
                assert isinstance(meta, (int, np.integer))
                return self._midi_pitch_meta2tok(int(meta))
            mid, step = meta
            tok = self._midi_pitch_meta2tok(int(mid))
            if step is None:
                assert mid == MusicVocabulary.midi_rest_pitch_meta
                return tok
            return f'{tok}_{step}'
        if kind == VocabType.time_sig:
            if meta == MusicVocabulary.rare_time_sig_meta:
                return MusicVocabulary.rare_time_sig
            return f'TimeSig_{meta[0]}/{meta[1]}'
        if kind == VocabType.tempo:
            if meta == MusicVocabulary.low_tempo_meta:
                return MusicVocabulary.rare_low_tempo
            if meta == MusicVocabulary.high_tempo_meta:
                return MusicVocabulary.rare_high_tempo
            assert isinstance(meta, (int, np.integer))
            if self.tempo_bin:
                return self.tempo_meta2tok_map[int(meta)]
            return f'Tempo_{int(meta)}'
        assert kind == VocabType.key
        if isinstance(meta, Key):
            meta = enum2key_str[meta]
        return f'Key_{meta}'

    def _midi_pitch_meta2tok(self, meta: int) -> str:
        if meta == MusicVocabulary.midi_rest_pitch_meta:
            return self.rest
        return f'p_{meta % 12 + 1}/{MusicVocabulary.pitch_midi2octave(meta)}'

    def pitch_tok2midi_pitch_meta(self, tok: str) -> int:
        m = self.pitch_pattern.match(tok)
        idx, octave = int(m.group('numer')), int(m.group('denom'))
        return idx - 1 + (octave + 1) * 12

    def pitch_tok2midi_pitch_tok(self, tok: str, strict: bool = True) -> str:
        assert self.type(tok) == VocabType.pitch
        meta = self.tok2meta(tok, strict=False)
        mid = meta if self.pitch_kind == 'midi' else meta[0]
        if strict:
            while mid < 0:
                mid += 12
            while mid > 127:
                mid -= 12
        return self._midi_pitch_meta2tok(mid)

    def get_pitch_step(self, tok: str) -> Union[str, int]:
        if self.pitch_kind == 'midi':
            raise ValueError('Step is not part of vocabulary for midi pitch kind')
        step = self.pitch_pattern.match(tok).group('step')
        return int(step) if self.pitch_kind == 'degree' else step

    # ------------------------------------------------------------------ element/token conversion
    def note2pitch_str(self, midi: int, step: str = None, degree: int = None) -> str:
        """Build a pitch token from midi value (+step letter / degree for non-midi kinds)."""
        if midi == MusicVocabulary.midi_rest_pitch_meta:
            return self.rest
        s = f'p_{MusicVocabulary.pitch2local_index(midi)}/{MusicVocabulary.pitch_midi2octave(midi)}'
        if self.pitch_kind == 'step':
            assert step is not None
            return f'{s}_{step}'
        if self.pitch_kind == 'degree':
            if not (isinstance(degree, int) and 1 <= degree <= 7):
                raise ValueError(f'Invalid degree {degree!r}, should be in [1, 7]')
            return f'{s}_{degree}'
        return s

    def music_elm2toks(self, e: MusicElement) -> List[str]:
        if e.type in MusicVocabulary.special_elm_type2tok:
            return [MusicVocabulary.special_elm_type2tok[e.type]]
        if e.type == ElmType.time_sig:
            return [self.meta2tok(VocabType.time_sig, e.meta)]
        if e.type == ElmType.tempo:
            return [self.meta2tok(VocabType.tempo, e.meta)]
        if e.type == ElmType.key:
            return [self.meta2tok(VocabType.key, e.meta)]
        if e.type == ElmType.note:
            pch, dur = e.meta
            return [self.meta2tok(VocabType.pitch, pch), self.meta2tok(VocabType.duration, dur)]
        assert e.type == ElmType.tuplets
        pchs, dur = e.meta
        return [
            self.start_of_tuplet,
            *[self.meta2tok(VocabType.pitch, p) for p in pchs],
            self.meta2tok(VocabType.duration, dur),
            self.end_of_tuplet,
        ]

    # ------------------------------------------------------------------ rare sanitization
    def is_rare_token(self, tok: str) -> bool:
        return tok in MusicVocabulary.rare_tokens or tok not in self

    def sanitize_rare_token(self, tok: str, for_midi: bool = False, rare_pitch_only: bool = False) -> str:
        """Map an out-of-vocab token to its `*_rare` class (reference music_vocab.py:883-915)."""
        if tok in self.tok2id:
            return tok
        typ = self.type(tok)
        if typ == VocabType.pitch:
            if for_midi:
                meta = self.tok2meta(tok, strict=False)
                mid, step = meta if isinstance(meta, tuple) else (meta, None)
                while mid < 0:
                    mid += 12
                while mid > 127:
                    mid -= 12
                if self.pitch_kind == 'midi':
                    return self.meta2tok(VocabType.pitch, mid)
                return self.meta2tok(VocabType.pitch, (mid, step))
            return MusicVocabulary.rare_pitch
        if rare_pitch_only:
            return tok
        if typ == VocabType.duration:
            return MusicVocabulary.rare_duration
        if typ == VocabType.time_sig:
            return MusicVocabulary.rare_time_sig
        assert typ == VocabType.tempo
        tp = self.tok2meta(tok)
        return MusicVocabulary.rare_low_tempo if tp < TEMPO_LOW_EDGE else MusicVocabulary.rare_high_tempo

    def sanitize_rare_tokens(self, s: str, return_as_list: bool = False):
        toks = [self.sanitize_rare_token(tok) for tok in s.split()]
        return toks if return_as_list else ' '.join(toks)

    # ------------------------------------------------------------------ encode/decode
    def t2i(self, tok: str) -> int:
        return self.tok2id[self.sanitize_rare_token(tok)]

    def i2t(self, i: int) -> str:
        return self.id2tok[int(i)]

    def encode(self, s):
        if isinstance(s, list) and s and isinstance(s[0], list):
            return [self.encode(x) for x in s]
        if isinstance(s, list):
            return [self.tok2id[x] for x in s]
        return self.tok2id[s]

    def decode(self, ids):
        if isinstance(ids, list) and ids and isinstance(ids[0], list):
            return [self.decode(x) for x in ids]
        if isinstance(ids, list):
            return [self.id2tok[int(i)] for i in ids]
        return self.id2tok[int(ids)]

    def to_dict(self) -> Dict:
        return dict(
            precision=self.precision,
            special_tokens=dict(
                start_of_bar=MusicVocabulary.start_of_bar, end_of_song=MusicVocabulary.end_of_song,
                start_of_tuplet=MusicVocabulary.start_of_tuplet, end_of_tuplet=MusicVocabulary.end_of_tuplet,
            ),
            vocabulary=self.tok2id,
            n_vocabulary=len(self.tok2id),
        )

    # ------------------------------------------------------------------ dense id tables (TPU path)
    @cached_property
    def id_type_table(self) -> np.ndarray:
        """int8[V]: VocabType value per id."""
        return np.array([self.id2type[i].value for i in range(len(self))], dtype=np.int8)

    @cached_property
    def id_midi_table(self) -> np.ndarray:
        """int16[V]: midi pitch per id; -1 for rest, -2 for non-pitch/rare-pitch tokens.

        Powers vectorized `ids2pitches` / IKR with a single gather.
        """
        tbl = np.full(len(self), -2, dtype=np.int16)
        for i, tok in self.id2tok.items():
            if self.id2type[i] == VocabType.pitch:
                if tok == self.rest:
                    tbl[i] = -1
                elif tok == MusicVocabulary.rare_pitch:
                    tbl[i] = -2
                else:
                    meta = self.id2meta[i]
                    tbl[i] = meta if self.pitch_kind == 'midi' else meta[0]
        return tbl

    @cached_property
    def id_pitch_class_table(self) -> np.ndarray:
        """int8[V]: pitch class (0-11) per id; -1 for everything that has no pitch class."""
        midi = self.id_midi_table
        pc = np.where(midi >= 0, midi % 12, -1).astype(np.int8)
        return pc

    @cached_property
    def id_duration_table(self) -> np.ndarray:
        """float32[V]: quarterLength per duration id; 0 elsewhere."""
        tbl = np.zeros(len(self), dtype=np.float32)
        for i, tok in self.id2tok.items():
            if self.id2type[i] == VocabType.duration and tok != MusicVocabulary.rare_duration:
                tbl[i] = float(self.id2meta[i])
        return tbl


class _IsNonRestValidPitch:
    """Callable: is `tok` a genuine (non-rest, non-rare) pitch token (reference :954-970)."""

    def __call__(self, tok: str) -> bool:
        return ('p_' in tok) and tok != 'p_r' and tok != MusicVocabulary.rare_pitch


nrp = _IsNonRestValidPitch()
