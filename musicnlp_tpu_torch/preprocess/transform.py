"""Copy of `musicnlp_tpu/preprocess/transform.py` (pure Python / numpy): the port keeps its own copy
and imports nothing from the JAX package; only the import paths differ
(held against the original by tests/test_torch_pipeline.py).

Music-theory-aware augmentations, string-compatible + array-native.

Rebuild of the reference transforms (reference musicnlp/preprocess/transform.py):
SanitizeRare, RandomCrop, TempoGroup, KeyInsert, TokenPitchShift, PitchShift,
AugmentKey, CombineKeys, ToMidiPitch, ChannelMixer - same string->string semantics.

TPU-native addition: every per-token map is also *compiled to a dense int32
id-permutation table* (`build_step2degree_table`, `build_step2midi_table`,
`build_tempo_group_table`), so the hot training input path runs as numpy/XLA
gathers over fixed-shape id arrays instead of per-sample Python string
processing (SURVEY.md §7 step 4 - "what the TPU build vectorizes away").
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from musicnlp_tpu_torch.preprocess.key_finder import ScaleDegreeFinder
from musicnlp_tpu_torch.preprocess.music_converter import MusicConverter, MusicElm
from musicnlp_tpu_torch.vocab import (
    Channel, MusicVocabulary, MusicTokenizer, VocabType, nrp,
    key_ordinal2str, key_str2ordinal, N_KEY,
)

__all__ = [
    'Transform', 'SanitizeRare', 'RandomCrop', 'TempoGroup',
    'KeyInsert', 'TokenPitchShift', 'PitchShift', 'AugmentKey', 'CombineKeys',
    'ToMidiPitch', 'ChannelMixer',
    'build_step2degree_table', 'build_step2midi_table', 'build_vocab_id_map',
    'build_tempo_group_table',
]

Song = Union[str, List[str]]


class Transform:
    def __init__(self, return_as_list: bool = False):
        self.return_as_list = return_as_list

    def _out(self, toks: List[str]):
        return toks if self.return_as_list else ' '.join(toks)

    def __call__(self, text: Song) -> Song:
        raise NotImplementedError


class SanitizeRare(Transform):
    """OOV tokens -> `*_rare` class (or fold pitch to [0,127] when `for_midi`)."""

    def __init__(self, vocab: MusicVocabulary = None, for_midi: bool = False,
                 rare_pitch_only: bool = False, **kwargs):
        super().__init__(**kwargs)
        self.vocab = vocab or MusicVocabulary(pitch_kind='step')
        self.for_midi = for_midi
        self.rare_pitch_only = rare_pitch_only

    def __call__(self, text: Song) -> Song:
        toks = text if isinstance(text, list) else text.split()
        return self._out([
            self.vocab.sanitize_rare_token(t, for_midi=self.for_midi,
                                           rare_pitch_only=self.rare_pitch_only)
            for t in toks])


class RandomCrop(Transform):
    """Drop leading bars, mark with `[OMIT]` (reference transform.py:59-114)."""

    def __init__(self, vocab: MusicVocabulary = None, min_seg_length: int = 16,
                 crop_mult: int = 1, rng: np.random.Generator = None, **kwargs):
        super().__init__(**kwargs)
        self.vocab = vocab or MusicVocabulary(pitch_kind='step')
        self.min_seg_length = min_seg_length
        self.crop_mult = crop_mult
        self.rng = rng or np.random.default_rng()

    def __call__(self, text: Song) -> Song:
        toks = text if isinstance(text, list) else text.split()
        idxs_bar = [i for i, t in enumerate(toks) if t == self.vocab.start_of_bar]
        n_bar = len(idxs_bar)
        if n_bar > self.min_seg_length:
            high = n_bar - self.min_seg_length
            idx = 0
            if self.crop_mult == 1:
                idx = int(self.rng.integers(0, high + 1))
            elif high >= self.crop_mult:
                idx = int(self.rng.integers(0, high // self.crop_mult + 1)) * self.crop_mult
            if idx != 0:
                toks = (toks[:idxs_bar[0]] + [self.vocab.omitted_segment]
                        + toks[idxs_bar[idx]:])
        return self._out(toks)


class TempoGroup(Transform):
    """Tempo token -> binned tempo token (reference transform.py:117-135)."""

    def __init__(self, vocab_none: MusicVocabulary = None,
                 vocab_group: MusicVocabulary = None, **kwargs):
        super().__init__(**kwargs)
        self.vocab_none = vocab_none or MusicVocabulary(tempo_bin=None)
        assert vocab_group is not None and vocab_group.tempo_bin
        self.vocab_group = vocab_group

    def __call__(self, text: Song) -> Song:
        toks = text if isinstance(text, list) else list(text.split())
        tp = toks[1]
        assert self.vocab_group.type(tp) == VocabType.tempo
        meta = self.vocab_none.tok2meta(tp)
        meta = self.vocab_group.tempo_meta_map[meta]
        toks = list(toks)
        toks[1] = self.vocab_group.meta2tok(VocabType.tempo, meta)
        return self._out(toks)


class KeyInsert(Transform):
    """Insert a key token at position 2 (reference transform.py:138-151)."""

    def __init__(self, vocab: MusicVocabulary = None, rng: np.random.Generator = None, **kwargs):
        super().__init__(**kwargs)
        self.vocab = vocab or MusicVocabulary(pitch_kind='step')
        self.rng = rng or np.random.default_rng()

    def __call__(self, text: Song, key: Union[str, Dict[str, float]]) -> Song:
        toks = list(text) if isinstance(text, list) else text.split()
        assert self.vocab.type(toks[0]) == VocabType.time_sig
        assert self.vocab.type(toks[1]) == VocabType.tempo
        if isinstance(key, dict):
            ks, ws = zip(*[(k, max(v, 0.0)) for k, v in key.items() if v is not None])
            w = np.asarray(ws, dtype=np.float64)
            w = w / w.sum() if w.sum() > 0 else np.full(len(w), 1 / len(w))
            key = str(self.rng.choice(list(ks), p=w))
        toks.insert(2, self.vocab.meta2tok(VocabType.key, key))
        return self._out(toks)


class TokenPitchShift:
    """step pitch token -> degree pitch token for a key (reference transform.py:154-197)."""

    def __init__(self, vocab_step: MusicVocabulary = None,
                 vocab_degree: MusicVocabulary = None, key_token: str = None):
        self.vocab_step = vocab_step or MusicVocabulary(pitch_kind='step')
        self.vocab_degree = vocab_degree or MusicVocabulary(pitch_kind='degree')
        self.key_meta = None
        self._key_token = None
        if key_token is not None:
            self.key_token = key_token

    @property
    def key_token(self) -> str:
        return self._key_token

    @key_token.setter
    def key_token(self, val: str):
        if val != self._key_token:
            self._key_token = val
            self.key_meta = self.vocab_step.tok2meta(val)

    def __call__(self, tok: str) -> str:
        if not nrp(tok):
            return tok
        assert tok in self.vocab_step, f'rare pitch {tok!r} must be sanitized first'
        step = self.vocab_step.get_pitch_step(tok)
        deg = ScaleDegreeFinder.map_single(note=step, key=self.key_meta)
        midi = self.vocab_step.pitch_tok2midi_pitch_meta(tok)
        if midi == -12:       # p_1/-2_B (see MusicVocabulary edge cases)
            midi += 12
        elif midi == 131:     # p_12/9_C
            midi -= 12
        return self.vocab_degree.meta2tok(VocabType.pitch, (midi, deg))


class PitchShift(Transform):
    """Whole-song step->degree shift using the key at token 3 (reference :200-237)."""

    def __init__(self, vocab_step: MusicVocabulary = None,
                 vocab_degree: MusicVocabulary = None, **kwargs):
        super().__init__(**kwargs)
        self.vocab_step = vocab_step or MusicVocabulary(pitch_kind='step')
        self.vocab_degree = vocab_degree or MusicVocabulary(pitch_kind='degree')
        assert self.vocab_step.pitch_kind == 'step' and self.vocab_degree.pitch_kind == 'degree'
        self.tps = TokenPitchShift(vocab_step=self.vocab_step, vocab_degree=self.vocab_degree)

    def __call__(self, text: Song) -> Song:
        toks = text if isinstance(text, list) else text.split()
        key = toks[2]
        assert self.vocab_step.type(key) == VocabType.key
        self.tps.key_token = key
        return self._out([self.tps(t) for t in toks])


class AugmentKey:
    """KeyInsert then PitchShift (reference transform.py:240-254)."""

    def __init__(self, vocab: MusicVocabulary = None, return_as_list: bool = False,
                 rng: np.random.Generator = None):
        self.vocab = vocab or MusicVocabulary(pitch_kind='degree')
        assert self.vocab.pitch_kind == 'degree'
        self.ki = KeyInsert(return_as_list=True, rng=rng)
        self.ps = PitchShift(vocab_degree=self.vocab, return_as_list=return_as_list)

    def __call__(self, pair: Tuple[Song, Union[str, Dict[str, float]]]) -> Song:
        txt, key = pair
        return self.ps(self.ki(txt, key))


class CombineKeys:
    """Attach the 24-dim key-confidence vector for IKR eval (reference :257-287)."""
    n_key = N_KEY

    def __init__(self, tokenizer: MusicTokenizer = None):
        self.tokenizer = tokenizer
        self.sr = SanitizeRare(vocab=tokenizer.vocab)

    def __call__(self, samples: Dict[str, List]) -> Dict:
        txt = [self.sr(t) for t in samples['score']]
        ret = self.tokenizer(txt, padding='max_length', truncation=True)
        ret['key_scores'] = [CombineKeys.get_key_scores(d) for d in samples['keys']]
        return ret

    @staticmethod
    def get_key_scores(keys: Dict[str, Optional[float]]) -> List[float]:
        return [(keys.get(key_ordinal2str[i]) or -1) for i in range(N_KEY)]


class ToMidiPitch(Transform):
    """step/degree pitch tokens -> midi pitch tokens, for rendering (reference :290-310)."""

    def __init__(self, vocab: MusicVocabulary = None, **kwargs):
        super().__init__(**kwargs)
        self.vocab = vocab or MusicVocabulary(pitch_kind='step')
        assert self.vocab.pitch_kind != 'midi'

    def __call__(self, text: Song) -> Song:
        toks = text if isinstance(text, list) else text.split()
        return self._out([
            (self.vocab.pitch_tok2midi_pitch_tok(t) if nrp(t) else t) for t in toks])


class ChannelMixer(Transform):
    """Interleave melody/bass elements within each bar (reference transform.py:331-450)."""

    def __init__(self, precision: int = 5, vocab: MusicVocabulary = None,
                 mode: str = 'full', rng: np.random.Generator = None, **kwargs):
        super().__init__(**kwargs)
        self.mc = MusicConverter(mode='full', precision=precision, vocab_midi=vocab)
        self.vocab = self.mc.pk2v['midi']
        assert mode in ('full', 'swap')
        self.mix_mode = mode
        self.rng = rng or np.random.default_rng()

    def __call__(self, text: Song) -> Song:
        out = self.mc.str2tok_elms(text)
        toks: List[str] = [out.time_sig, out.tempo]
        if out.key:
            toks.append(out.key)
        if out.omit:
            toks.append(out.omit)
        for elms in out.elms_by_bar:
            toks += self._mix_up_bar_toks(elms)
        toks.append(self.vocab.end_of_song)
        return self._out(toks)

    def _split_bar_toks(self, elms: List[MusicElm]) -> Tuple[List[MusicElm], List[MusicElm]]:
        melody, bass = [], []
        it = iter(elms)
        e1 = next(it)
        assert e1[0] in (self.vocab.start_of_melody, self.vocab.start_of_bass)
        c = Channel.melody if e1[0] == self.vocab.start_of_melody else Channel.bass
        for e in it:
            if e[0] == self.vocab.start_of_melody:
                c = Channel.melody
            elif e[0] == self.vocab.start_of_bass:
                c = Channel.bass
            else:
                (melody if c == Channel.melody else bass).append(e)
        return melody, bass

    def _mix_up_bar_toks(self, elms: List[MusicElm]) -> List[str]:
        elms_m, elms_b = self._split_bar_toks(elms)
        if self.mix_mode == 'full':
            n_m, n_b = len(elms_m), len(elms_b)
            # sample an interleaving that preserves within-channel order, weighted
            # by remaining element counts (reference _Sampler :319-329)
            ret: List[str] = []
            im = ib = 0
            prev: Optional[str] = None
            thresh = n_m / (n_m + n_b) if (n_m + n_b) else 0.5
            while im < n_m and ib < n_b:
                add_mel = bool(self.rng.random() < thresh)
                curr = self.vocab.start_of_melody if add_mel else self.vocab.start_of_bass
                if curr != prev:
                    ret.append(curr)
                if add_mel:
                    ret += elms_m[im]
                    im += 1
                else:
                    ret += elms_b[ib]
                    ib += 1
                prev = curr
            if im < n_m:
                if prev != self.vocab.start_of_melody:
                    ret.append(self.vocab.start_of_melody)
                for e in elms_m[im:]:
                    ret += e
            elif ib < n_b:
                if prev != self.vocab.start_of_bass:
                    ret.append(self.vocab.start_of_bass)
                for e in elms_b[ib:]:
                    ret += e
        else:  # swap
            toks_m = [self.vocab.start_of_melody] + [t for e in elms_m for t in e]
            toks_b = [self.vocab.start_of_bass] + [t for e in elms_b for t in e]
            ret = (toks_m + toks_b) if self.rng.integers(2) == 0 else (toks_b + toks_m)
        return [self.vocab.start_of_bar] + ret


# -------------------------------------------------------------------- dense id tables
@lru_cache(maxsize=None)
def _default_vocabs() -> Tuple[MusicVocabulary, MusicVocabulary, MusicVocabulary]:
    return (MusicVocabulary(pitch_kind='midi'), MusicVocabulary(pitch_kind='step'),
            MusicVocabulary(pitch_kind='degree'))


def build_vocab_id_map(src: MusicVocabulary, dst: MusicVocabulary) -> np.ndarray:
    """int32[V_src]: src id -> dst id for tokens shared by both vocabs; -1 where the
    token is pitch-kind specific (pitch tokens need a key-aware table)."""
    out = np.full(len(src), -1, dtype=np.int32)
    for tok, i in src.tok2id.items():
        j = dst.tok2id.get(tok)
        if j is not None:
            out[i] = j
    return out


def build_step2degree_table(vocab_step: MusicVocabulary = None,
                            vocab_degree: MusicVocabulary = None) -> np.ndarray:
    """int32[N_KEY, V_step]: (key ordinal, step-vocab id) -> degree-vocab id.

    The KeyInsert+PitchShift augmentation becomes a single gather per song:
    ids_degree = TABLE[key_ordinal, ids_step].  Non-pitch tokens map to their
    degree-vocab id unchanged.
    """
    vs = vocab_step or _default_vocabs()[1]
    vd = vocab_degree or _default_vocabs()[2]
    base = build_vocab_id_map(vs, vd)
    table = np.tile(base, (N_KEY, 1))
    tps = TokenPitchShift(vocab_step=vs, vocab_degree=vd)
    for ordinal in range(N_KEY):
        key_tok = vd.meta2tok(VocabType.key, key_ordinal2str[ordinal])
        tps.key_token = key_tok
        for tok, i in vs.tok2id.items():
            if nrp(tok) and vs.type(tok) == VocabType.pitch:
                table[ordinal, i] = vd.tok2id[tps(tok)]
    assert (table >= 0).all(), 'every step token must map into the degree vocab'
    return table


def build_step2midi_table(vocab_step: MusicVocabulary = None,
                          vocab_midi: MusicVocabulary = None) -> np.ndarray:
    """int32[V_step]: step-vocab id -> midi-vocab id (ToMidiPitch as a gather)."""
    vs = vocab_step or _default_vocabs()[1]
    vm = vocab_midi or _default_vocabs()[0]
    out = build_vocab_id_map(vs, vm)
    for tok, i in vs.tok2id.items():
        if out[i] == -1:
            assert vs.type(tok) == VocabType.pitch
            out[i] = vm.tok2id[vs.pitch_tok2midi_pitch_tok(tok)]
    return out


def build_tempo_group_table(vocab_plain: MusicVocabulary,
                            vocab_binned: MusicVocabulary) -> np.ndarray:
    """int32[V_plain]: plain-vocab id -> binned-tempo-vocab id (TempoGroup as
    a gather; reference transform.py:117-135).  Requires matching pitch kinds
    and a `tempo_bin` on the destination vocabulary."""
    assert vocab_binned.tempo_bin, 'destination vocabulary must bin tempos'
    assert vocab_plain.pitch_kind == vocab_binned.pitch_kind
    out = np.full(len(vocab_plain), -1, dtype=np.int32)
    for tok, i in vocab_plain.tok2id.items():
        if vocab_plain.type(tok) == VocabType.tempo \
                and tok not in vocab_plain.rare_tok2meta:
            meta = vocab_plain.tok2meta(tok)
            binned = vocab_binned.tempo_meta_map[meta]
            out[i] = vocab_binned.tok2id[
                vocab_binned.meta2tok(VocabType.tempo, binned)]
        else:
            j = vocab_binned.tok2id.get(tok)
            out[i] = j if j is not None else -1
    assert (out >= 0).all()
    return out
