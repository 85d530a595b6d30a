"""Copy of `musicnlp_tpu/preprocess/music_converter.py` (pure Python / numpy): the port keeps its own copy
and imports nothing from the JAX package; only the import paths differ
(held against the original by tests/test_torch_pipeline.py).

Token string <-> Score conversion (detokenizer + inverse).

Rebuild of the reference converter (reference musicnlp/preprocess/music_converter.py:59):
  str2music_elms  - tokens -> MusicElement IR with bar/channel/tuplet grammar (:294-372)
  str2tok_elms    - tokens -> per-bar token groups, no meta conversion (:217-274)
  str2score       - full render via make_score with duration repair (:428-458)
  mxl2str         - extracted-score file -> token string, for generation prompts (:162-215)
"""
from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import Dict, List, Optional, Union

from musicnlp_tpu_torch.io.score import Note, Pitch, Rest, Score, SNote, TsTup
from musicnlp_tpu_torch.io.note_ops import make_score
from musicnlp_tpu_torch.io.musicxml import parse_file
from musicnlp_tpu_torch.vocab import (
    Channel, ElmType, MusicElement, MusicVocabulary, VocabType,
)

__all__ = ['MusicConverter', 'MusicElm', 'SongSplitOutput', 'ElmParseOutput']

MusicElm = List[str]


@dataclass
class ElmParseOutput:
    elms: List[MusicElement] = None
    time_sig: MusicElement = None
    tempo: MusicElement = None
    key: MusicElement = None
    elms_by_bar: List[List[MusicElement]] = None


@dataclass
class SongSplitOutput:
    elms: List[MusicElm] = None
    time_sig: str = None
    tempo: str = None
    key: str = None
    omit: str = None
    elms_by_bar: List[List[MusicElm]] = None
    end_of_song: str = None


@dataclass
class PartExtractOutput:
    time_sig: TsTup = None
    tempo: int = None
    key: str = None
    toks: List[List[str]] = None


class MusicConverter:
    def __init__(
            self, mode: str = 'full', precision: int = 5,
            vocab_midi: MusicVocabulary = None, vocab_step: MusicVocabulary = None,
            vocab_degree: MusicVocabulary = None,
    ):
        assert mode in ('melody', 'full')
        self.mode = mode
        self.precision = precision
        self.pk2v: Dict[str, MusicVocabulary] = dict(
            midi=vocab_midi or MusicVocabulary(precision=precision, pitch_kind='midi'),
            step=vocab_step or MusicVocabulary(precision=precision, pitch_kind='step'),
            degree=vocab_degree or MusicVocabulary(precision=precision, pitch_kind='degree'),
        )
        _v = self.pk2v['midi']
        self._non_tup_spec = {
            _v.omitted_segment, _v.start_of_bar, _v.end_of_song,
            _v.start_of_melody, _v.start_of_bass,
        }

    @property
    def vocabs(self):
        return self.pk2v

    # ------------------------------------------------------------------ tokens -> IR
    def str2tok_elms(self, text: Union[str, List[str]]) -> SongSplitOutput:
        """Group tokens into per-element token lists, split by bar (reference :217-274)."""
        toks = text if isinstance(text, list) else text.split()
        vocab = self.pk2v['midi']  # type dispatch is pitch-kind independent
        elms: List[MusicElm] = []
        it = iter(toks)
        tok = next(it, None)
        while tok is not None:
            typ = vocab.type(tok)
            if typ == VocabType.special:
                if tok in self._non_tup_spec:
                    elms.append([tok])
                else:
                    assert tok == vocab.start_of_tuplet, f'unexpected special token {tok!r}'
                    tok = next(it, None)
                    toks_tup = []
                    while tok is not None and tok != vocab.end_of_tuplet:
                        toks_tup.append(tok)
                        tok = next(it, None)
                    toks_p, tok_d = toks_tup[:-1], toks_tup[-1]
                    assert len(toks_tup) >= 3
                    assert all(vocab.type(t) == VocabType.pitch for t in toks_p)
                    assert vocab.type(tok_d) == VocabType.duration
                    elms.append([vocab.start_of_tuplet, *toks_p, tok_d, vocab.end_of_tuplet])
            elif typ in (VocabType.time_sig, VocabType.tempo, VocabType.key):
                elms.append([tok])
            else:
                assert typ == VocabType.pitch, f'expected pitch, got {tok!r}'
                tok_d = next(it, None)
                assert tok_d is not None and vocab.type(tok_d) == VocabType.duration
                elms.append([tok, tok_d])
            tok = next(it, None)

        ts, tp, elms = elms[0], elms[1], elms[2:]
        assert vocab.type(ts[0]) == VocabType.time_sig
        assert vocab.type(tp[0]) == VocabType.tempo
        ts, tp = ts[0], tp[0]
        key = omit = None
        if elms and vocab.type(elms[0][0]) == VocabType.key:
            key, elms = elms[0][0], elms[1:]
        if elms and elms[0][0] == vocab.omitted_segment:
            omit, elms = elms[0][0], elms[1:]

        idxs_bar = [i for i, es in enumerate(elms) if es == [vocab.start_of_bar]]
        elms_by_bar = ([elms[idx:idxs_bar[i + 1]] for i, idx in enumerate(idxs_bar[:-1])]
                       + [elms[idxs_bar[-1]:]]) if idxs_bar else []
        elms_by_bar = [es[1:] for es in elms_by_bar]
        eos = None
        if elms_by_bar and elms_by_bar[-1] and elms_by_bar[-1][-1] == [vocab.end_of_song]:
            elms_by_bar[-1] = elms_by_bar[-1][:-1]
            eos = vocab.end_of_song
        return SongSplitOutput(elms=elms, time_sig=ts, tempo=tp, key=key, omit=omit,
                               elms_by_bar=elms_by_bar, end_of_song=eos)

    def str2music_elms(
            self, text: Union[str, List[str]], group: bool = True, omit_eos: bool = False,
            strict: bool = True, pitch_kind: str = 'midi',
    ) -> ElmParseOutput:
        """Tokens -> MusicElement IR (reference :294-372)."""
        vocab = self.pk2v[pitch_kind]

        def comp(x):
            return vocab.tok2meta(x, strict=strict)

        toks = text if isinstance(text, list) else text.split()
        it = iter(toks)
        tok = next(it, None)
        lst_out: List[MusicElement] = []
        while tok is not None:
            typ = vocab.type(tok)
            if typ == VocabType.special:
                if tok == vocab.start_of_bar:
                    lst_out.append(MusicElement(type=ElmType.bar_start))
                elif tok == vocab.end_of_song:
                    lst_out.append(MusicElement(type=ElmType.song_end))
                elif tok == vocab.start_of_tuplet:
                    tok = next(it, None)
                    toks_tup = []
                    while tok is not None and tok != vocab.end_of_tuplet:
                        toks_tup.append(tok)
                        tok = next(it, None)
                    assert len(toks_tup) >= 3, 'at least 2 pitches + 1 duration in a tuplet'
                    toks_p, tok_d = toks_tup[:-1], toks_tup[-1]
                    assert all(vocab.type(t) == VocabType.pitch for t in toks_p)
                    assert vocab.type(tok_d) == VocabType.duration
                    lst_out.append(MusicElement(
                        type=ElmType.tuplets,
                        meta=(tuple(comp(t) for t in toks_p), comp(tok_d))))
                elif tok == vocab.start_of_melody:
                    lst_out.append(MusicElement(type=ElmType.melody))
                elif tok == vocab.start_of_bass:
                    lst_out.append(MusicElement(type=ElmType.bass))
                else:
                    assert tok == vocab.omitted_segment  # skip
            elif typ == VocabType.time_sig:
                lst_out.append(MusicElement(type=ElmType.time_sig, meta=comp(tok)))
            elif typ == VocabType.tempo:
                lst_out.append(MusicElement(type=ElmType.tempo, meta=comp(tok)))
            elif typ == VocabType.key:
                lst_out.append(MusicElement(type=ElmType.key, meta=comp(tok)))
            else:
                assert typ == VocabType.pitch, f'unexpected token {tok!r}'
                tok_d = next(it, None)
                assert tok_d is not None and vocab.type(tok_d) == VocabType.duration, \
                    f'pitch token {tok!r} should be followed by a duration, got {tok_d!r}'
                lst_out.append(MusicElement(type=ElmType.note, meta=(comp(tok), comp(tok_d))))
            tok = next(it, None)

        ts = tp = key = bar_lst = None
        if group:
            ts, tp, lst = lst_out[0], lst_out[1], lst_out[2:]
            assert ts.type == ElmType.time_sig, 'first element must be time signature'
            assert tp.type == ElmType.tempo, 'second element must be tempo'
            if lst and lst[0].type == ElmType.key:
                key, lst = lst[0], lst[1:]
            if omit_eos:
                lst = [e for e in lst if e.type != ElmType.song_end]
            else:
                lst, e_l = lst[:-1], lst[-1]
                assert e_l.type == ElmType.song_end, 'last element must be end of song'
            idxs = [i for i, e in enumerate(lst) if e.type == ElmType.bar_start]
            bar_lst = ([lst[idx:idxs[i + 1]] for i, idx in enumerate(idxs[:-1])]
                       + [lst[idxs[-1]:]]) if idxs else []
            bar_lst = [notes[1:] for notes in bar_lst]
            assert all(len(bar) > 0 for bar in bar_lst), 'bar should contain at least one note'
        return ElmParseOutput(elms=lst_out, time_sig=ts, tempo=tp, key=key, elms_by_bar=bar_lst)

    # ------------------------------------------------------------------ IR -> notes
    @staticmethod
    def mus_elm2note(note: MusicElement, pitch_kind: str = 'midi') -> List[SNote]:
        """MusicElement -> IR notes; tuplet duration split evenly (reference :374-402)."""
        assert note.type in (ElmType.note, ElmType.tuplets)
        pitch, q_len = note.meta
        if q_len is None:
            # rare-duration token: the reference renders it as a zero-length
            # note (m21 Duration(quarterLength=None), reference :392); the MIDI
            # writer drops zero spans, matching that behavior
            q_len = Fraction(0)
        step = None
        if pitch_kind != 'midi':
            assert isinstance(pitch, tuple)
            if note.type == ElmType.note:
                # step kind carries the spelled letter name: preserve it so the
                # rendered score keeps the extractor's enharmonic spelling
                # (reference extracted MXLs spell Ab4 as p_9/4_A, not G#4)
                if pitch_kind == 'step' and isinstance(pitch[1], str):
                    step = pitch[1]
                pitch = pitch[0]
            else:
                pitch = tuple(p for p in pitch)
        if note.type == ElmType.note:
            if pitch == MusicVocabulary.midi_rest_pitch_meta:
                return [Rest(duration=q_len)]
            if step is not None and 0 <= pitch < 128:
                from musicnlp_tpu_torch.io.score import _STEP2PC
                alter = ((pitch - _STEP2PC[step] + 6) % 12) - 6
                return [Note(pitch=Pitch(midi=pitch, step=step, alter=alter),
                             duration=q_len)]
            return [Note(pitch=Pitch(midi=pitch), duration=q_len)]
        dur_ea = Fraction(q_len) / len(pitch)
        return [
            n for p in pitch
            for n in MusicConverter.mus_elm2note(
                MusicElement(ElmType.note, (p, dur_ea)), pitch_kind=pitch_kind)
        ]

    @staticmethod
    def bar2notes(notes: List[MusicElement], pitch_kind: str = 'midi') -> List[SNote]:
        return [n for e in notes for n in MusicConverter.mus_elm2note(e, pitch_kind=pitch_kind)]

    @staticmethod
    def split_notes(notes: List[MusicElement]) -> Dict[str, List[MusicElement]]:
        """Split bar elements into melody/bass channels (reference :408-426)."""
        lst_melody, lst_bass = [], []
        it = iter(notes)
        first = next(it)
        c = Channel.melody if first.type == ElmType.melody else Channel.bass
        for n in it:
            if n.type == ElmType.melody:
                c = Channel.melody
            elif n.type == ElmType.bass:
                c = Channel.bass
            else:
                (lst_melody if c == Channel.melody else lst_bass).append(n)
        return dict(melody=lst_melody, bass=lst_bass)

    def str2score(
            self, decoded: Union[str, List[str]], omit_eos: bool = False, title: str = None,
            check_duration_match: Union[str, None] = None, pitch_kind: str = 'midi',
    ) -> Score:
        """Render a token sequence to a Score (reference :428-458)."""
        out = self.str2music_elms(decoded, group=True, omit_eos=omit_eos, pitch_kind=pitch_kind)
        ts, tp, lst = out.time_sig, out.tempo, out.elms_by_bar
        if self.mode == 'melody':
            d_notes = dict(melody=[MusicConverter.bar2notes(notes, pitch_kind) for notes in lst])
        else:
            d_notes = dict(melody=[], bass=[])
            for notes in lst:
                d = MusicConverter.split_notes(notes)
                d_notes['melody'].append(MusicConverter.bar2notes(d['melody'], pitch_kind))
                d_notes['bass'].append(MusicConverter.bar2notes(d['bass'], pitch_kind))
        time_sig = None if ts.meta == self.pk2v['midi'].rare_time_sig_meta else f'{ts.meta[0]}/{ts.meta[1]}'
        return make_score(title=title, mode=self.mode, time_sig=time_sig, tempo=tp.meta,
                          d_notes=d_notes, check_duration_match=check_duration_match)

    # ------------------------------------------------------------------ score -> tokens
    def _bar2grouped_notes(self, measure) -> List:
        """Group fractional-duration runs back into tuplet tuples.

        The reference matches music21 `fullName` strings (reference :85-117); here
        tuplets are identified arithmetically: consecutive notes whose duration has
        the same non-power-of-2 denominator form one group whose total is integral
        over the slot grid.
        """
        out = []
        elems = list(measure.elements)
        i = 0
        while i < len(elems):
            e = elems[i]
            d = Fraction(e.dur)
            den = d.denominator
            while den % 2 == 0:
                den //= 2
            if den > 1:  # tuplet member
                group = [e]
                j = i + 1
                while j < len(elems):
                    d2 = Fraction(elems[j].dur)
                    den2 = d2.denominator
                    while den2 % 2 == 0:
                        den2 //= 2
                    if den2 == den:
                        group.append(elems[j])
                        j += 1
                    else:
                        break
                # split equal-size runs: reference groups by n_tup notes each
                n_tup = den
                if len(group) % n_tup == 0:
                    for k in range(0, len(group), n_tup):
                        out.append(tuple(group[k:k + n_tup]))
                else:
                    out.append(tuple(group))
                i = j
            else:
                out.append(e)
                i += 1
        return out

    def _part2toks(
            self, part, insert_key: Optional[str] = None, n_bar: int = None,
            check_meta: bool = True, pitch_kind: str = 'step',
    ) -> PartExtractOutput:
        bars = list(part.measures)
        assert [b.number for b in bars] == list(range(len(bars))), 'invalid bar numbers'
        bar0 = bars[0]
        ts_tup, tempo = bar0.time_sig, bar0.tempo
        if check_meta:
            assert ts_tup is not None, 'expect a time signature in bar 0'
            assert tempo is not None, 'expect a tempo in bar 0'
        if tempo is not None:
            assert float(tempo).is_integer(), f'non-integer tempo {tempo}'
            tempo = int(tempo)
        if n_bar is not None:
            assert n_bar > 0
            bars = bars[:min(n_bar, len(bars))]

        vocab = self.pk2v[pitch_kind]
        toks: List[List[str]] = []
        for bar in bars:
            bar_toks: List[str] = []
            for e in self._bar2grouped_notes(bar):
                bar_toks.extend(self._elm2toks(e, vocab, pitch_kind))
            toks.append(bar_toks)
        return PartExtractOutput(time_sig=ts_tup, tempo=tempo, key=insert_key, toks=toks)

    def _elm2toks(self, e, vocab: MusicVocabulary, pitch_kind: str) -> List[str]:
        from musicnlp_tpu_torch.io.score import note2dur

        def pitch_tok(n) -> str:
            if isinstance(n, Rest):
                return vocab.rest
            if pitch_kind == 'midi':
                return vocab.note2pitch_str(n.pitch.midi)
            if pitch_kind == 'step':
                return vocab.note2pitch_str(n.pitch.midi, step=n.pitch.step)
            raise ValueError('degree pitch requires a key; use transforms.PitchShift')

        def dur_tok(d) -> str:
            return vocab.meta2tok(VocabType.duration, Fraction(d))

        if isinstance(e, tuple):
            return [vocab.start_of_tuplet, *[pitch_tok(n) for n in e],
                    dur_tok(note2dur(e)), vocab.end_of_tuplet]
        return [pitch_tok(e), dur_tok(e.dur)]

    def mxl2str(
            self, song: Union[str, Score], join: bool = True, n_bar: int = None,
            insert_key: Union[bool, str] = False, pitch_kind: str = 'step',
    ) -> Union[str, List[str]]:
        """Extracted-score file -> token representation (reference :162-215)."""
        vocab = self.pk2v[pitch_kind]
        score = parse_file(song) if isinstance(song, str) else song
        parts = list(score.parts)
        ok = (self.mode == 'melody' and len(parts) == 1) or (self.mode == 'full' and len(parts) == 2)
        assert ok, f'invalid #parts={len(parts)} for mode {self.mode!r}'
        part_melody = next(p for p in parts if 'Melody' in p.name)
        part_bass = next((p for p in parts if 'Bass' in p.name), None) if self.mode == 'full' else None

        key = None
        if insert_key:
            if isinstance(insert_key, str):
                key = insert_key
            else:
                from musicnlp_tpu_torch.preprocess.key_finder import KeyFinder
                scores = KeyFinder(score)(return_type='dict')
                key = max(scores, key=scores.get)

        out_m = self._part2toks(part_melody, insert_key=key, n_bar=n_bar, pitch_kind=pitch_kind)
        time_sig, tempo = out_m.time_sig, out_m.tempo
        out_b = None
        if self.mode == 'full':
            out_b = self._part2toks(part_bass, insert_key=key, n_bar=n_bar,
                                    check_meta=False, pitch_kind=pitch_kind)
            assert not out_b.time_sig or time_sig == out_b.time_sig
            assert not out_b.tempo or tempo == out_b.tempo
        toks = [vocab.meta2tok(VocabType.time_sig, time_sig),
                vocab.meta2tok(VocabType.tempo, tempo)]
        if insert_key:
            toks.append(vocab.meta2tok(VocabType.key, key))
        if self.mode == 'melody':
            for ts in out_m.toks:
                toks.append(vocab.start_of_bar)
                toks.extend(ts)
        else:
            for ts_m, ts_b in zip(out_m.toks, out_b.toks):
                toks.extend([vocab.start_of_bar, vocab.start_of_melody])
                toks.extend(ts_m)
                toks.append(vocab.start_of_bass)
                toks.extend(ts_b)
        for_gen = n_bar is not None
        toks.append(vocab.start_of_bar if for_gen else vocab.end_of_song)
        return ' '.join(toks) if join else toks

    # ------------------------------------------------------------------ visualization
    def visualize_str(self, score: Union[str, List[str]], pitch_kind: str = 'midi') -> str:
        """One bar per row (reference :276-292); plain text (no terminal colors)."""
        out = self.str2tok_elms(score)
        groups = [[g for g in (out.time_sig, out.tempo, out.key, out.omit) if g is not None]]
        groups += [[t for elms in bar for t in elms] for bar in out.elms_by_bar]
        n_pad = len(str(len(groups)))
        return '\n'.join(f'{i:>{n_pad}}: {" ".join(toks)}' for i, toks in enumerate(groups))
