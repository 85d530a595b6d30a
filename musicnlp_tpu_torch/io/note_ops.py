"""Copy of `musicnlp_tpu/io/note_ops.py` (pure Python / numpy): the port keeps its own copy
and imports nothing from the JAX package; only the import paths differ
(held against the original by tests/test_torch_pipeline.py).

Note algebra over the Score IR: gap fill, overlap predicates, bar validity,
and `make_score` assembly with duration-repair semantics.

Rebuild of the reference music-object utilities (reference
musicnlp/util/music_lib.py:498-836): `fill_with_rest`, rest merging, overlap/gap
predicates, `is_valid_bar_notes`, and `make_score` (piano Melody/Bass parts with
bar-duration repair by padding rests or cropping notes).
All arithmetic is Fraction-exact; the reference's eps=1e-8 float comparisons
(music_lib.py:74) are kept for robustness against float inputs.
"""
from __future__ import annotations

import logging
import math
from fractions import Fraction
from typing import Dict, Iterable, List, Optional, Tuple, Union

from musicnlp_tpu_torch.io.score import (
    Chord, Dur, ExtNote, Measure, Note, Part, Rest, Score, SNote, TsTup,
    eps, flatten_notes, get_end_qlen, get_offset, note2dur, time_sig2bar_dur,
)

__all__ = [
    'make_rest', 'note2clean_note', 'fill_with_rest', 'join_consecutive_rest_notes',
    'notes_have_gap', 'notes_overlapping', 'non_tuplet_notes_overlapping',
    'is_notes_pos_duration', 'get_notes_duration', 'is_valid_bar_notes',
    'assign_sequential_offsets', 'make_score', 'PrecisionChecker',
]

logger = logging.getLogger(__name__)


def make_rest(offset: Dur = 0, q_len: Dur = 1) -> Rest:
    return Rest(duration=q_len, offset=offset)


def note2clean_note(note: SNote, q_len: Dur) -> SNote:
    """Copy of note with new duration."""
    if isinstance(note, Rest):
        return Rest(duration=q_len, offset=note.offset)
    return Note(pitch=note.pitch, duration=q_len, offset=note.offset, velocity=note.velocity)


def fill_with_rest(
        notes: Iterable[ExtNote], duration: Dur = None, fill_start: bool = False,
) -> Tuple[List[ExtNote], List[Tuple[Dur, Dur]]]:
    """Fill missing time between sequential non-overlapping notes with rests
    (reference music_lib.py:498-556).  Returns (filled notes, gap ranges)."""
    it = iter(notes)
    note = next(it, None)
    if note is None:
        assert duration is not None
        return [make_rest(0, duration)], [(0, duration)]
    lst: List[ExtNote] = [note]
    meta: List[Tuple[Dur, Dur]] = []
    last_end = get_end_qlen(note)

    def fill(strt, end):
        lst.append(make_rest(strt, end - strt))
        meta.append((strt, end))

    for note in it:
        new_begin = get_offset(note)
        assert new_begin - last_end >= -eps
        if new_begin - last_end > eps:
            fill(last_end, new_begin)
        lst.append(note)
        last_end = get_end_qlen(note)
    if duration is not None and duration - last_end > eps:
        fill(last_end, duration)
    if fill_start:
        first_off = get_offset(lst[0])
        if first_off != 0:
            lst.insert(0, make_rest(0, first_off))
            meta.insert(0, (0, first_off))
    return lst, meta


def join_consecutive_rest_notes(notes: Iterable[SNote]) -> List[SNote]:
    """Identity, matching the reference's OBSERVED semantics.

    The reference's join_consecutive_rest_notes (music_lib.py:559-579) reads
    as a rest merger, but its shipped extraction artifacts
    (generated-samples/extracted/*.mxl) contain runs of adjacent un-merged
    rests at every call site's output (e.g. Beat It bar 19 melody holds three
    separate 1/8-QL rests back to back) -- the merge branch demonstrably never
    fires on real data.  Cross-extraction token parity against all 36
    original<->extracted pairs confirms it: treating this as identity takes
    exact matches from 6/36 to 16/36 with zero counter-examples, so the
    artifact-producing behavior is "no rest joining anywhere", and that is
    the contract this framework reproduces."""
    return list(notes)


def notes_have_gap(notes: Iterable[ExtNote], enforce_no_overlap: bool = True,
                   duration: Dur = None) -> bool:
    it = flatten_notes(notes)
    note = next(it, None)
    if note is None:
        return duration is not None and duration > 0
    if get_offset(note) > eps:      # leading gap (MIDI input has no rests)
        return True
    last_end = get_end_qlen(note)
    for note in it:
        diff = get_offset(note) - last_end
        if enforce_no_overlap and diff + eps < 0:
            raise ValueError(f'Notes overlap: last ends at {last_end}, '
                             f'next {note!r} starts at {get_offset(note)}')
        if diff - eps > 0:
            return True
        last_end = get_end_qlen(note)
    return duration is not None and (duration - last_end - eps) > 0


def notes_overlapping(notes: Iterable[ExtNote], flatten: bool = True) -> bool:
    ns = flatten_notes(notes) if flatten else iter(notes)
    note = next(ns, None)
    if note is None:
        return False
    end = get_end_qlen(note)
    for note in ns:
        if (end - eps) <= get_offset(note):
            end = get_end_qlen(note)
        else:
            return True
    return False


def _tup2note(t: Tuple[Note, ...]) -> Note:
    off = min(n.offset for n in t)
    q_len = max(n.end for n in t) - off
    return Note(pitch=t[0].pitch if isinstance(t[0], Note) else 60, duration=q_len, offset=off)


def non_tuplet_notes_overlapping(notes: Iterable[ExtNote]) -> bool:
    cleaned = [_tup2note(n) if isinstance(n, tuple) else n for n in notes]
    return notes_overlapping(cleaned)


def is_notes_pos_duration(notes: Iterable[ExtNote]) -> bool:
    return all(n.dur > 0 for n in flatten_notes(notes))


def get_notes_duration(notes: Iterable[ExtNote]) -> Dur:
    ret = sum((n.dur for n in flatten_notes(notes)), Fraction(0))
    return int(ret) if ret.denominator == 1 else ret


def is_valid_bar_notes(notes: Iterable[ExtNote], time_sig: Union[TsTup, str],
                       check_match_time_sig: bool = True) -> bool:
    """Notes cover the entire bar: positive durations, no overlap, no gap
    (reference music_lib.py:655-667)."""
    notes = list(notes)
    pos_dur = is_notes_pos_duration(notes)
    try:
        no_ovl = not notes_overlapping(notes)
        have_gap = notes_have_gap(notes)
    except ValueError:
        return False
    valid = pos_dur and no_ovl and not have_gap
    if check_match_time_sig:
        dur_bar = time_sig2bar_dur(time_sig)
        valid = valid and math.isclose(float(get_notes_duration(notes)), float(dur_bar), abs_tol=eps)
    return valid


class PrecisionChecker:
    """Are note times on the slot grid of 1/2^precision whole notes
    (reference music_lib.py:473-486)."""

    def __init__(self, precision: int = 5):
        self.prec = precision
        self.dur_slot = Fraction(4, 2 ** precision)

    def _ok(self, val) -> bool:
        return (Fraction(val) / self.dur_slot).denominator == 1

    def note_within_prec(self, note: ExtNote) -> bool:
        return self._ok(note2dur(note)) and self._ok(get_offset(note))

    def notes_within_prec(self, notes: Iterable[ExtNote]) -> bool:
        return all(self.note_within_prec(n) for n in notes)


def assign_sequential_offsets(notes: List[SNote]) -> List[SNote]:
    """Give notes back-to-back offsets starting at 0 (music21 `append` semantics)."""
    pos = Fraction(0)
    for n in notes:
        n.offset = pos
        pos += n.dur
    return notes


def make_score(
        title: str = 'musicnlp_tpu Song', composer: str = 'musicnlp_tpu', mode: str = 'melody',
        time_sig: Optional[str] = '4/4', tempo: int = 120,
        d_notes: Dict[str, List[List[SNote]]] = None,
        check_duration_match: Union[bool, str, None] = None,
) -> Score:
    """Assemble a rendered Score with piano Melody (+Bass) parts and bar-duration
    repair (reference music_lib.py:704-836).

    `d_notes` maps channel -> per-bar note lists (each note offset-0, durations set).
    `check_duration_match`: None/False, 'time-sig' (pad rest / crop notes to the bar
    duration) or 'each-other' (pad the shorter channel to match the longer).
    """
    assert mode in ('melody', 'full')
    check_dur = check_duration_match is not None and check_duration_match is not False
    if check_dur:
        assert check_duration_match in ('time-sig', 'each-other')

    def clean_bars(lst_notes: List[List[SNote]], is_bass: bool = False) -> List[List[SNote]]:
        out = []
        for i, notes in enumerate(lst_notes):
            notes = [n for n in notes if n.dur and n.dur > 0]
            if check_duration_match == 'time-sig':
                assert time_sig is not None and time_sig != 'TimeSig_rare'
                dur_notes, dur_bar = get_notes_duration(notes), time_sig2bar_dur(time_sig)
                diff = dur_notes - dur_bar
                if abs(diff) > eps:
                    typ = 'Bass' if is_bass else 'Melody'
                    if dur_notes < dur_bar:
                        notes = notes + [Rest(quarterLength=dur_bar - dur_notes)]
                        logger.warning('%s bar %d under-full: rest of %s added', typ, i + 1, dur_bar - dur_notes)
                    else:
                        # find first note exceeding the bar edge, crop/drop the tail
                        idx_last, dur = None, Fraction(0)
                        for i_, n in enumerate(notes):
                            dur += n.dur
                            if (dur - dur_bar) - eps > 0:
                                idx_last = i_
                                break
                        assert idx_last is not None
                        dur_prior = get_notes_duration(notes[:idx_last])
                        if abs(float(dur_prior - dur_bar)) < eps:
                            notes = notes[:idx_last]
                        else:
                            qlen = dur_bar - dur_prior
                            assert qlen > 0
                            notes[idx_last] = note2clean_note(notes[idx_last], q_len=qlen)
                            notes = notes[:idx_last + 1]
                        logger.warning('%s bar %d over-full: cropped to %s', typ, i + 1, dur_bar)
                        assert abs(float(get_notes_duration(notes) - dur_bar)) < eps
            out.append(notes)
        return out

    d_notes = d_notes or dict(melody=[])
    bars_melody = clean_bars(d_notes['melody'])
    bars_bass = None
    if mode == 'full':
        bars_bass = clean_bars(d_notes['bass'], is_bass=True)
        if check_duration_match == 'each-other':
            for idx, (nm, nb) in enumerate(zip(bars_melody, bars_bass)):
                dur_m, dur_b = get_notes_duration(nm), get_notes_duration(nb)
                if abs(float(dur_m - dur_b)) > eps:
                    if dur_m > dur_b:
                        nb.append(Rest(quarterLength=dur_m - dur_b))
                    else:
                        nm.append(Rest(quarterLength=dur_b - dur_m))
                    logger.warning('Melody/bass duration mismatch at bar %d (%s vs %s)', idx + 1, dur_m, dur_b)

    ts_tup: Optional[TsTup] = None
    if time_sig is not None and time_sig != 'TimeSig_rare':
        n, d = str(time_sig).split('/')
        ts_tup = (int(n), int(d))

    def build_part(name: str, bars: List[List[SNote]], is_bass: bool) -> Part:
        part = Part(name=name, midi_channel=1 if is_bass else 0)
        pos = Fraction(0)
        for i, notes in enumerate(bars):
            assign_sequential_offsets(notes)
            m = Measure(number=i, elements=list(notes), offset=pos, is_bass_clef=is_bass)
            if i == 0:
                m.tempo = tempo
                m.time_sig = ts_tup
            part.measures.append(m)
            bar_dur = time_sig2bar_dur(ts_tup) if ts_tup is not None else get_notes_duration(notes)
            pos += bar_dur
        return part

    title_post = 'Melody only' if mode == 'melody' else 'Melody & Bass'
    score = Score(title=f'{title}, {title_post}', composer=composer)
    score.parts.append(build_part('Melody, Ch#1', bars_melody, is_bass=False))
    if mode == 'full':
        score.parts.append(build_part('Bass, Ch#2', bars_bass, is_bass=True))
        offs_m = [m.offset for m in score.parts[0].measures]
        offs_b = [m.offset for m in score.parts[1].measures]
        assert offs_m == offs_b, 'melody/bass bar offsets diverged'
    return score
