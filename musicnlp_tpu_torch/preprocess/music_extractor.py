"""Copy of `musicnlp_tpu/preprocess/music_extractor.py` (pure Python / numpy): the port keeps its own copy
and imports nothing from the JAX package; only the import paths differ
(held against the original by tests/test_torch_extract.py).

Score -> music-token extraction: the core encoder.

Rebuild of the reference extractor (reference musicnlp/preprocess/music_extractor.py:51):
per-bar unroll with time-sig/tempo carry (it_bars :119-154), voice/chord flattening
with n-plet grouping & repair (expand_bar :163-419), skyline melody selection with
recursive-restart overlap resolution (get_notes_out :743-831), bass channel with
melody-dup removal (:526-580), and majority-overlap slot quantization
(notes2quantized_notes :876-970).

Differences by design (not behavior):
 - input Scores come from the first-party MIDI/MusicXML parsers (musicnlp_tpu_torch.io):
   tuplet runs are detected from the MusicXML <time-modification> notation
   (the same source music21's `fullName` matching reads, minus the per-note
   string formatting that is the reference's stated bottleneck at :182);
   MIDI sources, which carry no notation, fall back to arithmetic inference;
 - all times are exact Fractions on the slot grid;
 - the reference's per-file `_fix_edge_case` patch table (:630-725) is dataset-
   specific repair of broken corpus files and is generalized here by
   `_drop_rests_beyond_time_sig` + quantization instead of hard-coded bars.

Where the reference's CODE and its shipped ARTIFACTS disagree, the artifacts
win -- they are the parity ground truth the north-star benchmark measures
against (tests/test_reference_parity.py::test_cross_extraction_parity).
Artifact-derived behaviors: rest joining never fires, tuplet groups close on
slot-aligned cumulative durations, complex durations split into power-of-2
components, dyadic-split tuplets degrade to plain notes.
"""
from __future__ import annotations

import itertools
import math
from collections import Counter, defaultdict
from copy import deepcopy
from dataclasses import dataclass
from fractions import Fraction
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np

from musicnlp_tpu_torch.io.score import (
    Chord, Dur, ExtNote, Measure, Note, Rest, Score, SNote, TsTup,
    flatten_notes, get_end_qlen, get_offset, note2dur, note2pitch,
    time_sig2bar_dur, tuplet_name,
)
from musicnlp_tpu_torch.io.note_ops import (
    PrecisionChecker, fill_with_rest, get_notes_duration, is_notes_pos_duration,
    is_valid_bar_notes, join_consecutive_rest_notes, make_rest, make_score,
    non_tuplet_notes_overlapping, notes_have_gap, notes_overlapping,
)
from musicnlp_tpu_torch.io.musicxml import parse_file
from musicnlp_tpu_torch.preprocess.key_finder import KeyFinder
from musicnlp_tpu_torch.preprocess.warning_logger import WarnLog
from musicnlp_tpu_torch.vocab import (
    COMMON_TEMPOS, COMMON_TIME_SIGS, MusicVocabulary, VocabType,
    is_common_tempo, is_common_time_sig,
)

__all__ = ['MusicExtractor', 'MusicExtractorOutput']


@dataclass
class MusicExtractorOutput:
    score: Any = None
    song_path: str = None
    title: str = None
    duration: int = None
    warnings: List[Dict[str, Any]] = None
    keys: Dict[str, float] = None


@dataclass
class BarInfo:
    bars: List[Measure]
    time_sig: TsTup
    tempo: float


def _filled_ranges(notes: Iterable[ExtNote]) -> List[Tuple[float, float]]:
    return [(float(get_offset(n)), float(get_end_qlen(n))) for n in notes]


def _note2clean_note(note: ExtNote, q_len: Dur = None) -> ExtNote:
    """Copy with optionally-overridden duration.  Tuplet members are ALWAYS
    re-split evenly over the group's total duration with back-to-back offsets
    (reference music_lib.py:184-229 note2clean_note: q_len defaults to the
    tuplet total) -- this is what equalizes mixed-duration brackets like
    dotted-16th+32nd+16th before the precision checks."""
    if isinstance(note, tuple):
        if q_len is None:
            q_len = note2dur(note)
        dur_ea = Fraction(q_len) / len(note)
        out, off = [], note[0].offset
        for n in note:
            n2 = _note2clean_note(n, q_len=dur_ea)
            n2.offset = off
            out.append(n2)
            off += dur_ea
        return tuple(out)
    q = note.dur if q_len is None else Fraction(q_len)
    if isinstance(note, Rest):
        return Rest(duration=q, offset=note.offset)
    if isinstance(note, Chord):
        return Chord(pitches=list(note.pitches), duration=q, offset=note.offset,
                     velocity=getattr(note, 'velocity', 90))
    return Note(pitch=note.pitch, duration=q, offset=note.offset,
                velocity=getattr(note, 'velocity', 90))


def _is_8th(d: Dur) -> bool:
    """Is duration a multiple of an 8th note (1/2 QL)?"""
    return (Fraction(d) * 2).denominator == 1


def _is_single_notatable(ql: Fraction) -> bool:
    """Expressible as ONE notated duration: 2^k * (2 - 2^-dots), dots 0..4
    (music21's type+dots model; 15/4 = triple-dotted half occurs in the
    reference's own artifacts as a single token)."""
    for d in range(5):
        base = ql / (2 - Fraction(1, 1 << d)) if d else ql
        if base.numerator == 1 and (base.denominator & (base.denominator - 1)) == 0:
            return True
        if base.denominator == 1 and (base.numerator & (base.numerator - 1)) == 0:
            return True
    return False


def _notation_components(ql: Fraction) -> List[Fraction]:
    """music21's rendering of a complex duration: descending pure-power-of-2
    components, STOPPING as soon as the remainder is a single notatable
    (possibly dotted) duration.  Calibrated against the reference's shipped
    artifacts: 25/8 QL ships as 2 + 1 + 1/8 (the 9/8 remainder is not a
    single duration, so the pure-power walk continues -- NOT dotted-half +
    1/8), while 11/4 QL ships as 2 + 3/4 (the 3/4 remainder IS a dotted
    eighth, so it stays whole -- NOT 2 + 1/2 + 1/4; Merry Go Round bar 21).
    Identity for notatable durations."""
    if _is_single_notatable(ql):
        return [ql]
    # dyadic input is the walk's termination invariant (a 1/3-QL input would
    # never reach 0); guaranteed by notes2quantized_notes upstream
    assert ql.denominator & (ql.denominator - 1) == 0, ql
    out: List[Fraction] = []
    rem = ql
    while rem > 0:
        if _is_single_notatable(rem):
            out.append(rem)
            break
        p = Fraction(1)
        while p * 2 <= rem:
            p *= 2
        while p > rem:
            p /= 2
        out.append(p)
        rem -= p
    return out


def _odd_part(n: int) -> int:
    while n % 2 == 0:
        n //= 2
    return n


def _tuplet_n(d: Fraction) -> int:
    """Tuplet cardinality implied by a duration, or 1 if not tuplet-like.

    A clean n-plet member at unit 1/(n*k) QL (k a power of 2) spans at most ~2
    units; arbitrary off-grid durations (MIDI timing jitter like 9/10 QL) have
    large numerators relative to the unit and must go to slot quantization
    instead.  This replaces the reference's music21-`fullName` string matching
    (reference music_extractor.py:183) with an arithmetic test.
    """
    q = d.denominator
    n = _odd_part(q)
    if n == 1 or n > 13:
        return 1
    k = q // n  # power-of-2 subdivision of the tuplet unit
    return n if d.numerator <= 2 * k else 1


def _is_empty_bars(bars: List[Measure]) -> bool:
    return all(
        not isinstance(e, (Note, Chord))
        for b in bars
        for stream in ([b.elements] if not b.voices else b.voices)
        for e in stream
    )


class MusicExtractor:
    """Extract melody (and bass) from a Score into the 1-D token representation."""

    def __init__(
            self, precision: int = 5, mode: str = 'melody', with_pitch_step: bool = False,
            warn_logger: Union[WarnLog, bool, None] = None,
            greedy_tuplet_pitch_threshold: int = 3 ** 9,
            verbose: bool = False, epsilon: float = 1e-8,
    ):
        assert mode in ('melody', 'full')
        self.prec = precision
        self.mode = mode
        self.pc = PrecisionChecker(precision=precision)
        self.warn_logger = (warn_logger if isinstance(warn_logger, WarnLog)
                            else (WarnLog(verbose=verbose) if warn_logger else None))
        self.greedy_tuplet_pitch_threshold = greedy_tuplet_pitch_threshold
        self.verbose = verbose
        self.eps = epsilon
        self.with_pitch_step = with_pitch_step
        # default for direct expand_bar/extract_notes calls; __call__ passes
        # the per-song value (from Score.source) explicitly, so one extractor
        # instance can serve concurrent songs without racing on shared state
        self.infer_tuplets_default = True
        self.vocab = MusicVocabulary(
            precision=precision, pitch_kind='step' if with_pitch_step else 'midi')
        self.meta = dict(mode=mode, precision=precision, with_pitch_step=with_pitch_step,
                         greedy_tuplet_pitch_threshold=greedy_tuplet_pitch_threshold)

    @staticmethod
    def meta2fnm_meta(d: Dict) -> str:
        return f'{{md={d["mode"][0]}, prec={d["precision"]}, th={d["greedy_tuplet_pitch_threshold"]}}}'

    def log_warn(self, log_d: Dict = None, **kwargs):
        if self.warn_logger is not None:
            self.warn_logger.update((log_d or {}) | kwargs)

    def dur_within_prec(self, dur: Dur) -> bool:
        return (Fraction(dur) / Fraction(4, 2 ** self.prec)).denominator == 1

    # ------------------------------------------------------------------ bar unroll
    def it_bars(self, scr: Score) -> Iterable[BarInfo]:
        """Unroll a score by time with per-bar time signature & tempo carry
        (reference :119-154)."""
        parts = list(scr.parts)
        ignore = [p.is_drum for p in parts]
        time_sig: Optional[TsTup] = None
        tempo: Optional[float] = None
        for idx, bars in enumerate(zip(*[p.measures for p in parts])):
            nums = [b.number for b in bars]
            assert all(n == nums[0] for n in nums), 'bar numbers should be the same'
            tss = [b.time_sig for b in bars if b.time_sig is not None]
            if idx == 0 or tss:
                assert tss, 'first bar must have a time signature'
                assert all(t == tss[0] for t in tss)
                time_sig = tss[0]
            tempos = [b.tempo for b in bars if b.tempo is not None]
            if tempos:
                tempo = float(np.mean(tempos))
            elif idx == 0:
                self.log_warn(warn_name=WarnLog.MissTempo)
                tempo = 120.0
            yield BarInfo(bars=[b for ig, b in zip(ignore, bars) if not ig],
                          time_sig=time_sig, tempo=tempo)

    # ------------------------------------------------------------------ bar expansion
    @staticmethod
    def chord2notes(c: Chord) -> List[Note]:
        return [Note(pitch=p, duration=c.dur, offset=c.offset, velocity=c.velocity)
                for p in c.pitches]

    def _tuplet_run_class(self, elm, infer_tuplets: bool) -> Optional[Tuple[str, int]]:
        """(run-class name, n_tup) if this element starts/continues a tuplet run.

        MusicXML sources carry explicit <time-modification> notation; the run
        class mirrors music21's `Tuplet.fullName` name classes the reference
        groups by (reference music_extractor.py:183-194: a run continues while
        the name matches, and n_tup = actual-notes of the first element;
        `_group_tuplets` then renormalizes n_tup for uniformly-clean runs).
        MIDI sources have no tuplet notation, so cardinality is inferred
        arithmetically from the duration there (first-party behavior; the
        reference never parses MIDI directly)."""
        tm = getattr(elm, 'tm', None)
        if tm is not None:
            return tuplet_name(tm), tm[0]
        if infer_tuplets:
            n = _tuplet_n(Fraction(elm.dur))
            if n > 1:
                return f'inferred/{n}', n
        return None

    def expand_bar(self, elements: List, time_sig: TsTup, keep_chord: bool = False,
                   number: int = None,
                   infer_tuplets: Optional[bool] = None) -> List[ExtNote]:
        """Flatten a bar's element stream into notes, grouping n-plets with repair
        heuristics (reference expand_bar :163-419).

        infer_tuplets: arithmetic tuplet inference for notation-less sources
        (MIDI); None -> the constructor default.  MusicXML callers pass False
        (explicit <time-modification> notation wins)."""
        if infer_tuplets is None:
            infer_tuplets = self.infer_tuplets_default
        lst: List[ExtNote] = []
        it = iter(elements)
        elm = next(it, None)
        while elm is not None:
            run = self._tuplet_run_class(elm, infer_tuplets)
            if run is not None:  # collect the run of same-class tuplet elements
                name, n_tup = run
                elms_tup: List[Union[Rest, Note, Chord]] = [elm]
                elm_ = next(it, None)
                while elm_ is not None:
                    run_ = self._tuplet_run_class(elm_, infer_tuplets)
                    if run_ is None or run_[0] != name:
                        break
                    elms_tup.append(elm_)
                    elm_ = next(it, None)

                if notes_overlapping(elms_tup):
                    self.log_warn(warn_name=WarnLog.TupNoteOvlIn, bar_num=number,
                                  filled_ranges=_filled_ranges(elms_tup))
                if notes_have_gap(elms_tup, enforce_no_overlap=False):
                    self.log_warn(warn_name=WarnLog.TupNoteGap, bar_num=number,
                                  time_sig=time_sig, filled_ranges=_filled_ranges(elms_tup))

                lst.extend(self._group_tuplets(elms_tup, n_tup, time_sig, number, keep_chord))
                elm = elm_
                continue
            if isinstance(elm, (Note, Rest)):
                lst.append(elm)
            elif isinstance(elm, Chord):
                if keep_chord:
                    lst.append(elm)
                else:
                    lst.extend(MusicExtractor.chord2notes(elm))
            elm = next(it, None)
        assert is_notes_pos_duration(lst)
        return lst

    def _group_tuplets(self, elms_tup: List, n_tup: int, time_sig: TsTup,
                       number: int, keep_chord: bool) -> List[ExtNote]:
        """Group a run of tuplet elements into tuples of `n_tup`, with the reference's
        repair heuristics (duration rounding, overlap fixing, chord expansion caps).

        When the run is UNIFORMLY composed of clean o-unit durations for a
        proper odd divisor o of n_tup, the ratio renormalizes to o -- a run of
        nine clean 1/6-QL members marked 9:8 splits into Triplet groups
        (Fuer Elise bars 104-108 in the reference's artifacts), while a 9:8
        run containing jittered members keeps n_tup=9 (Beat It) and an
        undotted uniform 2/9-QL 9:8 run keeps 9 (odd part IS 9; Mozart
        Sonata 11's 9-group)."""
        odds = {self._clean_odd_unit(Fraction(e.dur)) for e in elms_tup}
        if len(odds) == 1:
            o = odds.pop()
            if o is not None and o < n_tup and n_tup % o == 0:
                n_tup = o
        lst: List[ExtNote] = []
        dur = Fraction(0)
        idx_next_strt, n_tup_curr = 0, 0
        tup_added, tup_ignored = False, False
        n_ignored = 0
        is_single_tup = False
        idx_last = len(elms_tup) - 1

        for idx, e_tup in enumerate(elms_tup):
            dur += e_tup.dur
            n_tup_curr += 1
            # closure and the tail-join both test multiples of an 8TH note
            # (reference is_8th, music_extractor.py:229/249) -- NOT the slot
            # grid: a [1/6, 1/12] leftover (1/4 QL, on-grid but no 8th) stays
            # its own group in the reference's artifacts (Beat It m.110)
            if n_tup_curr >= n_tup and _is_8th(dur):
                lst.append(tuple(elms_tup[idx_next_strt:idx + 1]))
                tup_added = True
                idx_next_strt = idx + 1
                n_tup_curr = 0
                dur = Fraction(0)
            if idx == idx_last and idx_next_strt <= idx_last:
                if len(elms_tup) == 1:  # lone odd-duration element: treat as single note
                    note = elms_tup[0]
                    if (not keep_chord) and isinstance(note, Chord):
                        note = max(MusicExtractor.chord2notes(note), key=note2pitch)
                    lst.append(note)
                    tup_added, is_single_tup = True, True
                    break
                if _is_8th(dur) and n_tup_curr < n_tup:  # not enough at tail
                    if tup_added:
                        lst[-1] = lst[-1] + tuple(elms_tup[idx_next_strt:])
                    else:
                        tup_added = True
                        lst.append(tuple(elms_tup[idx_next_strt:]))
                elif n_tup_curr > 0:
                    assert not _is_8th(dur)
                    warn_nm = WarnLog.InvTupDur
                    ranges = _filled_ranges(elms_tup[idx_next_strt:])
                    curr_ignored = False
                    if not self.dur_within_prec(dur):
                        warn_nm = WarnLog.InvTupDurSv
                        slot = Fraction(4, 2 ** self.prec)
                        dur = min(round(dur / slot) * slot, time_sig2bar_dur(time_sig))
                        n_last = len(elms_tup) - idx_next_strt
                        if dur > 0:
                            dur_ea = Fraction(dur) / n_last
                            strt = elms_tup[idx_next_strt].offset
                            for i in range(idx_next_strt, len(elms_tup)):
                                elms_tup[i] = _note2clean_note(elms_tup[i], q_len=dur_ea) \
                                    if not isinstance(elms_tup[i], Chord) else elms_tup[i]
                                elms_tup[i].offset = strt
                                elms_tup[i].dur = dur_ea
                                strt += dur_ea
                        else:
                            n_ignored += n_last
                            tup_ignored = curr_ignored = True
                            self.log_warn(warn_name=WarnLog.LowTupDur, bar_num=number,
                                          time_sig=time_sig, precision=self.prec,
                                          filled_ranges=ranges)
                    if not curr_ignored:
                        lst.append(tuple(elms_tup[idx_next_strt:]))
                        tup_added = True
                    self.log_warn(warn_name=warn_nm, bar_num=number, filled_ranges=ranges)
        assert tup_added or tup_ignored
        if is_single_tup:
            return lst

        assert sum(len(t) for t in lst) + n_ignored == len(elms_tup)
        for tup in lst:
            if len(tup) != n_tup:
                self.log_warn(warn_name=WarnLog.InvTupSz, bar_num=number,
                              n_expect=n_tup, n_got=len(tup))
        # enforce that each group's members tile its span back-to-back: both
        # overlaps AND internal gaps (members not adjacent -- seen in the
        # reference's own sample MIDIs) make note2dur(tuple) inconsistent with
        # the span and would fail bar validity downstream
        for i, tup in enumerate(lst):
            overlapping = notes_overlapping(tup)
            span = get_end_qlen(tup) - get_offset(tup)
            gappy = (not overlapping
                     and sum((Fraction(n.dur) for n in tup), Fraction(0)) != span)
            if overlapping or gappy:
                ranges = _filled_ranges(tup)
                self.log_warn(warn_name=(WarnLog.TupNoteOvlOut if overlapping
                                         else WarnLog.TupNoteGap),
                              bar_num=number, time_sig=time_sig,
                              filled_ranges=ranges)
                total_dur = sum((n.dur for n in tup), Fraction(0))
                if (total_dur / Fraction(4, 2 ** self.prec)).denominator != 1:
                    self.log_warn(warn_name=WarnLog.InvTupDur, bar_num=number,
                                  filled_ranges=ranges, precision=self.prec,
                                  total_duration=float(total_dur))
                fixed = [_note2clean_note(tup[0])]
                off = fixed[0].offset + fixed[0].dur
                for n in tup[1:]:
                    n2 = _note2clean_note(n)
                    n2.offset = off
                    fixed.append(n2)
                    off += n2.dur
                assert not notes_overlapping(fixed)
                lst[i] = tuple(fixed)
        for tup in lst:
            n_rest = sum(isinstance(n, Rest) for n in tup)
            if n_rest:
                self.log_warn(warn_name=WarnLog.RestInTup, bar_num=number,
                              n_rest=n_rest, n_note=len(tup))
        if not keep_chord:
            tups_new, has_chord = [], False
            for tup in lst:
                if any(isinstance(n, Chord) for n in tup):
                    has_chord = True
                    opns = [MusicExtractor.chord2notes(n) if isinstance(n, Chord) else (n,)
                            for n in tup]
                    n_opns = [len(o) for o in opns if o]
                    if math.prod(n_opns) > self.greedy_tuplet_pitch_threshold:
                        self.log_warn(warn_name=WarnLog.ExcecTupNote, bar_num=number,
                                      note_choices=n_opns,
                                      threshold=self.greedy_tuplet_pitch_threshold)
                        tups_new.append(tuple(max(notes, key=note2pitch) for notes in opns))
                    else:
                        tups_new.extend(itertools.product(*opns))
                else:
                    tups_new.append(tup)
            if has_chord:
                lst = tups_new
        out: List[ExtNote] = []
        for tup in lst:
            if isinstance(tup, tuple):
                if len(tup) == 1:
                    out.append(tup[0])
                elif all(isinstance(n, Rest) for n in tup):
                    qlen = sum((n.dur for n in tup), Fraction(0))
                    out.append(make_rest(offset=tup[0].offset, q_len=qlen))
                else:
                    out.append(tup)
            else:
                out.append(tup)
        return out

    # ------------------------------------------------------------------ skyline
    @staticmethod
    def _clean_odd_unit(d: Fraction) -> Optional[int]:
        """The odd subdivision o if `d` is a clean single o-plet unit, else None."""
        o = _odd_part(d.denominator)
        return o if o > 1 and _tuplet_n(d) == o else None

    @staticmethod
    def sort_groups(groups: Dict, reverse: bool = False):
        for offset, ns in groups.items():
            groups[offset] = sorted(ns, key=lambda nt: (note2pitch(nt), note2dur(nt)),
                                    reverse=reverse)

    @staticmethod
    def _ext_notes_eq(nt1: ExtNote, nt2: ExtNote) -> bool:
        if type(nt1) is not type(nt2):
            return False
        if isinstance(nt1, Rest):
            return nt1.offset == nt2.offset and nt1.dur == nt2.dur
        if isinstance(nt1, Note):
            return (nt1.offset == nt2.offset and nt1.dur == nt2.dur
                    and nt1.pitch.midi == nt2.pitch.midi)
        return len(nt1) == len(nt2) and all(
            MusicExtractor._ext_notes_eq(a, b) for a, b in zip(nt1, nt2))

    def _drop_rests_beyond_time_sig(self, groups: Dict, time_sig: TsTup, number: int = None):
        """Truncate/drop rests that extend past the bar (reference :462-498)."""
        bar_dur = time_sig2bar_dur(time_sig)
        for offset in list(groups.keys()):
            _notes, rests = [], []
            for n in groups[offset]:
                if isinstance(n, Rest) and get_end_qlen(n) > bar_dur:
                    rests.append(n)
                    if offset < bar_dur:
                        _notes.append(make_rest(offset=n.offset, q_len=bar_dur - offset))
                else:
                    _notes.append(n)
            groups[offset] = _notes
            if rests:
                self.log_warn(warn_name=WarnLog.RestsBeyondTimeSig, bar_num=number,
                              filled_ranges=_filled_ranges(rests), time_sig=time_sig)

    def get_notes_out(self, groups: Dict, number: int, keep: str = 'high',
                      pre_sort: bool = False) -> List[ExtNote]:
        """Skyline selection with restart on truncation
        (reference get_notes_out :743-831).

        The reference restarts via tail recursion; dense real-world bars can
        need >1000 restarts (found on the reference's own sample MIDIs), so
        the restart is a loop here.  Each restart removes or shrinks a note,
        so the loop terminates.
        """
        is_high = keep == 'high'
        while True:
            if pre_sort:
                MusicExtractor.sort_groups(groups, reverse=not is_high)
            pre_sort = False
            restart = False
            ns_out: List[ExtNote] = []
            last_end: Dur = Fraction(0)
            for offset in sorted(groups.keys()):
                notes_ = groups[offset]
                if not notes_:
                    del groups[offset]
                    continue
                nt = notes_[-1]  # extreme-pitch note at this offset
                nt_end = get_end_qlen(nt)
                if ns_out and float(last_end) - float(offset) > self.eps:
                    note_last = ns_out[-1]
                    pch_last, pch_curr = note2pitch(note_last), note2pitch(nt)
                    later_better = pch_curr > pch_last if is_high else pch_curr < pch_last
                    if later_better:  # truncate last added note
                        if isinstance(note_last, tuple):  # remove whole tuplet, restart
                            del groups[get_offset(note_last)][-1]
                            self.log_warn(warn_name=WarnLog.HighPchOvlTup, bar_num=number)
                            restart = True
                            break
                        self.log_warn(warn_name=WarnLog.HighPchOvl, bar_num=number)
                        nt_ = nt[0] if isinstance(nt, tuple) else nt
                        new_dur = nt_.offset - note_last.offset
                        note_last.dur = Fraction(new_dur)
                        pre_sort = True
                        assert note_last.dur >= 0
                        if note_last.dur == 0:  # was itself a makeup note: drop it
                            dropped = ns_out.pop()
                            assert dropped.offset == offset
                            assert groups[offset][-1] is dropped or \
                                MusicExtractor._ext_notes_eq(groups[offset][-1], dropped)
                            del groups[offset][-1]
                            self.log_warn(warn_name=WarnLog.LowPchMakeupRmv, bar_num=number)
                        ns_out.append(nt)
                        last_end = nt_end
                    elif float(nt_end) - float(last_end) > self.eps:
                        # lower pitch but ends later: truncate current, re-insert at last_end
                        if not isinstance(nt, tuple):
                            del groups[offset][-1]
                            nt_ = _note2clean_note(nt)
                            nt_.offset = Fraction(last_end)
                            nt_.dur = Fraction(nt_end - last_end)
                            assert nt_.dur > 0
                            keys = list(groups.keys())
                            closest = min(keys, key=lambda x: abs(float(x) - float(last_end)))
                            tgt = closest if abs(float(last_end) - float(closest)) < self.eps else last_end
                            groups.setdefault(tgt, []).append(nt_)
                            MusicExtractor.sort_groups(groups, reverse=not is_high)
                            self.log_warn(warn_name=WarnLog.LowPchMakeup, bar_num=number)
                            restart = True
                            break
                    # else: fully covered by prior note, skip
                else:
                    ns_out.append(nt)
                    last_end = nt_end
            if not restart:
                return ns_out

    # ------------------------------------------------------------------ quantization
    def notes2quantized_notes(self, notes: List[ExtNote], time_sig: TsTup,
                              number: int = None) -> List[ExtNote]:
        """Snap notes to the slot grid by majority overlap (reference :876-970)."""
        dur_slot = Fraction(4, 2 ** self.prec)
        dur_bar = time_sig2bar_dur(time_sig)
        n_slots_f = dur_bar / dur_slot
        if n_slots_f.denominator != 1:
            # fractional #slots (e.g. 21/64 time): round bar up to whole slots
            n_slots = math.ceil(n_slots_f)
            dur_bar = dur_slot * n_slots
        else:
            n_slots = int(n_slots_f)
        bin_edges = [(i * dur_slot, (i + 1) * dur_slot) for i in range(n_slots)]

        def note2range(n):
            return (get_offset(n), get_end_qlen(n))

        notes_ranges = [note2range(n) for n in notes]
        n_notes = len(notes)

        def get_overlap(low, high, i):
            return min(high, notes_ranges[i][1]) - max(low, notes_ranges[i][0])

        def assign(low, high):
            if n_notes == 0:
                return None
            best = max(range(n_notes), key=lambda i: get_overlap(low, high, i))
            return best if get_overlap(low, high, best) > 0 else None

        idxs_note = [assign(*edge) for edge in bin_edges]

        filled = [(i is not None and get_overlap(*edge, i) > 0)
                  for edge, i in zip(bin_edges, idxs_note)]
        if not all(filled):
            missing = [[i for i, _ in grp] for flag, grp in
                       itertools.groupby(enumerate(filled), key=lambda x: x[1]) if not flag]
            ranges = [(float(g[0] * dur_slot), float((g[-1] + 1) * dur_slot)) for g in missing]
            self.log_warn(warn_name=WarnLog.BarNoteGap, bar_num=number, time_sig=time_sig,
                          precision=self.prec, unfilled_ranges=ranges)

        # run-length compress slot assignments -> notes
        offset = Fraction(0)
        notes_out: List[ExtNote] = []
        for i, run in itertools.groupby(idxs_note):
            n_run = len(list(run))
            q_len = n_run * dur_slot
            if i is None:
                nd = make_rest(offset=offset, q_len=q_len)
                notes_out.append(nd)
                offset += q_len
            else:
                nt = _note2clean_note(notes[i], q_len=q_len)
                if isinstance(nt, tuple):
                    dur_ea = Fraction(q_len) / len(nt)
                    repositioned = []
                    for k, t in enumerate(nt):
                        t.offset = offset + dur_ea * k
                        repositioned.append(t)
                    notes_out.append(tuple(repositioned))
                else:
                    nt.offset = offset
                    notes_out.append(nt)
                offset += note2dur(nt)
        assert not notes_overlapping(notes_out)
        assert sum((note2dur(n) for n in notes_out), Fraction(0)) == dur_bar
        return notes_out

    def clean_quantized_tuplets(self, notes: List[ExtNote], num_bar: int) -> List[ExtNote]:
        """Tuplets whose members are on the slot grid degrade to plain notes
        (reference :972-984)."""
        lst: List[ExtNote] = []
        for nt in notes:
            if isinstance(nt, tuple) and any(self.pc.note_within_prec(n) for n in nt):
                assert all(self.pc.note_within_prec(n) for n in nt)
                lst.extend(join_consecutive_rest_notes(nt))
                self.log_warn(warn_name=WarnLog.TupNoteQuant, bar_num=num_bar,
                              filled_ranges=_filled_ranges(notes))
            else:
                lst.append(nt)
        return join_consecutive_rest_notes(lst)

    # ------------------------------------------------------------------ per-song pipeline
    def warn_notes_duration(self, notes, time_sig: TsTup, number: int):
        if not math.isclose(float(get_notes_duration(notes)),
                            float(time_sig2bar_dur(time_sig)), abs_tol=self.eps):
            self.log_warn(warn_name=WarnLog.InvBarDur, bar_num=number,
                          filled_ranges=_filled_ranges(notes), time_sig=time_sig)

    def warn_notes_overlap(self, notes, number: int):
        if notes_overlapping(notes):
            assert not non_tuplet_notes_overlapping(notes)
            for tup in notes:
                if isinstance(tup, tuple) and notes_overlapping(tup):
                    self.log_warn(warn_name=WarnLog.TupNoteOvlOut, bar_num=number,
                                  filled_ranges=_filled_ranges(tup))

    def extract_notes(self, lst_bar_info: List[BarInfo],
                      time_sigs: List[TsTup],
                      infer_tuplets: Optional[bool] = None,
                      ) -> Dict[str, List[List[ExtNote]]]:
        lst_melody, lst_bass = [], []
        for i_bar, bi in enumerate(lst_bar_info):
            bars, time_sig = bi.bars, bi.time_sig
            all_notes: List[ExtNote] = []
            for b in bars:
                streams = [b.elements] if not b.voices else b.voices
                for stream in streams:
                    all_notes += self.expand_bar(stream, time_sig, keep_chord=False,
                                                 number=i_bar,
                                                 infer_tuplets=infer_tuplets)
            groups_melody: Dict = defaultdict(list)
            for n in all_notes:
                groups_melody[get_offset(n)].append(n)
            groups_melody = dict(groups_melody)
            self._drop_rests_beyond_time_sig(groups_melody, time_sig, number=i_bar)
            MusicExtractor.sort_groups(groups_melody, reverse=False)

            groups_bass = None
            if self.mode == 'full':
                groups_bass = {
                    k: [self._deep_copy_note(n) for n in v if not isinstance(n, Rest)]
                    for k, v in groups_melody.items()
                }
                MusicExtractor.sort_groups(groups_bass, reverse=True)

            def _local_post_process(notes_):
                self.warn_notes_duration(notes_, time_sig, i_bar)
                self.warn_notes_overlap(notes_, i_bar)
                return [_note2clean_note(nt) for nt in join_consecutive_rest_notes(notes_)]

            notes_melody = self.get_notes_out(groups_melody, i_bar, keep='high')
            lst_melody.append(_local_post_process(notes_melody))
            if self.mode == 'full':
                _notes_bass = self.get_notes_out(groups_bass, i_bar, keep='low')
                notes_bass, removed = [], False
                for nb in _notes_bass:
                    if not any(MusicExtractor._ext_notes_eq(nb, nm) for nm in notes_melody):
                        notes_bass.append(nb)
                        removed = True
                if removed:
                    notes_bass = fill_with_rest(
                        notes_bass, duration=time_sig2bar_dur(time_sig), fill_start=True)[0]
                lst_bass.append(_local_post_process(notes_bass))
        d = dict(melody=self._post_process(lst_melody, time_sigs))
        if self.mode == 'full':
            d['bass'] = self._post_process(lst_bass, time_sigs)
        return d

    @staticmethod
    def _deep_copy_note(note: ExtNote) -> ExtNote:
        if isinstance(note, tuple):
            return tuple(MusicExtractor._deep_copy_note(n) for n in note)
        return _note2clean_note(note)

    def _post_process(self, lst_notes, time_sigs: List[TsTup]):
        for i_bar, (notes, time_sig) in enumerate(zip(lst_notes, time_sigs)):
            dur = time_sig2bar_dur(time_sig)
            if not self.pc.notes_within_prec(notes):
                lst_notes[i_bar] = self.notes2quantized_notes(notes, time_sig, number=i_bar)
                assert self.pc.notes_within_prec(lst_notes[i_bar])
                self.log_warn(warn_name=WarnLog.NoteNotQuant, bar_num=i_bar,
                              filled_ranges=_filled_ranges(notes))
            elif notes_have_gap(notes, duration=dur):
                lst_notes[i_bar], unfilled = fill_with_rest(notes, duration=dur,
                                                            fill_start=True)
                self.log_warn(warn_name=WarnLog.BarNoteGap, bar_num=i_bar, time_sig=time_sig,
                              precision=self.prec,
                              unfilled_ranges=[(float(a), float(b)) for a, b in unfilled])
        lst_notes = [self.clean_quantized_tuplets(notes, i) for i, notes in enumerate(lst_notes)]
        lst_notes = [self._resplit_uniform_tuplets(notes) for notes in lst_notes]
        for i_bar, (notes, time_sig) in enumerate(zip(lst_notes, time_sigs)):
            n_slots_f = time_sig2bar_dur(time_sig) / Fraction(4, 2 ** self.prec)
            check_dur = n_slots_f.denominator == 1  # fractional-slot bars can't match exactly
            if not is_valid_bar_notes(notes, time_sig, check_match_time_sig=check_dur):
                raise ValueError(
                    f'Invalid bar notes at bar {i_bar}: '
                    f'time_sig={time_sig}, total={get_notes_duration(notes)}, '
                    f'ranges={_filled_ranges(notes)}')
        return [self._split_complex_durations(notes) for notes in lst_notes]

    @staticmethod
    def _resplit_uniform_tuplets(notes: List[ExtNote]) -> List[ExtNote]:
        """Re-chunk tuplet groups by the cardinality their CLEANED member
        duration implies -- the reference's artifact grammar.

        The reference writes its extraction to MXL and music21 re-notates each
        member from its final duration (a 1/12-QL member becomes a 16th with
        3:2 time-modification regardless of the source's 7:8 bracket); the
        reference's own re-reader then chunks consecutive same-class tuplet
        members STRICTLY into n_tup-sized groups (reference
        music_converter.py:85-107 `_bar2grouped_bar`: `group_n(lst_tup,
        n_tup)` with an assert `len % n_tup == 0`).  So a 6-member jittered
        7:8 run whose evened members are 1/3 QL appears in the shipped
        artifacts -- the parity ground truth -- as TWO Triplet groups
        (Moonlight m.8, Beat It m.21), never one sextuplet.  Emitting that
        form directly keeps extractor output, rendered MXL, and mxl2str in
        agreement.  Adjacent groups of the same tuplet CLASS are one run on a
        re-read even at different unit sizes (a 1/6-member group and a
        1/3-member group are both "Triplet" in music21's fullName, so a
        [6 x 1/6][3 x 1/3] pair re-chunks into three Triplets -- Merry
        Christmas Mr. Lawrence), so runs merge by implied cardinality before
        chunking.  Runs whose length is not a multiple of the cardinality
        keep their shape (the reference's assert implies its artifacts never
        carry these)."""
        def _group_class(g: tuple) -> Optional[int]:
            """The tuplet cardinality o shared by ALL members, else None."""
            os_ = {_tuplet_n(Fraction(m.dur)) for m in g}
            if len(os_) != 1:
                return None
            o = os_.pop()
            return o if o > 1 else None

        out: List[ExtNote] = []
        run: List[tuple] = []
        run_o: Optional[int] = None

        def _flush():
            nonlocal run_o
            if not run:
                return
            o = run_o
            n_members = sum(len(g) for g in run)
            if n_members % o != 0 or all(len(g) == o for g in run):
                out.extend(run)
            else:
                members = [m for g in run for m in g]
                out.extend(tuple(members[i:i + o])
                           for i in range(0, len(members), o))
            run.clear()
            run_o = None

        for n in notes:
            o = _group_class(n) if isinstance(n, tuple) else None
            if o is not None:
                if run and o != run_o:
                    _flush()
                run.append(n)
                run_o = o
            else:
                _flush()
                out.append(n)
        _flush()
        return out

    @staticmethod
    def _split_complex_durations(notes: List[ExtNote]) -> List[ExtNote]:
        """Split plain notes/rests whose duration is not notatable as one
        type+dots into music21's export components (descending powers of 2,
        notes tied).  The reference's artifacts -- the parity ground truth --
        carry this split: music21's MusicXML export partitions complex
        durations (e.g. a quantization-merged 9/8-QL rest appears as
        rest(1)+rest(1/8)); reproducing it at the extractor tail makes token
        output, rendered MXL, and mxl2str agree with the reference."""
        out: List[ExtNote] = []
        for n in notes:
            if isinstance(n, tuple):
                # a tuplet whose even-split member duration is DYADIC renders
                # as plain notes (music21 writes no time-modification for
                # expressible durations, so the group structure is lost in the
                # MXL): a (rest, note) pair of total 1/8 QL appears as two
                # plain 1/16 notes in the reference's artifacts
                dur_ea = Fraction(note2dur(n)) / len(n)
                den = dur_ea.denominator
                if den & (den - 1) == 0:
                    out.extend(_note2clean_note(n))
                    continue
                out.append(n)
                continue
            comps = _notation_components(Fraction(n.dur))
            if len(comps) == 1:
                out.append(n)
                continue
            off = n.offset
            for k, c in enumerate(comps):
                piece = _note2clean_note(n, q_len=c)
                piece.offset = off
                if isinstance(piece, Note):
                    piece.tie = ('start' if k == 0 else
                                 'stop' if k == len(comps) - 1 else 'continue')
                out.append(piece)
                off += c
        return out

    # ------------------------------------------------------------------ entry
    def __call__(self, song: Union[str, Score], exp: str = 'str_join',
                 return_meta: bool = False, return_key: bool = False):
        """Extract a song (reference __call__ :986-1146).

        exp: 'score' (render a Score of the extraction), 'str', 'id', 'str_join',
        'visualize'.
        """
        assert exp in ('score', 'mxl', 'str', 'id', 'str_join', 'visualize')
        if self.warn_logger is not None and self.warn_logger.idx_track is not None:
            self.warn_logger.end_tracking()

        song_path = None
        if isinstance(song, str):
            song_path = song
            song = parse_file(song)
        song_for_key = song if return_key else None
        # MusicXML carries explicit tuplet notation (the reference's music21
        # `fullName` source); only duration-infer tuplets for MIDI/programmatic
        infer_tuplets = getattr(song, 'source', '') != 'musicxml'

        title = (song.title or 'untitled').removesuffix('.mxl').removesuffix('.musicxml')
        lst_bar_info = list(self.it_bars(song))
        assert lst_bar_info, 'no bars found in song'
        assert all(bi.bars for bi in lst_bar_info), \
            'no pitched notes found - song contains drum tracks only'
        n_bars_ori = len(lst_bar_info)

        empty_warns = []
        idx = 0
        while idx < n_bars_ori and _is_empty_bars(lst_bar_info[idx].bars):
            idx += 1
        assert idx < n_bars_ori, 'song has no notes'
        if idx > 0:
            empty_warns.append(dict(warn_name=WarnLog.EmptyStrt, bar_range=(0, idx - 1)))
        idx_end = n_bars_ori - 1
        while _is_empty_bars(lst_bar_info[idx_end].bars):
            idx_end -= 1
        if idx_end + 1 != n_bars_ori:
            empty_warns.append(dict(warn_name=WarnLog.EmptyEnd,
                                    bar_range=(idx_end + 1, n_bars_ori - 1)))
        lst_bar_info = lst_bar_info[idx:idx_end + 1]

        time_sigs = [bi.time_sig for bi in lst_bar_info]
        tempos = [bi.tempo for bi in lst_bar_info]
        secs = round(sum(
            float(time_sig2bar_dur(ts)) * 60 / tp for ts, tp in zip(time_sigs, tempos)))
        mean_tempo = round(float(np.mean(tempos)))
        counter_ts = Counter(time_sigs)
        time_sig_mode = max(counter_ts, key=counter_ts.get)
        ts_mode_str = f'{time_sig_mode[0]}/{time_sig_mode[1]}'

        if self.warn_logger is not None:
            self.warn_logger.start_tracking()
        lst_ts = sorted(set(time_sigs), key=lambda x: (x[1], x[0]))
        lst_tp = sorted(set(round(t) for t in tempos))
        if len(lst_ts) > 1:
            self.log_warn(warn_name=WarnLog.MultTimeSig, time_sigs=lst_ts)
        if len(lst_tp) > 1:
            self.log_warn(warn_name=WarnLog.MultTempo, tempos=lst_tp)
        if not is_common_time_sig(time_sig_mode):
            self.log_warn(warn_name=WarnLog.RareTimeSig, time_sig_expect=COMMON_TIME_SIGS,
                          time_sig_got=time_sig_mode)
        if not is_common_tempo(mean_tempo):
            self.log_warn(warn_name=WarnLog.RareTempo, tempo_expect='[40, 240]',
                          tempo_got=mean_tempo)
        for w in empty_warns:
            self.log_warn(w)
        th = 0.95
        if counter_ts[time_sig_mode] / len(time_sigs) < th:
            self.log_warn(warn_name=WarnLog.IncTimeSig, time_sig=time_sig_mode,
                          threshold=th, n_bar_total=len(time_sigs),
                          n_bar_mode=counter_ts[time_sig_mode])

        d_notes = self.extract_notes(lst_bar_info, time_sigs,
                                     infer_tuplets=infer_tuplets)

        if exp in ('score', 'mxl'):
            d_flat = {k: [list(flatten_notes(notes)) for notes in ln]
                      for k, ln in d_notes.items()}
            scr_out = make_score(title=f'{title}, extracted', mode=self.mode,
                                 time_sig=ts_mode_str, tempo=mean_tempo, d_notes=d_flat,
                                 check_duration_match=False)
        else:
            def e2s(elm) -> List[str]:
                return self._elm2toks(elm)

            groups: List[List[str]] = [[
                self.vocab.meta2tok(VocabType.time_sig, time_sig_mode),
                self.vocab.meta2tok(VocabType.tempo, mean_tempo),
            ]]
            if self.mode == 'melody':
                for notes in d_notes['melody']:
                    groups.append([self.vocab.start_of_bar]
                                  + [t for n in notes for t in e2s(n)])
            else:
                for nm, nb in zip(d_notes['melody'], d_notes['bass']):
                    groups.append(
                        [self.vocab.start_of_bar, self.vocab.start_of_melody]
                        + [t for n in nm for t in e2s(n)]
                        + [self.vocab.start_of_bass]
                        + [t for n in nb for t in e2s(n)])
            groups.append([self.vocab.end_of_song])
            if exp == 'visualize':
                n_pad = len(str(len(groups)))
                scr_out = '\n'.join(f'{"" if i == 0 else i - 1:>{n_pad}}: {" ".join(toks)}'
                                    for i, toks in enumerate(groups))
            else:
                toks = [t for g in groups for t in g]
                if exp == 'str':
                    scr_out = toks
                elif exp == 'id':
                    scr_out = [self.vocab.t2i(t) for t in toks]
                else:
                    scr_out = ' '.join(toks)

        ret: Any = scr_out
        if return_meta:
            warnings = self.warn_logger.to_json() if self.warn_logger is not None else None
            ret = dict(score=scr_out, title=title, duration=secs, warnings=warnings)
            if song_path:
                ret['song_path'] = song_path
        if return_key:
            keys = KeyFinder(song_for_key)(return_type='dict')
            if isinstance(ret, dict):
                ret['keys'] = keys
            else:
                ret = dict(score=scr_out, keys=keys)
        return MusicExtractorOutput(**ret) if isinstance(ret, dict) else ret

    def _elm2toks(self, e: ExtNote) -> List[str]:
        if isinstance(e, tuple):
            return [self.vocab.start_of_tuplet,
                    *[self._pitch_tok(n) for n in e],
                    self.vocab.meta2tok(VocabType.duration, Fraction(note2dur(e))),
                    self.vocab.end_of_tuplet]
        return [self._pitch_tok(e), self.vocab.meta2tok(VocabType.duration, Fraction(e.dur))]

    def _pitch_tok(self, n: SNote) -> str:
        if isinstance(n, Rest):
            return self.vocab.rest
        if self.with_pitch_step:
            return self.vocab.note2pitch_str(n.pitch.midi, step=n.pitch.step)
        return self.vocab.note2pitch_str(n.pitch.midi)
