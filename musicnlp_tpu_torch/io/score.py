"""Copy of `musicnlp_tpu/io/score.py` (pure Python / numpy): the port keeps its own copy
and imports nothing from the JAX package; only the import paths differ
(held against the original by tests/test_torch_pipeline.py).

First-party in-memory score IR: the music21-free replacement used everywhere.

The reference builds on music21 Stream objects (reference musicnlp/util/music_lib.py:40-57);
this framework keeps a small, slot-based, Fraction-exact IR instead.  All times are in
quarterLength (QL) as `fractions.Fraction` so slot quantization at precision 5
(1/8 QL slots) is exact, matching the reference's Fraction arithmetic requirement
(SURVEY.md §7 hard parts).

Structure: Score -> Part -> Measure -> [Note | Rest | Chord].  A tuplet is represented
as a plain tuple of Notes (the reference's `ExtNote` convention, music_lib.py:70-74).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple, Union

__all__ = [
    'Dur', 'Pitch', 'Note', 'Rest', 'Chord', 'SNote', 'ExtNote',
    'Measure', 'Part', 'Score', 'TsTup',
    'MIDI_SPELLING', 'midi2step_octave',
    'note2dur', 'note2pitch', 'get_offset', 'get_end_qlen', 'flatten_notes', 'unpack_notes',
    'time_sig2bar_dur', 'tuplet_name', 'eps',
]

Dur = Union[int, float, Fraction]
TsTup = Tuple[int, int]
eps = 1e-8

# music21's default midi->name spelling (sharp-biased with E-flat/B-flat):
# Pitch(midi=63).name == 'E-', Pitch(midi=61).name == 'C#', etc.
MIDI_SPELLING: List[Tuple[str, int]] = [
    ('C', 0), ('C', 1), ('D', 0), ('E', -1), ('E', 0), ('F', 0),
    ('F', 1), ('G', 0), ('G', 1), ('A', 0), ('B', -1), ('B', 0),
]
_STEP2PC = dict(C=0, D=2, E=4, F=5, G=7, A=9, B=11)


def midi2step_octave(midi: int) -> Tuple[str, int, int]:
    """midi -> (step letter, alter, spelled octave), music21-default spelling."""
    step, alter = MIDI_SPELLING[midi % 12]
    octave = (midi - alter) // 12 - 1
    return step, alter, octave


def _frac(x: Dur) -> Fraction:
    return x if isinstance(x, Fraction) else Fraction(x).limit_denominator(1 << 16)


@dataclass(frozen=True)
class Pitch:
    """A concrete pitch; `step`/`alter` carry the spelled name when known."""
    midi: int
    step: str = None
    alter: int = 0

    def __post_init__(self):
        if self.step is None:
            step, alter, _ = midi2step_octave(self.midi)
            object.__setattr__(self, 'step', step)
            object.__setattr__(self, 'alter', alter)

    @property
    def pitch_class(self) -> int:
        return self.midi % 12

    @property
    def octave(self) -> int:
        """Spelled octave (accounts for B#/C- crossing the octave boundary)."""
        return (self.midi - self.alter) // 12 - 1

    @property
    def name(self) -> str:
        acc = '#' * self.alter if self.alter > 0 else '-' * (-self.alter)
        return f'{self.step}{acc}'

    @property
    def name_with_octave(self) -> str:
        return f'{self.name}{self.octave}'

    @classmethod
    def from_name(cls, name: str, octave: int) -> 'Pitch':
        step = name[0]
        alter = name.count('#') - name.count('-')
        midi = (octave + 1) * 12 + _STEP2PC[step] + alter
        return cls(midi=midi, step=step, alter=alter)


class _Timed:
    """Base for notes/rests: mutable offset + Fraction duration in QL."""
    __slots__ = ('offset', 'dur')

    def __init__(self, duration: Dur = 0, offset: Dur = 0):
        self.dur: Fraction = _frac(duration)
        self.offset: Fraction = _frac(offset)

    @property
    def duration(self) -> '_DurView':
        return _DurView(self)

    @duration.setter
    def duration(self, d):
        self.dur = _frac(d.quarterLength if hasattr(d, 'quarterLength') else d)

    @property
    def end(self) -> Fraction:
        return self.offset + self.dur


class _DurView:
    """music21-compatible `.duration.quarterLength` accessor."""
    __slots__ = ('_owner',)

    def __init__(self, owner: _Timed):
        self._owner = owner

    @property
    def quarterLength(self) -> Fraction:
        return self._owner.dur

    @quarterLength.setter
    def quarterLength(self, v: Dur):
        self._owner.dur = _frac(v)

    def __repr__(self):
        return f'Dur({self._owner.dur})'


class Note(_Timed):
    __slots__ = ('pitch', 'velocity', 'tie', 'tm')

    def __init__(self, pitch: Union[Pitch, int] = 60, duration: Dur = 1, offset: Dur = 0,
                 velocity: int = 90, tie: str = None, tm: Optional[Tuple[int, int]] = None):
        super().__init__(duration, offset)
        self.pitch = pitch if isinstance(pitch, Pitch) else Pitch(midi=int(pitch))
        self.velocity = velocity
        self.tie = tie  # None | 'start' | 'stop' | 'continue'
        self.tm = tm    # MusicXML <time-modification> (actual, normal) or None

    def __repr__(self):
        return f'Note({self.pitch.name_with_octave}, off={self.offset}, ql={self.dur})'


class Rest(_Timed):
    __slots__ = ('tm',)

    def __init__(self, duration: Dur = 1, offset: Dur = 0, quarterLength: Dur = None,
                 tm: Optional[Tuple[int, int]] = None):
        super().__init__(quarterLength if quarterLength is not None else duration, offset)
        self.tm = tm

    def __repr__(self):
        return f'Rest(off={self.offset}, ql={self.dur})'


class Chord(_Timed):
    __slots__ = ('pitches', 'velocity', 'tm')

    def __init__(self, pitches: Sequence[Union[Pitch, int]] = (), duration: Dur = 1,
                 offset: Dur = 0, velocity: int = 90, tm: Optional[Tuple[int, int]] = None):
        super().__init__(duration, offset)
        self.pitches = [p if isinstance(p, Pitch) else Pitch(midi=int(p)) for p in pitches]
        self.velocity = velocity
        self.tm = tm

    @property
    def pitch_classes(self) -> List[int]:
        return [p.pitch_class for p in self.pitches]

    def __repr__(self):
        return f'Chord({[p.name_with_octave for p in self.pitches]}, off={self.offset}, ql={self.dur})'


SNote = Union[Note, Rest]
ExtNote = Union[Note, Rest, Tuple[Note, ...]]


@dataclass
class Measure:
    """One bar of one part.  `time_sig`/`tempo` present when they (re)start here."""
    number: int = 0
    elements: List[Union[Note, Rest, Chord]] = field(default_factory=list)
    time_sig: Optional[TsTup] = None
    tempo: Optional[float] = None
    offset: Fraction = Fraction(0)  # bar start in QL from song beginning
    is_bass_clef: bool = False
    voices: Optional[List[List[Union[Note, Rest, Chord]]]] = None  # polyphonic sub-voices

    def append(self, notes: Union[Iterable, Note, Rest, Chord]):
        if isinstance(notes, (Note, Rest, Chord)):
            self.elements.append(notes)
        else:
            self.elements.extend(notes)

    @property
    def notes(self) -> List[Union[Note, Rest, Chord]]:
        return self.elements


@dataclass
class Part:
    name: str = ''
    measures: List[Measure] = field(default_factory=list)
    is_drum: bool = False
    midi_program: int = 0
    midi_channel: int = 0

    def __iter__(self) -> Iterator[Measure]:
        return iter(self.measures)


@dataclass
class Score:
    title: str = ''
    composer: str = 'musicnlp_tpu'
    parts: List[Part] = field(default_factory=list)
    source: str = ''  # 'musicxml' | 'midi' | '' (programmatic)

    def __iter__(self) -> Iterator[Part]:
        return iter(self.parts)

    # I/O: implemented in musicnlp_tpu_torch.io.midi / musicnlp_tpu_torch.io.musicxml; bound here
    # for a music21-like `score.write(...)` convenience surface.
    def write_midi(self, path: str):
        from musicnlp_tpu_torch.io.midi import write_midi
        write_midi(self, path)

    def write_musicxml(self, path: str):
        from musicnlp_tpu_torch.io.musicxml import write_musicxml
        write_musicxml(self, path)

    def write_mxl(self, path: str):
        from musicnlp_tpu_torch.io.musicxml import write_mxl
        write_mxl(self, path)

    def write(self, fmt: str = 'mxl', fp: str = None, **_):
        if fmt == 'mxl':
            self.write_mxl(fp)
        elif fmt in ('midi', 'mid'):
            self.write_midi(fp)
        elif fmt in ('musicxml', 'xml'):
            self.write_musicxml(fp)
        else:
            raise ValueError(f'Unknown format {fmt!r}')


# ---------------------------------------------------------------------- note algebra
def tuplet_name(tm: Tuple[int, int]) -> str:
    """Tuplet run-class from a (actual, normal) time-modification, mirroring the
    name classes of music21's `Tuplet.fullName` that the reference groups runs
    by (reference music_extractor.py:183-194, music_lib.py:286-298): a run of
    tuplet elements continues while the name class matches, and all generic
    ratios share one 'Tuplet' class."""
    a, n = tm
    if a == 3 and n == 2:
        return 'Triplet'
    if a == 5 and n in (4, 2):
        return 'Quintuplet'
    if a == 7 and n == 4:
        return 'Septuplet'
    return 'Tuplet'


def note2dur(note: ExtNote) -> Fraction:
    """Duration of a note or whole tuplet group (reference music_lib.py note2dur)."""
    if isinstance(note, tuple):
        return sum((n.dur for n in note), Fraction(0))
    return note.dur


def note2pitch(note: ExtNote) -> float:
    """Pitch for skyline ordering, in Hz (reference music_lib.py:148-157): note =
    equal-tempered frequency, rest = 0, tuplet = duration-weighted mean over
    members (so a rest member pulls the average down without dominating it).
    Frequency (not midi) matters: the exponential scale reorders tuplet
    averages relative to plain notes, and the reference's skyline decisions
    depend on it."""
    if isinstance(note, tuple):
        tot = sum((n.dur for n in note), Fraction(0))
        if tot == 0:
            return 0.0
        return float(sum(note2pitch(n) * n.dur for n in note) / tot)
    if isinstance(note, Rest):
        return 0.0
    if isinstance(note, Chord):
        return _midi2freq(max(p.midi for p in note.pitches))
    return _midi2freq(note.pitch.midi)


def _midi2freq(midi: int) -> float:
    return 440.0 * 2.0 ** ((midi - 69) / 12.0)


def get_offset(note: ExtNote) -> Fraction:
    return note[0].offset if isinstance(note, tuple) else note.offset


def get_end_qlen(note: ExtNote) -> Fraction:
    return note[-1].end if isinstance(note, tuple) else note.end


def flatten_notes(notes: Iterable[ExtNote]) -> Iterator[SNote]:
    for n in notes:
        if isinstance(n, tuple):
            yield from n
        else:
            yield n


def unpack_notes(notes: Iterable[ExtNote]) -> List[SNote]:
    return list(flatten_notes(notes))


def time_sig2bar_dur(ts: Union[TsTup, str]) -> Fraction:
    if isinstance(ts, str):
        n, d = ts.split('/')
        ts = (int(n), int(d))
    return Fraction(ts[0] * 4, ts[1])
