"""Copy of `musicnlp_tpu/preprocess/melody_grid.py` (numpy): the port keeps its own copy and
imports nothing from the JAX package; only the import paths differ, and
`MelodyGridDataset` is a `torch.utils.data.Dataset` with the same items
(held against the original by tests/test_torch_melody_grid.py).

Time-slot grid melody encoding -- the reference's legacy melody stack.

Rebuild of the reference's obsolete first-generation pipeline (reference
musicnlp/preprocess/melody_extractor.py:81-949 `MidiMelodyExtractor` /
`MxlMelodyExtractor` + `VerticalBar` + slot `Tokenizer` + `MelodyTokenizer`,
and musicnlp/trainer/melody_loader.py:20-39 `MelodyLoader`), kept there behind
`KEEP_OBSOLETE` as the predecessor of the duration-token language.

Encoding model (reference melody_extractor.py:179-194, 557-646):
 - each bar is divided into equidistant slots of 1/2**precision whole-note
   duration; the slot count depends on the time signature
   (``numerator * 2**precision / denominator``);
 - each slot holds ONE id: a MIDI pitch (the highest sounding, enforcing
   monophony), a rest, or a special marker;
 - the id space is the reference's `get_tokenizer` layout (:157-176):
   128 special ids ([SEP]=0 bar separator, [TRIP]=1 triplet marker, [PAD]=2,
   [REST]=64) then pitch p -> 128+p for p in [0, 128);
 - a triplet group's span is split into 4 equal slot-runs: the 3 member
   pitches then a [TRIP] marker ("last quarter encoding", :625-630);
 - bars are joined with a single [SEP] between them (:646);
 - per bar, the PART with the highest duration-weighted mean pitch frequency
   is selected wholesale (`VerticalBar.pnm_with_max_pitch(method='fqs')`,
   the `bar_with_max_pitch` strategy :794-851).

The rebuild is columnar: encodings are int32 numpy arrays end to end (the
reference built one Python `Slot` object per time step), rasterization is a
vectorized per-bar fill, and the padded-matrix dataset is a single array
(one host-to-device copy) -- no per-item object churn.
"""
from __future__ import annotations

from fractions import Fraction
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from musicnlp_tpu_torch.io.musicxml import parse_file
from musicnlp_tpu_torch.io.score import (
    Chord, Measure, Note, Part, Rest, Score, TsTup, note2pitch,
)

__all__ = [
    'GridVocab', 'MelodyGridExtractor', 'grid_decode', 'MelodyGridDataset',
]


class GridVocab:
    """The legacy stack's id space (reference melody_extractor.py:157-176) and
    its readable string forms (`MelodyTokenizer.MAP_DF` :904-915)."""

    N_SPECIAL = 128
    SEP, TRIP, PAD = 0, 1, 2
    REST = N_SPECIAL // 2  # 64
    SIZE = N_SPECIAL + 128

    _SPECIAL2STR = {SEP: '<s>', TRIP: '<t>', PAD: '<p>', REST: '<r>'}
    _STR2SPECIAL = {v: k for k, v in _SPECIAL2STR.items()}

    @classmethod
    def pitch2id(cls, midi: int) -> int:
        assert 0 <= midi < 128
        return cls.N_SPECIAL + midi

    @classmethod
    def id2pitch(cls, id_: int) -> Optional[int]:
        return id_ - cls.N_SPECIAL if id_ >= cls.N_SPECIAL else None

    @classmethod
    def id2str(cls, id_: int) -> str:
        p = cls.id2pitch(id_)
        return f'p{p}' if p is not None else cls._SPECIAL2STR.get(id_, f'[{id_}]')

    @classmethod
    def str2id(cls, s: str) -> int:
        if s.startswith('p') and s[1:].isdigit():
            return cls.pitch2id(int(s[1:]))
        return cls._STR2SPECIAL[s]

    @classmethod
    def ids2strs(cls, ids: Iterable[int]) -> List[str]:
        return [cls.id2str(int(i)) for i in ids]


def _slot_ql(precision: int) -> Fraction:
    """One slot's duration in quarter-length (1/2**prec whole note)."""
    return Fraction(4, 2 ** precision)


def _n_slots(ts: TsTup, precision: int) -> int:
    numer, denom = ts
    n = Fraction(numer * 2 ** precision, denom)
    assert n.denominator == 1, f'time signature {ts} not representable at precision {precision}'
    return int(n)


def _elm_pitch(e: Union[Note, Chord]) -> int:
    if isinstance(e, Chord):
        return max(p.midi for p in e.pitches)
    return e.pitch.midi


def _bar_mean_freq(bar: Measure) -> Optional[float]:
    """Duration-weighted mean pitch frequency (the reference's 'fqs' part-
    selection metric) or None for a bar with no sounding notes.  Rests count
    at frequency 0 with their duration (reference avg_pitch appends rests
    with value 0, melody_extractor.py:406-428): a sparse high line scores
    BELOW a continuous lower melody."""
    fs, ws = [], []
    any_note = False
    streams = bar.voices if bar.voices else [bar.elements]
    for stream in streams:
        for e in stream:
            if isinstance(e, (Note, Chord)):
                fs.append(note2pitch(e))  # Chord -> its max-midi pitch's freq
                ws.append(float(e.dur))
                any_note = True
            elif isinstance(e, Rest):
                fs.append(0.0)
                ws.append(float(e.dur))
    if not any_note or sum(ws) == 0:
        return None
    return float(np.average(fs, weights=ws))


def _is_triplet_like(e) -> bool:
    tm = getattr(e, 'tm', None)
    if tm is not None:
        return tm[0] % 3 == 0
    d = Fraction(e.dur)
    return d.denominator % 3 == 0


class MelodyGridExtractor:
    """Score -> slot-grid pitch ids, the `bar_with_max_pitch` strategy."""

    def __init__(self, precision: int = 5):
        self.prec = precision
        self.slot = _slot_ql(precision)

    def __call__(self, song: Union[str, Score]) -> np.ndarray:
        scr = parse_file(song) if isinstance(song, str) else song
        parts = [p for p in scr.parts if not p.is_drum and p.measures]
        assert parts, 'no pitched parts'
        n_bars = min(len(p.measures) for p in parts)

        ts: TsTup = (4, 4)
        out: List[np.ndarray] = []
        for i in range(n_bars):
            bars = [p.measures[i] for p in parts]
            for b in bars:  # unroll time signature across bars, as it_bars does
                if b.time_sig is not None:
                    ts = b.time_sig
                    break
            chosen = max(bars, key=lambda b: _bar_mean_freq(b) or -1.0)
            out.append(self._encode_bar(chosen, ts))
        sep = np.array([GridVocab.SEP], dtype=np.int32)
        return np.concatenate(
            [a for i, bar in enumerate(out) for a in ((bar,) if i == 0 else (sep, bar))])

    # ------------------------------------------------------------------ raster
    def _encode_bar(self, bar: Measure, ts: TsTup) -> np.ndarray:
        n = _n_slots(ts, self.prec)
        grid = np.full(n, -1, dtype=np.int32)  # -1 = unset; filled w/ REST at end
        pitch = np.full(n, -1, dtype=np.int32)  # highest midi written per slot

        streams = bar.voices if bar.voices else [bar.elements]
        for stream in streams:
            elms = [e for e in stream if isinstance(e, (Note, Rest, Chord))]
            i = 0
            while i < len(elms):
                # triplet group: 3 consecutive triplet-like sounding elements
                # whose span covers a multiple of 4 slots
                if (len(elms) - i >= 3
                        and all(_is_triplet_like(e) and not isinstance(e, Rest)
                                for e in elms[i:i + 3])):
                    trip = elms[i:i + 3]
                    span = sum((Fraction(e.dur) for e in trip), Fraction(0))
                    num = span / self.slot
                    strt = Fraction(trip[0].offset) / self.slot
                    if (num.denominator == 1 and num % 4 == 0
                            and strt.denominator == 1):
                        k = int(num) // 4
                        s0 = int(strt)
                        ids = [GridVocab.pitch2id(_elm_pitch(e)) for e in trip]
                        ids.append(GridVocab.TRIP)
                        ps = [_elm_pitch(e) for e in trip] + [128]  # TRIP wins its run
                        for j, (id_, p) in enumerate(zip(ids, ps)):
                            lo, hi = s0 + j * k, s0 + (j + 1) * k
                            if lo >= n:
                                break
                            hi = min(hi, n)
                            win = slice(lo, hi)
                            mask = p > pitch[win]
                            grid[win][mask] = id_
                            pitch[win][mask] = p
                        i += 3
                        continue
                self._raster_one(elms[i], grid, pitch, n)
                i += 1
        grid[grid < 0] = GridVocab.REST
        return grid

    def _raster_one(self, e, grid: np.ndarray, pitch: np.ndarray, n: int):
        lo = int(round(float(Fraction(e.offset) / self.slot)))
        hi = int(round(float((Fraction(e.offset) + Fraction(e.dur)) / self.slot)))
        lo, hi = max(lo, 0), min(max(hi, lo), n)
        if hi == lo:
            return
        if isinstance(e, Rest):
            return  # unset slots become REST at the end
        p = _elm_pitch(e)
        win = slice(lo, hi)
        mask = p > pitch[win]
        grid[win][mask] = GridVocab.pitch2id(p)
        pitch[win][mask] = p


# ---------------------------------------------------------------------- decode
def _rle(ids: np.ndarray) -> List[Tuple[int, int]]:
    """(id, run_length) pairs (the reference's `compress`, melody_extractor.py:671)."""
    if len(ids) == 0:
        return []
    change = np.flatnonzero(np.diff(ids)) + 1
    bounds = np.concatenate([[0], change, [len(ids)]])
    return [(int(ids[a]), int(b - a)) for a, b in zip(bounds[:-1], bounds[1:])]


def grid_decode(ids: Sequence[int], precision: int = 5,
                tempo: float = 120.0, title: str = 'decoded') -> Score:
    """Grid ids -> single-piano-part Score (reference `Tokenizer.decode`
    :648-686 + `encoding2score` :860-886; time signatures inferred per bar
    with denominator 4, the reference's stated w.l.o.g. assumption :668-672).

    A [TRIP]-terminated quadruple of equal runs decodes back to a triplet:
    3 notes evenly covering all four runs' span (:696-760)."""
    ids = np.asarray(ids, dtype=np.int32)
    ids = ids[ids != GridVocab.PAD]
    slot = _slot_ql(precision)
    bars_ids = [a for a in np.split(ids, np.flatnonzero(ids == GridVocab.SEP))]
    bars_ids = [(a if i == 0 else a[1:]) for i, a in enumerate(bars_ids)]

    slots_per_quarter = Fraction(2 ** precision, 4)
    measures: List[Measure] = []
    prev_ts: Optional[TsTup] = None
    bar_off = Fraction(0)  # absolute bar start in QL (write_midi keys on it)
    num_bar = 0
    for bids in bars_ids:
        if len(bids) == 0:
            continue    # consecutive/trailing SEP in a model-generated stream
        numer = Fraction(len(bids)) / slots_per_quarter
        assert numer.denominator == 1, 'bar length not a whole number of beats'
        ts: TsTup = (int(numer), 4)

        # Triplet regions FIRST, at slot level: a [TRIP] run of length k at
        # slot s closes a triplet spanning [s-3k, s+k).  Working on slots
        # (not the RLE walk) keeps reconstruction correct when member runs
        # MERGE -- repeated member pitches, or a first member continuing the
        # preceding note's pitch (the reference's ln==1/ln==2 and
        # dur_non_trip split branches, melody_extractor.py:696-760).
        regions: List[Tuple[int, int]] = []   # (start_slot, k)
        s = 0
        for id_, k in _rle(bids):
            if id_ == GridVocab.TRIP and s - 3 * k >= 0 \
                    and (not regions or regions[-1][0] + 4 * regions[-1][1]
                         <= s - 3 * k):
                members = [bids[s - (3 - j) * k: s - (2 - j) * k]
                           for j in range(3)]
                if all(len(set(g.tolist())) == 1
                       and GridVocab.id2pitch(int(g[0])) is not None
                       for g in members):
                    regions.append((s - 3 * k, k))
            s += k

        notes: List[Union[Note, Rest]] = []

        def decode_plain(lo: int, hi: int):
            for id_, k in _rle(bids[lo:hi]):
                off = lo * slot
                dur = k * slot
                p = GridVocab.id2pitch(id_)
                notes.append(Rest(duration=dur, offset=off) if p is None
                             else Note(pitch=p, duration=dur, offset=off))
                lo += k

        cur = 0
        for rs, k in regions:
            decode_plain(cur, rs)
            dur_ea = 4 * k * slot / 3
            for j in range(3):
                notes.append(Note(pitch=GridVocab.id2pitch(int(bids[rs + j * k])),
                                  duration=dur_ea,
                                  offset=rs * slot + j * dur_ea))
            cur = rs + 4 * k
        decode_plain(cur, len(bids))
        measures.append(Measure(
            number=num_bar, elements=notes,
            time_sig=(ts if ts != prev_ts else None),
            tempo=(tempo if num_bar == 0 else None), offset=bar_off))
        prev_ts = ts
        bar_off += len(bids) * slot
        num_bar += 1
    part = Part(name='musicnlp_tpu, Piano, CH #1', measures=measures)
    return Score(title=title, parts=[part])


# ---------------------------------------------------------------------- loader
class MelodyGridDataset(torch.utils.data.Dataset):
    """Padded id-matrix dataset (reference trainer/melody_loader.py:20-39
    `MelodyLoader`): all songs padded to the longest with [PAD] into ONE
    int32 matrix; items are its numpy rows, so a `DataLoader` batches them."""

    def __init__(self, songs: Sequence[Sequence[int]],
                 names: Optional[Sequence[str]] = None, pad: bool = True):
        self.pad = pad
        self.names = list(names) if names is not None else [str(i) for i in range(len(songs))]
        n = max((len(s) for s in songs), default=0)
        self.ids = np.full((len(songs), n), GridVocab.PAD, dtype=np.int32)
        for i, s in enumerate(songs):
            self.ids[i, :len(s)] = np.asarray(s, dtype=np.int32)

    def __len__(self) -> int:
        return self.ids.shape[0]

    def __getitem__(self, idx: int) -> np.ndarray:
        row = self.ids[idx]
        return row if self.pad else row[row != GridVocab.PAD]
