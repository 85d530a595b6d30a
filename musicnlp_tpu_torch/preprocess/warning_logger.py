"""Copy of `musicnlp_tpu/preprocess/warning_logger.py` (pure Python): the port keeps its own copy
and imports nothing from the JAX package; only the import paths differ
(held against the original by tests/test_torch_extract.py).

Typed extraction-warning log (27 types, severity 1-14).

Rebuild of the reference warning taxonomy (reference
musicnlp/preprocess/warning_logger.py:19-90) with per-song tracking and
JSON/DataFrame export for dataset-level observability reports.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional

__all__ = ['WarnLog']

logger = logging.getLogger(__name__)


class WarnLog:
    MultTempo, MultTimeSig = 'Multiple Tempos', 'Multiple Time Signatures'
    MissTempo = 'Missing Tempo'
    RestsBeyondTimeSig = 'Rests Beyond Time Signature'
    InvTupSz = 'Invalid Tuplet Size'
    TupNoteOvlOut, TupNoteOvlIn = 'Output Tuplet Notes Overlap', 'Input Tuplet Notes Overlap'
    InvTupDur, InvTupDurSv = 'Invalid Tuplet Durations', 'Invalid Tuplet Durations, Severe'
    LowTupDur = 'Tuplet Group Duration Too Low'
    RestInTup = 'Rest in Tuplet'
    HighPchOvl, HighPchOvlTup = 'Higher Pitch Overlap', 'Higher Pitch Overlap with Triplet'
    LowPchMakeup, LowPchMakeupRmv = 'Lower Pitch Makeup', 'Lower Pitch Makeup Removed'
    IncTimeSig, RareTimeSig = 'Inconsistent Time Signatures', 'Rare Time Signature'
    RareTempo = 'Rare Mean Tempo'
    NoteNotQuant, TupNoteQuant = 'Notes Beyond Quantization', 'Tuplet Notes Quantizable'
    TupTotalNotQuant = 'Tuplet Total Duration Beyond Quantization'
    InvBarDur = 'Invalid Bar Notes Duration'
    TupNoteGap = 'Gap Observed in Consecutive Tuplets'
    BarNoteGap = 'Gap in extracted Bar Notes'
    ExcecTupNote = 'Excessive Tuplet Chord Notes'
    EmptyStrt, EmptyEnd = 'Beginning Empty Bars', 'Ending Empty Bars'

    types = [
        EmptyStrt, EmptyEnd, MultTempo, MultTimeSig, MissTempo, IncTimeSig, RareTimeSig,
        RareTempo, RestsBeyondTimeSig, HighPchOvl, HighPchOvlTup, LowPchMakeup,
        LowPchMakeupRmv, InvTupSz, LowTupDur, InvTupDur, InvTupDurSv, RestInTup,
        ExcecTupNote, TupNoteQuant, TupNoteGap, NoteNotQuant, TupTotalNotQuant,
        TupNoteOvlIn, TupNoteOvlOut, InvBarDur, BarNoteGap,
    ]
    type2severity: Dict[str, int] = {
        EmptyStrt: 1, EmptyEnd: 1, MultTempo: 2, MultTimeSig: 2, MissTempo: 3,
        IncTimeSig: 3, RareTimeSig: 3, RareTempo: 3, RestsBeyondTimeSig: 3,
        HighPchOvl: 6, HighPchOvlTup: 6, LowPchMakeup: 6, LowPchMakeupRmv: 6,
        InvTupSz: 6, InvTupDur: 6, LowTupDur: 6, InvTupDurSv: 8, RestInTup: 8,
        ExcecTupNote: 8, TupNoteQuant: 8, TupNoteGap: 8, TupNoteOvlIn: 8,
        NoteNotQuant: 10, TupTotalNotQuant: 12, TupNoteOvlOut: 12, InvBarDur: 12,
        BarNoteGap: 14,
    }

    def __init__(self, name: str = 'Music Extraction Warn Log', verbose: bool = False):
        self.warnings: List[Dict] = []
        self.idx_track: Optional[int] = None
        self.verbose = verbose

    def update(self, warn: Dict):
        """Add a warning entry: dict with at least `warn_name` (one of `types`)."""
        nm = warn.get('warn_name')
        assert nm in WarnLog.type2severity, f'unknown warning type {nm!r}'
        self.warnings.append(dict(warn))
        if self.verbose:
            logger.warning('%s: %s', nm, {k: v for k, v in warn.items() if k != 'warn_name'})

    def start_tracking(self):
        """Mark start of a new song; `show_track` summarizes entries since."""
        self.idx_track = len(self.warnings)

    def end_tracking(self) -> List[Dict]:
        assert self.idx_track is not None
        out = self.warnings[self.idx_track:]
        self.idx_track = None
        return out

    def tracked(self) -> List[Dict]:
        return self.warnings[self.idx_track or 0:]

    def show_track(self) -> str:
        from collections import Counter
        counts = Counter(w['warn_name'] for w in self.tracked())
        return ', '.join(f'{k}: {v}' for k, v in counts.items()) or '(no warnings)'

    def to_json(self) -> List[Dict]:
        def ser(v):
            from fractions import Fraction
            if isinstance(v, Fraction):
                return str(v)
            if isinstance(v, (list, tuple)):
                return [ser(x) for x in v]
            return v
        return [{k: ser(v) for k, v in w.items()} for w in self.warnings]

    def to_df(self):
        import pandas as pd
        rows = [dict(w, severity=WarnLog.type2severity[w['warn_name']]) for w in self.warnings]
        return pd.DataFrame(rows)

    def __len__(self):
        return len(self.warnings)
