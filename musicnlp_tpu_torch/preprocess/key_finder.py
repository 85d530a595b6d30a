"""Copy of `musicnlp_tpu/preprocess/key_finder.py` (pure Python / numpy): the port keeps its own copy
and imports nothing from the JAX package; only the import paths differ
(held against the original by tests/test_torch_pipeline.py).

Krumhansl-Schmuckler key finding + scale-degree mapping, numpy-vectorized.

Rebuild of the reference key finder (reference musicnlp/preprocess/key_finder.py:49-147):
pitch-class duration histogram correlated against the 24 rotated major/minor
profiles.  Where the reference loops `np.corrcoef` 24 times, this computes all 24
correlations as one vectorized op (the K-S correlation is a tiny matmul,
SURVEY.md §7 step 3).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from musicnlp_tpu_torch.io.score import Chord, Note, Score
from musicnlp_tpu_torch.io.musicxml import parse_file
from musicnlp_tpu_torch.vocab.elm_type import Key, key_str2enum, enum2key_str

__all__ = ['KeyFinder', 'ScaleDegreeFinder', 'get_durations']

# major/minor profiles, see http://rnhart.net/articles/key-finding/
# (reference key_finder.py:67-68)
_PROFILES = np.array([
    [0.748, 0.06, 0.488, 0.082, 0.67, 0.46, 0.096, 0.715, 0.104, 0.366, 0.057, 0.4],
    [0.712, 0.084, 0.474, 0.618, 0.049, 0.46, 0.105, 0.747, 0.404, 0.067, 0.133, 0.33],
])
_PITCHES = ['C', 'C#', 'D', 'D#', 'E', 'F', 'F#', 'G', 'G#', 'A', 'A#', 'B']
# circle-of-fifths conventional enharmonic naming (reference key_finder.py:71-98)
_CONV_MAJOR = {'C': 'C', 'F': 'F', 'A#': 'Bb', 'D#': 'Eb', 'G#': 'Ab', 'C#': 'Db',
               'F#': 'Gb', 'B': 'B', 'E': 'E', 'A': 'A', 'D': 'D', 'G': 'G'}
_CONV_MINOR = {'A': 'A', 'D': 'D', 'G': 'G', 'C': 'C', 'F': 'F', 'A#': 'Bb',
               'D#': 'Eb', 'G#': 'G#', 'C#': 'C#', 'F#': 'F#', 'B': 'B', 'E': 'E'}

# all 24 rotated profiles stacked: [2, 12(rotation), 12(pc)]
_ROT = np.stack([
    np.stack([np.roll(_PROFILES[k], i) for i in range(12)]) for k in range(2)
])

Keys = Tuple[List[str], List[str]]
KeysDict = Dict[Union[Key, str], float]


def get_durations(score: Score) -> np.ndarray:
    """Total duration per pitch class in quarterLength, drums excluded
    (reference key_finder.py:25-46)."""
    result = np.zeros(12)
    for part in score.parts:
        if part.is_drum:
            continue
        for m in part.measures:
            streams = [m.elements] if not m.voices else m.voices
            for elems in streams:
                for e in elems:
                    if isinstance(e, Note):
                        result[e.pitch.pitch_class] += float(e.dur)
                    elif isinstance(e, Chord):
                        for pc in e.pitch_classes:
                            result[pc] += float(e.dur)
    return result


class KeyFinder:
    """Find candidate keys of a piece with confidences."""

    def __init__(self, song: Union[str, Score] = None,
                 pc_durations: np.ndarray = None):
        """Takes a score/path OR a precomputed 12-dim pitch-class duration
        histogram (the fast native extraction path supplies the latter)."""
        self.piece: Optional[Score] = (
            parse_file(song) if isinstance(song, str) else song)
        self._pc_durations = pc_durations
        assert self.piece is not None or pc_durations is not None

    def __call__(self, return_type: str = 'list') -> Union[Keys, KeysDict]:
        assert return_type in ('list', 'enum', 'dict')
        durations = (np.asarray(self._pc_durations, float)
                     if self._pc_durations is not None
                     else get_durations(self.piece))

        # vectorized correlation of `durations` against all 24 rotated profiles
        d = durations - durations.mean()
        d_norm = np.sqrt((d * d).sum())
        prof = _ROT - _ROT.mean(axis=-1, keepdims=True)        # [2, 12, 12]
        prof_norm = np.sqrt((prof * prof).sum(axis=-1))        # [2, 12]
        with np.errstate(invalid='ignore', divide='ignore'):
            corr = (prof @ d) / (prof_norm * d_norm)           # [2, 12]
        corr = np.nan_to_num(corr, nan=0.0)

        best_maj, best_min = corr[0].max(), corr[1].max()
        # fuzzy search keeps candidates >= 0.8/0.7 of best (reference :129-132)
        close_ma = int((corr[0] >= best_maj * 0.8).sum())
        close_mi = int((corr[1] >= best_min * 0.7).sum())
        best_maj_keys = np.argsort(corr[0])[-close_ma:]
        best_min_keys = np.argsort(corr[1])[-close_mi:]
        maj = [(f'{_CONV_MAJOR[_PITCHES[t]]}Major', corr[0][t]) for t in best_maj_keys]
        mnr = [(f'{_CONV_MINOR[_PITCHES[t]]}Minor', corr[1][t]) for t in best_min_keys]
        if return_type == 'list':
            return [k for k, _ in maj], [k for k, _ in mnr]
        out: KeysDict = {}
        for k, v in dict(maj).items():
            out[Key.from_str(k) if return_type == 'enum' else k] = float(v)
        for k, v in dict(mnr).items():
            out[Key.from_str(k) if return_type == 'enum' else k] = float(v)
        return out


class ScaleDegreeFinder:
    """Letter-step -> scale degree in [1, 7] w.r.t. a key (reference key_finder.py:198-261)."""
    t0_degrees = dict(C=0, D=1, E=2, F=3, G=4, A=5, B=6)

    @staticmethod
    def map_single(note: str, key: Union[Key, str]) -> int:
        """`note` is a step letter (A-G); rests have no degree (0)."""
        if note is None:
            return 0
        step = note
        deg = ScaleDegreeFinder.t0_degrees[step]
        if isinstance(key, Key):
            key = enum2key_str[key]
        return (deg - ScaleDegreeFinder.t0_degrees[key[0]]) % 7 + 1
