"""Copy of `musicnlp_tpu/vocab/elm_type.py` (numpy only): the port keeps its own copy
and imports nothing from the JAX package.  Ids and tables must stay identical
(tests/test_torch_vocab.py).

Music element IR: element kinds, channels, and the 24-key system.

TPU-native rebuild of the reference IR (see reference musicnlp/vocab/elm_type.py:14-131).
The enums and tables here are the *contract* shared by the extractor, the detokenizer,
the augmentation pipeline, and the vectorized IKR metric.  Everything downstream
compiles integer lookup tables from these.
"""
from __future__ import annotations

from enum import Enum
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np

__all__ = [
    'ElmType', 'Channel', 'MusicElement',
    'Key', 'key_str2enum', 'enum2key_str',
    'key_enum2tuple', 'key_str2ordinal', 'key_ordinal2str', 'key_ordinal2key_enum',
    'key_offset_dict', 'OFFKEY_OFFSET', 'MAJOR_OFFKEY_OFFSET_IDX', 'MINOR_OFFKEY_OFFSET_IDX',
    'N_KEY', 'key_inkey_mask', 'key_tonic_pc', 'key_is_major',
]


class ElmType(Enum):
    """Kinds of elements a decoded song is made of (reference elm_type.py:14)."""
    seg_omit, bar_start, melody, bass, song_end, time_sig, tempo, key, note, tuplets = range(10)


class Channel(Enum):
    melody, bass = range(2)


@dataclass
class MusicElement:
    """Intermediate representation for conversion between token strings & scores."""
    type: ElmType
    meta: Optional[Union[int, Tuple]] = None


class Key(Enum):
    """24 keys; `f` = flat, `s` = sharp (reference elm_type.py:31)."""
    CMaj, FMaj, BfMaj, EfMaj, AfMaj, DfMaj, GfMaj, BMaj, EMaj, AMaj, DMaj, GMaj, \
        AMin, DMin, GMin, CMin, FMin, BfMin, EfMin, GsMin, CsMin, FsMin, BMin, EMin = range(24)

    @classmethod
    def from_str(cls, key: str) -> 'Key':
        return key_str2enum[key]


key_str2enum: Dict[str, Key] = {
    'CMajor': Key.CMaj, 'FMajor': Key.FMaj, 'BbMajor': Key.BfMaj, 'EbMajor': Key.EfMaj,
    'AbMajor': Key.AfMaj, 'DbMajor': Key.DfMaj, 'GbMajor': Key.GfMaj, 'BMajor': Key.BMaj,
    'EMajor': Key.EMaj, 'AMajor': Key.AMaj, 'DMajor': Key.DMaj, 'GMajor': Key.GMaj,
    'AMinor': Key.AMin, 'DMinor': Key.DMin, 'GMinor': Key.GMin, 'CMinor': Key.CMin,
    'FMinor': Key.FMin, 'BbMinor': Key.BfMin, 'EbMinor': Key.EfMin, 'G#Minor': Key.GsMin,
    'C#Minor': Key.CsMin, 'F#Minor': Key.FsMin, 'BMinor': Key.BMin, 'EMinor': Key.EMin,
}
enum2key_str: Dict[Key, str] = {v: k for k, v in key_str2enum.items()}

# Key -> (is_major, tonic name); note the reference maps EMin to 'E-' (kept verbatim,
# reference elm_type.py:76-101 -- it is a known quirk their IKR tables rely on).
key_enum2tuple: Dict[Key, Tuple[int, str]] = {
    Key.CMin: (0, 'C'), Key.CsMin: (0, 'C#'), Key.DMin: (0, 'D'), Key.EfMin: (0, 'E-'),
    Key.EMin: (0, 'E-'), Key.FMin: (0, 'F'), Key.FsMin: (0, 'F#'), Key.GMin: (0, 'G'),
    Key.GsMin: (0, 'G#'), Key.AMin: (0, 'A'), Key.BfMin: (0, 'B-'), Key.BMin: (0, 'B'),
    Key.CMaj: (1, 'C'), Key.DMaj: (1, 'D'), Key.DfMaj: (1, 'D-'), Key.EfMaj: (1, 'E-'),
    Key.EMaj: (1, 'E'), Key.FMaj: (1, 'F'), Key.GMaj: (1, 'G'), Key.GfMaj: (1, 'G-'),
    Key.AMaj: (1, 'A'), Key.AfMaj: (1, 'A-'), Key.BfMaj: (1, 'B-'), Key.BMaj: (1, 'B'),
}

key_str2ordinal: Dict[str, int] = {k: i for i, k in enumerate(key_str2enum.keys())}
key_ordinal2str: Dict[int, str] = {i: k for k, i in key_str2ordinal.items()}
key_ordinal2key_enum: Dict[int, Key] = {i: key_str2enum[k] for k, i in key_str2ordinal.items()}
N_KEY = len(key_str2enum)

key_offset_dict: Dict[str, int] = {
    'C': 0, 'C#': 1, 'D-': 1, 'D': 2, 'D#': 3, 'E-': 3, 'E': 4, 'F': 5,
    'F#': 6, 'G-': 6, 'G': 7, 'G#': 8, 'A-': 8, 'A': 9, 'B-': 10, 'B': 11,
}
MAJOR_OFFKEY_OFFSET_IDX = [1, 3, 6, 8, 10]
MINOR_OFFKEY_OFFSET_IDX = [1, 4, 6, 9, 11]
OFFKEY_OFFSET = [MINOR_OFFKEY_OFFSET_IDX, MAJOR_OFFKEY_OFFSET_IDX]


def _build_key_tables():
    """Dense tables used by the vectorized IKR metric.

    Returns (inkey_mask[24, 12] bool, tonic_pc[24] int8, is_major[24] int8):
    inkey_mask[k, pc] is True iff midi pitch-class pc is diatonic to key ordinal k,
    matching reference metrics.py:103-117 semantics exactly.
    """
    inkey = np.ones((N_KEY, 12), dtype=bool)
    tonic = np.zeros(N_KEY, dtype=np.int8)
    major = np.zeros(N_KEY, dtype=np.int8)
    for ordinal in range(N_KEY):
        k = key_ordinal2key_enum[ordinal]
        is_maj, name = key_enum2tuple[k]
        off = key_offset_dict[name]
        tonic[ordinal] = off
        major[ordinal] = is_maj
        for pc in range(12):
            rel = (pc - off) % 12
            inkey[ordinal, pc] = rel not in OFFKEY_OFFSET[is_maj]
    return inkey, tonic, major


key_inkey_mask, key_tonic_pc, key_is_major = _build_key_tables()
