"""Copy of `musicnlp_tpu/utils/music_fs.py` (pure Python): the port keeps its own copy
and imports nothing from the JAX package; only the import paths differ
(held against the original by tests/test_torch_extract.py).

Dataset file-system management.

Rebuild of the reference's corpus FS layer (reference musicnlp/util/music.py):
`Ordinal2Fnm` 10k-per-dir ordinal sharding (:92-117, for LMD-scale corpora
where one flat directory is unusable), converted-song path discovery
(`get_converted_song_paths` :401-437 -- preferring the best available
converter backend per song), pre-determined split maps (MAESTRO/NES-MDB
:207-315), and the conversion-status ledger (`get_conversion_meta` :438-530).
"""
from __future__ import annotations

import csv
import glob
import json
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

from musicnlp_tpu_torch.utils.config import sconfig, u

__all__ = ['Ordinal2Fnm', 'get_converted_song_paths', 'clean_dataset_paths',
           'load_split_map', 'save_split_map', 'ConversionLedger']


class Ordinal2Fnm:
    """Ordinal -> sharded path `00000-10000/00042.ext` (reference :92-117)."""

    def __init__(self, total: int, group_size: int = 10_000, ext: str = None):
        self.total = total
        self.grp_sz = int(group_size)
        self.n_digit = len(str(total))
        self.ext = ext

    def __call__(self, i: int, return_parts: bool = False
                 ) -> Union[str, Tuple[str, str]]:
        i_grp = i // self.grp_sz
        strt = i_grp * self.grp_sz
        end = min((i_grp + 1) * self.grp_sz, self.total)
        dir_nm = f'{strt:0{self.n_digit}}-{end:0{self.n_digit}}'
        fnm = f'{i:0{self.n_digit}}'
        if self.ext:
            fnm = f'{fnm}.{self.ext}'
        return (fnm, dir_nm) if return_parts else os.path.join(dir_nm, fnm)


# Converter backends in preference order (reference music.py:401-437: MuseScore
# output preferred over Logic Pro when both exist for a song).
CONVERTER_BACKENDS = ('MS', 'LP', 'all')


def get_converted_song_paths(dataset_name: str, fmt: str = None,
                             backend: str = 'all') -> List[str]:
    """All converted song files for a registry dataset, deduplicated across
    converter backends by stem, preferring earlier CONVERTER_BACKENDS."""
    d = sconfig(f'datasets.{dataset_name}')
    fmt = fmt or d['song_fmt']
    root = u.converted_dir(dataset_name)
    if backend != 'all':
        return sorted(glob.glob(os.path.join(root, backend, '**', fmt),
                                recursive=True))
    by_stem: Dict[str, Tuple[int, str]] = {}
    # backend subdirs if present, else flat
    sub_backends = [b for b in CONVERTER_BACKENDS[:-1]
                    if os.path.isdir(os.path.join(root, b))]
    search = ([(i, os.path.join(root, b)) for i, b in enumerate(sub_backends)]
              or [(0, root)])
    for rank, base in search:
        for p in glob.glob(os.path.join(base, '**', fmt), recursive=True):
            stem = os.path.splitext(os.path.basename(p))[0]
            if stem not in by_stem or rank < by_stem[stem][0]:
                by_stem[stem] = (rank, p)
    return sorted(p for _, p in by_stem.values())


def clean_dataset_paths(paths: Iterable[str]) -> List[Tuple[str, str]]:
    """Normalize raw corpus filenames to `<artist> - <title>` stems
    (reference music.py:120-205's normalization, minus OS moves: returns
    (src, normalized_stem) pairs so the caller controls the copy)."""
    out = []
    for p in paths:
        stem = os.path.splitext(os.path.basename(p))[0]
        stem = stem.replace('_', ' ').strip()
        stem = ' '.join(stem.split())
        if ' - ' not in stem:
            stem = f'unknown - {stem}'
        out.append((p, stem))
    return out


def save_split_map(split_map: Dict[str, str], path: str):
    with open(path, 'w') as f:
        json.dump(split_map, f, indent=0)


def load_split_map(path: str) -> Dict[str, str]:
    """title -> 'train'|'test' pre-determined splits (MAESTRO/NES-MDB style,
    reference music.py:207-315; MAESTRO ships a CSV with a split column)."""
    if path.endswith('.csv'):
        out = {}
        with open(path) as f:
            for row in csv.DictReader(f):
                title = (row.get('canonical_title') or row.get('title')
                         or row.get('midi_filename', ''))
                split = row.get('split', 'train')
                out[title] = 'test' if split in ('test', 'validation') else 'train'
        return out
    with open(path) as f:
        return json.load(f)


class ConversionLedger:
    """Conversion-status ledger: song -> converted | error | empty
    (reference music.py:438-530's meta CSV), resumable and crash-tolerant."""

    FIELDS = ('song', 'status', 'backend', 'detail')

    def __init__(self, path: str):
        self.path = path
        self._rows: Dict[str, Dict[str, str]] = {}
        if os.path.exists(path):
            with open(path) as f:
                for row in csv.DictReader(f):
                    self._rows[row['song']] = row

    def record(self, song: str, status: str, backend: str = '', detail: str = ''):
        assert status in ('converted', 'error', 'empty')
        self._rows[song] = dict(song=song, status=status, backend=backend,
                                detail=detail)

    def status(self, song: str) -> Optional[str]:
        row = self._rows.get(song)
        return row['status'] if row else None

    def save(self):
        os.makedirs(os.path.dirname(self.path) or '.', exist_ok=True)
        with open(self.path, 'w', newline='') as f:
            w = csv.DictWriter(f, fieldnames=self.FIELDS)
            w.writeheader()
            for song in sorted(self._rows):
                w.writerow(self._rows[song])

    def summary(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for row in self._rows.values():
            out[row['status']] = out.get(row['status'], 0) + 1
        return out
