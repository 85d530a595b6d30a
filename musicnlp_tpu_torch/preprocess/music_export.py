"""Copy of `combine_saved_songs` and `json2dataset` from
`musicnlp_tpu/preprocess/music_export.py` (pure Python / numpy): the port keeps
its own copy and imports nothing from the JAX package; only the import paths
differ (held against the original by tests/test_torch_pipeline.py).  Batch
extraction (`MusicExport`, `MusicExtractor`, the CLI's `extract`) comes with a
later slice.

`json2dataset` materializes the COLUMNAR store (`preprocess/dataset.py`
`SongDataset` npz: int32 id arrays + bar offsets + 24-dim key scores) with a
train/test split (fractional, or pre-determined per title).
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Sequence, Union

import numpy as np

__all__ = ['SEED', 'combine_saved_songs', 'json2dataset']

SEED = 77  # reference util/config.py random seed (musicnlp_tpu/utils/config.py)


def combine_saved_songs(json_paths: Sequence[str], out_path: str = None,
                        extractor_meta: Dict = None) -> Dict[str, Any]:
    """Merge per-song JSON shards into one combined file
    (reference music_export.py:213-250)."""
    songs = []
    for p in sorted(json_paths):
        with open(p) as f:
            d = json.load(f)
        # keep only actual song records: error shards have 'error', and a
        # directory glob can pick up a previously written combined file
        # (music/n_song keys) -- silently ingesting it would nest a whole
        # corpus as one "song" and crash json2dataset later
        if 'error' not in d and 'score' in d:
            songs.append(d)
    combined = dict(music=songs, n_song=len(songs),
                    extractor_meta=extractor_meta or {})
    if out_path:
        os.makedirs(os.path.dirname(out_path) or '.', exist_ok=True)
        with open(out_path, 'w') as f:
            json.dump(combined, f)
    return combined


def json2dataset(
        songs_or_combined: Union[Dict, List[Dict]], out_dir: str,
        test_frac: float = 0.02, split_map: Dict[str, str] = None,
        pitch_kind: str = 'step', seed: int = SEED,
) -> Dict[str, str]:
    """Songs -> columnar SongDataset npz with train/test split
    (reference music_export.py:252-369).

    split_map: optional title -> 'train'|'test' pre-determined split
    (MAESTRO/NES-MDB style, reference util/music.py:207-315); otherwise a
    seeded fractional split.
    """
    from musicnlp_tpu_torch.preprocess.dataset import SongDataset
    from musicnlp_tpu_torch.vocab import MusicVocabulary

    songs = (songs_or_combined.get('music')
             if isinstance(songs_or_combined, dict) else songs_or_combined)
    vocab = MusicVocabulary(pitch_kind=pitch_kind)
    # Corpora extracted the reference way are STEP-kind (spelled pitches,
    # p_<idx>/<oct>_<step>).  A midi materialization remaps them here --
    # key-independent, same table AugmentedDataset uses at load.  A degree
    # materialization is key-DEPENDENT (one id per key x pitch) and belongs
    # at train time, so asking for it on a step corpus is an error.
    step_pitch = re.compile(r'p_-?\d+/-?\d+_')
    if pitch_kind != 'step' and songs \
            and any(step_pitch.match(t) for t in songs[0]['score'].split()):
        if pitch_kind == 'degree':
            raise ValueError(
                "a step-kind corpus cannot materialize as 'degree' (degree "
                "pitch ids depend on the sampled key): materialize as 'step' "
                "and train with a degree tokenizer + key insertion "
                "(CLI: train --pitch-kind degree --insert-key)")
        from musicnlp_tpu_torch.preprocess.transform import ToMidiPitch
        remap = ToMidiPitch(vocab=MusicVocabulary(pitch_kind='step'))
        songs = [dict(s, score=remap(s['score'])) for s in songs]
    if split_map:
        tr = [s for s in songs if split_map.get(s.get('title'), 'train') == 'train']
        te = [s for s in songs if split_map.get(s.get('title')) == 'test']
    else:
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(songs))
        n_test = max(1, int(len(songs) * test_frac)) if len(songs) > 1 else 0
        test_idx = set(order[:n_test].tolist())
        tr = [s for i, s in enumerate(songs) if i not in test_idx]
        te = [s for i, s in enumerate(songs) if i in test_idx]
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for split, subset in (('train', tr), ('test', te)):
        if not subset:
            continue
        ds = SongDataset.from_songs(subset, vocab=vocab)
        p = os.path.join(out_dir, f'{split}.npz')
        ds.save(p)
        paths[split] = p
    with open(os.path.join(out_dir, 'meta.json'), 'w') as f:
        json.dump(dict(n_train=len(tr), n_test=len(te), pitch_kind=pitch_kind,
                       seed=seed), f, indent=2)
    return paths
