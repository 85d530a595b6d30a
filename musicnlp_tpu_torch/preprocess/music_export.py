"""Copy of the batch extraction module `musicnlp_tpu/preprocess/music_export.py`
(`SingleExport`, `MusicExport`, `combine_saved_songs`, `json2dataset`; pure
Python / numpy): the port keeps its own copy and imports nothing from the JAX
package (held against the original by tests/test_torch_extract.py and
tests/test_torch_pipeline.py).

Corpora -> per-song JSON shards -> columnar dataset: a file list or a
registry dataset name -> per-song JSON (`save_each`) or one combined record
list, parallel extraction in process or thread pools, resume by skipping
existing outputs, per-song error isolation (`halt_on_error`),
`combine_saved_songs`, and `json2dataset`, which materializes the COLUMNAR
store (`preprocess/dataset.py` `SongDataset` npz: int32 id arrays + bar
offsets + 24-dim key scores) with a train/test split (fractional, or
pre-determined per title).

Two differences from the JAX `MusicExport`, both deliberate:
  * `fast_midi=True` runs the native extractor on every .mid / .midi file
    and raises when its library cannot be built or loaded; the JAX one
    quietly uses the Python extractor then.
  * process pools start their workers by `spawn`, never by fork: the port's
    `extract` runs in processes that hold torch's threads and may hold an
    initialised CUDA context, which a forked child inherits broken.  The
    records do not change.
"""
from __future__ import annotations

import glob
import json
import multiprocessing
import os
import re
import time
import traceback
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor, as_completed
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from musicnlp_tpu_torch.preprocess.music_extractor import MusicExtractor
from musicnlp_tpu_torch.utils.config import SEED, sconfig, u

__all__ = ['SingleExport', 'MusicExport', 'combine_saved_songs', 'json2dataset']


def _safe_stem(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


@dataclass
class SingleExport:
    """Per-file extraction job; a top-level picklable callable for process pools."""
    extractor_args: Dict[str, Any] = field(default_factory=dict)
    output_dir: Optional[str] = None          # save-each mode when set
    halt_on_error: bool = True
    fast_midi: bool = False                   # native C++ kernel for .mid files

    def __call__(self, path: str) -> Optional[Dict[str, Any]]:
        out_path = None
        if self.output_dir:
            out_path = os.path.join(self.output_dir, f'{_safe_stem(path)}.json')
            if os.path.exists(out_path):      # resume (reference :53-56)
                return None
        fx = None
        if self.fast_midi and path.lower().endswith(('.mid', '.midi')):
            # outside the per-song isolation: a library that cannot be built
            # or loaded is the run's failure, not this song's
            from musicnlp_tpu_torch.preprocess.fast_extractor import FastMidiExtractor
            fx = FastMidiExtractor(precision=self.extractor_args.get('precision', 5),
                                   mode=self.extractor_args.get('mode', 'full'))
        try:
            if fx is not None:
                rec = dict(fx.extract_with_meta(path), song_path=path)
            else:
                extractor = MusicExtractor(**self.extractor_args)
                d = extractor(path, exp='str_join', return_meta=True, return_key=True)
                rec = dict(score=d.score, title=d.title, duration=d.duration,
                           keys=d.keys, warnings=d.warnings, song_path=path)
        except Exception as e:
            if self.halt_on_error:
                raise
            return dict(error=f'{type(e).__name__}: {e}', song_path=path,
                        traceback=traceback.format_exc())
        if out_path:
            with open(out_path, 'w') as f:
                json.dump(rec, f)
            # distinct from the resume-skip None so the n_done /
            # n_skipped counts are truthful
            return dict(saved=out_path)
        return rec


class MusicExport:
    """Batch extraction with parallel modes + resume."""

    def __init__(self, mode: str = 'full', extractor_args: Dict = None,
                 verbose: Union[bool, str] = True):
        self.mode = mode
        self.extractor_args = dict(mode=mode, verbose=False, **(extractor_args or {}))
        self.verbose = verbose

    def __call__(
            self, songs: Union[str, Sequence[str]], output_dir: str = None,
            save_each: bool = True, parallel: Union[bool, int] = False,
            parallel_mode: str = 'process', halt_on_error: bool = None,
            subset: Optional[Tuple[int, int]] = None, fast_midi: bool = False,
    ) -> Dict[str, Any]:
        """songs: dataset name (registry) or explicit file list.

        Returns dict(n_total, n_error, errors, seconds) with n_done /
        n_skipped when save_each, else `songs` (the records, in completion
        order when parallel)."""
        if isinstance(songs, str):
            d = sconfig(f'datasets.{songs}')
            pattern = os.path.join(u.converted_dir(songs), '**', d['song_fmt'])
            paths = sorted(glob.glob(pattern, recursive=True))
        else:
            paths = list(songs)
        if subset:
            paths = paths[subset[0]:subset[1]]
        assert paths, 'no songs to export'
        if halt_on_error is None:
            halt_on_error = not parallel   # reference :68-73
        if save_each:
            assert output_dir, 'save_each needs an output_dir'
            os.makedirs(output_dir, exist_ok=True)

        job = SingleExport(extractor_args=self.extractor_args,
                           output_dir=output_dir if save_each else None,
                           halt_on_error=halt_on_error, fast_midi=fast_midi)
        t0 = time.time()
        results: List[Optional[Dict]] = []
        if parallel:
            n_worker = (os.cpu_count() or 4) if parallel is True else int(parallel)
            if parallel_mode == 'process':
                pool = ProcessPoolExecutor(max_workers=n_worker,
                                           mp_context=multiprocessing.get_context('spawn'))
            else:
                pool = ThreadPoolExecutor(max_workers=n_worker)
            with pool as ex:
                futs = {ex.submit(job, p): p for p in paths}
                for fut in as_completed(futs):
                    results.append(fut.result())
        else:
            for p in paths:
                results.append(job(p))

        errors = [r for r in results if r and 'error' in r]
        done = [r for r in results if r and 'error' not in r]
        # a None result = output already existed (resume-by-skip, :53-56)
        n_skip = sum(1 for r in results if r is None)
        out = dict(n_total=len(paths), n_error=len(errors), errors=errors,
                   seconds=round(time.time() - t0, 2))
        if save_each:
            out['n_skipped'] = n_skip
            out['n_done'] = len(paths) - len(errors) - n_skip
        else:
            out['songs'] = done
        return out


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
