"""Copy of `musicnlp_tpu/utils/config.py` (pure Python): the port keeps its own copy
and imports nothing from the JAX package; only the import paths differ
(held against the original by tests/test_torch_extract.py).

Config + path registry.

Rebuild of the reference config system (reference musicnlp/util/config.py:13-243
`config_dict` -> config.json + `sconfig` dotted lookup, musicnlp/util/util.py:21-43
path derivation, musicnlp/util/project_paths.py:3-17): a static dataset
registry (names, directory conventions, song counts, splits), a dotted-path
accessor, and a path registry deriving datasets/models/tokenizers dirs from a
base path (env-overridable -- the equivalent of the reference's HPC scratch
redirect, util/util.py:31-43).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

__all__ = ['config_dict', 'sconfig', 'PathRegistry', 'u', 'SEED']

SEED = 77  # reference util/config.py random seed

_EXT_FMT = '*.mxl'

# Dataset registry (reference util/config.py:13-154 + preprocess/dataset.py:28-50).
config_dict: Dict[str, Any] = {
    'datasets': {
        'POP909': dict(
            dir_nm='POP909-Dataset', converted_dir_nm='POP909',
            song_fmt=_EXT_FMT, n_song=909),
        'MAESTRO': dict(
            dir_nm='maestro-v3.0.0', converted_dir_nm='MAESTRO',
            song_fmt=_EXT_FMT, n_song=1276, split='pre-determined'),
        'LMD': dict(
            dir_nm='lmd-full', converted_dir_nm='LMD',
            song_fmt=_EXT_FMT, n_song=176640, sharded=True),
        'LMCI': dict(
            dir_nm='lmci', converted_dir_nm='LMCI',
            song_fmt=_EXT_FMT, n_song=127112, sharded=True),
        'NES-MDB': dict(
            dir_nm='nesmdb_midi', converted_dir_nm='NES-MDB',
            song_fmt=_EXT_FMT, n_song=5261, split='pre-determined'),
        'mxl-eg': dict(
            dir_nm='mxl-eg', converted_dir_nm='mxl-eg', song_fmt=_EXT_FMT,
            n_song=None),
    },
    'extraction': dict(precision=5, mode='full', greedy_tuplet_pitch_threshold=3 ** 9),
    'random-seed': SEED,
    'check-arg': dict(
        pitch_kind=['midi', 'step', 'degree'],
        model_name=['transf-xl', 'reformer'],
        model_size=['debug', 'debug-large', 'tiny', 'small', 'base', 'large'],
        dataset_split=['train', 'test'],
        generation_mode=['unconditional', 'conditional'],
        generation_strategy=['greedy', 'sample', 'beam', 'contrastive'],
        tokenizer_scheme=['vanilla', 'wordpiece', 'pairmerge'],
    ),
}


def sconfig(path: str, default=KeyError) -> Any:
    """Dotted-path config lookup: sconfig('datasets.POP909.n_song')."""
    cur: Any = config_dict
    for part in path.split('.'):
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        else:
            if default is KeyError:
                raise KeyError(f'config path {path!r} not found at {part!r}')
            return default
    return cur


class PathRegistry:
    """Derives project paths from a base dir (override: MUSICNLP_TPU_BASE)."""

    def __init__(self, base_path: Optional[str] = None):
        self._base = base_path

    @property
    def base_path(self) -> str:
        if self._base:
            return self._base
        env = os.environ.get('MUSICNLP_TPU_BASE')
        if env:
            return env
        # two levels above the package (reference project_paths.py:10)
        pkg = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        return os.path.dirname(pkg)

    @property
    def dataset_path(self) -> str:
        return os.path.join(self.base_path, 'datasets')

    @property
    def model_path(self) -> str:
        return os.path.join(self.base_path, 'models')

    @property
    def tokenizer_path(self) -> str:
        return os.path.join(self.base_path, 'tokenizers')

    @property
    def generated_path(self) -> str:
        return os.path.join(self.base_path, 'generated')

    def converted_dir(self, dataset_name: str, backend: str = 'all') -> str:
        d = sconfig(f'datasets.{dataset_name}')
        return os.path.join(self.dataset_path, 'converted', d['converted_dir_nm'])

    def write_config_json(self, path: str = None) -> str:
        path = path or os.path.join(
            os.path.dirname(os.path.abspath(__file__)), 'config.json')
        with open(path, 'w') as f:
            json.dump(config_dict, f, indent=2)
        return path


u = PathRegistry()
