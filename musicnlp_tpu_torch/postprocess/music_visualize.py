"""Copy of `musicnlp_tpu/postprocess/music_visualize.py` (pure Python): the port keeps its own copy
and imports nothing from the JAX package; only the import paths differ
(held against the original by tests/test_torch_postprocess.py).

Dataset visualization: extraction-output distributions and reports.

Rebuild of the reference `MusicVisualize` (reference
musicnlp/postprocess/music_visualize.py:70-862): token-length / bar-count /
tuplet / duration / time-sig / tempo / key / pitch distributions,
duration-WEIGHTED pitch and key distributions (:480-546), empty-channel and
tuplet-duration ratios (:709-776), rare-token ratios (:777), warning-type and
warning-SEVERITY breakdowns (:797-862), token-coverage curves and
coverage-at-ratio summaries per tokenizer scheme (:630-708), per-dataset hue
comparisons (the `dnm` hue of every reference plot), and the stats cache
(:107-123, pickle there; JSON here).

Design difference: statistics are computed into plain dicts/DataFrames first
(`.stats()` / `.dist(kind)`) and plotting is a thin optional layer on top, so
reports work headless and feed tests without a display.
"""
from __future__ import annotations

import json
import os
from collections import Counter
from fractions import Fraction
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

from musicnlp_tpu_torch.postprocess.music_stats import MusicStats
from musicnlp_tpu_torch.vocab import MusicVocabulary, VocabType

__all__ = ['MusicVisualize']

SongsLike = Union[List[Dict], str]


class MusicVisualize:
    DISTS = ('token_length', 'bar_count', 'tuplet_count', 'song_duration',
             'time_sig', 'tempo', 'key', 'pitch', 'note_duration',
             'rare_ratio', 'warning')

    def __init__(self, songs: Union[SongsLike, Dict[str, SongsLike]],
                 dataset_name: str = None, pitch_kind: str = 'midi'):
        """songs: list of extraction dicts ({'score', 'keys', 'warnings', ...}),
        a path to a combined JSON, or a {dataset_name: songs-or-path} dict for
        multi-dataset comparisons (the reference's per-dataset hue)."""
        if isinstance(songs, dict) and songs and \
                not ('score' in songs or 'music' in songs):
            self.datasets = {nm: self._load(s) for nm, s in songs.items()}
            self.dataset_name = dataset_name or '+'.join(self.datasets)
        else:
            self.dataset_name = dataset_name or 'dataset'
            self.datasets = {self.dataset_name: self._load(songs)}
        self.songs = [s for ss in self.datasets.values() for s in ss]
        self.stats_helper = MusicStats(pitch_kind=pitch_kind)
        self.vocab = self.stats_helper.vocab
        self._cache: Optional[Dict[str, Any]] = None
        self._per_ds: Dict[str, Dict[str, Any]] = {}

    @staticmethod
    def _load(songs: SongsLike) -> List[Dict]:
        if isinstance(songs, str):
            with open(songs) as f:
                d = json.load(f)
            songs = d.get('music', d) if isinstance(d, dict) else d
        return songs

    # ------------------------------------------------------------------ data
    def _compute(self, songs: List[Dict]) -> Dict[str, Any]:
        v = self.vocab
        token_length, bar_count, tuplet_count, durations = [], [], [], Counter()
        time_sigs, tempos, keys, pitches = Counter(), Counter(), Counter(), Counter()
        wkeys: Dict[str, float] = Counter()
        rare_ratio, song_duration, warnings = [], [], Counter()
        n_bar_ch, n_empty_ch = 0, 0
        for s in songs:
            toks = s['score'].split()
            st = self.stats_helper.song_stats(toks)
            token_length.append(st['n_token'])
            bar_count.append(st['n_bar'])
            tuplet_count.append(st['n_tuplet'])
            rare_ratio.append(st['rare_ratio'])
            if s.get('duration') is not None:
                song_duration.append(s['duration'])
            tc = self.stats_helper.vocab_type_counts(toks, strict=False)
            time_sigs.update(tc.get('time_sig', {}))
            tempos.update(tc.get('tempo', {}))
            durations.update(tc.get('duration', {}))
            pitches.update(tc.get('pitch', {}))
            e, t = self._empty_channels(toks)
            n_empty_ch += e
            n_bar_ch += t
            for k, conf in (s.get('keys') or {}).items():
                if conf:
                    keys[k] += 1
                    wkeys[k] += float(conf)
            for w in (s.get('warnings') or []):
                warnings[w.get('warn_name', w) if isinstance(w, dict) else w] += 1
        return dict(
            n_song=len(songs),
            token_length=np.array(token_length),
            bar_count=np.array(bar_count),
            tuplet_count=np.array(tuplet_count),
            song_duration=np.array(song_duration),
            rare_ratio=np.array(rare_ratio),
            time_sig=time_sigs, tempo=tempos, key=keys, key_weighted=wkeys,
            pitch=pitches, note_duration=durations, warning=warnings,
            empty_channel_ratio=(n_empty_ch / n_bar_ch) if n_bar_ch else 0.0,
        )

    def _empty_channels(self, toks: List[str]):
        """(n_empty_channel, n_channel): channel markers with no note before
        the next structural marker (reference empty_channel_ratio :709-738)."""
        v = self.vocab
        markers = {v.start_of_bar, v.start_of_melody, v.start_of_bass,
                   v.end_of_song}
        n_empty = n_ch = 0
        open_ch = False
        has_note = False
        for t in toks:
            if t in (v.start_of_melody, v.start_of_bass):
                if open_ch:
                    n_empty += not has_note
                n_ch += 1
                open_ch, has_note = True, False
            elif t in markers:
                if open_ch:
                    n_empty += not has_note
                open_ch, has_note = False, False
            elif open_ch and self.vocab.type(t) == VocabType.pitch:
                has_note = True
        if open_ch:
            n_empty += not has_note
        return n_empty, n_ch

    def per_dataset(self, name: str) -> Dict[str, Any]:
        if name not in self._per_ds:
            self._per_ds[name] = self._compute(self.datasets[name])
        return self._per_ds[name]

    def stats(self) -> Dict[str, Any]:
        """Merged (all-dataset) statistics; cached."""
        if self._cache is None:
            self._cache = self._compute(self.songs)
        return self._cache

    def dist(self, kind: str, dataset: str = None):
        assert kind in MusicVisualize.DISTS, f'unknown dist {kind!r}'
        st = self.per_dataset(dataset) if dataset else self.stats()
        return st[kind]

    # ------------------------------------------------- weighted distributions
    def weighted_pitch_dist(self, dataset: str = None) -> Dict[int, float]:
        """Duration-weighted midi-pitch histogram (reference
        note_pitch_dist(weighted=True) :525-546): each pitch counts its total
        sounded quarter-length, tuplet members an even split."""
        songs = self.datasets[dataset] if dataset else self.songs
        acc: Dict[int, Fraction] = {}
        for s in songs:
            for p, d in self.stats_helper.weighted_pitch_counts(s['score']).items():
                acc[p] = acc.get(p, Fraction(0)) + d
        return {p: float(d) for p, d in sorted(acc.items())}

    def key_dist(self, weighted: bool = True, dataset: str = None
                 ) -> Dict[str, float]:
        """KeyFinder key distribution; weighted=True weights each candidate by
        its confidence (reference key_dist :480-507)."""
        st = self.per_dataset(dataset) if dataset else self.stats()
        return dict(st['key_weighted' if weighted else 'key'])

    def tuplet_duration_ratio(self, dataset: str = None) -> float:
        """Fraction of total sounded duration inside tuplets
        (reference :739-776)."""
        songs = self.datasets[dataset] if dataset else self.songs
        from musicnlp_tpu_torch.vocab import ElmType
        tup = total = Fraction(0)
        for s in songs:
            out = self.stats_helper.converter.str2music_elms(
                s['score'], pitch_kind=self.stats_helper.pitch_kind)
            for elm in out.elms:
                if elm.type == ElmType.note and elm.meta[1] is not None:
                    total += Fraction(elm.meta[1])
                elif elm.type == ElmType.tuplets and elm.meta[1] is not None:
                    total += Fraction(elm.meta[1])
                    tup += Fraction(elm.meta[1])
        return float(tup / total) if total else 0.0

    # ------------------------------------------------------------- coverage
    def token_coverage_curve(self, max_vocab: int = None, dataset: str = None,
                             tokenizer=None):
        """Cumulative corpus coverage by unit-frequency rank (reference
        token_coverage_dist :630-708).  With `tokenizer` (e.g. a trained
        WordPiece/PairMerge), coverage is over its learned units instead of
        base tokens -- the per-tokenizer curves of the reference."""
        c = Counter()
        songs = self.datasets[dataset] if dataset else self.songs
        for s in songs:
            units = (tokenizer.tokenize(s['score']) if tokenizer is not None
                     else s['score'].split())
            c.update(units)
        counts = np.sort(np.fromiter(c.values(), dtype=np.int64))[::-1]
        if max_vocab:
            counts = counts[:max_vocab]
        return np.cumsum(counts) / counts.sum()

    def coverage_summary(self, ratios: Sequence[float] = (0.5, 0.9, 0.95, 0.99),
                         tokenizer=None) -> Dict[str, Dict[float, int]]:
        """Per dataset: vocabulary size needed to cover each corpus ratio
        (the reference's 'vocab size at 95% coverage' table, e.g. pair-merge
        4642 @ 0.95, reference pair_merge_tokenizer.py:301)."""
        out = {}
        for nm in self.datasets:
            curve = self.token_coverage_curve(dataset=nm, tokenizer=tokenizer)
            out[nm] = {r: int(np.searchsorted(curve, r) + 1) for r in ratios}
        return out

    # ------------------------------------------------------------- warnings
    def warning_severity_report(self, dataset: str = None) -> Dict[str, Any]:
        """Warning counts grouped by WarnLog severity (reference
        warning_type_dist :833-862 orders its bars by severity)."""
        from musicnlp_tpu_torch.preprocess.warning_logger import WarnLog
        st = self.per_dataset(dataset) if dataset else self.stats()
        by_sev: Dict[int, Counter] = {}
        for name, n in st['warning'].items():
            sev = WarnLog.type2severity.get(name, 0)
            by_sev.setdefault(sev, Counter())[name] = n
        total = sum(st['warning'].values())
        return dict(
            total=total,
            by_severity={s: dict(c) for s, c in sorted(by_sev.items(),
                                                       reverse=True)},
            severity_weighted=sum(
                WarnLog.type2severity.get(nm, 0) * n
                for nm, n in st['warning'].items()),
        )

    # --------------------------------------------------------------- report
    def report(self) -> Dict[str, Any]:
        """Compact scalar summary (the reference's dataset table rows);
        multi-dataset instances also get a per-dataset breakdown."""
        st = self.stats()

        def _c(x):
            return dict(mean=float(np.mean(x)), p50=float(np.median(x)),
                        max=int(np.max(x))) if len(x) else {}

        def _row(st):
            return dict(
                n_song=st['n_song'],
                token_length=_c(st['token_length']),
                bar_count=_c(st['bar_count']),
                rare_token_ratio=(float(np.mean(st['rare_ratio']))
                                  if len(st['rare_ratio']) else 0.0),
                empty_channel_ratio=st['empty_channel_ratio'],
                top_time_sigs=st['time_sig'].most_common(3),
                top_tempos=st['tempo'].most_common(3),
                top_keys=st['key'].most_common(3),
                n_warning=sum(st['warning'].values()),
                warning_types=dict(st['warning']),
            )
        rep = dict(dataset=self.dataset_name, **_row(st))
        if len(self.datasets) > 1:
            rep['per_dataset'] = {nm: _row(self.per_dataset(nm))
                                  for nm in self.datasets}
        return rep

    # ---------------------------------------------------------------- cache
    def save_cache(self, path: str):
        """Persist computed stats (the reference pickles its song-info frame,
        :107-123; JSON here so caches stay diffable)."""
        def key_enc(kk):
            if isinstance(kk, Fraction):
                return f'F:{kk.numerator}/{kk.denominator}'
            return repr(kk)

        def enc(st):
            out = {}
            for k, v in st.items():
                if isinstance(v, np.ndarray):
                    out[k] = v.tolist()
                elif isinstance(v, (Counter, dict)):
                    out[k] = [[key_enc(kk), vv] for kk, vv in v.items()]
                else:
                    out[k] = v
            return out
        with open(path, 'w') as f:
            json.dump(dict(merged=enc(self.stats()),
                           per_dataset={nm: enc(self.per_dataset(nm))
                                        for nm in self.datasets}), f)

    def load_cache(self, path: str):
        import ast

        def key_dec(kk):
            if kk.startswith('F:'):
                return Fraction(kk[2:])
            return ast.literal_eval(kk)

        def dec(st):
            out = {}
            arrays = ('token_length', 'bar_count', 'tuplet_count',
                      'song_duration', 'rare_ratio')
            for k, v in st.items():
                if k in arrays:
                    out[k] = np.asarray(v)
                elif isinstance(v, list) and v and isinstance(v[0], list):
                    out[k] = Counter({key_dec(kk): vv for kk, vv in v})
                else:
                    out[k] = v
            return out
        with open(path) as f:
            d = json.load(f)
        self._cache = dec(d['merged'])
        self._per_ds = {nm: dec(st) for nm, st in d['per_dataset'].items()}

    # ------------------------------------------------------------------ plots
    def plot(self, kind: str, out_path: str = None, bins: int = 40,
             by_dataset: bool = False):
        """Render one distribution to PNG (headless-safe).  by_dataset=True
        overlays every dataset on one axis (the reference's hue comparison)."""
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 3.5))
        groups = (list(self.datasets) if by_dataset and len(self.datasets) > 1
                  else [None])
        for nm in groups:
            data = self.dist(kind, dataset=nm)
            label = nm or self.dataset_name
            if isinstance(data, Counter):
                items = data.most_common(24)
                ax.bar([str(k) for k, _ in items], [v for _, v in items],
                       alpha=0.6 if len(groups) > 1 else 1.0, label=label)
                ax.tick_params(axis='x', rotation=60, labelsize=7)
            else:
                ax.hist(data, bins=bins, alpha=0.6 if len(groups) > 1 else 1.0,
                        density=len(groups) > 1, label=label)
        if len(groups) > 1:
            ax.legend(fontsize=7)
        ax.set_title(f'{self.dataset_name}: {kind}')
        fig.tight_layout()
        out_path = out_path or f'{self.dataset_name}_{kind}.png'
        fig.savefig(out_path, dpi=120)
        plt.close(fig)
        return out_path

    def plot_weighted_pitch(self, out_path: str, by_dataset: bool = True):
        """Duration-weighted pitch histogram PNG, optionally per-dataset."""
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 3.5))
        groups = (list(self.datasets) if by_dataset and len(self.datasets) > 1
                  else [None])
        for nm in groups:
            w = self.weighted_pitch_dist(dataset=nm)
            ps = [p for p in w if p >= 0]
            tot = sum(w[p] for p in ps) or 1.0
            ax.bar(ps, [w[p] / tot for p in ps], width=0.9,
                   alpha=0.6 if len(groups) > 1 else 1.0,
                   label=nm or self.dataset_name)
        if len(groups) > 1:
            ax.legend(fontsize=7)
        ax.set_xlabel('midi pitch')
        ax.set_ylabel('duration share')
        ax.set_title(f'{self.dataset_name}: duration-weighted pitch')
        fig.tight_layout()
        fig.savefig(out_path, dpi=120)
        plt.close(fig)
        return out_path

    def plot_coverage(self, out_path: str, tokenizers: Dict[str, Any] = None,
                      max_vocab: int = None):
        """Token-coverage curves, one line per dataset and (optionally) per
        trained tokenizer (reference token_coverage_dist :630-708)."""
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 3.5))
        for nm in self.datasets:
            curve = self.token_coverage_curve(max_vocab=max_vocab, dataset=nm)
            ax.plot(np.arange(1, len(curve) + 1), curve, label=f'{nm} (base)')
            for tk_nm, tk in (tokenizers or {}).items():
                curve = self.token_coverage_curve(
                    max_vocab=max_vocab, dataset=nm, tokenizer=tk)
                ax.plot(np.arange(1, len(curve) + 1), curve,
                        label=f'{nm} ({tk_nm})')
        ax.axhline(0.95, ls=':', lw=0.8)
        ax.set_xlabel('vocab rank')
        ax.set_ylabel('corpus coverage')
        ax.legend(fontsize=7)
        fig.tight_layout()
        fig.savefig(out_path, dpi=120)
        plt.close(fig)
        return out_path

    def plot_all(self, out_dir: str) -> List[str]:
        os.makedirs(out_dir, exist_ok=True)
        paths = [self.plot(k, os.path.join(out_dir, f'{k}.png'),
                           by_dataset=len(self.datasets) > 1)
                 for k in MusicVisualize.DISTS
                 if (len(self.dist(k)) if not isinstance(self.dist(k), Counter)
                     else sum(self.dist(k).values()))]
        paths.append(self.plot_weighted_pitch(
            os.path.join(out_dir, 'weighted_pitch.png')))
        paths.append(self.plot_coverage(os.path.join(out_dir, 'coverage.png')))
        return paths
