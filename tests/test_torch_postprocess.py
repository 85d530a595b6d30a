"""The analysis modules of the port (ROADMAP A.8) against the JAX package's,
on the CPU: the sample scores, `seq_metrics`, `MusicStats`, the non-plot
outputs of `MusicVisualize` (and its stats cache, read across packages),
the train-log summaries of a run the port's Trainer wrote, the ground-truth
in-key ratio and the key ordinals, the profiling helpers and the plots.
Host-side numbers are compared for equality; the in-key ratios, computed
in f32 by both, at 1e-6."""
import enum
import json
import os
import sys

import numpy as np
import pytest
import torch

from musicnlp_tpu import _sample_scores as jsamples
from musicnlp_tpu.postprocess import (
    MusicStats as JStats, MusicVisualize as JVisualize, load_train_log as j_load_train_log,
    summarize_run as j_summarize_run,
)
from musicnlp_tpu.trainer.metrics import IkrMetric as JIkr
from musicnlp_tpu.utils import seq_metrics as jseq
from musicnlp_tpu.vocab import MusicTokenizer as JTok
from musicnlp_tpu_torch import _sample_scores as samples
from musicnlp_tpu_torch.models.transformer_xl import TransfoXL, TransfoXLConfig
from musicnlp_tpu_torch.postprocess import (
    MusicStats, MusicVisualize, load_train_log, plot_train_curves, summarize_run,
)
from musicnlp_tpu_torch.preprocess.warning_logger import WarnLog
from musicnlp_tpu_torch.trainer import train as ttrain
from musicnlp_tpu_torch.trainer.metrics import IkrMetric
from musicnlp_tpu_torch.utils import seq_metrics
from musicnlp_tpu_torch.utils.profiling import StepTimer, device_trace, profile_fn, step_kernels
from musicnlp_tpu_torch.vocab import MusicTokenizer
from tests.test_torch_train import _Rows

IKR_TOL = 1e-6           # f32 ratios, summed in other orders
SCORES = dict(midi=samples.sample_full_midi, step=samples.sample_full_step,
              degree=samples.sample_full_degree)


def _songs(pk='midi'):
    """Extraction records over the sample scores: keys, durations, and
    warnings of three severities (one unknown to WarnLog)."""
    s = SCORES[pk]
    warns = [dict(warn_name=WarnLog.HighPchOvl), dict(warn_name=WarnLog.MissTempo)]
    return [dict(score=s, keys={'CMajor': 0.9, 'AMinor': 0.4}, duration=8, warnings=warns),
            dict(score=s, keys={'GMajor': 0.7}, duration=9, warnings=['made-up warning']),
            dict(score=s, keys={}, warnings=[])]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plain(x):
    """An enum of either package's vocabulary (each has its own copy of the
    classes) as its class and member names."""
    return (type(x).__name__, x.name) if isinstance(x, enum.Enum) else x


def _equal(a, b):
    """Deep equality over the stats' dicts, Counters, tuples and arrays."""
    if isinstance(a, dict):
        assert isinstance(b, dict), (a, b)
        a, b = {_plain(k): v for k, v in a.items()}, {_plain(k): v for k, v in b.items()}
        assert set(a) == set(b), (a, b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert _plain(a) == _plain(b) and type(_plain(a)) is type(_plain(b)), (a, b)


def test_sample_scores_copy_equals_jax():
    names = [n for n in vars(jsamples) if not n.startswith('_')]
    assert names == [n for n in vars(samples) if not n.startswith('_')]
    assert all(getattr(samples, n) == getattr(jsamples, n) for n in names)


def test_seq_metrics_equal_jax():
    texts = ['', *SCORES.values(), samples.gen_broken, 'a b c', 'c b a']
    for a in texts:
        for b in texts:
            assert seq_metrics.norm_edit_distance(a, b) == jseq.norm_edit_distance(a, b)
    counts = [{}, {'a': 3, 'b': 1}, {'b': 2, 'c': 5}, {'d': 7, 'a': 0}]
    for p in counts:
        for q in counts:
            assert seq_metrics.js_divergence(p, q) == jseq.js_divergence(p, q)


@pytest.mark.parametrize('pk', ['midi', 'step', 'degree'])
def test_music_stats_equal_jax(pk):
    mine, ref = MusicStats(pitch_kind=pk), JStats(pitch_kind=pk)
    for text in (SCORES[pk],) + ((samples.gen_broken,) if pk == 'midi' else ()):
        toks = text.split()
        _equal(dict(mine.vocab_type_counts(toks, strict=False)),
               dict(ref.vocab_type_counts(toks, strict=False)))
        _equal(mine.song_stats(text), ref.song_stats(text))
    _equal(mine.weighted_pitch_counts(SCORES[pk]), ref.weighted_pitch_counts(SCORES[pk]))


@pytest.mark.parametrize('pk', ['midi', 'degree'])
def test_music_visualize_outputs_equal_jax(pk, tmp_path):
    """Every non-plot output, for one dataset and for a two-dataset
    comparison; the stats cache written by each package loads in the other."""
    for songs in (_songs(pk), {'a': _songs(pk), 'b': _songs(pk)[:2]}):
        mine, ref = MusicVisualize(songs, pitch_kind=pk), JVisualize(songs, pitch_kind=pk)
        _equal(mine.stats(), ref.stats())
        _equal(mine.report(), ref.report())
        for kind in MusicVisualize.DISTS:
            _equal(mine.dist(kind), ref.dist(kind))
        _equal(mine.weighted_pitch_dist(), ref.weighted_pitch_dist())
        _equal(mine.key_dist(), ref.key_dist())
        _equal(mine.key_dist(weighted=False), ref.key_dist(weighted=False))
        assert mine.tuplet_duration_ratio() == ref.tuplet_duration_ratio()
        _equal(mine.token_coverage_curve(), ref.token_coverage_curve())
        _equal(mine.coverage_summary(), ref.coverage_summary())
        _equal(mine.warning_severity_report(), ref.warning_severity_report())
        for nm in mine.datasets:
            _equal(mine.per_dataset(nm), ref.per_dataset(nm))
        mine.save_cache(str(tmp_path / 'mine.json'))
        ref.save_cache(str(tmp_path / 'ref.json'))
        assert (tmp_path / 'mine.json').read_text() == (tmp_path / 'ref.json').read_text()
        other = MusicVisualize(songs, pitch_kind=pk)
        other.load_cache(str(tmp_path / 'ref.json'))
        _equal(other.report(), ref.report())


def test_visualize_without_matplotlib(monkeypatch, tmp_path):
    """The reports need no matplotlib; the plots raise ImportError naming it."""
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    monkeypatch.setitem(sys.modules, 'matplotlib.pyplot', None)
    mv = MusicVisualize(_songs())
    assert mv.report()['n_song'] == 3 and mv.coverage_summary()
    mv.save_cache(str(tmp_path / 'cache.json'))
    for plot in (lambda: mv.plot('bar_count', str(tmp_path / 'a.png')),
                 lambda: mv.plot_weighted_pitch(str(tmp_path / 'b.png')),
                 lambda: mv.plot_coverage(str(tmp_path / 'c.png'))):
        with pytest.raises(ImportError, match='matplotlib'):
            plot()


def test_plots_write_files(tmp_path):
    mv = MusicVisualize({'a': _songs(), 'b': _songs()[:1]})
    paths = mv.plot_all(str(tmp_path / 'plots'))
    assert len(paths) >= 3 and all(os.path.getsize(p) > 0 for p in paths)


def test_train_log_of_the_ports_trainer(tmp_path):
    """A run of the port's CPU Trainer (2 epochs, eval each): the train log
    it writes parses and summarizes as the JAX package's functions do, and
    its curves plot."""
    tok = MusicTokenizer(pitch_kind='midi', model_max_length=32)
    cfg = TransfoXLConfig(vocab_size=tok.vocab_size, model_size='test', d_model=32, n_head=2,
                          d_head=16, d_inner=64, n_layer=1, mem_len=16, clamp_len=32,
                          max_length=32, dtype='float32')
    ds = _Rows(np.random.default_rng(0).integers(0, tok.vocab_size, (8, 32)).astype(np.int32))
    args = ttrain.TrainArgs(batch_size=4, learning_rate=1e-3, num_train_epochs=2,
                            save_per_epoch=False)
    trainer = ttrain.Trainer(TransfoXL(cfg, device='cpu'), tok, ds, ds, args=args,
                             out_dir=str(tmp_path))
    trainer.train()
    path = trainer.log_path
    _equal(load_train_log(path), j_load_train_log(path))
    got = summarize_run(path)
    _equal(got, j_summarize_run(path))
    assert (got['n_step'], got['n_epoch']) == (4, 2) and 'best_eval_loss' in got
    assert os.path.getsize(plot_train_curves(path)) > 0


@pytest.mark.parametrize('pk', ['midi', 'degree'])
def test_ground_truth_ikr_and_key_ordinals_match_jax(pk):
    tok, jtok = MusicTokenizer(pitch_kind=pk), JTok(pitch_kind=pk)
    rng = np.random.default_rng(3)
    ids = np.stack([np.asarray(tok(SCORES[pk], padding='max_length', truncation=True,
                                   max_length=96)['input_ids'])] * 2
                   + [rng.integers(0, tok.vocab_size, 96)]).astype(np.int32)
    ids[1, 40:] = tok.pad_token_id
    key_scores = rng.random((3, 24)).astype(np.float32)
    key_scores[2] = 0.0                                  # no key at all
    mine, ref = IkrMetric(tok), JIkr(jtok)
    for best in (False, True):
        got = mine.ground_truth_ikr(ids, key_scores, best_key_only=best)
        want = ref.ground_truth_ikr(ids, key_scores, best_key_only=best)
        assert abs(got - want) <= IKR_TOL and 0 < got < 1
        assert mine.ground_truth_ikr(torch.from_numpy(ids), torch.from_numpy(key_scores),
                                     best_key_only=best) == got
    labels = ids.copy()
    key_ids = [tok.vocab.tok2id[f'Key_{k}'] for k in ('CMajor', 'FMinor')] if pk == 'degree' \
        else [0, 0]
    labels[0, 2], labels[1, 2], labels[2, 2] = key_ids[0], key_ids[1], -100
    got = mine.key_ordinals_from_labels(labels)
    want = ref.key_ordinals_from_labels(labels)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(mine.key_ordinals_from_labels(torch.from_numpy(labels)), want)


def test_step_timer_and_profile_fn():
    t = StepTimer()
    for _ in range(5):
        t.mark(n_tokens=100)
    s = t.summary()
    assert s['steps'] == 5 and s['tokens_per_sec'] > 0
    assert 'p50_step_s' in s and 'p90_step_s' in s and StepTimer().summary() == dict(steps=0)
    assert 'function calls' in profile_fn(lambda: sum(range(10000)))


def test_device_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    a = torch.ones(8, 8)
    with device_trace(str(tmp_path / 'trace'), device='cpu') as path:
        (a @ a).sum()
    assert os.path.dirname(path) == str(tmp_path / 'trace')
    with open(path) as f:
        events = json.load(f)['traceEvents']
    assert any(e.get('name') == 'aten::mm' for e in events)


def test_step_kernels_reads_past_the_longest_idle_gap(tmp_path):
    """Kernel events after the card's longest idle gap (the read step after
    a warm-up), counted by name; CPU events and other categories ignored."""
    def kernel(name, ts, dur):
        return dict(name=name, cat='kernel', ts=ts, dur=dur)
    events = [kernel('warm', 0, 10), kernel('warm', 12, 5), dict(name='aten::mm', cat='cpu_op',
                                                                  ts=50, dur=400),
              kernel('k1_tc', 500, 30), kernel('gemm', 531, 4), kernel('k1_tc', 540, 30),
              dict(name='Memcpy', cat='gpu_memcpy', ts=580, dur=2)]
    path = tmp_path / 'trace.json'
    path.write_text(json.dumps(dict(traceEvents=events[::-1])))
    assert step_kernels(str(path)) == {'k1_tc': 2, 'gemm': 1}
    path.write_text(json.dumps(dict(traceEvents=[kernel('only', 3, 1)])))
    assert step_kernels(str(path)) == {'only': 1}
