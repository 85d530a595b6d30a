"""The port's command line (`python -m musicnlp_tpu_torch`) on the CPU at debug
width: extract -> dataset -> train -> generate (sampled, beam, diverse-beam
and contrastive) on the goldens, the port's extracted corpus against the
JAX-extracted one, run directories read across the two packages, the recipe
wiring against the JAX `setup_recipe`, the learned tokenizer schemes
(wordpiece, pairmerge) from train to generate, and the refusals (a learned
scheme without its table, no CUDA without `--device cpu`)."""
import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

from musicnlp_tpu import cli as jcli
from musicnlp_tpu.preprocess.dataset import SongDataset as JSongDataset
from musicnlp_tpu.preprocess.music_export import MusicExport, combine_saved_songs
from musicnlp_tpu.trainer import eval as jeval
from musicnlp_tpu.trainer import train as jtrain
from musicnlp_tpu.utils.checkpoint import _flatten
from musicnlp_tpu_torch import cli
from musicnlp_tpu_torch.io import parse_file
from musicnlp_tpu_torch.preprocess.dataset import SongDataset, songdataset_to_dicts
from musicnlp_tpu_torch.trainer import eval as teval
from musicnlp_tpu_torch.trainer import train as ttrain
from musicnlp_tpu_torch.trainer.pair_merge_tokenizer import PairMergeTokenizerTrainer
from musicnlp_tpu_torch.trainer.wordpiece_tokenizer import WordPieceMusicTrainer
from musicnlp_tpu_torch.utils.checkpoint import flatten
from musicnlp_tpu_torch.vocab import MusicVocabulary

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = sorted(glob.glob(os.path.join(REPO, 'tests', 'goldens', 'golden*.musicxml')))


def _tripled(combined):
    """Each song three times (18 songs: the JAX Trainer's batch of 8 divides
    over its 8 CPU devices)."""
    return dict(combined, music=[dict(s, title=f'{s["title"]}-{i}') for i in range(3)
                                 for s in combined['music']])


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """combined.json of the goldens, extracted (step kind) by the port's own
    `extract` command, each song three times, and the port's `dataset` of it."""
    d = tmp_path_factory.mktemp('cli')
    assert cli.main(['extract', *GOLDENS, '--out', str(d / 'json'),
                     '--combine', str(d / 'extracted.json')]) == 0
    combined = json.loads((d / 'extracted.json').read_text())
    (d / 'combined.json').write_text(json.dumps(_tripled(combined)))
    assert cli.main(['dataset', str(d / 'combined.json'), '--out', str(d / 'ds'),
                     '--test-frac', '0.34']) == 0
    return d


def test_port_corpus_gives_the_jax_corpus_dataset(corpus, tmp_path):
    """The dataset built from the port's extraction equals, array for array,
    the one built from the JAX package's extraction of the same files."""
    MusicExport(mode='full', extractor_args=dict(with_pitch_step=True), verbose=False)(
        GOLDENS, output_dir=str(tmp_path / 'json'), save_each=True)
    combined = combine_saved_songs(sorted(glob.glob(str(tmp_path / 'json' / '*.json'))))
    (tmp_path / 'combined.json').write_text(json.dumps(_tripled(combined)))
    assert cli.main(['dataset', str(tmp_path / 'combined.json'), '--out', str(tmp_path / 'ds'),
                     '--test-frac', '0.34']) == 0
    for name in ('meta.json', 'train.npz', 'test.npz'):
        assert (tmp_path / 'ds' / name).read_bytes() == (corpus / 'ds' / name).read_bytes(), name


@pytest.fixture(scope='module')
def port_run(corpus):
    run = corpus / 'run'
    assert cli.main(['train', '--dataset', str(corpus / 'ds'), '--out', str(run), '--size',
                     'debug', '--epochs', '1', '--device', 'cpu']) == 0
    return run


def test_dataset_command_writes_the_columnar_store(corpus):
    meta = json.loads((corpus / 'ds' / 'meta.json').read_text())
    assert meta == dict(n_train=12, n_test=6, pitch_kind='step', seed=77)
    for split, n in (('train', 12), ('test', 6)):
        t = SongDataset.load(str(corpus / 'ds' / f'{split}.npz'))
        j = JSongDataset.load(str(corpus / 'ds' / f'{split}.npz'))
        assert len(t) == n and all(np.array_equal(a.ids, b.ids) for a, b in zip(t, j))


def test_train_then_generate_renders_files(port_run, corpus, capsys):
    log = [json.loads(line) for line in (port_run / 'train_log.jsonl').read_text().splitlines()]
    assert [r['step'] for r in log if 'loss' in r] == [1, 2, 3, 4, 5, 6]
    assert all(np.isfinite(r['loss']) for r in log if 'loss' in r)
    assert 'eval_loss' in log[-1] and (port_run / 'trained.npz').exists()
    out = corpus / 'gen'
    assert cli.main(['generate', '--model-dir', str(port_run), '--out', str(out), '--n', '2',
                     '--key', 'CMajor', '--top-k', '8', '--max-length', '64', '--seed', '0',
                     '--device', 'cpu']) == 0
    for ext in ('mxl', 'mid', 'json'):
        assert len(glob.glob(str(out / f'*.{ext}'))) == 2, ext
    for side in glob.glob(str(out / '*.json')):
        rec = json.loads(open(side).read())
        assert rec['prompt'].split()[2] == 'Key_CMajor' and rec['strategy'] == 'sample'
        assert rec['strategy_args'] == dict(top_k=8) and 'bar_durations_valid' in rec
        mxl = side.replace('.json', '.mxl')
        assert len(parse_file(mxl).parts[0].measures) == rec['text'].split().count('<bar>')
    # conditioned on a rendered song, through mxl2str
    cond = corpus / 'cond'
    assert cli.main(['generate', '--model-dir', str(port_run), '--out', str(cond), '--n', '1',
                     '--key', 'CMajor', '--condition-on', sorted(glob.glob(str(out / '*.mxl')))[0],
                     '--n-bar', '1', '--max-length', '64', '--device', 'cpu',
                     '--strategy', 'greedy']) == 0
    (side,) = glob.glob(str(cond / '*.json'))
    assert json.loads(open(side).read())['mode'] == 'conditional'


def _same_config(jcfg, tcfg):
    """The port's config fields equal the JAX config's (tuples as JSON lists)."""
    j, t = dataclasses.asdict(jcfg), dataclasses.asdict(tcfg)
    norm = lambda v: list(v) if isinstance(v, tuple) else v
    assert {k: norm(v) for k, v in t.items()} == {k: norm(j[k]) for k in t}


def _same_params(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.array_equal(np.asarray(a[k], np.float32), np.asarray(b[k], np.float32)), k


def test_run_directories_load_across_packages(port_run, corpus):
    """The port's run loads in the JAX `load_trained`, and the JAX CLI's run
    in the port's, with the same parameters and tokenizer."""
    jm, jp, jt = jeval.load_trained(str(port_run))
    tm, tp, tt = teval.load_trained(str(port_run), device='cpu')
    _same_params({k: np.asarray(v) for k, v in _flatten(jp).items()},
                 {k: v.numpy() for k, v in flatten(tp).items()})
    assert jt.pitch_kind == tt.pitch_kind == 'degree' and jt.vocab_size == tt.vocab_size
    jrun = corpus / 'jax_run'
    assert jcli.main(['train', '--dataset', str(corpus / 'ds'), '--out', str(jrun), '--size',
                      'debug', '--epochs', '1', '--batch-size', '8']) == 0
    jm, jp, jt = jeval.load_trained(str(jrun))
    tm, tp, tt = teval.load_trained(str(jrun), device='cpu')
    _same_params({k: np.asarray(v) for k, v in _flatten(jp).items()},
                 {k: v.numpy() for k, v in flatten(tp).items()})
    _same_config(jm.cfg, tm.cfg)


@pytest.mark.parametrize('recipe', ['22-11', '22-04', '22-12'])
def test_train_recipe_builds_what_jax_builds(recipe, corpus, monkeypatch):
    """`train --recipe` through the CLI (training skipped) wires the same
    configuration, optimizer arguments, augmentation and IKR mode as the JAX
    `setup_recipe` on the same datasets."""
    seen = {}

    def skip_training(self):
        seen['t'] = self
        return {}
    monkeypatch.setattr(ttrain.Trainer, 'train', skip_training)
    assert cli.main(['train', '--dataset', str(corpus / 'ds'), '--out', str(corpus / 'r'),
                     '--recipe', recipe, '--epochs', '3', '--device', 'cpu']) == 0
    t = seen['t']
    j = jtrain.setup_recipe(recipe, JSongDataset.load(str(corpus / 'ds' / 'train.npz')),
                            eval_datasets=JSongDataset.load(str(corpus / 'ds' / 'test.npz')),
                            train_args=dict(num_train_epochs=3))
    _same_config(j.model.cfg, t.model.cfg)
    assert dataclasses.asdict(t.args) == dataclasses.asdict(j.args)
    assert t.ikr.mode == j.ikr.mode == jtrain.RECIPES[recipe].get('ikr_mode', 'vanilla')
    for td, jd in ((t.train_dataset, j.train_dataset), (t.eval_dataset, j.eval_dataset)):
        for flag in ('random_crop', 'crop_mult', 'insert_key', 'pitch_shift', 'channel_mixup',
                     'to_midi_pitch', 'dataset_split', 'max_length'):
            assert getattr(td, flag) == getattr(jd, flag), flag
    assert t.tokenizer.pitch_kind == j.tokenizer.pitch_kind
    assert t.tokenizer.model_max_length == j.tokenizer.model_max_length


def _rendered(out_dir, n):
    """The sidecars of a generate run whose MXL files re-read to their bars."""
    sides = sorted(glob.glob(os.path.join(out_dir, '*.json')))
    assert len(sides) == n
    recs = [json.loads(open(p).read()) for p in sides]
    for side, rec in zip(sides, recs):
        mxl = side.replace('.json', '.mxl')
        assert len(parse_file(mxl).parts[0].measures) == rec['text'].split().count('<bar>')
        assert os.path.getsize(side.replace('.json', '.mid')) > 0
    return recs


@pytest.mark.parametrize('flags,strategy_args', [
    (['--strategy', 'beam', '--num-beams', '4'], dict(num_beams=4, length_penalty=1.0)),
    (['--strategy', 'beam', '--num-beams', '4', '--num-beam-groups', '2',
      '--diversity-penalty', '0.5', '--top-p', '0.9'],
     dict(num_beams=4, length_penalty=1.0, num_beam_groups=2, diversity_penalty=0.5)),
    (['--strategy', 'contrastive', '--top-k', '4', '--penalty-alpha', '0.6',
      '--temperature', '0.7'], dict(penalty_alpha=0.6, top_k=4)),
])
def test_search_strategies_render_files(port_run, corpus, capsys, flags, strategy_args):
    """Beam, diverse-beam and contrastive search through the command line:
    the strategy arguments the JAX CLI builds (warning about the sampling
    flags each search ignores), rendered files that re-read."""
    out = corpus / f'gen-{len(flags)}'
    assert cli.main(['generate', '--model-dir', str(port_run), '--out', str(out), '--n', '2',
                     '--key', 'CMajor', '--max-length', '48', '--device', 'cpu', *flags]) == 0
    err = capsys.readouterr().err
    assert ('ignores' in err) == any(f in flags for f in ('--top-p', '--temperature'))
    for rec in _rendered(str(out), 2):
        assert rec['strategy'] == flags[1] and rec['strategy_args'] == strategy_args


def test_refusals_exit_non_zero(port_run, corpus, monkeypatch, capsys):
    """Beam and contrastive search, refused until the search slice, now run
    (exit 0, files that re-read); a learned-tokenizer scheme without
    `--tokenizer-path` exits 2 with the JAX CLI's message (the flag parses),
    and without CUDA the card's commands exit non-zero."""
    base = ['generate', '--model-dir', str(port_run), '--device', 'cpu', '--n', '1',
            '--max-length', '32', '--key', 'CMajor', '--strategy']
    for strategy in ('beam', 'contrastive'):
        out = corpus / f'refused-{strategy}'
        assert cli.main(base + [strategy, '--out', str(out)]) == 0
        _rendered(str(out), 1)
    capsys.readouterr()
    train = ['train', '--dataset', str(corpus / 'ds'), '--out', str(corpus / 'w'),
             '--tokenizer-scheme', 'wordpiece']
    assert cli.main(train + ['--device', 'cpu']) == 2
    err = capsys.readouterr().err
    assert jcli.main(train) == 2
    assert err == capsys.readouterr().err and '--tokenizer-path' in err
    assert not (corpus / 'w').exists()
    # the search flags and the learned-tokenizer flag parse
    for argv in (base + ['sample', '--num-beams', '4', '--out', str(corpus / 'f1')],
                 base + ['sample', '--penalty-alpha', '0.6', '--out', str(corpus / 'f2')]):
        assert cli.main(argv) == 0
    assert cli.build_parser().parse_args(train + ['--tokenizer-path', 'units.json']) \
        .tokenizer_path == 'units.json'
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for argv in (['generate', '--model-dir', str(port_run)],
                 ['train', '--dataset', str(corpus / 'ds'), '--out', str(corpus / 'x')]):
        with pytest.raises(SystemExit, match='CUDA') as e:
            cli.main(argv)
        assert e.value.code != 0
    assert not (corpus / 'x').exists()


@pytest.mark.parametrize('scheme', ['wordpiece', 'pairmerge'])
def test_learned_tokenizer_train_then_generate(scheme, corpus, tmp_path):
    """`train --tokenizer-scheme wordpiece|pairmerge --tokenizer-path` with a
    table trained here on the corpus (degree kind, each song in each of its
    keys): the string pipeline trains the debug model over the table's
    vocab, the run directory carries the table, `generate` rebuilds the
    tokenizer and writes files that re-read, and the JAX package loads the
    run with the same tokenizer."""
    songs = songdataset_to_dicts(SongDataset.load(str(corpus / 'ds' / 'train.npz')))
    texts = list(WordPieceMusicTrainer.key_augmented_corpus(songs))
    table = str(tmp_path / 'table.json')
    if scheme == 'wordpiece':
        n_base = len(MusicVocabulary(pitch_kind='degree'))
        tok = WordPieceMusicTrainer(pitch_kind='degree')(texts, 2 * n_base + 200, save=table)
    else:
        tok = PairMergeTokenizerTrainer(pitch_kind='degree')(texts, coverage_ratio=0.9,
                                                             save=table)
    run = tmp_path / 'run'
    assert cli.main(['train', '--dataset', str(corpus / 'ds'), '--out', str(run), '--size',
                     'debug', '--epochs', '1', '--device', 'cpu', '--tokenizer-scheme', scheme,
                     '--tokenizer-path', table]) == 0
    meta = json.loads((run / 'meta.json').read_text())
    assert meta['tokenizer']['scheme'] == scheme
    assert meta['config']['vocab_size'] == meta['tokenizer']['vocab_size'] == tok.vocab_size
    log = [json.loads(line) for line in (run / 'train_log.jsonl').read_text().splitlines()]
    assert len([r for r in log if 'loss' in r]) == 6 and 'eval_loss' in log[-1]
    assert all(np.isfinite(r['loss']) for r in log if 'loss' in r)
    out = tmp_path / 'gen'
    assert cli.main(['generate', '--model-dir', str(run), '--out', str(out), '--n', '2',
                     '--key', 'CMajor', '--top-k', '8', '--max-length', '64', '--seed', '0',
                     '--device', 'cpu']) == 0
    _rendered(str(out), 2)
    _, _, ttok = teval.load_trained(str(run), device='cpu')
    _, _, jtok = jeval.load_trained(str(run))
    assert type(ttok).__name__ == type(jtok).__name__ == type(tok).__name__
    assert ttok.meta == jtok.meta == tok.meta
    assert ttok.encode(texts[0]) == jtok.encode(texts[0])
