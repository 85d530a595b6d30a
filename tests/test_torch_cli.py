"""The port's command line (`python -m musicnlp_tpu_torch`) on the CPU at debug
width: dataset -> train -> generate on songs the JAX extractor writes, run
directories read across the two packages, the recipe wiring against the JAX
`setup_recipe`, and the refusals (beam / contrastive, learned tokenizers, no
CUDA without `--device cpu`)."""
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
from musicnlp_tpu_torch.preprocess.dataset import SongDataset
from musicnlp_tpu_torch.trainer import eval as teval
from musicnlp_tpu_torch.trainer import train as ttrain
from musicnlp_tpu_torch.utils.checkpoint import flatten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = sorted(glob.glob(os.path.join(REPO, 'tests', 'goldens', 'golden*.musicxml')))


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """combined.json of the goldens, extracted (step kind) by the JAX package,
    each song three times (18 songs: the JAX Trainer's batch of 8 divides over
    its 8 CPU devices), and the port's `dataset` of it."""
    d = tmp_path_factory.mktemp('cli')
    MusicExport(mode='full', extractor_args=dict(with_pitch_step=True), verbose=False)(
        GOLDENS, output_dir=str(d / 'json'), save_each=True)
    combined = combine_saved_songs(sorted(glob.glob(str(d / 'json' / '*.json'))))
    combined['music'] = [dict(s, title=f'{s["title"]}-{i}') for i in range(3)
                         for s in combined['music']]
    (d / 'combined.json').write_text(json.dumps(combined))
    assert cli.main(['dataset', str(d / 'combined.json'), '--out', str(d / 'ds'),
                     '--test-frac', '0.34']) == 0
    return d


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


@pytest.mark.parametrize('recipe', ['22-11', '22-04'])
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


def test_refusals_exit_non_zero(port_run, corpus, monkeypatch, capsys):
    base = ['generate', '--model-dir', str(port_run), '--device', 'cpu', '--strategy']
    assert cli.main(base + ['beam']) == 2
    assert cli.main(base + ['contrastive']) == 2
    assert cli.main(['train', '--dataset', str(corpus / 'ds'), '--out', str(corpus / 'w'),
                     '--tokenizer-scheme', 'wordpiece', '--device', 'cpu']) == 2
    err = capsys.readouterr().err
    assert err.count('A.3') == 2 and 'learned-tokenizer' in err
    # the beam / contrastive / learned-tokenizer flags come with their slices
    for argv in (base + ['sample', '--num-beams', '4'], base + ['sample', '--penalty-alpha', '0.6'],
                 ['train', '--dataset', str(corpus / 'ds'), '--out', str(corpus / 'w'),
                  '--tokenizer-path', 'units.json', '--device', 'cpu']):
        with pytest.raises(SystemExit) as e:
            cli.main(argv)
        assert e.value.code == 2
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for argv in (['generate', '--model-dir', str(port_run)],
                 ['train', '--dataset', str(corpus / 'ds'), '--out', str(corpus / 'x')]):
        with pytest.raises(SystemExit, match='CUDA') as e:
            cli.main(argv)
        assert e.value.code != 0
    assert not (corpus / 'x').exists()
