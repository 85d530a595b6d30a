"""The port's data pipeline and rendering against the JAX package: the io
readers and writers, the detokenizer, `KeyFinder`, `json2dataset`, the
augmented datasets, the token repairs, conditional prompts and the rendering
generator.  Pure Python / numpy copies must agree bit for bit; the generator
runs TF-XL at debug width in f32 on the same parameters."""
import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from musicnlp_tpu.io import parse_file as j_parse_file
from musicnlp_tpu.io.midi import write_midi as j_write_midi
from musicnlp_tpu.io.musicxml import write_musicxml as j_write_musicxml
from musicnlp_tpu.models.transformer_xl import TransfoXL as JTransfoXL, TransfoXLConfig as JCfg
from musicnlp_tpu.preprocess import dataset as jds
from musicnlp_tpu.preprocess.key_finder import KeyFinder as JKeyFinder
from musicnlp_tpu.preprocess.music_converter import MusicConverter as JConverter
from musicnlp_tpu.preprocess.music_export import MusicExport, json2dataset as j_json2dataset
from musicnlp_tpu.trainer import eval as jeval
from musicnlp_tpu.vocab import MusicTokenizer as JTokenizer
from musicnlp_tpu_torch import _sample_scores as samples
from musicnlp_tpu_torch.io import parse_file
from musicnlp_tpu_torch.io.midi import write_midi
from musicnlp_tpu_torch.io.musicxml import write_musicxml
from musicnlp_tpu_torch.models.transformer_xl import TransfoXL, TransfoXLConfig
from musicnlp_tpu_torch.preprocess import dataset as tds
from musicnlp_tpu_torch.preprocess.key_finder import KeyFinder
from musicnlp_tpu_torch.preprocess.music_converter import MusicConverter
from musicnlp_tpu_torch.preprocess.music_export import json2dataset
from musicnlp_tpu_torch.trainer import eval as teval
from musicnlp_tpu_torch.vocab import MusicTokenizer
from chip_smoke import synthetic_songs
from tests.torch_parity import to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = sorted(glob.glob(os.path.join(REPO, 'tests', 'goldens', 'golden*.musicxml')))


@pytest.fixture(scope='module')
def extracted():
    """The goldens as the JAX extractor writes them (step kind), in file order."""
    res = MusicExport(mode='full', extractor_args=dict(with_pitch_step=True), verbose=False)(
        GOLDENS, save_each=False)
    by_path = {s['song_path']: s for s in res['songs']}
    return [by_path[p] for p in GOLDENS]


def _files(tmp_path, name, score, writers):
    """Write `score` with (midi, musicxml) writers -> (midi bytes, musicxml text)."""
    mid, xml = tmp_path / f'{name}.mid', tmp_path / f'{name}.musicxml'
    writers[0](score, str(mid))
    writers[1](score, str(xml))
    return mid.read_bytes(), xml.read_text()


@pytest.mark.parametrize('i', range(6))
def test_parse_file_and_writers_match_jax(i, tmp_path):
    """A golden parsed by each package and written back by each package's
    writers: byte-identical MIDI, identical MusicXML text; the same keys."""
    path = GOLDENS[i]
    j, t = j_parse_file(path), parse_file(path)
    assert _files(tmp_path, 'j', j, (j_write_midi, j_write_musicxml)) == \
        _files(tmp_path, 't', t, (write_midi, write_musicxml))
    assert KeyFinder(t)(return_type='dict') == JKeyFinder(j)(return_type='dict')


@pytest.mark.parametrize('i', range(6))
def test_mxl2str_matches_jax(i, extracted, tmp_path):
    """An extracted golden rendered to MXL; `mxl2str(pitch_kind='step')` of it
    in both packages gives the same token string (and with key insertion)."""
    text = extracted[i]['score']
    path = str(tmp_path / 'song.mxl')
    JConverter(mode='full').str2score(text, pitch_kind='step', title='t').write_mxl(path)
    want = JConverter(mode='full').mxl2str(path, pitch_kind='step')
    assert MusicConverter(mode='full').mxl2str(path, pitch_kind='step') == want
    assert MusicConverter(mode='full').mxl2str(path, pitch_kind='midi', insert_key=True) == \
        JConverter(mode='full').mxl2str(path, pitch_kind='midi', insert_key=True)


@pytest.mark.parametrize('text,kind', [(samples.sample_full_midi, 'midi'),
                                       (samples.sample_full_step, 'step'),
                                       (samples.sample_full_degree, 'degree')])
def test_str2score_writes_identical_files(text, kind, tmp_path):
    j = JConverter(mode='full').str2score(text, pitch_kind=kind, title='t')
    t = MusicConverter(mode='full').str2score(text, pitch_kind=kind, title='t')
    assert _files(tmp_path, 'j', j, (j_write_midi, j_write_musicxml)) == \
        _files(tmp_path, 't', t, (write_midi, write_musicxml))
    # the two packages' dataclasses and enums: equal as printed
    assert repr(MusicConverter().str2music_elms(text, pitch_kind=kind)) == \
        repr(JConverter().str2music_elms(text, pitch_kind=kind))


@pytest.mark.parametrize('kind', ['step', 'midi'])
def test_json2dataset_matches_jax(kind, tmp_path):
    songs = synthetic_songs(12, 20, seed=1)
    pj = j_json2dataset(dict(music=songs), str(tmp_path / 'j'), test_frac=0.25, pitch_kind=kind)
    pt = json2dataset(dict(music=songs), str(tmp_path / 't'), test_frac=0.25, pitch_kind=kind)
    assert sorted(pj) == sorted(pt) == ['test', 'train']
    for split in pj:
        zj, zt = np.load(pj[split]), np.load(pt[split])
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert zj[k].dtype == zt[k].dtype and np.array_equal(zj[k], zt[k]), (split, k)
    assert (tmp_path / 'j' / 'meta.json').read_text() == (tmp_path / 't' / 'meta.json').read_text()


AUG = {   # tokenizer pitch kind, AugmentedDataset flags
    'degree-key-shift-mixup-crop': ('degree', dict(insert_key=True, pitch_shift=True,
                                                   channel_mixup=True, random_crop=True)),
    'midi-remap-crop': ('midi', dict(random_crop=True)),
    'midi-mixup-swap-crop4': ('midi', dict(channel_mixup='swap', random_crop=4)),
    'step-no-crop-eval': ('step', dict(random_crop=False, dataset_split='test')),
}


def _datasets(kind, flags, songs, max_length=160):
    sd_j = jds.SongDataset.from_songs(songs)
    sd_t = tds.SongDataset.from_songs(songs)
    tj = JTokenizer(pitch_kind=kind, model_max_length=max_length)
    tt = MusicTokenizer(pitch_kind=kind, model_max_length=max_length)
    return (jds.AugmentedDataset(sd_j, tj, seed=5, **flags),
            tds.AugmentedDataset(sd_t, tt, seed=5, **flags))


def _same_batches(a, b, **kw):
    n = 0
    for x, y in zip(a.batches(**kw), b.batches(**kw), strict=True):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k
        n += 1
    return n


@pytest.mark.parametrize('case', sorted(AUG))
def test_augmented_batches_match_jax(case):
    """Two epochs of batches, bit-identical (the same numpy RNG streams)."""
    kind, flags = AUG[case]
    dj, dt = _datasets(kind, flags, synthetic_songs(10, 24, seed=2))
    for seed in (3, 4):
        assert _same_batches(dj, dt, batch_size=3, shuffle=True, seed=seed) == 3
    assert _same_batches(dj, dt, batch_size=4, shuffle=False, drop_last=False) == 3


def test_proportion_mixing_matches_jax():
    songs = synthetic_songs(14, 20, seed=6)
    pairs = [_datasets('midi', dict(random_crop=True, channel_mixup=True), part)
             for part in (songs[:9], songs[9:])]
    mj = jds.ProportionMixingDataset([p[0] for p in pairs], k=4, seed=8)
    mt = tds.ProportionMixingDataset([p[1] for p in pairs], k=4, seed=8)
    for epoch in range(3):
        mj.resample()
        mt.resample()
        assert len(mj) == len(mt) == 8
        assert _same_batches(mj, mt, batch_size=2, shuffle=True, seed=epoch) == 4
    sd = tds.SongDataset.from_songs(songs)
    assert tds.songdataset_to_dicts(sd) == jds.songdataset_to_dicts(jds.SongDataset.from_songs(songs))


BROKEN = [
    samples.gen_broken,
    ('TimeSig_4/4 Tempo_120 <bar> <melody> p_5/4 d_4 p_7/4 d_2 <bass> p_5/2 d_2 '
     '<bar> <melody> p_5/4 d_1 <bass> p_5/2 d_4 </s>'),
    'TimeSig_rare Tempo_120 <bar> p_1/4 d_1 <melody> p_3/4 d_1/2 <tup> p_1/4 p_3/4 d_1 </tup>',
    samples.sample_full_midi,
]


@pytest.mark.parametrize('i', range(len(BROKEN)))
def test_repairs_match_jax(i):
    text = BROKEN[i]
    tok = MusicTokenizer(pitch_kind='midi')
    jv, tv = JTokenizer(pitch_kind='midi').vocab, tok.vocab
    for fn in ('truncate_last_bar', 'repair_generated'):
        assert getattr(teval, fn)(text, tv) == getattr(jeval, fn)(text, jv), fn
    fixed = jeval.repair_generated(text, jv)
    assert teval.repair_bar_durations(fixed, tv) == jeval.repair_bar_durations(fixed, jv)
    assert teval.truncate_first_n_bar(fixed, 1, tv) == jeval.truncate_first_n_bar(fixed, 1, jv)


@pytest.fixture(scope='module')
def generators():
    """A debug TF-XL in f32 with the same parameters in both packages; the
    degree tokenizer (key-augmented) and the midi one."""
    def pair(kind, augment_key, seed):
        cfg = dict(vocab_size=MusicTokenizer(pitch_kind=kind).vocab_size, max_length=96,
                   dtype='float32')
        jm = JTransfoXL(JCfg.from_size('debug', **cfg))
        jp = jm.init(jax.random.PRNGKey(seed))
        tm = TransfoXL(TransfoXLConfig.from_size('debug', **cfg), device='cpu')
        jt = JTokenizer(pitch_kind=kind, model_max_length=96)
        tt = MusicTokenizer(pitch_kind=kind, model_max_length=96)
        return (jeval.MusicGenerator(jm, jt, jp, augment_key=augment_key),
                teval.MusicGenerator(tm, tt, to_torch(jp), augment_key=augment_key))
    return dict(degree=pair('degree', True, 0), midi=pair('midi', False, 1))


@pytest.mark.parametrize('kind,key', [('degree', 'EbMajor'), ('degree', 'dict'), ('midi', None)])
def test_conditional_prompt_matches_jax(generators, extracted, tmp_path, kind, key):
    """From a rendered golden (an MXL path) and from its step token string."""
    song = extracted[2]
    path = str(tmp_path / 'song.mxl')
    JConverter(mode='full').str2score(song['score'], pitch_kind='step', title='t').write_mxl(path)
    key = song['keys'] if key == 'dict' else key
    gj, gt = generators[kind]
    for src in (path, song['score']):
        want = gj.conditional_prompt(src, n_bar=2, key=key)
        assert gt.conditional_prompt(src, n_bar=2, key=key) == want
        assert len(want.split()) > 6


def test_call_renders_what_jax_renders(generators, tmp_path):
    """MusicGenerator.__call__(strategy='greedy') at f32: the sidecars' texts
    (after truncation and the full repair) equal the JAX generator's, and the
    written files parse to the rendered bars; `generate(strategy='beam')`
    gives the JAX generator's tokens."""
    gj, gt = generators['degree']
    outs = {}
    for name, g in (('jax', gj), ('torch', gt)):
        g.out_dir = str(tmp_path / name)
        outs[name] = g(mode='unconditional', strategy='greedy', n_song=2,
                       prompt_args=dict(key='CMajor'), max_length=64, seed=0)
    for rj, rt in zip(outs['jax'], outs['torch']):
        assert rt['text'] == rj['text'] and rt['bar_durations_valid'] == rj['bar_durations_valid']
        with open(rt['mxl'].replace('.mxl', '.json')) as f:
            assert json.load(f)['text'] == rt['text']
        n_bar = rt['text'].split().count('<bar>')
        assert len(parse_file(rt['mxl']).parts[0].measures) == n_bar
        assert os.path.getsize(rt['midi']) > 0
    # beam search (refused until the search slice) gives the JAX generator's tokens
    prompts = [gt.unconditional_prompt(key='CMajor'), gt.unconditional_prompt(key='AMinor')]
    want = gj.generate(prompts, strategy='beam', max_length=48, num_beams=4)
    assert gt.generate(prompts, strategy='beam', max_length=48, num_beams=4) == want
