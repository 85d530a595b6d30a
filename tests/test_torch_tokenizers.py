"""The learned tokenizers of the port against the JAX package's, on the
goldens' songs: WordPiece (the shipped 262,144-unit table and tables trained
here by the native library and by its Python copy), pair-merge (trained
here), their identity in a run directory across both packages, and the
string pipeline (`StringAugmentedDataset`, `iter_song_w_all_keys`) batch for
batch."""
import glob
import os

import numpy as np
import pytest

from musicnlp_tpu.preprocess import dataset as jdataset
from musicnlp_tpu.preprocess import transform as jtsf
from musicnlp_tpu.trainer import train as jtrain
from musicnlp_tpu.trainer.pair_merge_tokenizer import (
    PairMergeTokenizer as JPairMerge, PairMergeTokenizerTrainer as JPairMergeTrainer,
)
from musicnlp_tpu.trainer.wordpiece_tokenizer import (
    WordPieceMusicTokenizer as JWordPiece, WordPieceMusicTrainer as JWordPieceTrainer,
)
from musicnlp_tpu_torch import native
from musicnlp_tpu_torch.native._py_wordpiece import PyEncoder, py_train
from musicnlp_tpu_torch.preprocess import dataset as tdataset
from musicnlp_tpu_torch.preprocess import transform as tsf
from musicnlp_tpu_torch.preprocess.music_extractor import MusicExtractor
from musicnlp_tpu_torch.trainer import train as ttrain
from musicnlp_tpu_torch.trainer.pair_merge_tokenizer import (
    PairMergeTokenizer, PairMergeTokenizerTrainer,
)
from musicnlp_tpu_torch.trainer.wordpiece_tokenizer import (
    Score2Word, WordPieceMusicTokenizer, WordPieceMusicTrainer,
)
from musicnlp_tpu_torch.vocab import MusicVocabulary

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLE_262K = os.path.join(REPO, 'artifacts', 'wordpiece_262144_degree.json.gz')
GOLDENS = sorted(glob.glob(os.path.join(REPO, 'tests', 'goldens', 'golden*.musicxml')))


@pytest.fixture(scope='module')
def songs():
    """The goldens extracted by the port with step pitches and their keys."""
    out = []
    for p in GOLDENS:
        o = MusicExtractor(mode='full', with_pitch_step=True)(p, exp='str_join', return_meta=True,
                                                              return_key=True)
        out.append(dict(score=o.score, keys=o.keys, title=o.title))
    return out


@pytest.fixture(scope='module')
def corpora(songs):
    """Training corpora: degree kind (each song in each candidate key, the
    reference's corpus) and midi kind."""
    degree = list(WordPieceMusicTrainer.key_augmented_corpus(songs))
    san, to_midi = tsf.SanitizeRare(), tsf.ToMidiPitch()
    midi = [to_midi(san(s['score'])) for s in songs]
    return dict(degree=degree, midi=midi)


@pytest.fixture(scope='module')
def tables(corpora):
    """(port, JAX) tokenizers of each scheme and pitch kind, trained here."""
    out = {}
    for kind, corpus in corpora.items():
        n = len(MusicVocabulary(pitch_kind=kind))
        out['wordpiece', kind] = (WordPieceMusicTrainer(pitch_kind=kind)(corpus, 2 * n + 300),
                                  JWordPieceTrainer(pitch_kind=kind)(corpus, 2 * n + 300))
        out['pairmerge', kind] = (PairMergeTokenizerTrainer(pitch_kind=kind)(corpus,
                                                                            coverage_ratio=0.9),
                                  JPairMergeTrainer(pitch_kind=kind)(corpus, coverage_ratio=0.9))
    return out


@pytest.fixture(scope='module')
def tok_262k():
    return WordPieceMusicTokenizer.from_file(TABLE_262K), JWordPiece.from_file(TABLE_262K)


@pytest.mark.parametrize('table', ['262k', 'trained'])
def test_wordpiece_ids_and_decodes_equal_jax(table, corpora, tables, tok_262k):
    """Ids, unit strings and decodes of the goldens' degree texts equal the
    JAX package's; every text round-trips."""
    tok, jtok = tok_262k if table == '262k' else tables['wordpiece', 'degree']
    assert tok.vocab_size == jtok.vocab_size == (262144 if table == '262k' else tok.vocab_size)
    assert tok.units == jtok.units
    for text in corpora['degree']:
        ids = tok.encode(text)
        assert ids == jtok.encode(text)
        assert tok.tokenize(text) == jtok.tokenize(text)
        assert tok.decode(ids) == jtok.decode(ids) == text
        assert tok.ids2pitches(ids) == jtok.ids2pitches(ids)
        padded = tok.encode(text, padding='max_length', truncation=True, max_length=300)
        assert padded == jtok.encode(text, padding='max_length', truncation=True, max_length=300)
    assert tok(corpora['degree'][:2]) == jtok(corpora['degree'][:2])


def test_native_tables_equal_python_tables(corpora, tables):
    """The native trainer's table equals `py_train`'s (the plain version)
    and the JAX package's, for both pitch kinds."""
    s2w = Score2Word(MusicVocabulary(pitch_kind='midi'))
    words = {}
    for text in corpora['midi']:
        for w in s2w(text):
            key = tuple(s2w.vocab.t2i(t) for t in w)
            words[key] = words.get(key, 0) + 1
    n = len(s2w.vocab)
    plain = py_train([list(w) for w in words], list(words.values()), n, 300)
    for kind in ('degree', 'midi'):
        tok, jtok = tables['wordpiece', kind]
        assert tok.units == jtok.units and tok.meta == jtok.meta
    assert [(c, tuple(s)) for c, s in plain] == tables['wordpiece', 'midi'][0].units


@pytest.mark.parametrize('table', ['262k', 'trained'])
def test_python_encoder_equals_native(table, corpora, tables, tok_262k):
    tok = tok_262k[0] if table == '262k' else tables['wordpiece', 'degree'][0]
    plain = PyEncoder(tok.units)
    for text in corpora['degree']:
        for w in tok.s2w(text):
            syms = [tok.vocab.t2i(t) for t in w]
            assert tok._enc.encode(syms) == plain.encode(syms)


@pytest.mark.parametrize('kind', ['degree', 'midi'])
def test_pair_merge_equals_jax(kind, corpora, tables, tmp_path):
    """Pair-merge trained here: the same merged units, ids and decodes, also
    after a round trip through each package's `from_file`."""
    tok, jtok = tables['pairmerge', kind]
    assert tok.meta == jtok.meta and tok.vocab_size == jtok.vocab_size
    PairMergeTokenizerTrainer(pitch_kind=kind)(corpora[kind], coverage_ratio=0.9,
                                               save=str(tmp_path / 'pm.json'))
    assert PairMergeTokenizer.from_file(str(tmp_path / 'pm.json')).meta == \
        JPairMerge.from_file(str(tmp_path / 'pm.json')).meta == tok.meta
    assert tok.added_tok2id and len(tok.added_tok2id) == tok.meta['n_added']
    for text in corpora[kind]:
        ids = tok.encode(text)
        assert ids == jtok.encode(text)
        assert max(ids) >= len(tok.vocab)          # merged ids are used
        assert tok.decode(ids) == jtok.decode(ids) == text
        assert tok.ids2pitches(ids) == jtok.ids2pitches(ids)
    raw = 'TimeSig_4/4 Tempo_120 <bar> d_1 d_1 </s>'     # not a song: base tokens
    assert tok.encode(raw) == jtok.encode(raw)


@pytest.mark.parametrize('scheme', ['wordpiece', 'pairmerge'])
def test_describe_rebuild_round_trip(scheme, tables, corpora, tmp_path):
    """A run directory's tokenizer identity rebuilds the same tokenizer, in
    the port and across the two packages."""
    tok, jtok = tables[scheme, 'degree']
    tok.model_max_length = jtok.model_max_length = 512
    meta = dict(tokenizer=ttrain.describe_tokenizer(tok, str(tmp_path / 'port')))
    jmeta = dict(tokenizer=jtrain.describe_tokenizer(jtok, str(tmp_path / 'jax')))
    assert meta == jmeta
    assert (tmp_path / 'port' / 'tokenizer.json').read_text() == \
        (tmp_path / 'jax' / 'tokenizer.json').read_text()
    for back in (ttrain.rebuild_tokenizer(meta, str(tmp_path / 'port')),
                 ttrain.rebuild_tokenizer(jmeta, str(tmp_path / 'jax'))):
        assert type(back) is type(tok) and back.model_max_length == 512
        assert back.meta == tok.meta
        assert back.encode(corpora['degree'][0]) == tok.encode(corpora['degree'][0])
    again = jtrain.rebuild_tokenizer(meta, str(tmp_path / 'port'))
    assert again.encode(corpora['degree'][1]) == tok.encode(corpora['degree'][1])


def test_wiring_reads_the_262k_table():
    """get_model_n_tokenizer with a learned scheme: the model's vocab is the
    table's, as in the JAX package; an unknown scheme is refused."""
    model, tok = ttrain.get_model_n_tokenizer('transf-xl', 'debug', tokenizer_scheme='wordpiece',
                                              tokenizer_path=TABLE_262K, device='cpu')
    jmodel, jtok = jtrain.get_model_n_tokenizer('transf-xl', 'debug',
                                                tokenizer_scheme='wordpiece',
                                                tokenizer_path=TABLE_262K)
    assert model.cfg.vocab_size == jmodel.cfg.vocab_size == tok.vocab_size == 262144
    assert tok.model_max_length == jtok.model_max_length == 64
    with pytest.raises(ValueError, match='scheme'):
        ttrain.get_model_n_tokenizer('transf-xl', 'debug', tokenizer_scheme='bpe', device='cpu')


STRING_CASES = [
    ('wordpiece', 'degree', dict(random_crop=True, insert_key=True, pitch_shift=True,
                                 channel_mixup=True)),
    ('wordpiece', 'degree', dict(random_crop=False, insert_key=True, pitch_shift=True)),
    ('wordpiece', 'midi', dict(random_crop=True, channel_mixup=True)),
    ('wordpiece', 'midi', dict(random_crop=False)),
    ('pairmerge', 'degree', dict(random_crop=True, insert_key=True, pitch_shift=True,
                                 channel_mixup=True)),
    ('pairmerge', 'midi', dict(random_crop=False, channel_mixup=True)),
]


@pytest.mark.parametrize('scheme,kind,aug', STRING_CASES)
def test_string_dataset_batches_bit_identical(scheme, kind, aug, songs, tables):
    """Same songs, same seed: every batch of an epoch equals the JAX
    package's, array for array (the transforms draw from one
    np.random.default_rng(seed) in the same order)."""
    tok, jtok = tables[scheme, kind]
    tok.model_max_length = jtok.model_max_length = 256
    ds = tdataset.StringAugmentedDataset(songs, tok, seed=5, **aug)
    jds = jdataset.StringAugmentedDataset(songs, jtok, seed=5, **aug)
    assert len(ds) == len(jds) == len(songs)
    n = 0
    for epoch in range(2):
        for a, b in zip(ds.batches(2, shuffle=True, seed=epoch),
                        jds.batches(2, shuffle=True, seed=epoch)):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
            assert ((a['labels'] == -100) == (a['input_ids'] == tok.pad_token_id)).all()
            n += 1
    assert n == 2 * (len(songs) // 2)


def test_iter_song_w_all_keys_matches(songs):
    got = tdataset.iter_song_w_all_keys(songs)
    want = jdataset.iter_song_w_all_keys(songs)
    assert got.total == want.total == sum(len(s['keys']) for s in songs)
    assert list(got.generator) == list(want.generator)
    ak, san = jtsf.AugmentKey(), jtsf.SanitizeRare()
    assert list(WordPieceMusicTrainer.key_augmented_corpus(songs)) == \
        list(JWordPieceTrainer.key_augmented_corpus(songs)) == \
        [ak((san(s), k)) for s, k in jdataset.iter_song_w_all_keys(songs).generator]


def test_unbuildable_wordpiece_library_raises(tmp_path, monkeypatch):
    """No fallback: a WordPiece source g++ refuses raises with g++'s output
    when a tokenizer is built or trained."""
    (tmp_path / 'wordpiece.cpp').write_text('this is not C++\n')
    monkeypatch.setattr(native, 'SRC_DIR', tmp_path)
    monkeypatch.setattr(native, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(native, '_LIBS', {})
    meta = dict(units=[[0, [0]], [1, [0]]], music_vocab=dict(precision=5, pitch_kind='midi'))
    with pytest.raises(RuntimeError, match='g\\+\\+ failed for native/wordpiece.cpp'):
        WordPieceMusicTokenizer(meta)
    with pytest.raises(RuntimeError, match='g\\+\\+ failed'):
        WordPieceMusicTrainer(pitch_kind='midi')(['TimeSig_4/4 Tempo_120 </s>'], 2000)
