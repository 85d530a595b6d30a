"""The port's vocabulary copy gives the JAX package's ids and tables exactly."""
import numpy as np
import pytest

import musicnlp_tpu.vocab as jv
import musicnlp_tpu_torch.vocab as tv

SONG = ('TimeSig_4/4 Tempo_120 <bar> <melody> p_7/2_F d_1 p_2/4_C d_1/2 '
        '<bass> p_7/2_F d_2 <bar> <melody> p_r d_4 <bass> p_5/2_E d_4 </s>')


@pytest.mark.parametrize('kind', ['midi', 'degree', 'step'])
def test_vocab_tables_identical(kind):
    a, b = jv.MusicVocabulary(pitch_kind=kind), tv.MusicVocabulary(pitch_kind=kind)
    assert len(a) == len(b)
    assert a.tok2id == b.tok2id
    np.testing.assert_array_equal(np.asarray(a.id_pitch_class_table),
                                  np.asarray(b.id_pitch_class_table))
    np.testing.assert_array_equal(np.asarray(jv.key_inkey_mask), np.asarray(tv.key_inkey_mask))
    assert jv.key_ordinal2str == tv.key_ordinal2str


@pytest.mark.parametrize('kind', ['midi', 'degree'])
def test_tokenizer_roundtrip_identical(kind):
    ja, tb = jv.MusicTokenizer(pitch_kind=kind), tv.MusicTokenizer(pitch_kind=kind)
    assert (ja.pad_token_id, ja.eos_token_id, ja.vocab_size) == \
        (tb.pad_token_id, tb.eos_token_id, tb.vocab_size)
    # a string of this kind's own tokens: every id but the pitches of `SONG`
    toks = [t for t in ja.vocab.tok2id if not t.startswith('[')][:200]
    text = ' '.join(toks)
    ids_a, ids_b = ja.encode(text), tb.encode(text)
    assert list(ids_a) == list(ids_b)
    assert tb.decode(ids_b) == ja.decode(ids_a) == text


def test_step_song_encodes_identically():
    ja, tb = jv.MusicTokenizer(pitch_kind='step'), tv.MusicTokenizer(pitch_kind='step')
    assert list(ja.encode(SONG)) == list(tb.encode(SONG))
