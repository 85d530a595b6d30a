"""The legacy melody stack of the port (ROADMAP A.8) against the JAX
package's, on the CPU: grid ids and `grid_decode` on the goldens and on
hand-built scores (identical), `MelodyGridDataset` as a torch Dataset, and
`PitchEmbedding` from the same seed (emb_in, emb_out and the epoch losses
within 1e-5; each package loads the other's `.npz`)."""
import glob
import os
from fractions import Fraction

import numpy as np
import pytest
import torch

from musicnlp_tpu import io as jio
from musicnlp_tpu.preprocess import (
    GridVocab as JGridVocab, MelodyGridDataset as JGridDataset,
    MelodyGridExtractor as JGridExtractor, grid_decode as j_grid_decode,
)
from musicnlp_tpu.trainer import PitchEmbedding as JPitchEmbedding
from musicnlp_tpu_torch import io as tio
from musicnlp_tpu_torch.io import read_midi
from musicnlp_tpu_torch.preprocess import (
    GridVocab, MelodyGridDataset, MelodyGridExtractor, grid_decode,
)
from musicnlp_tpu_torch.trainer import PitchEmbedding

GOLDENS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), 'goldens', 'golden*.*')))
W2V_TOL = 1e-5           # f32 SGD, gradients summed in other orders (gathers vs one-hot)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dump(score):
    """A decoded score as plain values, for comparison across packages."""
    out = []
    for part in score.parts:
        for m in part.measures:
            elms = [(type(e).__name__, getattr(getattr(e, 'pitch', None), 'midi', None),
                     Fraction(e.dur), Fraction(e.offset)) for e in m.elements]
            out.append((part.name, m.number, m.time_sig, m.tempo, Fraction(m.offset), elms))
    return out


def _score(io, bars, ts=(4, 4)):
    """One part of the given bars, built with `io`'s own classes; bars hold
    ('n', pitch, dur, offset[, tm]) or ('r', dur, offset)."""
    measures = []
    for i, bar in enumerate(bars):
        elms = [io.Note(pitch=e[1], duration=e[2], offset=e[3], **({'tm': e[4]} if len(e) > 4
                                                                   else {}))
                if e[0] == 'n' else io.Rest(duration=e[1], offset=e[2]) for e in bar]
        measures.append(io.Measure(number=i, elements=elms, time_sig=ts if i == 0 else None,
                                   tempo=120.0 if i == 0 else None))
    return io.Score(title='t', parts=[io.Part(name='P1', measures=measures)])


TRIP = [('n', 60 + i, Fraction(1, 3), Fraction(i, 3), (3, 2)) for i in range(3)]
BARS = {
    'simple': [[('n', 60, 1, 0), ('r', 1, 1), ('n', 64, 2, 2)], [('n', 67, 4, 0)]],
    'triplet': [TRIP + [('r', 3, 1)]],
    'merged-triplet': [[('n', p, Fraction(1, 3), Fraction(i, 3), (3, 2))
                        for i, p in enumerate((60, 60, 62))] + [('r', 3, 1)]],
    'triplet-after-note': [[('n', 60, 1, 0)] + [('n', p, Fraction(1, 3), 1 + Fraction(i, 3),
                                                 (3, 2)) for i, p in enumerate((60, 64, 67))]
                           + [('r', 2, 2)]],
    'three-bars': [[('n', 60 + 4 * i, 1, i) for i in range(4)],
                   [('r', 1, 0), ('n', 65, Fraction(1, 2), 1),
                    ('n', 69, Fraction(5, 2), Fraction(3, 2))], [('n', 74, 4, 0)]],
}


def test_grid_vocab_equals_jax():
    assert (GridVocab.SEP, GridVocab.TRIP, GridVocab.PAD, GridVocab.REST, GridVocab.SIZE) == \
        (JGridVocab.SEP, JGridVocab.TRIP, JGridVocab.PAD, JGridVocab.REST, JGridVocab.SIZE)
    assert [GridVocab.id2str(i) for i in range(GridVocab.SIZE)] == \
        [JGridVocab.id2str(i) for i in range(JGridVocab.SIZE)]


@pytest.mark.parametrize('path', GOLDENS, ids=os.path.basename)
def test_goldens_encode_and_decode_as_jax(path, tmp_path):
    """Grid ids (precision 5 and 4) and their decoded scores are identical;
    the decoded score's MIDI file is byte-identical and re-encodes to the ids."""
    for prec in (5, 4):
        ids = MelodyGridExtractor(precision=prec)(path)
        want = JGridExtractor(precision=prec)(path)
        assert ids.dtype == want.dtype and ids.tolist() == want.tolist()
        assert ids.max() >= GridVocab.N_SPECIAL
        got, ref = grid_decode(ids, precision=prec), j_grid_decode(want, precision=prec)
        assert _dump(got) == _dump(ref)
    got.write_midi(str(tmp_path / 'a.mid'))
    ref.write_midi(str(tmp_path / 'b.mid'))
    assert (tmp_path / 'a.mid').read_bytes() == (tmp_path / 'b.mid').read_bytes()
    assert MelodyGridExtractor(precision=4)(read_midi(str(tmp_path / 'a.mid'))).tolist() == \
        ids.tolist()


@pytest.mark.parametrize('name', sorted(BARS))
def test_hand_built_scores_encode_and_decode_as_jax(name):
    ids = MelodyGridExtractor()(_score(tio, BARS[name]))
    want = JGridExtractor()(_score(jio, BARS[name]))
    assert ids.tolist() == want.tolist()
    assert _dump(grid_decode(ids)) == _dump(j_grid_decode(want))


def test_dataset_is_a_torch_dataset_with_jax_items():
    songs = [[128, 129, 130], [140], [150, 151]]
    for pad in (True, False):
        ds, ref = MelodyGridDataset(songs, pad=pad), JGridDataset(songs, pad=pad)
        assert isinstance(ds, torch.utils.data.Dataset) and len(ds) == len(ref) == 3
        for i in range(3):
            assert ds[i].dtype == np.int32 and ds[i].tolist() == ref[i].tolist()
    batch = next(iter(torch.utils.data.DataLoader(MelodyGridDataset(songs), batch_size=3)))
    assert batch.tolist() == JGridDataset(songs).ids.tolist()


def _communities():
    rng = np.random.default_rng(0)
    a = [GridVocab.pitch2id(p) for p in (60, 62, 64, 65, 67)]
    b = [GridVocab.pitch2id(p) for p in (90, 92, 94, 96, 98)]
    return [rng.choice(c, size=60).tolist() for _ in range(15) for c in (a, b)]


def _golden_grids():
    return [JGridExtractor()(p) for p in GOLDENS if p.endswith('.musicxml')]


@pytest.mark.parametrize('corpus,kw,train', [
    ('goldens', dict(vector_size=16, window=4, negatives=4, lr=0.1, seed=1),
     dict(epochs=2, batch_size=512)),
    ('communities', dict(vector_size=16, window=4, negatives=4, lr=0.1, seed=1),
     dict(epochs=3, batch_size=512)),
    ('small', dict(vector_size=4, window=2, negatives=2, lr=0.05, seed=0),
     dict(epochs=2, batch_size=4096)),
])
def test_pitch_embedding_matches_jax(corpus, kw, train, tmp_path):
    """The same seed draws the same init, permutations and negatives, so the
    embeddings and every epoch's mean loss agree; each package loads the
    other's file."""
    songs = dict(goldens=_golden_grids, communities=_communities,
                 small=lambda: [[130, 131, 132, 133]] * 3)[corpus]()
    pe, ref = PitchEmbedding(device='cpu', **kw), JPitchEmbedding(**kw)
    emb, want = pe(songs, **train), ref(songs, **train)
    assert emb.shape == want.shape == (GridVocab.SIZE, kw['vector_size'])
    scale = float(np.abs(want).max())
    assert float(np.abs(emb - want).max()) <= W2V_TOL * scale
    assert float(np.abs(pe.emb_out - ref.emb_out).max()) <= \
        W2V_TOL * float(np.abs(ref.emb_out).max())
    np.testing.assert_allclose(pe.losses, ref.losses, rtol=W2V_TOL)
    assert len(pe.losses) == train['epochs']

    pe.save(str(tmp_path / 'torch.npz'))
    ref.save(str(tmp_path / 'jax.npz'))
    theirs = PitchEmbedding.load(str(tmp_path / 'jax.npz'), device='cpu')
    mine = JPitchEmbedding.load(str(tmp_path / 'torch.npz'))
    np.testing.assert_array_equal(theirs.emb_in, ref.emb_in)
    np.testing.assert_array_equal(mine.emb_in, pe.emb_in)
    assert (theirs.dim, theirs.window, theirs.k, theirs.losses) == \
        (ref.dim, ref.window, ref.k, ref.losses)
    assert mine.losses == pe.losses
    a, b = songs[0][0], songs[0][1]
    assert theirs.similarity(a, b) == ref.similarity(a, b)


def test_pitch_embedding_structures_and_refuses():
    """Co-occurring pitches embed closer than never-co-occurring ones; an
    empty corpus and a query before training raise."""
    pe = PitchEmbedding(vector_size=16, window=4, negatives=4, lr=0.1, seed=1, device='cpu')
    pe(_communities(), epochs=3, batch_size=512)
    a, b = GridVocab.pitch2id(60), GridVocab.pitch2id(62)
    assert pe.losses[-1] < pe.losses[0]
    assert pe.similarity(a, b) > pe.similarity(a, GridVocab.pitch2id(92))
    assert set(i for i, _ in pe.most_similar(a, topn=4)) & {b, GridVocab.pitch2id(64)}
    with pytest.raises(ValueError, match='no training pairs'):
        PitchEmbedding(device='cpu')([[130]])
    with pytest.raises(ValueError, match='train'):
        PitchEmbedding(device='cpu').save('unused.npz')
