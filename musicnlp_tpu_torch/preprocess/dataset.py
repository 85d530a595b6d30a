"""Copy of `musicnlp_tpu/preprocess/dataset.py` (pure Python / numpy): the port keeps its own copy
and imports nothing from the JAX package; only the import paths differ
(held against the original by tests/test_torch_pipeline.py and, for the
learned tokenizers' string pipeline, tests/test_torch_tokenizers.py).

Training dataset pipeline: columnar token arrays + augmentation chain.

Rebuild of the reference data loading (reference musicnlp/preprocess/dataset.py):
`load_songs` (:69), `AugmentedDataset` (:208-365) applying the transform chain
per sample, and `ProportionMixingDataset` (:368-453) with T5
examples-proportional mixing and per-epoch subset resampling.

TPU-native design: songs are *encoded once* into int32 id arrays with
precomputed bar-start indices and 24-dim key-score vectors (columnar
materialization, SURVEY.md §7 step 3-4).  The per-step augmentations then run
in id space: random crop is an index slice via stored bar offsets, key
insert + degree pitch shift is ONE table gather (`build_step2degree_table`),
and every sample leaves as a fixed-shape `(input_ids, labels, key_scores)`
record ready for device batching - no per-sample string processing on the hot
path (the reference's stated CPU bottleneck, SURVEY.md §3.2).
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

from musicnlp_tpu_torch.preprocess import transform as tsf
from musicnlp_tpu_torch.vocab import (
    MusicTokenizer, MusicVocabulary, N_KEY, key_ordinal2str, key_str2ordinal,
)

__all__ = [
    'load_songs', 'EncodedSong', 'SongDataset', 'AugmentedDataset',
    'StringAugmentedDataset', 'ProportionMixingDataset', 'iter_song_w_all_keys',
    'songdataset_to_dicts',
]


def songdataset_to_dicts(sd: 'SongDataset') -> List[Dict]:
    """Decode a columnar SongDataset back to raw song dicts
    ({'score', 'keys', 'title'}) -- the input form of the learned-tokenizer
    STRING pipeline (StringAugmentedDataset), which must re-run transforms on
    token text rather than on compiled base-vocab id tables."""
    vocab = MusicVocabulary(pitch_kind=sd.pitch_kind)
    out = []
    for s in sd.songs:
        keys = {key_ordinal2str[i]: float(v)
                for i, v in enumerate(s.key_scores) if v >= 0}
        out.append(dict(score=' '.join(vocab.i2t(int(i)) for i in s.ids),
                        keys=keys, title=s.title))
    return out


def load_songs(*paths: str) -> List[Dict]:
    """Load extraction-output JSONs (each: {music: [...]} or a list of songs)."""
    songs: List[Dict] = []
    for p in paths:
        with open(p) as f:
            d = json.load(f)
        if isinstance(d, dict):
            d = d.get('music') or d.get('songs') or [d]
        songs.extend(d)
    return songs


@dataclass
class _AllKeysOutput:
    generator: Iterator
    total: int


def iter_song_w_all_keys(songs: List[Dict]) -> _AllKeysOutput:
    """Yield (score, key) for each song x candidate key (reference dataset.py:136)."""
    def gen():
        for s in songs:
            for k in s['keys']:
                yield s['score'], k
    total = sum(len(s['keys']) for s in songs)
    return _AllKeysOutput(generator=gen(), total=total)


@dataclass
class EncodedSong:
    """Columnar record: one song encoded once at materialization time."""
    ids: np.ndarray          # int32[n] step-kind sanitized token ids
    bar_starts: np.ndarray   # int32[n_bar] indices of <bar> tokens in `ids`
    key_scores: np.ndarray   # float32[24], -1 where key absent
    title: str = ''


class SongDataset:
    """Columnar store of encoded songs (the HF-dataset-on-disk equivalent)."""

    def __init__(self, songs: List[EncodedSong], pitch_kind: str = 'step'):
        self.songs = songs
        self.pitch_kind = pitch_kind

    def __len__(self):
        return len(self.songs)

    def __getitem__(self, i: int) -> EncodedSong:
        return self.songs[i]

    @classmethod
    def from_songs(cls, songs: List[Dict], vocab: MusicVocabulary = None) -> 'SongDataset':
        """Encode raw song dicts ({'score': str, 'keys': {...}, 'title': str})."""
        vocab = vocab or MusicVocabulary(pitch_kind='step')
        bar_id = vocab.tok2id[vocab.start_of_bar]
        rare_ids = {vocab.tok2id[t] for t in MusicVocabulary.rare_tokens
                    if t in vocab.tok2id}
        out = []
        for s in songs:
            ids = np.array([vocab.t2i(t) for t in s['score'].split()], dtype=np.int32)
            n_rare = int(np.isin(ids, list(rare_ids)).sum())
            if n_rare > 0.1 * len(ids):
                raise ValueError(
                    f'{n_rare}/{len(ids)} tokens of {s.get("title")!r} sanitized '
                    f'to rare -- corpus pitch kind likely mismatches the '
                    f'{vocab.pitch_kind!r} vocabulary')
            bar_starts = np.where(ids == bar_id)[0].astype(np.int32)
            keys = s.get('keys') or {}
            ks = np.full(N_KEY, -1.0, dtype=np.float32)
            for k, v in keys.items():
                if v is not None:
                    ks[key_str2ordinal[k]] = v
            out.append(EncodedSong(ids=ids, bar_starts=bar_starts, key_scores=ks,
                                   title=s.get('title', '')))
        return cls(out, pitch_kind=vocab.pitch_kind)

    # npz persistence -------------------------------------------------------
    def save(self, path: str):
        lens = np.array([len(s.ids) for s in self.songs], dtype=np.int64)
        bar_lens = np.array([len(s.bar_starts) for s in self.songs], dtype=np.int64)
        np.savez_compressed(
            path,
            ids=np.concatenate([s.ids for s in self.songs]) if self.songs else np.array([], np.int32),
            lens=lens,
            bar_starts=np.concatenate([s.bar_starts for s in self.songs]) if self.songs else np.array([], np.int32),
            bar_lens=bar_lens,
            key_scores=np.stack([s.key_scores for s in self.songs]) if self.songs else np.zeros((0, N_KEY), np.float32),
            titles=np.array([s.title for s in self.songs]),
            pitch_kind=np.array(self.pitch_kind),
        )

    @classmethod
    def load(cls, path: str) -> 'SongDataset':
        z = np.load(path, allow_pickle=False)
        songs = []
        id_off = bar_off = 0
        for i, (n, nb) in enumerate(zip(z['lens'], z['bar_lens'])):
            songs.append(EncodedSong(
                ids=z['ids'][id_off:id_off + n],
                bar_starts=z['bar_starts'][bar_off:bar_off + nb],
                key_scores=z['key_scores'][i],
                title=str(z['titles'][i]),
            ))
            id_off += n
            bar_off += nb
        return cls(songs, pitch_kind=str(z['pitch_kind']))


class AugmentedDataset:
    """Map-style dataset with the id-space augmentation chain.

    Emits dict(input_ids int32[L], labels int32[L], key_scores float32[24]).
    Labels equal input ids with pads masked to -100 (PT_LOSS_PAD semantics,
    reference util/train/train_util_wrap.py:22); the model shifts internally.
    """
    PT_LOSS_PAD = -100

    def __init__(
            self, dataset: SongDataset, tokenizer: MusicTokenizer = None,
            random_crop: Union[bool, int] = True, min_seg_length: int = 16,
            insert_key: bool = False, pitch_shift: bool = False,
            channel_mixup: Union[bool, str] = False, mode: str = 'full',
            dataset_split: str = 'train', seed: int = 77,
            to_midi_pitch: bool = None,
    ):
        self.dset = dataset
        self.tokenizer = tokenizer
        self.max_length = tokenizer.model_max_length
        self.random_crop = random_crop
        self.crop_mult = 1 if random_crop is True else int(random_crop or 1)
        self.min_seg_length = min_seg_length
        self.insert_key = insert_key
        self.pitch_shift = pitch_shift
        self.channel_mixup = channel_mixup
        self.mode = mode
        self.dataset_split = dataset_split
        self.rng = np.random.default_rng(seed)

        pk = tokenizer.pitch_kind
        src_kind = getattr(dataset, 'pitch_kind', 'step')
        # remap only when the materialized ids are step-kind and the tokenizer
        # is midi-kind; a dataset already materialized in the tokenizer's kind
        # must NOT be remapped again (midi ids gathered through the step->midi
        # table are garbage -- durations land on pitch ids)
        self.to_midi_pitch = (pk == 'midi' and src_kind == 'step') \
            if to_midi_pitch is None else to_midi_pitch
        if src_kind not in (pk, 'step'):
            raise ValueError(
                f'dataset pitch kind {src_kind!r} incompatible with '
                f'{pk!r} tokenizer: materialize the dataset as step '
                f'(remapped on the fly) or as the tokenizer kind')
        if pk == 'degree' and src_kind == 'step' \
                and not (insert_key and pitch_shift):
            # without the key-conditioned shift, step ids would index
            # valid-but-WRONG tokens of the degree vocab and train a garbage
            # model with no diagnostic
            raise ValueError(
                "a degree-kind tokenizer over a step-kind dataset needs the "
                "key-conditioned pitch shift: pass insert_key=True, "
                "pitch_shift=True (CLI: train --insert-key), or use a "
                "midi/step tokenizer")

        # dense tables compiled once (the whole augmentation chain becomes gathers)
        self._vocab_step = MusicVocabulary(pitch_kind='step')
        self._s2d: Optional[np.ndarray] = None
        self._s2m: Optional[np.ndarray] = None
        if insert_key and pitch_shift:
            assert pk == 'degree'
            assert src_kind == 'step', \
                'key-augmented (degree) datasets must be materialized step-kind'
            self._s2d = tsf.build_step2degree_table(self._vocab_step, tokenizer.vocab)
            self._key_tok_ids = np.array([
                tokenizer.vocab.tok2id[f'Key_{key_ordinal2str[i]}'] for i in range(N_KEY)
            ], dtype=np.int32)
        elif self.to_midi_pitch:
            assert src_kind == 'step', \
                'to_midi_pitch remaps step-kind ids; dataset is ' + src_kind
            self._s2m = tsf.build_step2midi_table(self._vocab_step, tokenizer.vocab)
        self._mixer = None
        if channel_mixup:
            mix_mode = 'full' if channel_mixup is True else channel_mixup
            self._mixer = _IdChannelMixer(tokenizer.vocab, mode=mix_mode, rng=self.rng)
        self._pad_id = tokenizer.pad_token_id
        # crop-insert id in the SOURCE id space (remap tables apply after)
        src_vocab = self._vocab_step if src_kind == 'step' else tokenizer.vocab
        self._omit_id_src = src_vocab.tok2id[src_vocab.omitted_segment]

    def __len__(self):
        return len(self.dset)

    def _sample_key_ordinal(self, key_scores: np.ndarray) -> int:
        w = np.where(key_scores > 0, key_scores, 0.0).astype(np.float64)
        tot = w.sum()
        if tot <= 0:
            return int(self.rng.integers(N_KEY))
        return int(self.rng.choice(N_KEY, p=w / tot))

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        song = self.dset[idx]
        ids = song.ids
        # 1. random crop via stored bar offsets (train only, reference dataset.py:333)
        if self.random_crop and self.dataset_split == 'train':
            n_bar = len(song.bar_starts)
            if n_bar > self.min_seg_length:
                high = n_bar - self.min_seg_length
                if self.crop_mult == 1:
                    k = int(self.rng.integers(0, high + 1))
                else:
                    k = (int(self.rng.integers(0, high // self.crop_mult + 1)) * self.crop_mult
                         if high >= self.crop_mult else 0)
                if k:
                    ids = np.concatenate([
                        ids[:song.bar_starts[0]],
                        np.array([self._omit_id_src], dtype=np.int32),
                        ids[song.bar_starts[k]:],
                    ])
        # 2. pitch-kind mapping: ONE gather
        if self._s2d is not None:
            ordinal = self._sample_key_ordinal(song.key_scores)
            ids = self._s2d[ordinal][ids]
            # insert the key token at position 2
            ids = np.concatenate([ids[:2], self._key_tok_ids[ordinal:ordinal + 1], ids[2:]])
        elif self._s2m is not None:
            ids = self._s2m[ids]
        # 3. channel mixup in id space
        if self._mixer is not None:
            ids = self._mixer(ids)
        # 4. pad/truncate to fixed shape
        ids = ids[:self.max_length].astype(np.int32)
        n = len(ids)
        if n < self.max_length:
            ids = np.pad(ids, (0, self.max_length - n), constant_values=self._pad_id)
        labels = np.where(ids == self._pad_id, AugmentedDataset.PT_LOSS_PAD, ids).astype(np.int32)
        return dict(input_ids=ids, labels=labels, key_scores=song.key_scores)

    def batches(self, batch_size: int, shuffle: bool = True,
                seed: int = None, drop_last: bool = True,
                shard: Optional[Tuple[int, int]] = None,
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Fixed-shape batches.  `shard=(host_id, n_hosts)` yields only this
        host's slice of each GLOBAL batch (multi-host input pipelines load
        per-process; the same seed keeps the global order consistent)."""
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed if seed is not None else self.rng.integers(2**31)).shuffle(order)
        for i in range(0, len(order) - (batch_size - 1 if drop_last else 0), batch_size):
            idxs = order[i:i + batch_size]
            if len(idxs) < batch_size and drop_last:
                break
            if shard is not None:
                hid, n_hosts = shard
                assert batch_size % n_hosts == 0
                per = batch_size // n_hosts
                idxs = idxs[hid * per:(hid + 1) * per]
            items = [self[int(j)] for j in idxs]
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}


class _IdChannelMixer:
    """Channel mixup directly on id arrays (melody/bass interleave per bar)."""

    def __init__(self, vocab: MusicVocabulary, mode: str = 'full',
                 rng: np.random.Generator = None):
        self.vocab = vocab
        self.mode = mode
        self.rng = rng or np.random.default_rng()
        self.id_bar = vocab.tok2id[vocab.start_of_bar]
        self.id_mel = vocab.tok2id[vocab.start_of_melody]
        self.id_bass = vocab.tok2id[vocab.start_of_bass]
        self.id_eos = vocab.tok2id[vocab.end_of_song]
        self.id_tup = vocab.tok2id[vocab.start_of_tuplet]
        self.id_etup = vocab.tok2id[vocab.end_of_tuplet]
        tt = vocab.id_type_table
        from musicnlp_tpu_torch.vocab import VocabType
        self.is_pitch = tt == VocabType.pitch.value

    def _bar_elements(self, ids: np.ndarray) -> List[Tuple[int, np.ndarray]]:
        """Split one bar's ids into (channel, element-ids) units."""
        out = []
        c = 0
        i = 0
        n = len(ids)
        while i < n:
            t = int(ids[i])
            if t == self.id_mel:
                c = 0
                i += 1
            elif t == self.id_bass:
                c = 1
                i += 1
            elif t == self.id_tup:
                j = i + 1
                while j < n and ids[j] != self.id_etup:
                    j += 1
                out.append((c, ids[i:j + 1]))
                i = j + 1
            else:  # note: pitch + duration
                out.append((c, ids[i:i + 2]))
                i += 2
        return out

    def __call__(self, ids: np.ndarray) -> np.ndarray:
        bar_idx = np.where(ids == self.id_bar)[0]
        if len(bar_idx) == 0:
            return ids
        head = ids[:bar_idx[0]]
        has_eos = ids[-1] == self.id_eos
        body_end = len(ids) - 1 if has_eos else len(ids)
        pieces: List[np.ndarray] = [head]
        bounds = list(bar_idx) + [body_end]
        for b0, b1 in zip(bounds[:-1], bounds[1:]):
            bar = ids[b0 + 1:b1]
            elems = self._bar_elements(bar)
            mel = [e for c, e in elems if c == 0]
            bass = [e for c, e in elems if c == 1]
            mixed: List[np.ndarray] = [np.array([self.id_bar], dtype=np.int32)]
            if self.mode == 'swap' and self.rng.integers(2) == 0:
                mel, bass = bass, mel
                first_id, second_id = self.id_bass, self.id_mel
                mixed.append(np.array([first_id], dtype=np.int32))
                mixed += mel
                mixed.append(np.array([second_id], dtype=np.int32))
                mixed += bass
            elif self.mode == 'swap':
                mixed.append(np.array([self.id_mel], dtype=np.int32))
                mixed += mel
                mixed.append(np.array([self.id_bass], dtype=np.int32))
                mixed += bass
            else:
                im = ib = 0
                prev = -1
                n_m, n_b = len(mel), len(bass)
                thresh = n_m / (n_m + n_b) if (n_m + n_b) else 0.5
                while im < n_m and ib < n_b:
                    add_mel = self.rng.random() < thresh
                    marker = self.id_mel if add_mel else self.id_bass
                    if marker != prev:
                        mixed.append(np.array([marker], dtype=np.int32))
                    mixed.append(mel[im] if add_mel else bass[ib])
                    if add_mel:
                        im += 1
                    else:
                        ib += 1
                    prev = marker
                if im < n_m:
                    if prev != self.id_mel:
                        mixed.append(np.array([self.id_mel], dtype=np.int32))
                    mixed += mel[im:]
                elif ib < n_b:
                    if prev != self.id_bass:
                        mixed.append(np.array([self.id_bass], dtype=np.int32))
                    mixed += bass[ib:]
            pieces.append(np.concatenate(mixed) if mixed else np.array([], np.int32))
        if has_eos:
            pieces.append(np.array([self.id_eos], dtype=np.int32))
        return np.concatenate(pieces).astype(np.int32)


class ProportionMixingDataset:
    """T5 examples-proportional mixing with artifact cap K and per-epoch subset
    resampling (reference dataset.py:368-453)."""

    def __init__(self, dataset_list: List[AugmentedDataset] = None, k: int = None,
                 seed: int = 77):
        assert k is not None
        self.dsets = dataset_list
        self.k = k
        self.rng = np.random.default_rng(seed)
        self.dset_szs = [min(len(d), k) for d in self.dsets]
        self.sz = sum(self.dset_szs)
        self._sampled_idxs: List[Optional[np.ndarray]] = [None] * len(self.dsets)
        self.resample()

    def resample(self):
        """Resample the k-subset of each larger-than-k dataset (per epoch)."""
        for i, d in enumerate(self.dsets):
            if len(d) > self.k:
                self._sampled_idxs[i] = self.rng.choice(len(d), size=self.k, replace=False)

    def __len__(self):
        return self.sz

    def __getitem__(self, idx: int):
        assert 0 <= idx < self.sz
        for i, sz in enumerate(self.dset_szs):
            if idx < sz:
                if self._sampled_idxs[i] is not None:
                    idx = int(self._sampled_idxs[i][idx])
                return self.dsets[i][idx]
            idx -= sz
        raise IndexError

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = None,
                drop_last: bool = True,
                shard: Optional[Tuple[int, int]] = None,
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Fixed-shape batches; `shard=(host_id, n_hosts)` yields this host's
        slice of each global batch (same semantics as AugmentedDataset)."""
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed if seed is not None else self.rng.integers(2**31)).shuffle(order)
        for i in range(0, len(order) - (batch_size - 1 if drop_last else 0), batch_size):
            idxs = order[i:i + batch_size]
            if len(idxs) < batch_size and drop_last:
                break
            if shard is not None:
                hid, n_hosts = shard
                assert batch_size % n_hosts == 0
                per = batch_size // n_hosts
                idxs = idxs[hid * per:(hid + 1) * per]
            items = [self[int(j)] for j in idxs]
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}


class StringAugmentedDataset:
    """Reference-style per-sample STRING pipeline (reference dataset.py:208-365).

    The id-space `AugmentedDataset` compiles augmentations to base-vocab
    permutation tables, which cannot represent a LEARNED tokenizer's merged
    ids (wordpiece / pair-merge).  This class runs the transform chain on
    token strings and then the learned tokenizer, exactly like the reference:
    RandomCrop -> SanitizeRare -> (AugmentKey | ToMidiPitch) -> ChannelMixer
    -> tokenizer(pad/truncate).
    """
    PT_LOSS_PAD = -100

    def __init__(
            self, songs: List[Dict], tokenizer: MusicTokenizer,
            random_crop: Union[bool, int] = True, min_seg_length: int = 16,
            insert_key: bool = False, pitch_shift: bool = False,
            channel_mixup: Union[bool, str] = False, mode: str = 'full',
            dataset_split: str = 'train', seed: int = 77,
    ):
        self.songs = songs
        self.tokenizer = tokenizer
        self.max_length = tokenizer.model_max_length
        self.dataset_split = dataset_split
        rng = np.random.default_rng(seed)
        self.rng = rng
        pk = tokenizer.pitch_kind

        vocab_step = MusicVocabulary(pitch_kind='step')
        chain = []
        if random_crop and dataset_split == 'train':
            chain.append(tsf.RandomCrop(
                vocab=vocab_step, min_seg_length=min_seg_length,
                crop_mult=1 if random_crop is True else int(random_crop),
                rng=rng, return_as_list=True))
        self._sanitize = tsf.SanitizeRare(vocab=vocab_step, return_as_list=True)
        self._aug_key = None
        self._to_midi = None
        if insert_key and pitch_shift:
            assert pk == 'degree'
            self._aug_key = tsf.AugmentKey(vocab=tokenizer.vocab
                                           if tokenizer.vocab.pitch_kind == 'degree'
                                           else MusicVocabulary(pitch_kind='degree'),
                                           rng=rng, return_as_list=True)
        elif pk == 'midi':
            self._to_midi = tsf.ToMidiPitch(vocab=vocab_step, return_as_list=True)
        self._mixer = None
        if channel_mixup:
            self._mixer = tsf.ChannelMixer(
                rng=rng, mode='full' if channel_mixup is True else channel_mixup,
                return_as_list=True)
        self._pre = chain

    def __len__(self):
        return len(self.songs)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        s = self.songs[idx]
        toks: Union[str, List[str]] = s['score']
        for t in self._pre:
            toks = t(toks)
        toks = self._sanitize(toks)
        if self._aug_key is not None:
            toks = self._aug_key((toks, s.get('keys') or {}))
        elif self._to_midi is not None:
            toks = self._to_midi(toks)
        if self._mixer is not None:
            toks = self._mixer(toks)
        ids = np.asarray(self.tokenizer.encode(
            toks, padding='max_length', truncation=True), dtype=np.int32)
        pad = self.tokenizer.pad_token_id
        labels = np.where(ids == pad, StringAugmentedDataset.PT_LOSS_PAD,
                          ids).astype(np.int32)
        ks = np.asarray(tsf.CombineKeys.get_key_scores(s.get('keys') or {}),
                        np.float32)
        return dict(input_ids=ids, labels=labels, key_scores=ks)

    batches = AugmentedDataset.batches
