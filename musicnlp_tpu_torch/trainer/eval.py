"""Scoring and generation drivers.

Counterpart of `musicnlp_tpu/trainer/eval.py` (and of the scoring half of
`Trainer.eval_step` in `musicnlp_tpu/trainer/train.py`):
  * `load_trained` reads a Trainer output directory (`trained.npz` +
    `meta.json`) of either package, TF-XL or Reformer (`meta['model_name']`),
    for the vanilla tokenizer scheme;
  * `score_batch` is the forward-only loss with NTP accuracy and IKR;
  * `MusicGenerator.generate` turns prompt token strings into generated token
    strings, greedy or sampled, over the model's incremental decode state;
    `MusicGenerator.__call__` builds unconditional or conditional prompts
    (`conditional_prompt`: the first bars of a song or a rendered MXL, with a
    given key or the best of a key-score dict),
    repairs the sampled tokens (`repair_generated`, `repair_bar_durations`)
    and renders each song to MXL, MIDI and a JSON sidecar.
Both take either model family: they need only its `loss`, or its
`compute_params`, `init_decode_state` and `decode_step`.  The token repairs
are copies of the JAX package's (pure Python).  Beam and contrastive search
come with slice A.3.
"""
from __future__ import annotations

import json
import os
import time
from fractions import Fraction
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from musicnlp_tpu_torch.models.reformer import Reformer, ReformerConfig
from musicnlp_tpu_torch.models.transformer_xl import TransfoXL, TransfoXLConfig
from musicnlp_tpu_torch.ops.sampling import SampleConfig, generate_scan
from musicnlp_tpu_torch.preprocess import transform as tsf
from musicnlp_tpu_torch.preprocess.music_converter import MusicConverter
from musicnlp_tpu_torch.trainer.metrics import IkrMetric
from musicnlp_tpu_torch.utils.checkpoint import load_meta, restore_pytree
from musicnlp_tpu_torch.vocab import MusicTokenizer, MusicVocabulary, VocabType

__all__ = ['MusicGenerator', 'MODEL_FAMILIES', 'load_trained', 'score_batch',
           'truncate_first_n_bar', 'truncate_last_bar', 'repair_generated',
           'repair_bar_durations']


Model = Union[TransfoXL, Reformer]
# model_name (as meta.json records it) -> (model class, config class)
MODEL_FAMILIES = {'transf-xl': (TransfoXL, TransfoXLConfig),
                  'reformer': (Reformer, ReformerConfig)}


def truncate_first_n_bar(text: str, n_bar: int, vocab: MusicVocabulary) -> str:
    """Keep global tokens + first n bars (reference eval.py:187-198)."""
    toks = text.split()
    idxs = [i for i, t in enumerate(toks) if t == vocab.start_of_bar]
    if len(idxs) < n_bar:
        raise ValueError(f'song has {len(idxs)} bars < {n_bar}')
    end = idxs[n_bar] if len(idxs) > n_bar else len(toks)
    return ' '.join(toks[:end])


def truncate_last_bar(text: str, vocab: MusicVocabulary) -> str:
    """Drop an unfinished trailing bar, ensure </s> (reference eval.py:178-185)."""
    toks = text.split()
    if toks and toks[-1] == vocab.end_of_song:
        return ' '.join(toks)
    idxs = [i for i, t in enumerate(toks) if t == vocab.start_of_bar]
    if len(idxs) > 1:
        toks = toks[:idxs[-1]]
    return ' '.join(toks + [vocab.end_of_song])


def repair_generated(text: str, vocab: MusicVocabulary) -> str:
    """Token-level grammar repair for sampled model output.

    The detokenizer grammar (music_converter.py) is strict -- same as the
    reference's (reference music_converter.py:365-371 asserts non-empty bars,
    pitch-then-duration pairing, etc.).  A sampled model can mildly violate
    it; rather than crash the render, drop the violating fragments:
      * a pitch not followed by a duration is dropped;
      * a tuplet without >=2 pitches + 1 duration is unwrapped/dropped;
      * bars left with no notes are dropped;
      * the sequence is closed with </s>.
    This extends the reference's render-robustness path (its `gen_broken`
    fixture + 'each-other' duration repair) up to the token level.
    """
    toks = text.split()
    v = vocab
    head: List[str] = []
    i = 0
    while i < len(toks) and toks[i] != v.start_of_bar:
        if toks[i] != v.end_of_song:
            head.append(toks[i])
        i += 1

    def is_pitch(t):
        return v.type(t) == VocabType.pitch

    def is_dur(t):
        return v.type(t) == VocabType.duration

    bars: List[List[str]] = []
    cur: Optional[List[str]] = None
    n = len(toks)
    while i < n:
        t = toks[i]
        if t == v.start_of_bar:
            cur = []
            bars.append(cur)
            i += 1
        elif t == v.end_of_song:
            break
        elif cur is None:
            i += 1
        elif t in (v.start_of_melody, v.start_of_bass):
            cur.append(t)
            i += 1
        elif t == v.start_of_tuplet:
            j = i + 1
            grp = []
            while j < n and toks[j] not in (v.end_of_tuplet, v.start_of_bar,
                                            v.end_of_song):
                grp.append(toks[j])
                j += 1
            closed = j < n and toks[j] == v.end_of_tuplet
            ok = (closed and len(grp) >= 3 and all(is_pitch(x) for x in grp[:-1])
                  and is_dur(grp[-1]))
            if ok:
                grp = [v.rest if x == MusicVocabulary.rare_pitch else x
                       for x in grp]
                cur += [v.start_of_tuplet, *grp, v.end_of_tuplet]
            i = j + 1 if closed else j
        elif is_pitch(t):
            if i + 1 < n and is_dur(toks[i + 1]):
                # a rare-pitch token has no renderable pitch: emit a rest
                cur += [v.rest if t == MusicVocabulary.rare_pitch else t,
                        toks[i + 1]]
                i += 2
            else:
                i += 1  # dangling pitch: drop
        else:
            i += 1      # stray duration/global token inside a bar: drop

    def has_note(bar):
        return any(is_pitch(t) for t in bar)

    out = list(head)
    for bar in bars:
        if has_note(bar):
            out.append(v.start_of_bar)
            out += bar
    if not any(t == v.start_of_bar for t in out):
        # degenerate: emit one bar of rest so the render always succeeds
        out += [v.start_of_bar, v.start_of_melody, v.rest,
                v.meta2tok(VocabType.duration, 4)]
    out.append(v.end_of_song)
    return ' '.join(out)


def repair_bar_durations(text: str, vocab: MusicVocabulary) -> str:
    """Exact-fill bar repair: make every channel of every bar sum to the
    time signature's capacity, so the rendered MXL re-extracts under the
    strict grammar.

    A sampled model emits bars whose durations overflow or underfill the
    meter; the reference renders them anyway (34% of its own shipped 22-11
    generation MXLs fail its extraction grammar with 'invalid bar' totals --
    measured in artifacts/real_corpus_eval.json).  This pass (applied after
    `repair_generated`, whose output grammar it assumes):
      * truncates the note that crosses the bar capacity (its remainder is
        re-emitted as vocab durations) and drops anything after it;
      * drops a tuplet group that crosses the boundary (its total is a
        vocab duration, but splitting members is musically meaningless);
      * pads an underfull channel with rests;
      * adds an all-rest channel when a bar lacks <melody> or <bass>;
      * coalesces repeated channel markers (a sampled bar often reads
        `<melody> .. <bass> .. <melody> ..`; segments merge in order into
        one melody + one bass channel, the only shape the grammar admits);
      * drops rare-duration (unrenderable, zero-length) elements.
    All duration tokens are multiples of the vocab slot, so exact fills
    always exist.  Returns the input unchanged when every bar already fits
    -- callers can use `text == repaired` as the pre-repair validity rate,
    the symmetric quality metric vs the reference's shipped generations.
    """
    v = vocab
    toks = text.split()
    head: List[str] = []
    i = 0
    while i < len(toks) and toks[i] != v.start_of_bar:
        if toks[i] != v.end_of_song:
            head.append(toks[i])
        i += 1
    ts = next((t for t in head if v.type(t) == VocabType.time_sig), None)
    if ts is None:
        return text
    meta = v.tok2meta(ts)
    if meta is None or meta[0] is None:     # TimeSig_rare: substitute common
        num, den = 4, 4                     # time so the song stays renderable
        head[head.index(ts)] = v.meta2tok(VocabType.time_sig, (4, 4))
        ts_changed = True
    else:
        num, den = meta
        ts_changed = False
    cap = Fraction(num * 4, den)
    durs = [d for d in v.get_durations(exp='dur')]
    durs = [Fraction(d) for d in durs if Fraction(d) <= cap]
    max_d = max(durs)

    def decomp(r: Fraction) -> List[Fraction]:
        out = []
        while r > 0:
            d = min(r, max_d)
            out.append(d)
            r -= d
        return out

    def d_tok(f: Fraction):
        return v.meta2tok(VocabType.duration, int(f) if f.denominator == 1
                          else f)

    def dur_of(t) -> Optional[Fraction]:
        m = v.tok2meta(t)
        return None if m is None else Fraction(m)

    # parse bars -> [channel marker, [elements]] with elements
    # ('n', pitch, dur) | ('t', [pitches], dur)
    bars = []
    cur_bar = None
    cur_ch = None
    orphan_ch = False
    n = len(toks)

    def ensure_ch():
        # notes before the bar's first channel marker (repair_generated is
        # channel-agnostic, so they survive it) would otherwise render as a
        # malformed channel split: adopt them into an implicit melody channel
        nonlocal cur_ch, orphan_ch
        if cur_ch is None and cur_bar is not None:
            cur_ch = (v.start_of_melody, [])
            cur_bar.append(cur_ch)
            orphan_ch = True
        return cur_ch

    while i < n:
        t = toks[i]
        if t == v.start_of_bar:
            cur_bar = []
            bars.append(cur_bar)
            cur_ch = None
            i += 1
        elif t == v.end_of_song:
            break
        elif t in (v.start_of_melody, v.start_of_bass):
            cur_ch = (t, [])
            cur_bar.append(cur_ch)
            i += 1
        elif t == v.start_of_tuplet:
            j = i + 1
            grp = []
            while toks[j] != v.end_of_tuplet:
                grp.append(toks[j])
                j += 1
            if ensure_ch() is not None:
                cur_ch[1].append(('t', grp[:-1], grp[-1]))
            i = j + 1
        else:
            # post-repair_generated grammar: pitch followed by duration
            if i + 1 < n and v.type(t) == VocabType.pitch \
                    and v.type(toks[i + 1]) == VocabType.duration \
                    and ensure_ch() is not None:
                cur_ch[1].append(('n', t, toks[i + 1]))
                i += 2
            else:
                i += 1

    changed = ts_changed or orphan_ch
    out = list(head)
    for bar in bars:
        # coalesce repeated channel markers: all melody segments merge (in
        # order) into one channel, likewise bass -- the grammar admits only
        # `<bar> <melody> .. <bass> ..`
        merged = {v.start_of_melody: [], v.start_of_bass: []}
        for mark, elems in bar:
            if len(merged[mark]) > 0:
                changed = True
            merged[mark].extend(elems)
        rest_fill = [('n', v.rest, d_tok(f)) for f in decomp(cap)]
        for mark in merged:
            if not merged[mark]:
                merged[mark] = list(rest_fill)
                changed = True
        if bar and [m for m, _ in bar] != [v.start_of_melody,
                                           v.start_of_bass][:len(bar)]:
            changed = True
        out.append(v.start_of_bar)
        for mark in (v.start_of_melody, v.start_of_bass):
            elems = merged[mark]
            kept = []
            tot = Fraction(0)
            for e in elems:
                d = dur_of(e[2]) if e[2] is not None else None
                if d is None:                       # rare/zero-length: drop
                    changed = True
                    continue
                if tot + d <= cap:
                    kept.append(e)
                    tot += d
                    if tot == cap:
                        if e is not elems[-1]:
                            changed = True          # trailing overflow drops
                        break
                    continue
                changed = True
                rem = cap - tot
                if e[0] == 'n' and rem > 0:         # truncate the note
                    for f in decomp(rem):
                        kept.append(('n', e[1], d_tok(f)))
                    tot = cap
                break                               # drop the rest
            if tot < cap:                           # pad with rests
                changed = True
                for f in decomp(cap - tot):
                    kept.append(('n', v.rest, d_tok(f)))
            out.append(mark)
            for e in kept:
                if e[0] == 'n':
                    out += [e[1], e[2]]
                else:
                    out += [v.start_of_tuplet, *e[1], e[2], v.end_of_tuplet]
    out.append(v.end_of_song)
    return ' '.join(out) if changed else text


def load_trained(out_dir: str, device: Optional[Union[str, torch.device]] = None
                 ) -> Tuple[Model, Dict[str, Any], MusicTokenizer]:
    """(model, params, tokenizer) from a Trainer output directory."""
    meta = load_meta(os.path.join(out_dir, 'meta.json'))
    name = meta.get('model_name', 'transf-xl')
    if name not in MODEL_FAMILIES:
        raise ValueError(f'Unknown model {name!r}')
    if meta['config'].get('adaptive_cutoffs'):
        raise NotImplementedError('the adaptive head comes with a later slice')
    model_cls, cfg_cls = MODEL_FAMILIES[name]
    fields = cfg_cls.__dataclass_fields__
    # tuple fields come back from JSON as lists
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in meta['config'].items() if k in fields}
    cfg = cfg_cls(**kw)
    model = model_cls(cfg, device=device)
    params = restore_pytree(os.path.join(out_dir, 'trained'), model.device)
    from musicnlp_tpu_torch.trainer.train import rebuild_tokenizer   # train imports this module
    tokenizer = rebuild_tokenizer(meta, out_dir)
    tokenizer.model_max_length = cfg.max_length
    return model, params, tokenizer


@torch.no_grad()
def score_batch(model: Model, params: Dict[str, Any], input_ids: torch.Tensor,
                labels: torch.Tensor, ikr: IkrMetric,
                key_scores: Optional[torch.Tensor] = None, n_seg: int = 1
                ) -> Dict[str, torch.Tensor]:
    """Forward-only CLM loss with NTP accuracy and IKR, as the JAX Trainer's
    eval step computes them (the Trainer's eval step); every value stays a
    device tensor."""
    loss, mets = model.loss(params, input_ids, labels, deterministic=True, n_seg=n_seg)
    preds = mets.pop('preds')
    mets['ikr'] = ikr.on_device(preds, labels, key_scores)
    mets['loss'] = loss
    return mets


class MusicGenerator:
    """Batched autoregressive song generation and rendering."""

    def __init__(self, model: Model, tokenizer: MusicTokenizer, params,
                 augment_key: bool = False, out_dir: str = 'generated'):
        self.model = model
        self.tokenizer = tokenizer
        self.params = params
        self.augment_key = augment_key
        self.out_dir = out_dir
        self.vocab = tokenizer.vocab
        self.converter = MusicConverter(mode='full')
        self._vocab_step = MusicVocabulary(pitch_kind='step')
        self._sanitize = tsf.SanitizeRare(vocab=self._vocab_step)
        self._to_midi = tsf.ToMidiPitch(vocab=self._vocab_step)

    # ------------------------------------------------------------- prompts
    def unconditional_prompt(self, time_sig: Tuple[int, int] = (4, 4), tempo: int = 120,
                             key: Optional[str] = None) -> str:
        v = self.vocab
        toks = [v.meta2tok(VocabType.time_sig, tuple(time_sig)),
                v.meta2tok(VocabType.tempo, tempo)]
        if self.augment_key:
            if key is None:
                raise ValueError('a key-augmented model needs a prompt key')
            toks.append(f'Key_{key}')
        toks.append(v.start_of_bar)
        return ' '.join(toks)

    def conditional_prompt(self, song: str, n_bar: int = 4, key: Union[str, Dict, None] = None,
                           key_sample: str = 'max', rng: np.random.Generator = None) -> str:
        """First n bars of an extracted song's token string (or MusicXML path),
        mapped to the model's pitch kind (reference eval.py:187-275)."""
        if os.path.exists(song):
            text = self.converter.mxl2str(song, pitch_kind='step')
        else:
            text = song
        # the input's pitch kind: corpora may be stored in step kind (the
        # reference's layout) or directly in the model's kind
        first_pitch = next((t for t in text.split()
                            if t.startswith('p_') and t != 'p_r'
                            and t != MusicVocabulary.rare_pitch), None)
        in_kind = 'step'
        if first_pitch is not None:
            for kind, v in self.converter.pk2v.items():
                if v.pitch_pattern.match(first_pitch):
                    in_kind = kind
                    break
        if in_kind == self.tokenizer.pitch_kind:
            text = truncate_first_n_bar(text, n_bar, self.vocab)
            return ' '.join(self.vocab.sanitize_rare_token(t) for t in text.split())
        if in_kind != 'step':
            raise ValueError(f'cannot map a {in_kind}-kind prompt to '
                             f'{self.tokenizer.pitch_kind}')
        text = truncate_first_n_bar(text, n_bar, self._vocab_step)
        text = self._sanitize(text)
        if not self.augment_key:
            return self._to_midi(text)
        if isinstance(key, dict):
            keys, scores = zip(*[(k, v) for k, v in key.items() if v])
            if key_sample == 'max':
                key = keys[int(np.argmax(scores))]
            else:
                rng = rng or np.random.default_rng()
                p = np.asarray(scores, float)
                key = keys[int(rng.choice(len(keys), p=p / p.sum()))]
        if not isinstance(key, str):
            raise ValueError('a key-augmented model needs a prompt key')
        # PitchShift reads the key token at position 2, so insert it BEFORE
        # shifting (KeyInsert-then-PitchShift, the AugmentKey order)
        toks = text.split()
        toks.insert(2, f'Key_{key}')
        ps = tsf.PitchShift(vocab_step=self._vocab_step, vocab_degree=self.vocab)
        return ps(' '.join(toks))

    # -------------------------------------------------------------- decode
    @torch.no_grad()
    def generate(self, prompts: Sequence[str], strategy: str = 'sample',
                 max_length: int = None, seed: int = None, early_exit_chunk: int = 128,
                 **strategy_args) -> List[str]:
        """Prompt token strings -> generated token strings.

        early_exit_chunk: stop (checking once per chunk of steps) when every
        song has emitted </s>; the output is the same.  0 disables."""
        if strategy not in ('greedy', 'sample'):
            raise NotImplementedError(f'strategy {strategy!r} comes with slice A.3 (beam and '
                                      f'contrastive search)')
        tok, model = self.tokenizer, self.model
        dev = model.device
        max_length = max_length or tok.model_max_length
        cfg = SampleConfig(strategy=strategy, **strategy_args)
        enc = [tok.encode(p) for p in prompts]
        plen = np.array([len(e) for e in enc], np.int64)
        prompt_ids = np.full((len(enc), int(plen.max())), tok.pad_token_id, np.int64)
        for i, e in enumerate(enc):
            prompt_ids[i, :len(e)] = e
        params = model.compute_params(self.params)
        gen = torch.Generator(device=dev).manual_seed(
            int(time.time()) if seed is None else int(seed))
        ids, out_len = generate_scan(
            lambda t, s: model.decode_step(params, t, s),
            model.init_decode_state(len(enc)),
            torch.as_tensor(prompt_ids, device=dev), torch.as_tensor(plen, device=dev),
            max_length=max_length, eos_id=tok.eos_token_id, pad_id=tok.pad_token_id,
            sample_cfg=cfg, vocab_size=tok.vocab_size, generator=gen,
            early_exit_chunk=early_exit_chunk or None)
        ids, out_len = ids.cpu().numpy(), out_len.cpu().numpy()
        return [tok.decode(ids[i, :out_len[i]]) for i in range(len(enc))]

    # -------------------------------------------------------------- render
    def __call__(self, mode: str = 'unconditional', strategy: str = 'sample', n_song: int = 1,
                 prompt_args: Dict = None, save: bool = True, seed: int = None,
                 max_length: int = None, repair: str = 'full',
                 **strategy_args) -> List[Dict[str, Any]]:
        """Generate n songs and render them (reference eval.py:200-395).

        repair: 'none' renders the raw sampled tokens; 'grammar' applies
        `repair_generated`; 'full' (default) also exact-fills bar durations
        (`repair_bar_durations`) so every rendered file re-extracts.  Each
        record carries `bar_durations_valid`: whether the grammar-repaired
        text already had exact bars.  With `save`, writes
        `<out_dir>/<stamp>_<i>.{mxl,mid,json}`."""
        if repair not in ('none', 'grammar', 'full'):
            raise ValueError(f'repair is none, grammar or full: {repair!r}')
        pa = dict(prompt_args or {})
        if mode == 'unconditional':
            prompts = [self.unconditional_prompt(
                time_sig=pa.get('time_sig', (4, 4)), tempo=pa.get('tempo', 120),
                key=pa.get('key')) for _ in range(n_song)]
        elif mode == 'conditional' and 'songs' in pa:
            prompts = [self.conditional_prompt(
                s, n_bar=pa.get('n_bar', 4), key=pa.get('key'),
                key_sample=pa.get('key_sample', 'max')) for s in pa['songs']]
        else:
            raise ValueError(f"mode is 'unconditional', or 'conditional' with "
                             f"prompt_args['songs']: {mode!r}")
        t0 = time.time()
        texts = self.generate(prompts, strategy=strategy, seed=seed, max_length=max_length,
                              **strategy_args)
        dt = time.time() - t0
        outs = []
        os.makedirs(self.out_dir, exist_ok=True)
        for i, text in enumerate(texts):
            text = truncate_last_bar(text, self.vocab)
            rec = dict(prompt=prompts[i], strategy=strategy, strategy_args=strategy_args,
                       mode=mode, generation_seconds=dt / len(texts))
            if repair != 'none':
                text = repair_generated(text, self.vocab)
                filled = repair_bar_durations(text, self.vocab)
                rec['bar_durations_valid'] = filled == text
                if repair == 'full':
                    text = filled
            rec['text'] = text
            if save:
                stem = f'{time.strftime("%y-%m-%d_%H%M%S")}_{i}'
                score = self.converter.str2score(text, pitch_kind=self.tokenizer.pitch_kind,
                                                 title=f'generated-{stem}')
                mxl = os.path.join(self.out_dir, f'{stem}.mxl')
                mid = os.path.join(self.out_dir, f'{stem}.mid')
                score.write_mxl(mxl)
                score.write_midi(mid)
                with open(os.path.join(self.out_dir, f'{stem}.json'), 'w') as f:
                    json.dump(rec, f, indent=2)
                rec.update(mxl=mxl, midi=mid)
            outs.append(rec)
        return outs
