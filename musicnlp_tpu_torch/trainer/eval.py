"""Scoring and generation drivers.

Counterpart of `musicnlp_tpu/trainer/eval.py` (and of the scoring half of
`Trainer.eval_step` in `musicnlp_tpu/trainer/train.py`):
  * `load_trained` reads a Trainer output directory (`trained.npz` +
    `meta.json`) of either package, TF-XL or Reformer (`meta['model_name']`),
    for the vanilla tokenizer scheme;
  * `score_batch` is the forward-only loss with NTP accuracy and IKR;
  * `MusicGenerator.generate` turns prompt token strings into generated token
    strings, greedy or sampled, over the model's incremental decode state.
Both take either model family: they need only its `loss`, or its
`compute_params`, `init_decode_state` and `decode_step`.
Rendering to MXL/MIDI, conditional prompts, beam and contrastive search come
with later slices.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from musicnlp_tpu_torch.models.reformer import Reformer, ReformerConfig
from musicnlp_tpu_torch.models.transformer_xl import TransfoXL, TransfoXLConfig
from musicnlp_tpu_torch.ops.sampling import SampleConfig, generate_scan
from musicnlp_tpu_torch.trainer.metrics import IkrMetric
from musicnlp_tpu_torch.utils.checkpoint import load_meta, restore_pytree
from musicnlp_tpu_torch.vocab import MusicTokenizer, VocabType

__all__ = ['MusicGenerator', 'MODEL_FAMILIES', 'load_trained', 'score_batch']


Model = Union[TransfoXL, Reformer]
# model_name (as meta.json records it) -> (model class, config class)
MODEL_FAMILIES = {'transf-xl': (TransfoXL, TransfoXLConfig),
                  'reformer': (Reformer, ReformerConfig)}


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
    """Batched autoregressive song generation (token strings)."""

    def __init__(self, model: Model, tokenizer: MusicTokenizer, params,
                 augment_key: bool = False):
        self.model = model
        self.tokenizer = tokenizer
        self.params = params
        self.augment_key = augment_key
        self.vocab = tokenizer.vocab

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

    @torch.no_grad()
    def generate(self, prompts: Sequence[str], strategy: str = 'sample',
                 max_length: int = None, seed: int = None, early_exit_chunk: int = 128,
                 **strategy_args) -> List[str]:
        """Prompt token strings -> generated token strings.

        early_exit_chunk: stop (checking once per chunk of steps) when every
        song has emitted </s>; the output is the same.  0 disables."""
        if strategy not in ('greedy', 'sample'):
            raise NotImplementedError(f'strategy {strategy!r} comes with a later slice')
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
