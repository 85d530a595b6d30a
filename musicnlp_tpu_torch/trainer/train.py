"""Training loop on one GPU: optimizer presets, train step, eval, checkpoints.

Counterpart of `musicnlp_tpu/trainer/train.py` without the device mesh (no
`n_model`, no multi-host sharding).  One train step is the loss forward
(TF-XL through K1, the Reformer through K3), its backward (through K2 or
K4), the global-norm clip and the AdamW update, with next-token accuracy
and the in-key ratio computed in the step, as the JAX Trainer does.  The dataset contract is the JAX Trainer's:
an object with `__len__` and `batches(batch_size, shuffle, seed, drop_last)`
yielding numpy `input_ids`, `labels` (pads -100) and `key_scores` [B, 24].

`make_optimizer` reproduces optax's arithmetic (`clip_by_global_norm` ->
`adamw` on a warmup-cosine schedule, inside `optax.MultiSteps` when
gradients accumulate) and updates the parameters in place.  Dropout draws
come from one `torch.Generator` on the device, seeded from `args.seed` (and
from `seed + 104729 * epoch` on resume); they are not JAX's draws.
"""
from __future__ import annotations

import json
import logging
import math
import os
import re
import shutil
import time
from dataclasses import asdict, dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from musicnlp_tpu_torch.models.reformer import Reformer
from musicnlp_tpu_torch.ops.losses import PT_LOSS_PAD
from musicnlp_tpu_torch.trainer.eval import MODEL_FAMILIES, Model, score_batch
from musicnlp_tpu_torch.trainer.metrics import IkrMetric
from musicnlp_tpu_torch.utils import checkpoint as ckpt
from musicnlp_tpu_torch.utils.prefetch import prefetch
from musicnlp_tpu_torch.vocab import MusicTokenizer

__all__ = ['TrainArgs', 'AdamW', 'make_optimizer', 'Trainer', 'describe_tokenizer',
           'rebuild_tokenizer', 'get_model_n_tokenizer', 'get_all_setup', 'RECIPES',
           'setup_recipe']

logger = logging.getLogger(__name__)


@dataclass
class TrainArgs:
    """Per-model/size presets, as in the JAX package (reference train.py:63-160)."""
    batch_size: int = 32
    learning_rate: float = 3e-4
    weight_decay: float = 1e-2
    lr_scheduler_type: str = 'cosine'      # cosine | constant
    num_train_epochs: int = 64
    warmup_ratio: float = 0.1
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    gradient_accumulation_steps: int = 1
    eval_batch_size: Optional[int] = None
    logging_steps: int = 1
    save_per_epoch: bool = True
    save_every: int = 1                    # save every N epochs (the last always saves)
    save_total_limit: Optional[int] = None  # keep N recent checkpoints (+ the best)
    load_best_model_at_end: bool = True    # on eval_loss
    seed: int = 77
    n_seg: int = 1                         # >1: segment-loop TF-XL training

    presets = {
        'transf-xl': {
            'debug': dict(batch_size=2, learning_rate=1e-3, weight_decay=0.0,
                          lr_scheduler_type='constant', num_train_epochs=64),
            'debug-large': dict(batch_size=8, learning_rate=1e-3, weight_decay=0.0,
                                lr_scheduler_type='constant', num_train_epochs=16),
            'tiny': dict(batch_size=32, learning_rate=3e-4, weight_decay=1e-2,
                         lr_scheduler_type='cosine', num_train_epochs=64, warmup_ratio=0.1),
            'small': dict(batch_size=32, learning_rate=3e-4, weight_decay=1e-2,
                          lr_scheduler_type='cosine', num_train_epochs=64, warmup_ratio=0.1),
            'base': dict(batch_size=32, learning_rate=3e-4, weight_decay=1e-2,
                         lr_scheduler_type='cosine', num_train_epochs=64, warmup_ratio=0.1),
            'large': dict(batch_size=32, learning_rate=3e-4, weight_decay=1e-2,
                          lr_scheduler_type='cosine', num_train_epochs=64, warmup_ratio=0.1),
        },
        'reformer': {
            'debug': dict(batch_size=8, learning_rate=1e-3, weight_decay=0.0,
                          lr_scheduler_type='constant', num_train_epochs=32),
            'debug-large': dict(batch_size=8, learning_rate=1e-3, weight_decay=0.0,
                                lr_scheduler_type='constant', num_train_epochs=32),
            'tiny': dict(batch_size=32, learning_rate=3e-4, weight_decay=1e-2,
                         lr_scheduler_type='cosine', num_train_epochs=32, warmup_ratio=0.1),
            'small': dict(batch_size=32, learning_rate=3e-4, weight_decay=1e-2,
                          lr_scheduler_type='cosine', num_train_epochs=64, warmup_ratio=0.1),
            'base': dict(batch_size=32, learning_rate=3e-4, weight_decay=1e-2,
                         lr_scheduler_type='cosine', num_train_epochs=64, warmup_ratio=0.1),
            'large': dict(batch_size=32, learning_rate=3e-4, weight_decay=1e-2,
                          lr_scheduler_type='cosine', num_train_epochs=64, warmup_ratio=0.1),
        },
    }

    @classmethod
    def from_preset(cls, model_name: str, model_size: str, **overrides) -> 'TrainArgs':
        d = dict(cls.presets[model_name][model_size])
        d.update(overrides)
        return cls(**d)


# ------------------------------------------------------------------ optimizer
def _f32(x) -> np.float32:
    return np.float32(x)


def warmup_cosine_schedule(peak: float, warmup_steps: int, decay_steps: int
                           ) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, decay, end=0) in
    f32: linear from 0 over `warmup_steps`, then a cosine to 0 at
    `decay_steps` (which counts the warmup)."""
    span = decay_steps - warmup_steps

    def sched(count: int) -> float:
        if count < warmup_steps:
            return float(_f32(-peak) * (_f32(1) - _f32(count) / _f32(warmup_steps))
                         + _f32(peak))
        c = _f32(min(count - warmup_steps, span))
        cos = _f32(0.5) * (_f32(1) + np.cos(_f32(math.pi) * c / _f32(span), dtype=np.float32))
        return float(_f32(peak) * cos)
    return sched


class AdamW:
    """optax.chain(clip_by_global_norm(max_grad_norm), adamw(sched, b1, b2,
    eps, weight_decay)), inside optax.MultiSteps(accum_steps) when
    accum_steps > 1 -- the same arithmetic, in f32, updating the parameter
    tensors in place (no second copy of the parameters).

    * clip: g * max / |g| only when |g| >= max (no epsilon on the norm);
    * the schedule is read at the count BEFORE the step (the first warmup
      step has lr 0); decay applies to every parameter, unmasked;
    * accumulation keeps the running mean of k micro-batch gradients and
      clips and steps once per k micro-batches; the count (and so the
      schedule) advances in optimizer steps.

    The state is {'count', 'mini_step', 'mu', 'nu'[, 'acc']}: counters as
    CPU int64 tensors, moments keyed by the parameters' flat paths.  It is
    the port's own layout (`opt_state.npz`), not optax's."""

    def __init__(self, sched: Callable[[int], float], *, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0, max_grad_norm: float = 1.0,
                 accum_steps: int = 1):
        self.sched, self.b1, self.b2, self.eps = sched, b1, b2, eps
        self.weight_decay, self.max_grad_norm = weight_decay, max_grad_norm
        self.accum_steps = accum_steps

    def init(self, params) -> Dict[str, Any]:
        def zeros():
            return {k: torch.zeros_like(t, dtype=torch.float32)
                    for k, t in ckpt.flatten(params).items()}
        state = dict(count=torch.zeros((), dtype=torch.int64),
                     mini_step=torch.zeros((), dtype=torch.int64), mu=zeros(), nu=zeros())
        if self.accum_steps > 1:
            state['acc'] = zeros()
        return state

    @torch.no_grad()
    def step(self, params, grads: Dict[str, torch.Tensor], state: Dict[str, Any]) -> None:
        """Apply one micro-batch's gradients ({flat key: tensor}, as
        `checkpoint.flatten(params)` names them); with accumulation the
        parameters change on every k-th call only."""
        if self.accum_steps > 1:
            acc = ckpt.flatten(state['acc'])
            n = int(state['mini_step'])
            for key, g in grads.items():            # Welford mean, as optax.MultiSteps
                acc[key].add_((g.float() - acc[key]) / (n + 1))
            state['mini_step'] = torch.tensor((n + 1) % self.accum_steps)
            if n + 1 < self.accum_steps:
                return
            grads = acc
        p, mu, nu = ckpt.flatten(params), ckpt.flatten(state['mu']), ckpt.flatten(state['nu'])
        g_norm = global_norm(list(grads.values()))
        keep = g_norm < self.max_grad_norm
        count = int(state['count']) + 1
        # bias corrections and the step size in f32, as optax computes them
        b1c = float(1 - np.float32(self.b1) ** np.float32(count))
        b2c = float(1 - np.float32(self.b2) ** np.float32(count))
        lr = float(np.float32(self.sched(count - 1)))
        for key, g in grads.items():
            g = torch.where(keep, g.float(), g.float() / g_norm * self.max_grad_norm)
            mu[key].mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu[key].mul_(self.b2).add_(g * g, alpha=1 - self.b2)
            upd = (mu[key] / b1c) / (torch.sqrt(nu[key] / b2c) + self.eps)
            p[key].add_((upd + self.weight_decay * p[key]) * -lr)
        state['count'] = torch.tensor(count)
        if self.accum_steps > 1:
            for t in grads.values():
                t.zero_()


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over every entry, in f32 (optax.global_norm)."""
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))


def make_optimizer(args: TrainArgs, total_steps: int) -> Tuple[AdamW, Callable[[int], float]]:
    """AdamW + warmup-cosine (or constant) schedule + global-norm clip.

    `total_steps` counts micro-batches; with gradient accumulation the
    schedule is built over optimizer steps = total_steps // k."""
    k = args.gradient_accumulation_steps
    if k > 1:
        total_steps = max(1, total_steps // k)
    if args.lr_scheduler_type == 'cosine':
        warmup = max(1, int(total_steps * args.warmup_ratio))
        sched = warmup_cosine_schedule(args.learning_rate, warmup, max(total_steps, warmup + 1))
    else:
        lr = float(np.float32(args.learning_rate))

        def sched(count: int) -> float:
            return lr
    opt = AdamW(sched, b1=args.adam_beta1, b2=args.adam_beta2, eps=args.adam_epsilon,
                weight_decay=args.weight_decay, max_grad_norm=args.max_grad_norm,
                accum_steps=k)
    return opt, sched


# -------------------------------------------------------------------- trainer
def _to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device, non_blocking=True)
            for k, v in batch.items()}


class Trainer:
    """Epoch loop with per-step metrics, per-epoch eval + checkpoint,
    best-model-at-end on eval_loss, on the model's device."""

    def __init__(self, model: Model, tokenizer: MusicTokenizer, train_dataset,
                 eval_dataset=None, args: TrainArgs = None, out_dir: str = None,
                 ikr_mode: str = 'vanilla'):
        self.model = model
        self.tokenizer = tokenizer
        self.train_dataset = train_dataset
        self.eval_dataset = eval_dataset
        self.args = args or TrainArgs()
        self.out_dir = out_dir or os.path.join('models', f'run_{int(time.time())}')
        self.device = model.device
        self._saved_ckpts: List[str] = []
        self.steps_per_epoch = max(1, len(train_dataset) // self.args.batch_size)
        total = self.steps_per_epoch * self.args.num_train_epochs
        self.opt, self.lr_sched = make_optimizer(self.args, total)
        self.ikr = IkrMetric(tokenizer, mode=ikr_mode)
        self.log_path = os.path.join(self.out_dir, 'train_log.jsonl')
        self.generator = torch.Generator(device=self.device).manual_seed(self.args.seed)

    # ------------------------------------------------------------------ setup
    def init_state(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """(params, opt_state): the model's seeded init and a fresh optimizer."""
        params = self.model.init(seed=self.args.seed)
        return params, self.opt.init(params)

    def train_step(self, params, opt_state, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """One micro-batch: loss, gradients, optimizer update (in place),
        metrics.  `grad_norm` is the raw micro-batch gradient's norm."""
        flat = ckpt.flatten(params)
        loss, mets = self.model.loss(params, batch['input_ids'], batch['labels'],
                                     generator=self.generator, deterministic=False,
                                     n_seg=self.args.n_seg)
        grads = torch.autograd.grad(loss, list(flat.values()))
        mets['grad_norm'] = global_norm(grads)
        self.opt.step(params, dict(zip(flat.keys(), grads)), opt_state)
        with torch.no_grad():
            mets['ikr'] = self.ikr.on_device(mets.pop('preds'), batch['labels'],
                                             batch['key_scores'])
        mets['loss'] = loss.detach()
        return mets

    # ------------------------------------------------------------------ loops
    def _log(self, record: Dict):
        os.makedirs(self.out_dir, exist_ok=True)
        with open(self.log_path, 'a') as f:
            f.write(json.dumps({k: (float(v) if hasattr(v, 'item') else v)
                                for k, v in record.items()}) + '\n')

    def train(self, params=None, opt_state=None, resume_from: Optional[str] = None
              ) -> Dict[str, Any]:
        """Run the epoch loop.  `resume_from` restores params + optimizer
        state + epoch counter from an epoch checkpoint directory."""
        args = self.args
        start_epoch = 0
        if os.path.isdir(self.out_dir):
            # a kill between the writes and the rename strands a checkpoint-ep*.tmp
            for d in os.listdir(self.out_dir):
                if d.startswith('checkpoint-ep') and d.endswith('.tmp'):
                    shutil.rmtree(os.path.join(self.out_dir, d), ignore_errors=True)
        if resume_from is not None:
            params, opt_state, epoch = ckpt.load_checkpoint(resume_from, self.device)
            for key in ('count', 'mini_step'):
                opt_state[key] = opt_state[key].cpu()
            start_epoch = epoch + 1
            self.generator.manual_seed(args.seed + 104729 * start_epoch)
            # adopt the interrupted run's epoch checkpoints so rotation prunes them too
            old = sorted((int(m.group(1)), os.path.join(self.out_dir, d))
                         for d in os.listdir(self.out_dir)
                         if (m := re.fullmatch(r'checkpoint-ep(\d+)', d))
                         and os.path.isdir(os.path.join(self.out_dir, d)))
            self._saved_ckpts = [p for _, p in old]
        elif params is None:
            params, opt_state = self.init_state()
        elif opt_state is None:
            opt_state = self.opt.init(params)
        for t in ckpt.flatten(params).values():
            t.requires_grad_(True)
        best_loss, best_path = float('inf'), None
        global_step = start_epoch * self.steps_per_epoch
        history: List[Dict] = []
        for epoch in range(start_epoch, args.num_train_epochs):
            if hasattr(self.train_dataset, 'resample'):
                self.train_dataset.resample()        # proportional mixing, per epoch
            t_ep = time.time()
            n_tok_ep = 0
            for batch in prefetch(self.train_dataset.batches(
                    args.batch_size, shuffle=True, seed=args.seed + epoch)):
                n_tok_ep += int((batch['labels'] != PT_LOSS_PAD).sum())
                mets = self.train_step(params, opt_state, _to_device(batch, self.device))
                global_step += 1
                if global_step % args.logging_steps == 0:
                    opt_step = global_step // args.gradient_accumulation_steps
                    rec = dict(step=global_step, epoch=epoch, lr=float(self.lr_sched(opt_step)),
                               **{k: float(v) for k, v in mets.items()})
                    self._log(rec)
                    logger.info('step %d ep %d | loss %.4f acc %.4f ikr %.4f lr %.2e',
                                global_step, epoch, rec['loss'], rec['ntp_acc'], rec['ikr'],
                                rec['lr'])
            if self.device.type == 'cuda':
                torch.cuda.synchronize(self.device)
            dt = time.time() - t_ep
            ep_rec = dict(epoch=epoch, train_tokens_per_sec=n_tok_ep / max(dt, 1e-9))
            logger.info('epoch %d done: %.0f tokens/sec', epoch, ep_rec['train_tokens_per_sec'])
            do_save = args.save_per_epoch and (
                (epoch + 1) % max(args.save_every, 1) == 0
                or epoch == args.num_train_epochs - 1)
            if self.eval_dataset is not None:
                ev = self.evaluate(params)
                ep_rec.update({f'eval_{k}': v for k, v in ev.items()})
                if do_save:
                    path = self._save_checkpoint(epoch, params, opt_state)
                    if ev['loss'] < best_loss:
                        best_loss, best_path = ev['loss'], path
                    self._rotate_checkpoints(best_path)
            elif do_save:
                self._save_checkpoint(epoch, params, opt_state)
                self._rotate_checkpoints(best_path)
            self._log(ep_rec)
            history.append(ep_rec)
        if args.load_best_model_at_end and best_path is not None:
            best = ckpt.flatten(ckpt.restore_pytree(os.path.join(best_path, 'params'),
                                                    self.device))
            with torch.no_grad():
                for key, t in ckpt.flatten(params).items():
                    t.copy_(best[key])
        final = ckpt.save_pytree(os.path.join(self.out_dir, 'trained'), params)
        ckpt.save_meta(os.path.join(self.out_dir, 'meta.json'), dict(
            model_name=_model_name(self.model), config=asdict(self.model.cfg),
            train_args=asdict(args),
            tokenizer=describe_tokenizer(self.tokenizer, self.out_dir),
            best_eval_loss=best_loss, final_checkpoint=final))
        return dict(params=params, opt_state=opt_state, history=history,
                    best_eval_loss=best_loss)

    def _save_checkpoint(self, epoch: int, params, opt_state) -> str:
        d = ckpt.save_checkpoint(os.path.join(self.out_dir, f'checkpoint-ep{epoch}'), epoch,
                                 params, opt_state)
        self._saved_ckpts.append(d)
        return d

    def _rotate_checkpoints(self, best_path: Optional[str]) -> None:
        """Prune to the save_total_limit most recent epoch checkpoints, always
        keeping the best-eval-loss one."""
        limit = self.args.save_total_limit
        if not limit:
            return
        keep = set(self._saved_ckpts[-limit:])
        if best_path:
            keep.add(best_path)
        for d in [p for p in self._saved_ckpts if p not in keep]:
            if os.path.isdir(d):
                shutil.rmtree(d)
            self._saved_ckpts.remove(d)

    def evaluate(self, params) -> Dict[str, float]:
        """Mean loss / NTP accuracy / IKR over the eval set, the final partial
        batch padded to the fixed size with rows that count nothing."""
        bsz = self.args.eval_batch_size or self.args.batch_size
        tot: Dict[str, float] = {}
        n = 0.0
        for batch in self.eval_dataset.batches(bsz, shuffle=False, drop_last=False):
            n_real = len(batch['input_ids'])
            if n_real < bsz:
                pad = bsz - n_real
                batch = {k: np.concatenate([v, np.repeat(v[-1:], pad, 0)])
                         for k, v in batch.items()}
                batch['labels'][n_real:] = PT_LOSS_PAD
                batch['key_scores'][n_real:] = 0.0
            batch = _to_device(batch, self.device)
            mets = score_batch(self.model, params, batch['input_ids'], batch['labels'], self.ikr,
                               batch['key_scores'], n_seg=self.args.n_seg)
            for k in ('loss', 'ntp_acc', 'ikr'):
                tot[k] = tot.get(k, 0.0) + n_real * float(mets[k])
            n += n_real
        return {k: v / max(n, 1e-9) for k, v in tot.items()}


# ----------------------------------------------------------------- wiring
def _model_name(model: Model) -> str:
    return 'reformer' if isinstance(model, Reformer) else 'transf-xl'


def describe_tokenizer(tokenizer: MusicTokenizer, out_dir: str) -> Dict:
    """The tokenizer's identity as `meta.json` records it (vanilla scheme)."""
    if type(tokenizer).__name__ != 'MusicTokenizer':
        raise NotImplementedError(f'{type(tokenizer).__name__} comes with the learned-'
                                  f'tokenizer slice')
    return dict(pitch_kind=tokenizer.pitch_kind, precision=tokenizer.vocab.precision,
                model_max_length=tokenizer.model_max_length,
                vocab_size=tokenizer.vocab_size, scheme='vanilla')


def rebuild_tokenizer(meta: Dict, out_dir: str) -> MusicTokenizer:
    """Inverse of `describe_tokenizer`."""
    tk = meta.get('tokenizer')
    if tk is None:                  # checkpoints from before the identity was recorded
        return MusicTokenizer(pitch_kind='degree')
    if tk['scheme'] != 'vanilla':
        raise NotImplementedError(f"tokenizer scheme {tk['scheme']!r} comes with the "
                                  f"learned-tokenizer slice")
    return MusicTokenizer(pitch_kind=tk['pitch_kind'], precision=tk.get('precision', 5),
                          model_max_length=tk['model_max_length'])


def get_model_n_tokenizer(model_name: str, model_size: str, vocab_size: int = None,
                          pitch_kind: str = 'degree', max_length: int = None,
                          model_config: Dict = None, tokenizer_scheme: str = 'vanilla',
                          device: Optional[Union[str, torch.device]] = None
                          ) -> Tuple[Model, MusicTokenizer]:
    """Model + tokenizer wiring of the reference (train.py:31-59): TF-XL or
    the Reformer with the vanilla tokenizer; the learned tokenizers raise."""
    if tokenizer_scheme != 'vanilla':
        raise NotImplementedError(f'tokenizer scheme {tokenizer_scheme!r} comes with the '
                                  f'learned-tokenizer slice')
    if model_name not in MODEL_FAMILIES:
        raise ValueError(f'Unknown model {model_name!r}')
    model_cls, cfg_cls = MODEL_FAMILIES[model_name]
    tokenizer = MusicTokenizer(pitch_kind=pitch_kind)
    cfg = cfg_cls.from_size(model_size, vocab_size or tokenizer.vocab_size,
                            max_length=max_length, **(model_config or {}))
    tokenizer.model_max_length = cfg.max_length
    return model_cls(cfg, device=device), tokenizer


def get_all_setup(model_name: str, model_size: str, train_dataset=None, eval_dataset=None,
                  train_args: Dict = None, out_dir: str = None, pitch_kind: str = 'degree',
                  model_config: Dict = None,
                  device: Optional[Union[str, torch.device]] = None) -> Trainer:
    """One call: tokenizer + model + Trainer (reference train.py:287-368)."""
    model, tokenizer = get_model_n_tokenizer(model_name, model_size, pitch_kind=pitch_kind,
                                             model_config=model_config, device=device)
    args = TrainArgs.from_preset(model_name, model_size, **(train_args or {}))
    return Trainer(model, tokenizer, train_dataset, eval_dataset, args=args, out_dir=out_dir)


# The reference's published training recipes (reference generated-samples/
# README.md; trainer/train.py:474-591), as data; `setup_recipe` wires one.
RECIPES: Dict[str, Dict] = {
    # Reformer base, midi pitch, 8 epochs (POP909 + LMD subset)
    '22-04': dict(
        model_name='reformer', model_size='base', pitch_kind='midi',
        max_length=2048,
        train_args=dict(num_train_epochs=8, batch_size=32),
        augment=dict(random_crop=True, channel_mixup=True),
        generation=dict(strategy='sample', top_p=0.9),
    ),
    # TF-XL base, degree pitch, seq 1024 / mem 512, 128 epochs,
    # proportional mixing + key augmentation (the headline recipe)
    '22-11': dict(
        model_name='transf-xl', model_size='base', pitch_kind='degree',
        max_length=1024, model_config=dict(mem_len=512),
        train_args=dict(num_train_epochs=128, batch_size=21, weight_decay=0.1),
        augment=dict(random_crop=True, insert_key=True, pitch_shift=True,
                     channel_mixup=True),
        proportional_mixing_k=32768, ikr_mode='ins-key',
        generation=dict(strategy='sample', top_k=8),
    ),
    # TF-XL small, longer sequence (seq 2048 / mem 1024), top-k 8 sampling
    '22-12': dict(
        model_name='transf-xl', model_size='small', pitch_kind='degree',
        max_length=2048, model_config=dict(mem_len=1024),
        train_args=dict(num_train_epochs=128, batch_size=21, weight_decay=0.1),
        augment=dict(random_crop=True, insert_key=True, pitch_shift=True,
                     channel_mixup=True),
        proportional_mixing_k=32768, ikr_mode='ins-key',
        generation=dict(strategy='sample', top_k=8),
    ),
}


def setup_recipe(name: str, song_datasets, eval_datasets=None, out_dir: str = None,
                 train_args: Dict = None, overrides: Dict = None,
                 device: Optional[Union[str, torch.device]] = None) -> Trainer:
    """Wire a named recipe end to end: model + tokenizer + augmented datasets
    (+ proportional mixing when the recipe uses it) + Trainer (reference
    train.py:590-626).

    overrides: shallow recipe-field overrides (e.g. model_size='small' to run
    the 22-11 recipe at a different size tier)."""
    from musicnlp_tpu_torch.preprocess.dataset import (
        AugmentedDataset, ProportionMixingDataset, SongDataset,
    )
    r = dict(RECIPES[name], **(overrides or {}))
    model, tokenizer = get_model_n_tokenizer(
        r['model_name'], r['model_size'], pitch_kind=r['pitch_kind'],
        max_length=r['max_length'], model_config=r.get('model_config'), device=device)
    aug = dict(r['augment'])
    if isinstance(song_datasets, SongDataset):
        song_datasets = [song_datasets]
    trains = [AugmentedDataset(sd, tokenizer, dataset_split='train', **aug)
              for sd in song_datasets]
    k = r.get('proportional_mixing_k')
    train = (ProportionMixingDataset(trains, k=k) if (k and len(trains) > 1)
             else trains[0] if len(trains) == 1 else
             ProportionMixingDataset(trains, k=k or 10 ** 9))
    evald = None
    if eval_datasets is not None:
        if isinstance(eval_datasets, SongDataset):
            eval_datasets = [eval_datasets]
        aug_eval = {k_: v for k_, v in aug.items() if k_ != 'random_crop'}
        evald = AugmentedDataset(eval_datasets[0], tokenizer, random_crop=False,
                                 dataset_split='test', **aug_eval)
    args = TrainArgs.from_preset(r['model_name'], r['model_size'],
                                 **dict(r.get('train_args', {}), **(train_args or {})))
    return Trainer(model, tokenizer, train, evald, args=args, out_dir=out_dir,
                   ikr_mode=r.get('ikr_mode', 'vanilla'))
