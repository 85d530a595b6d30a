"""What the benchmark takes from the program: its models, its Trainer, its
`score_batch`, its tokenizer and IKR metric, and its feed.  Nothing else in
the harness imports the program; a family module names its model's classes
as dotted paths (`PROGRAM`), which only `model` here resolves."""
from __future__ import annotations

import importlib
from typing import Dict

from benchmark.harness import families
from musicnlp_tpu_torch.parallel.mesh import make_global_batch, make_mesh
from musicnlp_tpu_torch.trainer.eval import score_batch
from musicnlp_tpu_torch.trainer.metrics import IkrMetric
from musicnlp_tpu_torch.trainer.train import TrainArgs, Trainer
from musicnlp_tpu_torch.vocab import MusicTokenizer

__all__ = ['model', 'tokenizer', 'trainer', 'mesh', 'IkrMetric', 'score_batch', 'make_global_batch',
           'HeadOutputs']

_TRAIN_ARGS = ('batch_size', 'learning_rate', 'weight_decay', 'lr_scheduler_type',
               'num_train_epochs', 'warmup_ratio', 'adam_beta1', 'adam_beta2', 'adam_epsilon',
               'max_grad_norm')


def _resolve(path: str):
    module, _, name = path.rpartition('.')
    return getattr(importlib.import_module(module), name)


def model(config: Dict, device):
    """The configuration's model (its fields as the program's config takes
    them), of the classes its family's `PROGRAM` names."""
    cls, cfg_cls = (_resolve(p) for p in families.get(config['family']).PROGRAM)
    fields = cfg_cls.__dataclass_fields__
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in config['model'].items()
          if k in fields}
    return cls(cfg_cls(**kw), device=device)


def mesh(device):
    """The trivial mesh of one process, whose device the feed copies to."""
    return make_mesh(device=device)


def tokenizer(config: Dict) -> MusicTokenizer:
    tok = MusicTokenizer(pitch_kind=config['recipe']['pitch_kind'])
    tok.model_max_length = config['model']['max_length']
    return tok


class _EpochRows:
    """A dataset that only has a length: the Trainer reads it for its
    schedule's steps per epoch; the benchmark feeds `train_step` itself."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self):
        return self.n


def trainer(config: Dict, mdl, dropout_seed: int, out_dir: str) -> Trainer:
    """The recipe's Trainer over `mdl` (nothing is written to `out_dir`
    unless its epoch loop runs, which the benchmark never calls)."""
    rec = config['recipe']
    args = TrainArgs(seed=dropout_seed, **{k: rec[k] for k in _TRAIN_ARGS})
    return Trainer(mdl, tokenizer(config), _EpochRows(rec['epoch_rows']), None, args=args,
                   out_dir=out_dir, ikr_mode=rec['ikr_mode'])


class HeadOutputs:
    """Keeps a reference to the last logits the model's head produced (no
    copy, no sync), until `close` puts the head back as it was."""

    def __init__(self, mdl):
        self.mdl, self.inner, self.last = mdl, mdl._lm_head, None
        mdl._lm_head = self._head

    def _head(self, params, h):
        self.last = self.inner(params, h)
        return self.last

    def close(self) -> None:
        self.mdl._lm_head = self.inner
        self.last = None
