"""Copy of `musicnlp_tpu/postprocess/train_plot.py` (pure Python): the port keeps its own copy
and imports nothing from the JAX package; only the import paths differ
(held against the original by tests/test_torch_postprocess.py).

Training-curve parsing and plots from the trainer's JSONL logs.

Equivalent of the reference's TensorBoard event parsing + train-curve plots
(reference musicnlp/chore/plot.py:20-137), over this repo's
`train_log.jsonl` format (trainer/train.py `Trainer._log`).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

__all__ = ['load_train_log', 'summarize_run', 'plot_train_curves']


def load_train_log(path: str) -> Dict[str, List[Dict]]:
    """Split a train_log.jsonl into step records and epoch records."""
    steps, epochs = [], []
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            (epochs if 'eval_loss' in r or 'train_tokens_per_sec' in r
             else steps).append(r)
    return dict(steps=steps, epochs=epochs)


def summarize_run(path: str) -> Dict:
    log = load_train_log(path)
    out: Dict = dict(n_step=len(log['steps']), n_epoch=len(log['epochs']))
    if log['steps']:
        out['final_loss'] = log['steps'][-1].get('loss')
        out['final_ntp_acc'] = log['steps'][-1].get('ntp_acc')
    evals = [e for e in log['epochs'] if 'eval_loss' in e]
    if evals:
        best = min(evals, key=lambda e: e['eval_loss'])
        out.update(best_eval_loss=best['eval_loss'],
                   best_eval_ntp_acc=best.get('eval_ntp_acc'),
                   best_eval_ikr=best.get('eval_ikr'),
                   best_epoch=best.get('epoch'))
    tps = [e['train_tokens_per_sec'] for e in log['epochs']
           if 'train_tokens_per_sec' in e]
    if tps:
        out['mean_tokens_per_sec'] = sum(tps) / len(tps)
    return out


def plot_train_curves(path: str, out_path: Optional[str] = None,
                      metrics=('loss', 'ntp_acc', 'ikr', 'lr')) -> str:
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    log = load_train_log(path)
    steps = log['steps']
    n = len(metrics)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 3))
    for ax, m in zip(axes if n > 1 else [axes], metrics):
        xs = [r['step'] for r in steps if m in r]
        ys = [r[m] for r in steps if m in r]
        if xs:
            ax.plot(xs, ys, lw=0.8)
        ev = [(e['epoch'], e.get(f'eval_{m}')) for e in log['epochs']
              if e.get(f'eval_{m}') is not None]
        if ev and xs:
            per_ep = max(xs) / max(e for e, _ in ev) if max(e for e, _ in ev) else 1
            ax.plot([e * per_ep for e, _ in ev], [v for _, v in ev],
                    'o-', ms=3, label='eval')
            ax.legend(fontsize=7)
        ax.set_title(m, fontsize=9)
        ax.set_xlabel('step', fontsize=8)
    fig.tight_layout()
    out_path = out_path or os.path.join(os.path.dirname(path), 'train_curves.png')
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
