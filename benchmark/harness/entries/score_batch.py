"""Entry `score_batch`: the program's forward-only loss, NTP accuracy and
IKR of a batch, fed and fetched as `Trainer.evaluate` does.

The IKR metric handed to `score_batch` is the program's own, behind a
wrapper that keeps a reference to the predictions the model passes it; a
seeded reservoir keeps `SAMPLE` batches' predictions and fetched metrics
over the whole window.  The check runs the plain reference over each kept
batch: the loss, how far below the reference's best logit each prediction
that accuracy and IKR read lies (on average, and how many lie far below),
the logits themselves at `gaps.LOGIT_POSITIONS` of those positions (the
program's kept from its head's output: one small gather on the device for
a kept batch), and accuracy and IKR recounted from the program's
predictions.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.harness import families, gaps
from benchmark.harness.seeds import sub_seed
from benchmark.harness.traffic import make_pool, vocab
from benchmark.harness.weights import make_flat, nest
from benchmark.reference import common

SAMPLE = 3
WARM = 2
NUMBERS = ('loss_gap', 'logit_gap', 'pred_logit_gap', 'far_pred_count', 'acc_count_gap',
           'ikr_count_gap')
RATE = 'score_tokens_per_s'       # the end-to-end rate of this entry's units
BACKWARD = False                  # a unit runs the forward alone
CHECK_UNITS = 6                   # window units a calibration reading runs past set-up
FAR_LOGITS = 1.0                  # a prediction this far below the best is another answer
CONTROL_POOLS = 3                 # batches a reading without the program scores


class _KeepPreds:
    """The program's IKR metric; remembers the last predictions it saw."""

    def __init__(self, inner):
        self.inner, self.preds = inner, None

    def on_device(self, preds, *args, **kw):
        self.preds = preds
        return self.inner.on_device(preds, *args, **kw)


class Session:
    """The program's model on the seed's weights, scoring the pool in turn."""

    def __init__(self, cell, seed: int, device, prog=None):
        if prog is None:
            from benchmark.harness import program as prog
        self.prog = prog
        t0 = time.perf_counter()
        cfg = cell.config
        self.tokens = cell.traffic['batch'] * cell.traffic['seq_len']
        self.model = prog.model(cfg, device)
        self.mesh = prog.mesh(device)
        self.ikr = _KeepPreds(prog.IkrMetric(prog.tokenizer(cfg), mode=cfg['recipe']['ikr_mode']))
        self.head = prog.HeadOutputs(self.model)
        self.params = nest(make_flat(cfg['family'], cfg['model'], sub_seed(seed, 'weights'),
                                     device))
        t1 = time.perf_counter()
        self.pool = make_pool(cell.traffic, cfg, sub_seed(seed, 'rows'))
        self.at = [torch.from_numpy(positions(b['labels'], p).T.copy()).to(device)
                   for p, b in enumerate(self.pool)]
        t2 = time.perf_counter()
        self.rng = np.random.default_rng(sub_seed(seed, 'sample'))
        self.i, self.kept = 0, []
        for _ in range(WARM):                  # the shapes, warmed; not sampled
            self.unit()
        self.i, self.kept = 0, []
        self.phases = dict(build_s=t1 - t0, rows_s=t2 - t1, first_units_s=time.perf_counter() - t2)

    def unit(self) -> float:
        """One batch: feed, call, fetch; returns the host seconds in the call."""
        p = self.i % len(self.pool)
        with record_function('bench.feed'):
            feed = self.prog.make_global_batch(self.pool[p], self.mesh)
        with record_function('bench.score_batch'):
            t0 = time.perf_counter()
            mets = self.prog.score_batch(self.model, self.params, feed['input_ids'],
                                         feed['labels'], self.ikr, feed['key_scores'])
            span = time.perf_counter() - t0
        with record_function('bench.fetch'):
            vals = {k: float(v) for k, v in mets.items()}
        self.i += 1
        slot = len(self.kept) if len(self.kept) < SAMPLE else int(self.rng.integers(self.i))
        if slot < SAMPLE:                    # reservoir sampling over the window
            kept = (p, vals, self.ikr.preds, self._logits_at(p))
            if slot == len(self.kept):
                self.kept.append(kept)
            else:
                self.kept[slot] = kept
        self.ikr.preds = self.head.last = None
        return span

    def _logits_at(self, p: int):
        lg, (r, c) = self.head.last, self.at[p]
        if lg is None or lg.shape[:2] != self.pool[p]['labels'].shape:
            return None                      # rows missing or added: nothing compares
        return lg[r, c]

    def outputs(self) -> Dict:
        return dict(batches=[dict(pool=p, **vals, preds=preds.cpu().numpy(),
                                  logits=None if lg is None else lg.float().cpu())
                             for p, vals, preds, lg in self.kept])

    def free(self) -> None:
        self.head.close()
        del self.params, self.model, self.kept, self.head


@torch.no_grad()
def reference_outputs(cell, seed: int, device, prec: str = 'f32', outputs: Dict = None
                      ) -> Dict:
    """The reference's loss and f32 logits (kept on the host) for each of
    the pool's batches that `outputs` (the program's) sampled, or for its
    first `CONTROL_POOLS`, computed in blocks of rows."""
    pools = (sorted({b['pool'] for b in outputs['batches']}) if outputs is not None
             else range(min(CONTROL_POOLS, cell.traffic['pool'])))
    cfg = cell.config
    m, ref = cfg['model'], families.reference(cfg)
    common.no_tf32()
    flat = make_flat(cfg['family'], m, sub_seed(seed, 'weights'), device)
    pool = make_pool(cell.traffic, cfg, sub_seed(seed, 'rows'))
    block = cfg['reference_block_rows']
    out = []
    for p in pools:
        ids = torch.from_numpy(np.ascontiguousarray(pool[p]['input_ids'])).to(device)
        labels = torch.from_numpy(np.ascontiguousarray(pool[p]['labels'])).to(device)
        nll, n, logits = 0.0, 0, []
        for r0 in range(0, len(ids), block):
            lg = ref.logits(flat, ids[r0:r0 + block], m, prec)
            s, k = common.nll_sum(lg, labels[r0:r0 + block])
            nll, n = nll + float(s), n + k
            logits.append(lg.cpu())
            del lg
        out.append(dict(pool=p, loss=nll / max(n, 1), n_tok=n, logits=torch.cat(logits)))
    return dict(batches=out)


def positions(labels: np.ndarray, p: int) -> np.ndarray:
    """[n, 2] positions of pool batch `p` whose logits the check compares,
    drawn among those that accuracy and IKR read."""
    return gaps.logit_positions(labels[:, 1:] != common.LOSS_PAD, p)


def _at(logits: torch.Tensor, labels: np.ndarray, p: int) -> torch.Tensor:
    r, c = positions(labels, p).T
    return logits[torch.from_numpy(r), torch.from_numpy(c)]


def as_program(cell, pool, ref_out: Dict) -> Dict:
    """The outputs of a side that scores as `ref_out` computed (the control
    in the program's place): its loss, its predictions, and accuracy and
    IKR counted from them."""
    rec = cell.config['recipe']
    v = vocab(rec['pitch_kind'])
    batches = []
    for b in ref_out['batches']:
        preds = b['logits'].argmax(-1).numpy()
        labels = pool[b['pool']]['labels']
        correct = common.correct_count(torch.from_numpy(preds), torch.from_numpy(labels))
        ikr = common.in_key_ratio(preds, labels, pool[b['pool']]['key_scores'], v.pitch_class,
                                  v.inkey, v.key_of_id, rec['ikr_mode'])
        batches.append(dict(pool=b['pool'], loss=b['loss'], n_tok=float(b['n_tok']),
                            ntp_acc=correct / max(b['n_tok'], 1), ikr=ikr, preds=preds,
                            logits=_at(b['logits'], labels, b['pool'])))
    return dict(batches=batches)


def numbers(cell, pool, prog: Dict, ref: Dict) -> Dict[str, float]:
    """Over the sampled batches: loss_gap, the worst relative loss gap;
    logit_gap, the logits' median relative distance at the sampled
    positions (`gaps.logit_gap`); pred_logit_gap, the mean over the
    positions that accuracy and IKR read (a next label that is not a pad)
    of how far the reference's logit of the program's prediction lies below
    its best (0 where they agree; a mean, as the widest single gap of the
    Reformer is set by LSH bucket flips in any precision); far_pred_count,
    how many of those predictions lie more than `FAR_LOGITS` below it
    (another answer, not a near tie); acc_count_gap and ikr_count_gap, how
    far the program's accuracy and IKR lie from those recounted from its
    own predictions, in counts: tokens, and IKR's gap times songs times
    positions, so that one changed count reads about 1 or more and rounding
    under 0.01 (exact comparisons)."""
    out = dict.fromkeys(NUMBERS, 0.0)
    for b in prog['batches']:
        for k, x in _batch_gaps(cell, pool, b, ref).items():
            out[k] = max(out[k], x)
    return out


def _batch_gaps(cell, pool, b: Dict, ref: Dict) -> Dict[str, float]:
    rec = cell.config['recipe']
    v = vocab(rec['pitch_kind'])
    r = next(x for x in ref['batches'] if x['pool'] == b['pool'])
    batch = pool[b['pool']]
    labels = batch['labels']
    preds = np.asarray(b['preds'])
    loss = gaps.rel_gap(b['loss'], r['loss'])
    if preds.shape != labels.shape:              # rows missing or added: nothing compares
        return dict({k: 1e30 for k in NUMBERS}, loss_gap=loss)
    gap = _pred_gaps(preds, labels, r['logits'])
    correct = common.correct_count(torch.from_numpy(preds), torch.from_numpy(labels))
    ikr = common.in_key_ratio(preds, labels, batch['key_scores'], v.pitch_class, v.inkey,
                              v.key_of_id, rec['ikr_mode'])
    valid = labels[:, 1:] != common.LOSS_PAD
    pitched = valid & (v.pitch_class[np.clip(preds[:, :-1], 0, None)] >= 0)
    songs = max(1, int(pitched.any(1).sum()))
    return dict(loss_gap=loss,
                logit_gap=gaps.logit_gap(b['logits'], _at(r['logits'], labels, b['pool'])),
                pred_logit_gap=float(gap.double().mean()) if gap.numel() else 0.0,
                far_pred_count=float((gap > FAR_LOGITS).sum()),
                acc_count_gap=abs(b['ntp_acc'] * b['n_tok'] - correct)
                + abs(b['n_tok'] - r['n_tok']),
                ikr_count_gap=abs(b['ikr'] - ikr) * songs * labels.shape[1])


def _pred_gaps(preds: np.ndarray, labels: np.ndarray, logits: torch.Tensor) -> torch.Tensor:
    """How far below the reference's best logit each prediction that
    accuracy and IKR read lies."""
    valid = torch.from_numpy(labels[:, 1:] != common.LOSS_PAD)
    lg = logits[:, :-1]
    at = torch.gather(lg, -1, torch.from_numpy(preds[:, :-1]).long()[..., None])[..., 0]
    return (lg.amax(-1) - at)[valid]


def details(cell, pool, prog: Dict, ref: Dict) -> Dict:
    """What a calibration reading records besides the numbers: the widest
    single prediction gap."""
    refs = {r['pool']: r for r in ref['batches']}
    widest = [_pred_gaps(np.asarray(b['preds']), pool[b['pool']]['labels'],
                         refs[b['pool']]['logits']) for b in prog['batches']]
    return dict(widest_pred_gap=max((float(g.max()) for g in widest if g.numel()), default=0.0))


def faults(cell, seed: int, device, pool, ref: Dict):
    """(kind, outputs) of the reference in float32 in the program's place
    with a fault planted: the first batch scored over its first half of
    rows only (loss, count, accuracy and IKR of those rows, its predictions
    kept); one prediction altered where it is produced (the token the
    reference scores lowest)."""
    sound = as_program(cell, pool, ref)
    yield 'half_batch', _half_scored(cell, pool, sound, ref)
    b = dict(sound['batches'][0])
    b['preds'] = b['preds'].copy()
    b['preds'][0, 8] = int(ref['batches'][0]['logits'][0, 8].argmin())
    yield 'altered_prediction', dict(batches=[b] + sound['batches'][1:])


def _half_scored(cell, pool, sound: Dict, ref: Dict) -> Dict:
    rec = cell.config['recipe']
    v = vocab(rec['pitch_kind'])
    b, r = dict(sound['batches'][0]), ref['batches'][0]
    batch = pool[b['pool']]
    h = len(batch['labels']) // 2
    labels = batch['labels'][:h]
    s, n = common.nll_sum(r['logits'][:h], torch.from_numpy(labels))
    preds = b['preds'][:h]
    b.update(loss=float(s) / n, n_tok=float(n),
             ntp_acc=common.correct_count(torch.from_numpy(preds), torch.from_numpy(labels)) / n,
             ikr=common.in_key_ratio(preds, labels, batch['key_scores'][:h], v.pitch_class,
                                     v.inkey, v.key_of_id, rec['ikr_mode']))
    return dict(batches=[b] + sound['batches'][1:])
