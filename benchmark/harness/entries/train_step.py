"""Entry `train_step`: the recipe's `Trainer.train_step` (loss forward,
backward, clip and AdamW in place, NTP accuracy and IKR), fed and fetched
as `Trainer.train` does at `logging_steps` 1.

Set-up builds one Trainer with the seed's weights and its optimizer state
resumed at the end of the schedule's warmup (zero moments, the count at the
warmup's length, as a run restarted there would hold them), so that the
checked steps run at the recipe's peak learning rate and its weight decay
moves every leaf; then it drives the Trainer through its first `CHECKED`
steps on distinct rows through the window's own feed and call.  The window
continues the same object.  The check compares those steps with the plain
reference, started at the same count: each step's loss, each leaf's norm of
the first gradient as AdamW received it (its first moment after one step
over 1 - beta1) and of the parameters' change over the checked steps.
"""
from __future__ import annotations

import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.harness import families, gaps
from benchmark.harness.seeds import sub_seed
from benchmark.harness.traffic import make_pool
from benchmark.harness.weights import flatten, make_flat, nest
from benchmark.reference import common

CHECKED = 3
NUMBERS = ('loss_gap', 'logit_gap', 'grad_gap', 'lookup_grad_gap', 'update_gap')
RATE = 'train_tokens_per_s'       # the end-to-end rate of this entry's units
BACKWARD = True                   # a unit runs the backward (work counts, kernels)
CHECK_UNITS = 0                   # window units a calibration reading runs past set-up


def start_count(recipe: Dict) -> int:
    """The optimizer count both sides start from: the end of the warmup."""
    return common.schedule(recipe)[0]


def positions(labels: np.ndarray) -> np.ndarray:
    """[n, 2] positions of the first checked batch whose logits the check
    compares, drawn among those whose next label counts."""
    return gaps.logit_positions(labels[:, 1:] != common.LOSS_PAD, 0)


def _leaf_norms(tree: Dict[str, torch.Tensor], scale: float = 1.0) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(t.double())) * scale for k, t in tree.items()}


class Session:
    """The program's Trainer on the seed's weights, past its checked steps."""

    def __init__(self, cell, seed: int, device, prog=None):
        if prog is None:
            from benchmark.harness import program as prog
        self.prog, self.device = prog, device
        t0 = time.perf_counter()
        cfg = cell.config
        self.B, self.T = cell.traffic['batch'], cell.traffic['seq_len']
        self.tokens = self.B * self.T
        self.model = prog.model(cfg, device)
        self._out = tempfile.TemporaryDirectory()
        self.trainer = prog.trainer(cfg, self.model, sub_seed(seed, 'dropout'), self._out.name)
        flat = make_flat(cfg['family'], cfg['model'], sub_seed(seed, 'weights'), device)
        for t in flat.values():
            t.requires_grad_(True)
        self.params = nest(flat)
        self.opt_state = self.trainer.opt.init(self.params)
        self.opt_state['count'] = torch.tensor(start_count(cfg['recipe']), dtype=torch.int64)
        t1 = time.perf_counter()
        self.pool = make_pool(cell.traffic, cfg, sub_seed(seed, 'rows'))
        t2 = time.perf_counter()
        self.i = 0
        self.fetched: List[Dict[str, float]] = []
        # checked steps: the window's own feed and call
        head = prog.HeadOutputs(self.model)
        for _ in range(CHECKED):
            self.unit()
            if self.i == 1:
                b1 = cfg['recipe']['adam_beta1']
                self.grad_norms = _leaf_norms(self.opt_state['mu'], 1.0 / (1.0 - b1))
                self.logits = self._logits_at(head.last, self.pool[0]['labels'])
                head.close()
        start = make_flat(cfg['family'], cfg['model'], sub_seed(seed, 'weights'), device)
        now = flatten(self.params)
        self.delta_norms = {k: float(torch.linalg.vector_norm((now[k].detach() - v).double()))
                            for k, v in start.items()}
        del start, now
        self.losses = [f['loss'] for f in self.fetched]
        self.phases = dict(build_s=t1 - t0, rows_s=t2 - t1, first_units_s=time.perf_counter() - t2)

    def unit(self) -> float:
        """One step: feed, call, fetch; returns the host seconds in the call."""
        batch = self.pool[self.i % len(self.pool)]
        self.i += 1
        with record_function('bench.feed'):
            feed = self.prog.make_global_batch(batch, self.trainer.mesh)
        with record_function('bench.train_step'):
            t0 = time.perf_counter()
            mets = self.trainer.train_step(self.params, self.opt_state, feed)
            span = time.perf_counter() - t0
        with record_function('bench.fetch'):
            self.fetched.append({k: float(v) for k, v in mets.items()})
        return span

    @staticmethod
    def _logits_at(lg, labels: np.ndarray):
        if lg is None or lg.shape[:2] != labels.shape:
            return None                      # rows missing or added: nothing compares
        r, c = torch.from_numpy(positions(labels)).T.to(lg.device)
        return lg[r, c].detach().float().cpu()

    def outputs(self) -> Dict:
        return dict(losses=self.losses, logits=self.logits, grad_norms=self.grad_norms,
                    delta_norms=self.delta_norms)

    def free(self) -> None:
        del self.params, self.opt_state, self.trainer, self.model
        self._out.cleanup()


def reference_outputs(cell, seed: int, device, prec: str = 'f32', outputs: Dict = None,
                      rows: Optional[slice] = None, lookup: str = 'f32',
                      weight_decay: Optional[float] = None) -> Dict:
    """The plain reference's checked steps on the same weights, rows and
    dropout draws, computed in blocks of rows (`outputs`, the program's,
    name nothing it needs).  Variants that stand in the program's place:
    `rows` keeps only some rows of each batch and `weight_decay` replaces
    the recipe's (planted faults); `lookup` 'bf16' sums the embedding's
    gradient rows as the program's bfloat16 lookup does (a witness)."""
    cfg = cell.config
    m, rec, ref = cfg['model'], cfg['recipe'], families.reference(cfg)
    common.no_tf32()
    flat = make_flat(cfg['family'], m, sub_seed(seed, 'weights'), device)
    start = {k: v.clone() for k, v in flat.items()}
    for t in flat.values():
        t.requires_grad_(True)
    if weight_decay is not None:
        rec = dict(rec, weight_decay=weight_decay)
    opt = common.AdamW(rec, flat, count=start_count(rec))
    pool = make_pool(cell.traffic, cfg, sub_seed(seed, 'rows'))
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 'dropout'))
    B, T = cell.traffic['batch'], cell.traffic['seq_len']
    block = cfg['reference_block_rows']
    losses, grad_norms, logits = [], None, []
    at = positions(pool[0]['labels'])
    for step in range(CHECKED):
        batch = pool[step]
        masks = common.Dropout.draw(m['dropout'], ref.dropout_shapes(m, B, T), gen, device)
        ids = torch.from_numpy(np.ascontiguousarray(batch['input_ids'])).to(device)
        labels = torch.from_numpy(np.ascontiguousarray(batch['labels'])).to(device)
        keep = range(B)[rows] if rows is not None else range(B)
        n_total = int((labels[keep.start:keep.stop, 1:] != common.LOSS_PAD).sum())
        nll = 0.0
        sums = common.Bf16RowSums() if lookup == 'bf16' else common.lookup
        for r0 in range(keep.start, keep.stop, block):
            sl = slice(r0, min(r0 + block, keep.stop))
            drop = common.Dropout(m['dropout'], masks).block(sl)
            lg = ref.logits(flat, ids[sl], m, prec, drop, sums)
            if step == 0:
                r, c = at[(at[:, 0] >= sl.start) & (at[:, 0] < sl.stop)].T
                ri, ci = torch.from_numpy(r - sl.start), torch.from_numpy(c)
                logits.append(lg[ri, ci].detach().cpu())
            s, _ = common.nll_sum(lg, labels[sl])
            del lg
            (s / n_total).backward()
            nll += float(s.detach())
        if lookup == 'bf16':                       # the one table the references gather
            flat[ref.LOOKUP_LEAVES[0]].grad += sums.table_grad()
        losses.append(nll / n_total)
        grads = {k: p.grad for k, p in flat.items()}
        clipped = opt.step(flat, grads)
        if step == 0:
            grad_norms = _leaf_norms(clipped)
        for p in flat.values():
            p.grad = None
        del masks
    delta = {k: float(torch.linalg.vector_norm((flat[k].detach() - start[k]).double()))
             for k in flat}
    return dict(losses=losses, logits=torch.cat(logits), grad_norms=grad_norms,
                delta_norms=delta)


def numbers(cell, pool, prog: Dict, ref: Dict) -> Dict[str, float]:
    """loss_gap: the worst step's relative loss gap; logit_gap: the first
    step's logits' median relative distance (`gaps.logit_gap`); grad_gap and
    lookup_grad_gap: the worst leaf's gap of first-gradient norms
    (`gaps.worst_leaf`) over the leaves that are not lookup tables and over
    the lookup tables (whose gradient the program may sum over gathered rows
    in its compute type); update_gap: the same of the change norms over the
    leaves that the reference's gradient moves."""
    loss = max(gaps.rel_gap(p, r) for p, r in zip(prog['losses'], ref['losses']))
    return dict(loss_gap=loss, logit_gap=gaps.logit_gap(prog['logits'], ref['logits']),
                **{k: v for k, (v, _) in _leaf_gaps(cell, prog, ref).items()})


def _leaf_gaps(cell, prog: Dict, ref: Dict) -> Dict[str, tuple]:
    tables = families.reference(cell.config).LOOKUP_LEAVES
    g = ref['grad_norms']
    others = [k for k in g if k not in tables]
    return dict(grad_gap=gaps.worst_leaf(prog['grad_norms'], g, others, med_of=g),
                lookup_grad_gap=gaps.worst_leaf(prog['grad_norms'], g, tables, med_of=g),
                update_gap=gaps.worst_leaf(prog['delta_norms'], ref['delta_norms'],
                                           gaps.moving_leaves(g)))


def as_program(cell, pool, ref_out: Dict) -> Dict:
    """The outputs of a side that trains as `ref_out` did (the control)."""
    return ref_out


def details(cell, pool, prog: Dict, ref: Dict) -> Dict:
    """What a calibration reading records besides the numbers."""
    return dict(worst={k: leaf for k, (_, leaf) in _leaf_gaps(cell, prog, ref).items()},
                losses=[prog['losses'], ref['losses']],
                median_grad_gap=gaps.median_leaf(prog['grad_norms'], ref['grad_norms']))


def faults(cell, seed: int, device, pool, ref: Dict):
    """(kind, outputs) of the reference in float32 in the program's place
    with a fault planted: half of each batch left out (the mean over the
    rest); the recipe's weight decay left out; the optimizer state left
    unchanged (no gradient reaches it, nothing moves; its losses and first
    logits are taken as the reference's, so only the norms read it)."""
    B = cell.traffic['batch']
    yield 'half_batch', reference_outputs(cell, seed, device, rows=slice(0, B // 2))
    yield 'no_weight_decay', reference_outputs(cell, seed, device, weight_decay=0.0)
    yield 'state_unchanged', dict(losses=ref['losses'], logits=ref['logits'],
                                  grad_norms={k: 0.0 for k in ref['grad_norms']},
                                  delta_norms={k: 0.0 for k in ref['delta_norms']})


def witness(cell, seed: int, device) -> Dict:
    """The float32 reference with the embedding's gradient rows summed as
    the program's bfloat16 lookup sums them."""
    return reference_outputs(cell, seed, device, lookup='bf16')
