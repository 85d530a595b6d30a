"""Plain PyTorch pieces the two references share: products at a stated
precision, a table lookup, layer norm, dropout from pre-drawn masks, the
shifted CE, AdamW with the global-norm clip and the warmup-cosine schedule,
NTP accuracy and the in-key ratio.

Nothing here imports the program.  Precision 'f32' is float32 with TF32 off
(the caller turns TF32 off); 'fp8' is the control: every product's operands,
forward and backward, rounded to float8 e4m3 with one scale per tensor and
multiplied in float32, the step below the configuration's bfloat16.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

PRECISIONS = ('f32', 'fp8')
E4M3_MAX = 448.0
LOSS_PAD = -100


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 under one per-tensor scale, back in float32."""
    x = x.float()
    scale = torch.clamp(x.detach().abs().amax(), min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Fp8Matmul(torch.autograd.Function):
    """a [..., M, K] @ b ([K, N] or [..., K, N]) with every operand of the
    forward and the backward products rounded by `fp8_round`."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return fp8_round(a) @ fp8_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        gq = fp8_round(g)
        da = gq @ fp8_round(b).transpose(-1, -2)
        if b.dim() == 2:
            db = fp8_round(a).reshape(-1, a.shape[-1]).T @ gq.reshape(-1, g.shape[-1])
        else:
            db = fp8_round(a).transpose(-1, -2) @ gq
        return da, db


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """a @ b in float32, or through float8 operands (the control)."""
    if prec == 'f32':
        return a.float() @ b.float()
    if prec == 'fp8':
        return _Fp8Matmul.apply(a.float(), b.float())
    raise ValueError(f'precision {prec!r} is not one of {PRECISIONS}')


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[ids]: autograd sums each row's gradients in float32."""
    return table[ids.long()]


class Bf16RowSums:
    """A lookup whose table gradient is summed as PyTorch's CUDA index
    backward sums it for a bfloat16 table: each position's gradient row,
    rounded to bfloat16, is added to its token's row in the order of the
    positions, the sum rounded to bfloat16 after every addition.  Not the
    reference: a witness of what that summation costs.  Call it in place of
    `lookup` over the blocks of one batch in their order, then add
    `table_grad()` to the table's gradient (the lookup itself passes none)."""

    def __init__(self):
        self.ids, self.rows = [], []

    def __call__(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        self.V = table.shape[0]
        return _Capture.apply(table, ids.long(), self)

    def table_grad(self) -> torch.Tensor:
        ids = torch.cat([i.reshape(-1) for i in self.ids])
        g = torch.cat([r.reshape(len(i.reshape(-1)), -1) for i, r in zip(self.ids, self.rows)])
        g = g.to(torch.bfloat16)
        order = torch.argsort(ids, stable=True)                    # positions by token
        sid = ids[order]
        counts = torch.bincount(sid, minlength=self.V)
        rank = torch.arange(len(sid), device=ids.device) - (torch.cumsum(counts, 0) - counts)[sid]
        by_rank = order[torch.argsort(rank, stable=True)]          # k-th occurrences together
        acc = torch.zeros(self.V, g.shape[1], dtype=torch.bfloat16, device=g.device)
        off = 0
        for n in torch.bincount(rank).tolist():                    # one token once per round
            pos = by_rank[off:off + n]
            rows = ids[pos]
            acc[rows] = (acc[rows].float() + g[pos].float()).to(torch.bfloat16)
            off += n
        self.ids, self.rows = [], []
        return acc.float()


class _Capture(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, sums):
        ctx.sums, ctx.ids, ctx.shape = sums, ids, table.shape
        return table[ids]

    @staticmethod
    def backward(ctx, g):
        ctx.sums.ids.append(ctx.ids)
        ctx.sums.rows.append(g.detach().float())
        return torch.zeros(ctx.shape, dtype=g.dtype, device=g.device), None, None


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * scale + bias


def sinusoid(dist: torch.Tensor, d_model: int) -> torch.Tensor:
    """[K] distances -> [K, d_model]: sines of d / 10000^(2i/d), then cosines."""
    inv = 1.0 / (10000.0 ** (torch.arange(0, d_model, 2, dtype=torch.float32,
                                          device=dist.device) / d_model))
    arg = dist.float()[:, None] * inv[None, :]
    return torch.cat([torch.sin(arg), torch.cos(arg)], dim=-1)


class Dropout:
    """Inverted dropout from masks drawn once for the whole batch, in the
    order the model draws them (`draw`), then cut to a block of rows."""

    def __init__(self, rate: float, masks: Sequence[torch.Tensor] = ()):
        self.rate, self.masks, self.i, self.rows = rate, list(masks), 0, slice(None)

    @staticmethod
    def draw(rate: float, shapes: Sequence[Sequence[int]], generator: torch.Generator,
             device) -> List[torch.Tensor]:
        """One uniform draw per shape from `generator`, kept as boolean keep
        masks: u < 1 - rate."""
        return [torch.rand(tuple(s), generator=generator, device=device) < (1.0 - rate)
                for s in shapes]

    def block(self, rows: slice) -> 'Dropout':
        d = Dropout(self.rate, self.masks)
        d.rows = rows
        return d

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if not self.masks:
            return x
        keep = self.masks[self.i][self.rows]
        self.i += 1
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


def nll_sum(logits: torch.Tensor, labels: torch.Tensor):
    """(sum of -log p(labels[:, 1:]) over valid positions, their count) of
    logits[:, :-1]; labels -100 count nothing."""
    lg = logits[:, :-1]
    lb = labels[:, 1:]
    valid = lb != LOSS_PAD
    safe = torch.where(valid, lb, torch.zeros_like(lb)).long()
    nll = torch.logsumexp(lg, dim=-1) - torch.gather(lg, -1, safe[..., None])[..., 0]
    return torch.where(valid, nll, torch.zeros_like(nll)).sum(), int(valid.sum())


# ------------------------------------------------------------------ optimizer
def warmup_cosine(peak: float, warmup: int, total: int, count: int) -> float:
    """Linear from 0 over `warmup` steps, then a cosine to 0 at `total`."""
    if count < warmup:
        return peak * count / warmup
    span = total - warmup
    c = min(count - warmup, span)
    return peak * 0.5 * (1.0 + math.cos(math.pi * c / span))


def schedule(recipe: Dict) -> tuple:
    """(warmup, total) optimizer steps of a recipe's warmup-cosine schedule."""
    total = recipe['epoch_rows'] // recipe['batch_size'] * recipe['num_train_epochs']
    warmup = max(1, int(total * recipe['warmup_ratio']))
    return warmup, max(total, warmup + 1)


class AdamW:
    """clip_by_global_norm(max_grad_norm) then AdamW with decoupled weight
    decay on every leaf; the schedule is read at the count before the step,
    which starts at `count` (zero moments)."""

    def __init__(self, recipe: Dict, params: Dict[str, torch.Tensor], count: int = 0):
        self.r = recipe
        self.warmup, self.total = schedule(recipe)
        self.count = count
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        """Updates `params` in place; returns the clipped gradients."""
        r = self.r
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).float()
        factor = torch.where(norm < r['max_grad_norm'], torch.ones_like(norm),
                             r['max_grad_norm'] / norm)
        lr = warmup_cosine(r['learning_rate'], self.warmup, self.total, self.count)
        self.count += 1
        b1, b2 = r['adam_beta1'], r['adam_beta2']
        c1, c2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        clipped = {}
        for k, p in params.items():
            g = grads[k] * factor
            clipped[k] = g
            self.mu[k].mul_(b1).add_(g, alpha=1 - b1)
            self.nu[k].mul_(b2).add_(g * g, alpha=1 - b2)
            upd = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + r['adam_epsilon'])
            p.add_((upd + r['weight_decay'] * p) * -lr)
        return clipped


# ------------------------------------------------------------------ metrics
def correct_count(preds: torch.Tensor, labels: torch.Tensor) -> int:
    """Positions whose prediction equals the next label (valid labels only)."""
    lb = labels[:, 1:]
    return int(((preds[:, :-1] == lb) & (lb != LOSS_PAD)).sum())


def in_key_ratio(preds: np.ndarray, labels: np.ndarray, key_scores: np.ndarray,
                 pitch_class: np.ndarray, inkey: np.ndarray, key_of_id: np.ndarray,
                 mode: str) -> float:
    """The mean over songs with a predicted pitch of the share of predicted
    pitches (at valid next-label positions) diatonic to the song's key: the
    key read from the third label ('ins-key'), or weighted by `key_scores`
    ('vanilla').  float64 throughout."""
    p, lb = preds[:, :-1], labels[:, 1:]
    pc = pitch_class[np.clip(p, 0, len(pitch_class) - 1)]
    is_pitch = (pc >= 0) & (lb != LOSS_PAD)
    ratios = []
    for r in range(len(p)):
        n = int(is_pitch[r].sum())
        if n == 0:
            continue
        cls = pc[r][is_pitch[r]]
        per_key = inkey[cls].sum(axis=0) / n                     # [24]
        if mode == 'ins-key':
            ratios.append(per_key[max(int(key_of_id[np.clip(labels[r, 2], 0, None)]), 0)])
        else:
            w = np.clip(key_scores[r].astype(np.float64), 0, None)
            ratios.append(float((per_key * w / max(w.sum(), 1e-9)).sum()))
    return float(np.mean(ratios)) if ratios else 0.0
