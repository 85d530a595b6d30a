"""What the per-layer metrics of the program's spans read: the span log of
`musicnlp_tpu_torch.utils.profiling` after the traced slice.

While `torch.profiler` records, the program's spans log each closed span
with its parent, its root and its device ms (the stream's time between its
start and end events).  A reader takes the log's last `steps` roots
(`train.step` / `score.batch`, one per traced unit) and sums the device ms
of the named spans under them, per unit.  Records under no such root (a
block that `remat` recomputes on autograd's thread) are not counted.  It
returns None without a slice, with fewer roots than steps, or without
device times, as on a program that has no span log.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from musicnlp_tpu_torch.utils import profiling

ROOTS = ('train.step', 'score.batch')


def program_log() -> List[Dict]:
    read = getattr(profiling, 'span_log', None)
    return read() if read is not None else []


def span_ms(r, names: Sequence[str], log: Optional[List[Dict]] = None) -> Optional[float]:
    """Device ms per traced unit of the spans called `names` under the last
    `r.slice.steps` roots of `log` (the program's own by default)."""
    if r.slice is None:
        return None
    log = program_log() if log is None else log
    roots = [s['id'] for s in log if s['parent'] is None and s['name'] in ROOTS]
    if len(roots) < r.slice.steps:
        return None
    ids = set(roots[len(roots) - r.slice.steps:])
    ms = [s['device_ms'] for s in log if s['root'] in ids and s['name'] in names]
    if not ms or any(m is None for m in ms):
        return None
    return sum(ms) / r.slice.steps


def forward_ms(r) -> Optional[float]:
    return span_ms(r, ('train.forward',))


def backward_ms(r) -> Optional[float]:
    return span_ms(r, ('train.backward',))


def optimizer_ms(r) -> Optional[float]:
    return span_ms(r, ('train.optimizer',))


def attention_ms(r) -> Optional[float]:
    return span_ms(r, ('model.attn',))


def ffn_ms(r) -> Optional[float]:
    return span_ms(r, ('model.ffn',))


def head_ms(r) -> Optional[float]:
    return span_ms(r, ('model.head',))
