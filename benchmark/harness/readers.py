"""What the per-layer metric files (`metrics/<name>.py`) read from a run.

Each reader takes a `Readings` and returns a number, or None where it finds
nothing to read (then the metric is left out of the result line).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from benchmark.harness import families, work
from benchmark.harness.manifest import op_kernels
from benchmark.harness.trace import Slice


@dataclass
class Readings:
    cell: object                 # manifest.Cell
    units: int                   # steps or batches completed in the window
    window_s: float              # the window's length by the host clock
    host_s: float                # the benchmark's spans around the entry's calls, summed
    slice: Optional[Slice]       # the traced slice (a --trace 1 run)

    @property
    def backward(self) -> bool:
        return self.cell.module.BACKWARD

    @property
    def shape(self):
        return self.cell.traffic['batch'], self.cell.traffic['seq_len']


def host_ms_per_unit(r: Readings) -> Optional[float]:
    return r.host_s / r.units * 1e3 if r.units else None


def mfu_pct(r: Readings) -> Optional[float]:
    """The model's FLOPs (forward, and backward as two forwards: no
    recompute) per unit times the units, over the window's time at the
    dtype's published peak."""
    if not r.units:
        return None
    B, T = r.shape
    cfg = r.cell.config
    flops = work.train_flops(cfg, B, T) if r.backward else work.forward_flops(cfg, B, T)
    return flops * r.units / r.window_s / work.peak_flops(cfg) * 100.0


def attn_roofline_pct(r: Readings) -> Optional[float]:
    """The attention ops' least time (`work.bound_s` of every call that the
    family's `attention_calls` counts in the traced steps) over the device
    time of the kernels that `kernels/*.json` names for those ops."""
    if r.slice is None:
        return None
    B, T = r.shape
    calls = work.attention_calls(r.cell.config, B, T, r.backward)
    names = op_kernels()
    kernels = [k for op in calls for k in names.get(op, [])]
    t = r.slice.time_of(kernels) if kernels else 0.0
    if t <= 0.0:
        return None
    if not families.get(r.cell.config['family']).roofline_readable(calls):
        return None                 # an estimated pair count could move the bound
    bound = sum(work.bound_s(*c) for cs in calls.values() for c in cs) * r.slice.steps
    return bound / t * 100.0


def device_idle_pct(r: Readings) -> Optional[float]:
    """The share of the untraced window's time per unit in which no device
    operation ran: the device's busy time per traced unit (the slice's
    union of kernels, copies and fills over its units) against the window's
    host-clock time per unit.  The slice's own span is longer than an
    untraced unit by the profiler's host overhead, which is not the program's."""
    if r.slice is None or not r.units or r.slice.busy_s <= 0:
        return None
    return (1.0 - (r.slice.busy_s / r.slice.steps) / (r.window_s / r.units)) * 100.0


def read_all(per_layer, r: Readings, reader_of) -> Dict[str, Dict]:
    out = {}
    for m in per_layer:
        v = reader_of(m['name'])(r)
        if v is not None:
            out[m['name']] = dict(value=v, unit=m['unit'])
    return out
