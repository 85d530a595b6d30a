"""The traced slice: `torch.profiler` over a few steps after a traced
warm-up (a recording drops its first kernels), read from its Chrome trace.

`Slice` holds the device operations (kernels, copies, fills) inside the
benchmark's `bench.slice` span, their union (busy), the span's length
(window) and the idle gaps, each named by the innermost host activity
(an op, a runtime call or one of the benchmark's own spans) under it.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cpu_op', 'user_annotation', 'cuda_runtime', 'cuda_driver')
SLICE = 'bench.slice'


@dataclass
class Slice:
    steps: int
    window_s: float
    ops: List[Tuple[str, float, float]]             # (name, start us, end us), clipped
    gaps: List[Tuple[str, float]] = field(default_factory=list)   # (host activity, s)

    @property
    def busy_s(self) -> float:
        busy, end = 0.0, float('-inf')
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if e > end:
                busy += e - max(s, end)
                end = e
        return busy / 1e6

    def time_of(self, names: List[str]) -> float:
        """Seconds of the device operations whose name holds one of `names`
        as a whole identifier."""
        pat = re.compile('|'.join(rf'(?<![A-Za-z0-9_]){re.escape(n)}(?![A-Za-z0-9_])'
                                  for n in names))
        return sum(e - s for n, s, e in self.ops if pat.search(n)) / 1e6

    def top_ops(self, k: int = 10) -> List[List]:
        tot: Dict[str, float] = defaultdict(float)
        for n, s, e in self.ops:
            tot[n] += (e - s) / 1e6
        return [[n, t] for n, t in sorted(tot.items(), key=lambda x: -x[1])[:k]]

    def top_gaps(self, k: int = 10) -> List[List]:
        tot: Dict[str, float] = defaultdict(float)
        for n, t in self.gaps:
            tot[n] += t
        return [[n, t] for n, t in sorted(tot.items(), key=lambda x: -x[1])[:k]]


def record(unit: Callable[[], None], warm: int, steps: int) -> Slice:
    """Profile `warm` + `steps` calls of `unit` (each ends in a sync) and
    read the last `steps` from the trace."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(warm):
            unit()
        torch.cuda.synchronize()
        with record_function(SLICE):
            for _ in range(steps):
                unit()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)['traceEvents']
    finally:
        os.remove(path)
    return parse(events, steps)


def parse(events: List[Dict], steps: int) -> Slice:
    span = next(e for e in events if e.get('name') == SLICE and e.get('ph') == 'X'
                and e.get('cat') in ('user_annotation', 'cpu_op'))
    t0, t1 = float(span['ts']), float(span['ts']) + float(span['dur'])
    ops = []
    for e in events:
        if e.get('ph') == 'X' and e.get('cat') in DEVICE_CATS:
            s, d = float(e['ts']), float(e.get('dur', 0))
            s, end = max(s, t0), min(s + d, t1)
            if end > s:
                ops.append((e['name'], s, end))
    host = [(float(e['ts']), float(e['ts']) + float(e.get('dur', 0)), e['name'])
            for e in events if e.get('ph') == 'X' and e.get('cat') in HOST_CATS
            and e.get('tid') == span.get('tid') and e.get('name') != SLICE
            and t0 <= float(e['ts']) <= t1]
    sl = Slice(steps, (t1 - t0) / 1e6, ops)
    # idle gaps: the span's time outside every device operation
    cur, gaps = t0, []
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if t1 > cur:
        gaps.append((cur, t1))
    # one sweep: host spans nest on one thread, so the open span that
    # started last and still covers a gap's midpoint is the innermost one
    host.sort()
    stack, j = [], 0
    for a, b in gaps:
        mid = (a + b) / 2
        while j < len(host) and host[j][0] <= mid:
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        sl.gaps.append((stack[-1][2] if stack else 'no host op', (b - a) / 1e6))
    return sl
