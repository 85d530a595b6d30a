"""Profiling and tracing utilities.

Counterpart of `musicnlp_tpu/utils/profiling.py`: `device_trace` is rebuilt
on `torch.profiler` (CPU and, on the card, CUDA activities through CUPTI)
and writes a Chrome-trace JSON (chrome://tracing or Perfetto; no TensorBoard
package needed) that names every kernel that ran (`step_kernels` counts
one step's, `span_kernels` sums them by program span); `StepTimer` and
`profile_fn` are the JAX package's, unchanged.

The program's spans (`span`, at the names of `SPANS`) mark where a training
step or a scored batch spends its time.  A span is off unless a
`torch.profiler` recording is active: then it is one shared no-op context
and costs one flag read.  On, it is a `record_function` in the recording's
trace (on the profiler's clock, beside the device's events) and a record in
a bounded log (`span_log`) with its host time and, on CUDA, the stream's
time between a start and an end event.  A counter (`count`, at the names
of `COUNTERS`) is a device tensor the program computes anyway, logged under
the open span while a recording is active and read only by `span_log`.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import Counter, defaultdict, deque
from typing import Dict, Iterator, List, Optional, Union

import torch
import torch.autograd.profiler as _autograd_profiler

from musicnlp_tpu_torch import resolve_device

__all__ = ['device_trace', 'step_kernels', 'span', 'count', 'span_log', 'clear_span_log',
           'span_kernels', 'SPANS', 'COUNTERS', 'StepTimer', 'profile_fn']

# the program's spans: roots (a training step, a scored batch), the step's
# phases and the model's sections (an expert layer's block, and its routing
# and dispatch inside it)
SPANS = ('train.step', 'train.forward', 'train.backward', 'train.optimizer', 'score.batch',
         'model.attn', 'model.ffn', 'model.head', 'model.moe', 'model.route')
# the program's counters: the rows each held expert computed in one expert
# layer's forward
COUNTERS = ('moe_rows',)
LOG_SIZE = 4096                 # closed spans kept, newest last

if hasattr(_autograd_profiler, '_is_profiler_enabled'):
    def _recording() -> bool:
        return _autograd_profiler._is_profiler_enabled
else:                           # a torch without the module flag
    _recording = torch._C._autograd._profiler_enabled

_OFF = contextlib.nullcontext()
_log: deque = deque(maxlen=LOG_SIZE)
_ids = itertools.count(1)
_open = threading.local()       # .stack: this thread's open spans, innermost last


class _Span:
    """One open span: a `record_function` and, on CUDA, a pair of timing
    events on the current stream; appended to the log when it closes."""
    __slots__ = ('id', 'name', 'parent', 'root', 'thread', 't0', 't1', 'events', 'device_ms',
                 '_rf')

    def __init__(self, name: str):
        self.name = name
        self.events, self.device_ms = None, None

    def __enter__(self):
        stack = getattr(_open, 'stack', None)
        if stack is None:
            stack = _open.stack = []
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        self.root = stack[0].id if stack else self.id
        self.thread = threading.get_ident()
        stack.append(self)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        self._rf.__exit__(*exc)
        self._rf = None
        _open.stack.pop()
        _log.append(self)
        return False


def span(name: str):
    """A context that marks `name` (one of `SPANS`) while a `torch.profiler`
    recording is active, and does nothing otherwise.  Spans nest per
    thread: a span opened with none open on its thread (as on autograd's
    device thread) is the root of its own tree."""
    if not _recording():
        return _OFF
    return _Span(name)


class _Count:
    """One logged counter: a device tensor, read when the log is."""
    __slots__ = ('id', 'name', 'parent', 'root', 'thread', 'value')

    def __init__(self, name: str, value: torch.Tensor):
        stack = getattr(_open, 'stack', None) or []
        self.id, self.name, self.value = next(_ids), name, value
        self.parent = stack[-1].id if stack else None
        self.root = stack[0].id if stack else self.id
        self.thread = threading.get_ident()


def count(name: str, value: torch.Tensor) -> None:
    """Logs `value` (a tensor the caller computed anyway, kept as it is:
    no copy, no sync) as counter `name` (one of `COUNTERS`) under the
    innermost open span, while a `torch.profiler` recording is active;
    nothing otherwise."""
    if _recording():
        _log.append(_Count(name, value.detach()))


def span_log() -> List[Dict]:
    """The closed spans in the order they closed (children before their
    parent), at most `LOG_SIZE`: {id, name, parent, root (the outermost
    open span's id on its thread, its own for a root), thread, host_ms,
    device_ms}.  device_ms is the stream's time from the span's first work
    to its last, idle inside it included (None without CUDA); it waits for
    the span's end event, so read the log once the work has been launched.
    A counter's record (`count`) has `value`, its tensor as a list, and no
    device time."""
    out = []
    for s in list(_log):
        if isinstance(s, _Count):
            out.append(dict(id=s.id, name=s.name, parent=s.parent, root=s.root, thread=s.thread,
                            host_ms=0.0, device_ms=None, value=s.value.tolist()))
            continue
        if s.events is not None:
            start, end = s.events
            end.synchronize()
            s.device_ms, s.events = start.elapsed_time(end), None
        out.append(dict(id=s.id, name=s.name, parent=s.parent, root=s.root, thread=s.thread,
                        host_ms=(s.t1 - s.t0) / 1e6, device_ms=s.device_ms))
    return out


def clear_span_log() -> None:
    _log.clear()


@contextlib.contextmanager
def device_trace(log_dir: str, device: Optional[Union[str, torch.device]] = None
                 ) -> Iterator[str]:
    """Trace the host and, on CUDA (the default device), the card; yields the
    path of the Chrome-trace JSON under `log_dir`, written when the block
    ends.  The device is idle when tracing starts and is synchronised before
    it stops.  torch.profiler may drop kernels at the start of a recording
    (on an H100, a few to ~60, more as the process ages), so a block whose
    kernels must all be counted runs a warm-up first: see `step_kernels`."""
    from torch.profiler import ProfilerActivity, profile
    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == 'cuda' else (lambda: None)
    if dev.type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f'trace-{os.getpid()}-{time.time_ns()}.json')
    sync()
    with profile(activities=activities) as prof:
        yield path
        sync()
    prof.export_chrome_trace(path)


def step_kernels(path: str) -> Dict[str, int]:
    """Launches per device kernel name in a `device_trace` file, over the
    kernels after the card's longest idle gap: the block traced a warm-up
    step, synchronised and paused, then the step to read, whose kernels the
    profiler's losses at the start of a recording do not reach."""
    with open(path) as f:
        kern = sorted((e for e in json.load(f)['traceEvents'] if e.get('cat') == 'kernel'),
                      key=lambda e: e['ts'])
    if len(kern) > 1:
        gap = max(range(len(kern) - 1),
                  key=lambda i: kern[i + 1]['ts'] - kern[i]['ts'] - kern[i].get('dur', 0))
        kern = kern[gap + 1:]
    return dict(Counter(e['name'] for e in kern))


def span_kernels(path: str, units: Optional[int] = None) -> Dict[Optional[str], Dict[str, float]]:
    """Device ms per kernel name (and copy or fill) under each program span
    of a `device_trace` file: {span name: {kernel name: ms}}, None for work
    launched outside every span.  Each kernel is matched to the runtime call
    that launched it by correlation id, and goes to the innermost span open
    on the launching thread at that moment; a launch on a thread with none
    open (autograd's device thread in a backward) goes to the innermost
    span open on another thread, i.e. `train.backward` on the main one.
    `units`: only the work launched inside the last `units` outermost
    spans (past a traced warm-up, as `step_kernels` reads)."""
    with open(path) as f:
        events = [e for e in json.load(f)['traceEvents'] if e.get('ph') == 'X']
    spans = sorted(((float(e['ts']), float(e['ts']) + float(e.get('dur', 0)), e['tid'],
                     e['name']) for e in events
                    if e.get('cat') == 'user_annotation' and e['name'] in SPANS),
                   key=lambda s: (s[0], -s[1]))
    device = {}
    for e in events:
        corr = e.get('args', {}).get('correlation')
        if e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset') and corr is not None:
            device.setdefault(corr, []).append((e['name'], float(e.get('dur', 0)) / 1e3))
    launches = sorted((float(e['ts']), e['tid'], e['args']['correlation']) for e in events
                      if e.get('cat') in ('cuda_runtime', 'cuda_driver')
                      and e.get('args', {}).get('correlation') in device)
    if units is not None:
        outer, end = [], float('-inf')
        for s in spans:
            if s[0] >= end:
                outer.append(s)
                end = s[1]
        t_from = outer[-units][0] if 0 < units <= len(outer) else float('inf')
        launches = [x for x in launches if x[0] >= t_from]
    out: Dict[Optional[str], Dict[str, float]] = defaultdict(lambda: defaultdict(float))
    stacks: Dict[object, list] = defaultdict(list)
    j = 0
    for ts, tid, corr in launches:
        while j < len(spans) and spans[j][0] <= ts:
            st = stacks[spans[j][2]]
            while st and st[-1][1] < spans[j][0]:
                st.pop()
            st.append(spans[j])
            j += 1
        for st in stacks.values():
            while st and st[-1][1] < ts:
                st.pop()
        own = stacks.get(tid)
        if own:
            name = own[-1][3]
        else:
            tops = [st[-1] for st in stacks.values() if st]
            name = max(tops)[3] if tops else None
        for kernel, ms in device[corr]:
            out[name][kernel] += ms
    return {k: dict(v) for k, v in out.items()}


class StepTimer:
    """Wall-clock step timing with tokens/sec accounting.

    Note: CUDA work is asynchronous, so a lap measures the card's time only
    when the step ends in a host sync -- call `torch.cuda.synchronize()` (or
    fetch a metric) before `mark`.
    """

    def __init__(self):
        self.t0 = time.perf_counter()
        self.t_last = self.t0
        self.n_tokens = 0
        self.laps: List[float] = []

    def mark(self, n_tokens: int = 0) -> float:
        now = time.perf_counter()
        lap = now - self.t_last
        self.t_last = now
        self.n_tokens += n_tokens
        self.laps.append(lap)
        return lap

    @property
    def tokens_per_sec(self) -> float:
        dt = self.t_last - self.t0
        return self.n_tokens / dt if dt > 0 else 0.0

    def summary(self) -> Dict[str, float]:
        if not self.laps:
            return dict(steps=0)
        laps = sorted(self.laps)
        n = len(laps)
        return dict(steps=n, tokens_per_sec=self.tokens_per_sec,
                    p50_step_s=laps[n // 2], p90_step_s=laps[int(n * 0.9)],
                    total_s=self.t_last - self.t0)


def profile_fn(fn, *args, sort_by: str = 'cumulative', top: int = 30) -> str:
    """cProfile a host-side function (the reference `profile_runtime`
    equivalent for extraction/tokenizer code paths)."""
    import cProfile
    import io
    import pstats
    pr = cProfile.Profile()
    pr.enable()
    fn(*args)
    pr.disable()
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).sort_stats(sort_by).print_stats(top)
    return buf.getvalue()
