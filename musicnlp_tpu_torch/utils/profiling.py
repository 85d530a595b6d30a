"""Profiling and tracing utilities.

Counterpart of `musicnlp_tpu/utils/profiling.py`: `device_trace` is rebuilt
on `torch.profiler` (CPU and, on the card, CUDA activities through CUPTI)
and writes a Chrome-trace JSON (chrome://tracing or Perfetto; no TensorBoard
package needed) that names every kernel that ran (`step_kernels` counts
one step's); `StepTimer` and `profile_fn` are the JAX package's, unchanged.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import Counter
from typing import Dict, Iterator, List, Optional, Union

import torch

from musicnlp_tpu_torch import resolve_device

__all__ = ['device_trace', 'step_kernels', 'StepTimer', 'profile_fn']


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
