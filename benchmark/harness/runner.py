"""One run of one cell: set-up, the measured window, the traced slice, the
check against the plain reference, and the result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up is everything from the process's start to the first timed unit:
imports, the kernels' build (first run of a checkout) or load, the seed's
weights and rows, and the entry's own first units (the checked training
steps; two warm scoring batches).  The window then runs whole units
(feed, call, fetch) until `--seconds` have passed; its rate is every
token of every unit over the window's whole time.  With `--trace 1`
the window is followed by a profiled slice (2 traced warm-up units, then
3 read).  After it the program's state is freed and the reference checks
what the program produced.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from typing import Dict, List, Optional

import torch

from benchmark.harness import gaps, isolation, manifest, trace
from benchmark.harness.readers import Readings, read_all
from benchmark.harness.seeds import sub_seed
from benchmark.harness.traffic import make_pool

TRACE_WARM, TRACE_STEPS = 2, 3
GIB = 2.0 ** 30


def run(cell: manifest.Cell, seed: int, seconds: float, traced: bool, device,
        t_start: float, prog=None) -> Dict:
    """The result object of one run (every key but the check's, which
    `check` adds), with the program's outputs for the check under
    '_outputs' and the set-up's phases under '_setup_phases'; `prog` stands
    in for `harness.program` (tests plant faults)."""
    cuda = torch.device(device).type == 'cuda'
    t_run = time.time()
    session = cell.module.Session(cell, seed, device, prog=prog)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.time() - t_start
    phases = dict(before_run_s=t_run - t_start, **session.phases)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    units, host_s = 0, 0.0
    t0 = time.perf_counter()
    while True:
        host_s += session.unit()
        units += 1
        window_s = time.perf_counter() - t0
        if window_s >= seconds:
            break
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    sl = trace.record(session.unit, TRACE_WARM, TRACE_STEPS) if traced else None
    if cuda:
        peak = max(peak, torch.cuda.max_memory_allocated())
    readings = Readings(cell, units, window_s, host_s, sl)
    out = dict(correct=False, attempted=units, failed=0)
    if traced:
        out['metrics'] = read_all(cell.per_layer, readings, manifest.metric_reader)
    else:
        values = {cell.module.RATE: units * session.tokens / window_s,
                  'peak_mem_gib': window_peak / GIB, 'setup_s': setup_s}
        out['metrics'] = {e['name']: dict(value=values[e['name']], unit=e['unit'])
                          for e in cell.end_to_end}
    out['device'] = dict(platform='gpu' if cuda else 'cpu',
                         kind=torch.cuda.get_device_name(0) if cuda else 'cpu',
                         count=cell.chips, memory_peak_bytes=int(peak))
    if sl is not None:
        out['device'].update(busy_s=sl.busy_s, window_s=sl.window_s)
        out['breakdown'] = dict(device_ops=sl.top_ops(), idle_gaps=sl.top_gaps())
    outputs = session.outputs()
    session.free()
    del session
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    out['_outputs'] = outputs
    out['_setup_phases'] = phases
    return out


def check(cell: manifest.Cell, seed: int, outputs: Dict, device) -> Dict[str, Dict]:
    """{number: {value, limit}} of the program's outputs against the plain
    reference's, on the same weights, rows and draws."""
    entry = cell.module
    pool = make_pool(cell.traffic, cell.config, sub_seed(seed, 'rows'))
    ref = entry.reference_outputs(cell, seed, device, 'f32', outputs)
    nums = entry.numbers(cell, pool, outputs, ref)
    return {k: dict(value=v, limit=cell.limits[k]) for k, v in nums.items()}


def main(argv: Optional[List[str]] = None, t_start: Optional[float] = None) -> int:
    t_main = time.time()
    t_start = t_start or t_main
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = manifest.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f'{args.workload} needs {cell.chips} CUDA device(s); '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0} available',
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    t_cuda = time.time()
    torch.cuda.init()
    torch.empty(0, device='cuda')
    cuda_init_s = time.time() - t_cuda
    out = run(cell, args.seed, args.seconds, bool(args.trace), 'cuda', t_start)
    phases = dict(out.pop('_setup_phases'), cuda_init_s=cuda_init_s,
                  imports_s=t_main - t_start)
    checks = check(cell, args.seed, out.pop('_outputs'), 'cuda')
    out['correct'] = gaps.passes(checks)
    out['checks'] = checks
    bad = isolation.loaded(isolation.FORBIDDEN_RUN)
    if bad:
        print(f'forbidden modules loaded: {bad}', file=sys.stderr)
        return 3
    print('setup phases ' + json.dumps(phases), file=sys.stderr)
    for k, c in checks.items():
        print(f'check {k} {c["value"]!r} limit {c["limit"]!r}', file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0
