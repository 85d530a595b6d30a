"""Readings that a cell's limits are set from, many seeds in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--fault-seeds 7,8,9] [--witness-seeds 10,11] [--out FILE]

For each of `--seeds` the program runs the cell's checked path (its
set-up, then the entry's `CHECK_UNITS` window units) and is compared with
the plain reference, as a run's check does, without the measured window.
For each of `--control-seeds` the reference in float8 (`reference/common.py`,
precision 'fp8') stands in the program's place.  For each of
`--fault-seeds` the reference in float32 stands in the program's place with
each fault that the entry plants (`faults` of `harness/entries/<entry>.py`).
For each of `--witness-seeds` (an entry with a `witness`) the witness, a
variant of the reference that reproduces one choice of the program, is
compared with the reference, and the program with the witness.  One JSON
line per reading goes to stdout and to `--out`.  Needs the card; the
benchmark's runs never call it.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from benchmark.harness import manifest  # noqa: E402
from benchmark.harness.seeds import sub_seed  # noqa: E402
from benchmark.harness.traffic import make_pool  # noqa: E402


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def program_reading(cell, seed, device):
    s = cell.module.Session(cell, seed, device)
    for _ in range(cell.module.CHECK_UNITS):
        s.unit()
    out = s.outputs()
    s.free()
    del s
    _free()
    return out


def reference(cell, seed, device, prec, outputs=None):
    out = cell.module.reference_outputs(cell, seed, device, prec, outputs)
    _free()
    return out


def readings(cell, seeds, control_seeds, fault_seeds, device, witness_seeds=()):
    """Yields one record per reading: {kind, seed, numbers, ...}."""
    entry = cell.module
    for seed in seeds:
        t0 = time.perf_counter()
        out = program_reading(cell, seed, device)
        ref = reference(cell, seed, device, 'f32', out)
        pool = make_pool(cell.traffic, cell.config, sub_seed(seed, 'rows'))
        yield dict(kind='program', seed=seed, numbers=entry.numbers(cell, pool, out, ref),
                   seconds=time.perf_counter() - t0, **entry.details(cell, pool, out, ref))
    for seed in control_seeds:
        pool = make_pool(cell.traffic, cell.config, sub_seed(seed, 'rows'))
        ref = reference(cell, seed, device, 'f32')
        ctl = entry.as_program(cell, pool, reference(cell, seed, device, 'fp8'))
        yield dict(kind='control', seed=seed, numbers=entry.numbers(cell, pool, ctl, ref),
                   **entry.details(cell, pool, ctl, ref))
    for seed in fault_seeds:
        pool = make_pool(cell.traffic, cell.config, sub_seed(seed, 'rows'))
        ref = reference(cell, seed, device, 'f32')
        for kind, out in entry.faults(cell, seed, device, pool, ref):
            yield dict(kind='fault_' + kind, seed=seed, numbers=entry.numbers(cell, pool, out, ref))
            _free()
    for seed in witness_seeds:
        pool = make_pool(cell.traffic, cell.config, sub_seed(seed, 'rows'))
        out = program_reading(cell, seed, device)
        ref = reference(cell, seed, device, 'f32', out)
        wit = entry.witness(cell, seed, device)
        _free()
        yield dict(kind='witness', seed=seed, numbers=entry.numbers(cell, pool, wit, ref),
                   **entry.details(cell, pool, wit, ref))
        yield dict(kind='program_vs_witness', seed=seed,
                   numbers=entry.numbers(cell, pool, out, wit),
                   **entry.details(cell, pool, out, wit))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', default='')
    ap.add_argument('--control-seeds', default='')
    ap.add_argument('--fault-seeds', default='')
    ap.add_argument('--witness-seeds', default='')
    ap.add_argument('--out')
    a = ap.parse_args()

    def ints(s):
        return [int(x) for x in s.split(',') if x]
    if not torch.cuda.is_available():
        print('calibrate needs a CUDA device', file=sys.stderr)
        return 2
    cell = manifest.find_cell(a.workload)
    f = open(a.out, 'a') if a.out else None
    try:
        for rec in readings(cell, ints(a.seeds), ints(a.control_seeds), ints(a.fault_seeds),
                            'cuda', ints(a.witness_seeds)):
            rec['workload'] = a.workload
            line = json.dumps(rec)
            print(line, flush=True)
            if f:
                f.write(line + '\n')
                f.flush()
    finally:
        if f:
            f.close()
    return 0


if __name__ == '__main__':
    sys.exit(main())
