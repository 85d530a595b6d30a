"""The largest held expert's rows over the mean held expert's rows in one
expert layer's forward, averaged over the expert layers of the traced
steps: the straggler that sets the grouped products' time.  Read from the
program's counter `moe_rows` (the rows each held expert computed, logged
under `train.step` while the trace records); the backward's products follow
the same rows.  None on a program that logs no such counter."""
from benchmark.harness.spans import ROOTS, program_log


def read(r):
    if r.slice is None:
        return None
    log = program_log()
    roots = [s['id'] for s in log if s['parent'] is None and s['name'] in ROOTS]
    if len(roots) < r.slice.steps:
        return None
    ids = set(roots[len(roots) - r.slice.steps:])
    skews = [max(s['value']) * len(s['value']) / sum(s['value']) for s in log
             if s['root'] in ids and s['name'] == 'moe_rows' and sum(s.get('value') or [0]) > 0]
    return sum(skews) / len(skews) if skews else None
