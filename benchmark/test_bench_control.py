"""The control: the plain reference in float8 (the step below the
configurations' bfloat16), put in the program's place, reads further from
the float32 reference than the program does.  Here at a tiny size on the
CPU, on three seeds; the cells' limits were set from the same readings on
the card at each cell's own size (`calibrate.py`, `PERF.md`)."""
import pytest

from benchmark import calibrate
from benchmark.conftest import tiny_cell


@pytest.mark.parametrize('name', ['tfxl-22-11.train', 'reformer-22-04.train',
                                  'tfxl-22-11.score', 'reformer-22-04.score'])
def test_control_reads_above_the_program(name):
    seeds = [1, 2, 3]
    recs = list(calibrate.readings(tiny_cell(name), seeds, seeds, [], 'cpu'))
    prog = {r['seed']: r['numbers'] for r in recs if r['kind'] == 'program'}
    ctl = {r['seed']: r['numbers'] for r in recs if r['kind'] == 'control'}
    for s in seeds:
        assert ctl[s]['loss_gap'] > prog[s]['loss_gap'], (s, prog[s], ctl[s])
    assert min(c['loss_gap'] for c in ctl.values()) > 1.5 * min(p['loss_gap']
                                                                for p in prog.values())
