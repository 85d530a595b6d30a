"""The committed limits against the readings they were set from
(`limits/<cell>.json`, measured on the card by `calibrate.py`): each limit
lies between its readings, and the float8 control and each planted fault,
at their recorded readings, come out not correct under the comparison a
run makes (`gaps.passes`)."""
import json

import pytest

from benchmark.harness import gaps, manifest

FILES = sorted((manifest.BENCH_DIR / 'limits').glob('*.json'))


def _load(path):
    with open(path) as f:
        return json.load(f)


def _passes(limits, readings):
    return gaps.passes({k: dict(value=v, limit=limits[k]) for k, v in readings.items()})


@pytest.mark.parametrize('path', FILES, ids=lambda p: p.stem)
def test_each_cell_compares_its_entrys_numbers(path):
    cell = manifest.find_cell(path.stem)
    d = _load(path)
    assert set(d['limits']) == set(cell.module.NUMBERS) == set(d['readings'])


@pytest.mark.parametrize('path', FILES, ids=lambda p: p.stem)
def test_each_limit_lies_between_its_readings(path):
    """Above the program's largest reading (an exact comparison, whose
    readings are all 0, has the limit 0) and below the smallest reading of
    the control or fault that it was set against, where there is one."""
    d = _load(path)
    for k, lim in d['limits'].items():
        r = d['readings'][k]
        assert r['lower'] < lim or r['lower'] == lim == 0, (k, r, lim)
        if r['upper'] is not None:
            assert lim < r['upper'], (k, r, lim)


# the faults a run's check has to catch, each where the cell can have it
MUST_CATCH = {'half_batch', 'state_unchanged', 'altered_prediction'}


@pytest.mark.parametrize('path', FILES, ids=lambda p: p.stem)
def test_the_control_and_each_fault_are_not_correct(path):
    """The control and every planted fault but those listed, with the
    reason, under `uncaught` (none that a check has to catch)."""
    d = _load(path)
    assert not _passes(d['limits'], d['control']), d['control']
    assert d['faults']
    for kind, readings in d['faults'].items():
        assert not _passes(d['limits'], readings), (kind, readings)
    for kind, u in d.get('uncaught', {}).items():
        assert kind not in MUST_CATCH and u['why'] and _passes(d['limits'], u['readings'])


@pytest.mark.parametrize('path', FILES, ids=lambda p: p.stem)
def test_the_program_readings_are_correct(path):
    d = _load(path)
    assert _passes(d['limits'], {k: r['lower'] for k, r in d['readings'].items()})
