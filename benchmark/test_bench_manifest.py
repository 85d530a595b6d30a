"""BENCHMARK.json against the contract's character and shape rules, and
every name in it against the files that the harness finds by that name."""
import importlib
import json

import pytest

from benchmark.harness import manifest

M = manifest.load_manifest()


def test_manifest_keeps_the_rules():
    assert manifest.problems(M) == []
    assert len(json.dumps(M)) <= 64 * 1024


@pytest.mark.parametrize('name, ok', [
    ('tfxl-22-11.train', True), ('mfu_pct.score', True), ('_x', True), ('a' * 64, True),
    ('a' * 65, False), ('has space', False), ('a/b', False), ('a,b', False), ('.x', False),
    ('µs', False)])
def test_name_rule(name, ok):
    assert bool(manifest.NAME.match(name)) == ok


@pytest.mark.parametrize('unit, ok', [('tokens/s', True), ('%', True), ('GiB', True),
                                      ('ms', True), ('tokens per second', False), ('µs', False),
                                      ('a' * 17, False)])
def test_unit_rule(unit, ok):
    assert bool(manifest.UNIT.match(unit)) == ok


def test_broken_manifests_are_found():
    bad = json.loads(json.dumps(M))
    bad['end_to_end'] = [e for e in bad['end_to_end'] if e['name'] != 'setup_s']
    bad['workloads'][0]['chips'] = 2
    bad['per_layer'][0]['moves'] = 'no_such_metric'
    found = ' '.join(manifest.problems(bad))
    assert 'no setup_s' in found and 'chips 2' in found and 'moves no_such_metric' in found


@pytest.mark.parametrize('cell', [w['name'] for w in M['workloads']])
def test_each_cell_finds_its_files(cell):
    c = manifest.find_cell(cell)
    entry = importlib.import_module(f'benchmark.harness.entries.{c.entry}')
    assert set(c.limits) == set(entry.NUMBERS)
    e2e = {e['name'] for e in c.end_to_end}
    assert 'setup_s' in e2e and len(e2e) >= 2
    assert c.per_layer, 'every cell reports a per-layer metric'
    for p in c.per_layer:
        assert p['moves'] in e2e
        assert callable(manifest.metric_reader(p['name']))
    ops = manifest.op_kernels()
    assert {'rel_attn_fwd', 'rel_attn_bwd', 'window_attn_fwd', 'window_attn_bwd'} <= set(ops)


# the configurations measured at full size, in bfloat16 and uncut; a later
# configuration states its own widths, dtype and cuts
UNCUT = {'tfxl-base-22-11': (768, 12), 'reformer-base-22-04': (768, 12)}


def config_problems(m=M, root=manifest.ROOT):
    """Each configuration's file names it; those in `UNCUT` state no cut,
    bfloat16 and their widths."""
    found = []
    for c in m['configs']:
        with open(root / c['file']) as f:
            cfg = json.load(f)
        if cfg['name'] != c['name']:
            found.append(f"{c['file']} names {cfg['name']}")
        if c['name'] in UNCUT:
            model = cfg['model']
            if (c['reduced'], model['dtype'], (model['d_model'], model['n_head'])) != (
                    [], 'bfloat16', UNCUT[c['name']]):
                found.append(f"{c['name']} is not its uncut bfloat16 recipe")
    return found


def test_configs_state_no_cut_and_their_recipe():
    assert set(UNCUT) <= {c['name'] for c in M['configs']}
    assert config_problems() == []
