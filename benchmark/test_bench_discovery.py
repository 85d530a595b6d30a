"""A later PR adds a cell, a configuration, a traffic mix, a metric and a
kernel name by adding files and entries: the harness finds each by name,
with no edit to a file that is already there."""
import json
import shutil
import time

from benchmark.conftest import TINY_MODEL
from benchmark.harness import manifest, runner
from benchmark.harness.readers import Readings


def test_added_files_are_found_by_name(tmp_path):
    root = tmp_path / 'checkout'
    bench = root / 'benchmark'
    shutil.copytree(manifest.BENCH_DIR, bench, ignore=shutil.ignore_patterns('__pycache__'))
    m = manifest.load_manifest()
    with open(bench / 'configs' / 'tfxl-base-22-11.json') as f:
        cfg = json.load(f)
    cfg['name'] = 'tfxl-stub'
    cfg['model'].update(TINY_MODEL['transfo_xl'])
    cfg['reference_block_rows'] = 2
    (bench / 'configs' / 'tfxl-stub.json').write_text(json.dumps(cfg))
    (bench / 'traffic' / 'train-4x64.json').write_text(json.dumps(
        dict(entry='train_step', batch=4, seq_len=64, pool=5, why='a stub mix')))
    (bench / 'limits' / 'tfxl-stub.train.json').write_text(json.dumps(
        dict(limits=dict(loss_gap=1.0, logit_gap=1.0, grad_gap=1.0, lookup_grad_gap=1.0,
                         update_gap=1.0))))
    (bench / 'metrics' / 'stub_units.train.py').write_text(
        'def read(r):\n    return float(r.units)\n')
    (bench / 'kernels' / 'rel_attn_fwd.stub.json').write_text(json.dumps(
        dict(op='rel_attn_fwd', kernels=['k1_stub'])))
    m['configs'].append(dict(name='tfxl-stub', source='https://example.org/stub',
                             file='benchmark/configs/tfxl-stub.json', reduced=[], why='a stub'))
    m['workloads'].append(dict(name='tfxl-stub.train', config='tfxl-stub',
                               traffic='train-4x64', chips=1, why='a stub cell'))
    for e in m['end_to_end']:
        if e['name'] == 'train_tokens_per_s':
            e['workloads'].append('tfxl-stub.train')
    for p in m['per_layer']:
        if p.get('workloads') and 'tfxl-22-11.train' in p['workloads']:
            p['workloads'].append('tfxl-stub.train')
    m['per_layer'].append(dict(name='stub_units.train', unit='steps', better='higher',
                               source='host_clock', layer='entry points',
                               moves='train_tokens_per_s', workloads=['tfxl-stub.train']))
    (root / 'BENCHMARK.json').write_text(json.dumps(m))

    assert manifest.problems(m, root) == []
    cell = manifest.find_cell('tfxl-stub.train', manifest.load_manifest(root / 'BENCHMARK.json'),
                              bench)
    assert cell.config['model']['d_model'] == 64 and cell.traffic['batch'] == 4
    assert 'stub_units.train' in [p['name'] for p in cell.per_layer]
    assert 'k1_stub' in manifest.op_kernels(bench)['rel_attn_fwd']
    out = runner.run(cell, 3, 0.1, False, 'cpu', time.time())
    assert set(out['metrics']) == {'train_tokens_per_s', 'peak_mem_gib', 'setup_s'}
    read = manifest.metric_reader('stub_units.train', bench)
    assert read(Readings(cell, out['attempted'], 1.0, 0.1, None)) == out['attempted']
    # the files the benchmark had are unchanged
    for p in manifest.BENCH_DIR.rglob('*'):
        if p.is_file() and '__pycache__' not in p.parts:
            assert (bench / p.relative_to(manifest.BENCH_DIR)).read_bytes() == p.read_bytes()
