"""A later PR adds a cell, a configuration, a model family, a traffic mix,
a metric and a kernel name by adding files and entries: the harness finds
each by name, with no edit to a file that is already there."""
import json
import shutil
import subprocess
import sys
import time

from benchmark.harness import families, manifest, runner
from benchmark.harness.readers import Readings
from benchmark.test_bench_manifest import config_problems


def _checkout(tmp_path):
    """A copy of the benchmark's files, as a checkout holds them."""
    root = tmp_path / 'checkout'
    shutil.copytree(manifest.BENCH_DIR, root / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    return root, root / 'benchmark'


def _unchanged(bench):
    """The files the benchmark had are unchanged in the copy."""
    for p in manifest.BENCH_DIR.rglob('*'):
        if p.is_file() and '__pycache__' not in p.parts:
            assert (bench / p.relative_to(manifest.BENCH_DIR)).read_bytes() == p.read_bytes()


def test_added_files_are_found_by_name(tmp_path):
    root, bench = _checkout(tmp_path)
    m = manifest.load_manifest()
    with open(bench / 'configs' / 'tfxl-base-22-11.json') as f:
        cfg = json.load(f)
    cfg['name'] = 'tfxl-stub'
    cfg['model'].update(families.get('transfo_xl').TINY)
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

    assert manifest.problems(m, root) == [] and config_problems(m, root) == []
    cell = manifest.find_cell('tfxl-stub.train', manifest.load_manifest(root / 'BENCHMARK.json'),
                              bench)
    assert cell.config['model']['d_model'] == 64 and cell.traffic['batch'] == 4
    assert 'stub_units.train' in [p['name'] for p in cell.per_layer]
    assert 'k1_stub' in manifest.op_kernels(bench)['rel_attn_fwd']
    out = runner.run(cell, 3, 0.1, False, 'cpu', time.time())
    assert set(out['metrics']) == {'train_tokens_per_s', 'peak_mem_gib', 'setup_s'}
    read = manifest.metric_reader('stub_units.train', bench)
    assert read(Readings(cell, out['attempted'], 1.0, 0.1, None)) == out['attempted']
    _unchanged(bench)


ALIAS_FAMILY = '''"""TF-XL under a family name of its own, whose forward attention is an op
of its own (`alias_attn_fwd`) with its own work."""
from benchmark.families import transfo_xl
from benchmark.families.transfo_xl import (PROGRAM, TINY, forward_flops,  # noqa: F401
                                           layout, matmul_params, roofline_readable)


def alias_attn_fwd(BN, T, H, dtype):
    """Two H-long products for each of T x T pairs; q, k, v in, ctx out."""
    return 2 * 2 * H * T * T * BN, 4 * 2 * BN * T * H, dtype


def attention_calls(config, B, T, backward):
    m = config['model']
    out = transfo_xl.attention_calls(config, B, T, backward)
    del out['rel_attn_fwd']
    call = alias_attn_fwd(B * m['n_head'], T, m['d_head'], m['dtype'])
    out['alias_attn_fwd'] = [call] * m['n_layer']
    return out
'''

ALIAS_CHECK = '''
import json, sys, time
sys.path[:0] = [{checkout!r}, {root!r}]
import torch
torch.set_num_threads(1)
from benchmark.harness import families, gaps, manifest, readers, runner, trace, work
assert str(manifest.BENCH_DIR) == {bench!r}
cell = manifest.find_cell('tfxl-alias.train')
out = runner.run(cell, 2 ** 31 + 5, 0.1, False, 'cpu', time.time())
checks = runner.check(cell, 2 ** 31 + 5, out['_outputs'], 'cpu')
fam = families.get('tfxl_alias')
B, T = cell.traffic['batch'], cell.traffic['seq_len']
calls = work.attention_calls(cell.config, B, T, True)
m = cell.config['model']
k1 = work.rel_attn_fwd(B * m['n_head'], T, T, 0, m['d_head'], m['n_head'], m['dtype'])
stub = trace.Slice(2, 1e-3, [('void alias_k1<64>(...)', 0.0, 40.0),
                             ('void k2_dq_tc(...)', 40.0, 100.0)])
no_alias = trace.Slice(2, 1e-3, [('void k1_tc<64>(...)', 0.0, 40.0)])
read = lambda sl: readers.attn_roofline_pct(readers.Readings(cell, 1, 1.0, 0.1, sl))
print(json.dumps(dict(
    correct=gaps.passes(checks), checks=checks,
    kernels=manifest.op_kernels(), calls={{k: [list(c) for c in v] for k, v in calls.items()}},
    own=list(fam.alias_attn_fwd(B * m['n_head'], T, m['d_head'], m['dtype'])), k1=list(k1),
    roofline=read(stub), no_alias=read(no_alias),
    bound=sum(work.bound_s(*c) for cs in calls.values() for c in cs) * 2 / 100e-6 * 100,
    tokens_per_s=out['metrics']['train_tokens_per_s']['value'])))
'''


def test_a_new_family_comes_in_as_new_files(tmp_path):
    """A family `tfxl_alias` (its module, reference, configuration, traffic,
    limits and an op `alias_attn_fwd` with its kernel file), run and checked
    on the CPU in a fresh interpreter whose `benchmark` is the copy."""
    root, bench = _checkout(tmp_path)
    (bench / 'families' / 'tfxl_alias.py').write_text(ALIAS_FAMILY)
    (bench / 'reference' / 'tfxl_alias.py').write_text(
        '"""TF-XL\'s plain reference under the alias family\'s name."""\n'
        'from benchmark.reference.transfo_xl import LOOKUP_LEAVES, dropout_shapes, logits  '
        '# noqa: F401\n')
    (bench / 'kernels' / 'alias_attn_fwd.json').write_text(json.dumps(
        dict(op='alias_attn_fwd', kernels=['alias_k1'])))
    with open(bench / 'configs' / 'tfxl-base-22-11.json') as f:
        cfg = json.load(f)
    cfg.update(name='tfxl-alias', family='tfxl_alias', reference='tfxl_alias',
               reference_block_rows=2)
    cfg['model'].update(families.get('transfo_xl').TINY, dtype='float32')
    (bench / 'configs' / 'tfxl-alias.json').write_text(json.dumps(cfg))
    (bench / 'traffic' / 'train-4x64.json').write_text(json.dumps(
        dict(entry='train_step', batch=4, seq_len=64, pool=5, why='a stub mix')))
    # float32 on both sides: sound runs read round-off (1e-7 here; AdamW's
    # first step can lift the change's toward 1e-2), a wrong model reads 1e-2 or more
    (bench / 'limits' / 'tfxl-alias.train.json').write_text(json.dumps(
        dict(limits=dict(loss_gap=1e-5, logit_gap=1e-4, grad_gap=1e-4, lookup_grad_gap=1e-4,
                         update_gap=1e-2))))
    m = manifest.load_manifest()
    m['configs'].append(dict(name='tfxl-alias', source='https://example.org/alias',
                             file='benchmark/configs/tfxl-alias.json', reduced=[], why='an alias'))
    m['workloads'].append(dict(name='tfxl-alias.train', config='tfxl-alias',
                               traffic='train-4x64', chips=1, why='an alias cell'))
    for e in m['end_to_end'] + m['per_layer']:
        if 'tfxl-22-11.train' in e.get('workloads', []):
            e['workloads'].append('tfxl-alias.train')
    (root / 'BENCHMARK.json').write_text(json.dumps(m))
    assert manifest.problems(m, root) == [] and config_problems(m, root) == []

    script = ALIAS_CHECK.format(checkout=str(root), root=str(manifest.ROOT),
                                bench=str(bench))
    run = subprocess.run([sys.executable, '-c', script], capture_output=True, text=True,
                         timeout=600, cwd=root)
    assert run.returncode == 0, run.stderr[-3000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert out['correct'], out['checks']
    assert out['tokens_per_s'] > 0
    assert out['kernels']['alias_attn_fwd'] == ['alias_k1']
    assert out['calls']['alias_attn_fwd'] == [out['own']] * 2 and out['own'] != out['k1']
    assert sorted(out['calls']) == ['alias_attn_fwd', 'rel_attn_bwd']
    assert set(out['calls']) <= set(out['kernels'])
    assert out['roofline'] == out['bound'] and out['no_alias'] is None
    _unchanged(bench)
