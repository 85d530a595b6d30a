"""Trinity-Mini's configuration (`configs/trinity-mini-ep8.json`) and its
family module (`families/afmoe.py`): the weights' layout, the attention
calls and FLOPs by hand, the held share of the expert products, the
configuration's cut against the published config, the cell's per-layer
readers, and a tiny cell of the family correct on the CPU."""
import hashlib
import json
import time

import pytest

from benchmark.conftest import tiny_cell
from benchmark.harness import families, gaps, manifest, runner, work
from benchmark.harness.readers import Readings
from benchmark.harness.trace import Slice
from benchmark.harness.weights import layout
from benchmark.test_bench_manifest import config_problems

CELL = 'trinity-mini.train'
# the full-size layout: sha256 of its JSON list, leaves, first and last leaf
LAYOUT = ('e38cbf361e22df4accdcec8487b494fec7b0e1afd38c158db72e8510a138a571', 139,
          ['embed/weight', [1190, 2048], 'normal'],
          ['layers/7/moe/shared/down', [1024, 2048], 'normal'])
# Trinity-Mini's published config.json (the catalog's row) where this file cuts it
PUBLISHED = dict(num_hidden_layers=32, vocab_size=200192, num_experts=128, hidden_size=2048,
                 num_attention_heads=32, num_key_value_heads=4, head_dim=128,
                 intermediate_size=6144, moe_intermediate_size=1024, num_experts_per_tok=8,
                 num_shared_experts=1, num_dense_layers=2, route_scale=2.826,
                 sliding_window=2048, rms_norm_eps=1e-5, rope_theta=10000)


def _cell():
    return manifest.find_cell(CELL)


def test_layout_keys_and_shapes_are_pinned():
    m = _cell().config['model']
    leaves = [[k, list(s), kind] for k, s, kind in layout('afmoe', m)]
    digest, n, first, last = LAYOUT
    assert (len(leaves), leaves[0], leaves[-1]) == (n, first, last)
    assert hashlib.sha256(json.dumps(leaves).encode()).hexdigest() == digest
    shapes = {k: s for k, s, _ in leaves}
    assert shapes['layers/2/moe/experts/gate'] == [16, 2048, 1024]
    assert shapes['layers/2/moe/experts/down'] == [16, 1024, 2048]
    assert shapes['layers/2/moe/router'] == [2048, 128]
    assert shapes['layers/0/attn/q_norm'] == [128] and 'layers/0/moe/router' not in shapes
    assert not any('bias' in k for k in shapes)         # expert_bias is state, not a weight
    n_params = sum(__import__('math').prod(s) for s in shapes.values())
    assert n_params == 941_846_528


def test_attention_calls_and_flops_by_hand():
    """The sliding layers see 1,792.125 keys a query on average at T 8,192
    and window 2,048 (2,048 x 2,049 / 2 + 6,144 x 2,048 pairs); the full
    layers 4,096.5.  B x N = 128 query rows, 16 key rows."""
    cell = _cell()
    sliding, full = 2048 * 2049 // 2 + 6144 * 2048, 8192 * 8193 // 2
    assert sliding / 8192 == 1792.125 and full / 8192 == 4096.5
    calls = work.attention_calls(cell.config, 4, 8192, backward=True)
    kinds = cell.config['model']['layer_types']
    assert kinds == ['sliding_attention'] * 3 + ['full_attention'] + \
        ['sliding_attention'] * 3 + ['full_attention']
    bth = 128 * 8192 * 128
    kv = 16 * 8192 * 128
    for op, products, nbytes in (('gqa_attn_fwd', 2, 2 * (2 * bth + 2 * kv) + 4 * 128 * 8192),
                                 ('gqa_attn_bwd', 5, 2 * (4 * bth + 2 * kv) + 4 * 128 * 8192
                                  + 8 * kv)):
        want = [(products * 2 * 128 * (sliding if k == 'sliding_attention' else full) * 128,
                 nbytes, 'bfloat16') for k in kinds]
        assert calls[op] == want
    assert calls['gqa_attn_fwd'][0] == (962_139_783_168, 608_174_080, 'bfloat16')
    assert set(calls) <= set(manifest.op_kernels())
    assert families.get('afmoe').roofline_readable(calls)


def test_matmul_params_count_the_held_share():
    """Per token: q, gate, o (2,048 x 4,096 each) and k, v (2,048 x 512) in
    8 layers; 2 dense SwiGLUs of 6,144; 6 expert layers of a router
    (2,048 x 128), the shared expert and, of the routed experts, top-8 x
    16 / 128 = one expert's 3 x 2,048 x 1,024; the head 2,048 x 1,190."""
    cfg = _cell().config
    attn = 3 * 2048 * 4096 + 2 * 2048 * 512
    expert = 3 * 2048 * 1024
    want = 8 * attn + 2 * 3 * 2048 * 6144 + 6 * (2048 * 128 + expert + expert) + 2048 * 1190
    assert work.matmul_params(cfg) == want == 373_108_736
    flops = work.forward_flops(cfg, 4, 8192)
    assert flops / 32768 == pytest.approx(1.0566e9, rel=1e-4)
    held_all = dict(cfg, model=dict(cfg['model'], n_experts_held=128))
    assert work.matmul_params(held_all) - want == 6 * 7 * expert     # top-8 of 128: 8 experts


def test_configuration_states_its_cut_and_the_published_widths():
    cell = _cell()
    cfg, m = cell.config, cell.config['model']
    entry = next(c for c in manifest.load_manifest()['configs'] if c['name'] == cfg['name'])
    assert config_problems() == []
    assert entry['reduced'] == cfg['reduced'] == ['num_hidden_layers', 'layer_types',
                                                  'n_experts_held', 'vocab_size']
    assert entry['source'] == cfg['source']
    for k, v in PUBLISHED.items():                       # widths as published, cuts stated
        if k in cfg['reduced']:
            assert m[k] != v and str(v) in json.dumps(cfg['published'][k]), k
        else:
            assert m[k] == v, k
    assert (m['num_hidden_layers'], m['n_experts_held'], m['vocab_size']) == (8, 16, 1190)
    for k in m:                                          # the catalog's keys, as the model runs
        if k in cfg and k != 'name':
            assert cfg[k] == m[k], k
    assert set(cfg['assumed']) >= {'expert_bias', 'embedding_scale', 'sandwich_norms',
                                   'attention', 'output_gate', 'routing', 'vocabulary'}
    assert '32 chips' in cfg['deployment'] and m['dtype'] == 'bfloat16' and m['dropout'] == 0.0


def test_the_new_cell_reads_its_span_and_counter_metrics():
    steps = 2
    log = []
    for step in range(3):                               # 3 steps; the last 2 read
        root = 100 * (step + 1)
        for i, (name, ms, value) in enumerate([('model.moe', 5.0, None),
                                               ('model.route', 1.0, None),
                                               ('moe_rows', None, [10, 20, 30, 60])]):
            log.append(dict(id=root + i + 1, name=name, parent=root, root=root, thread=0,
                            host_ms=0.0, device_ms=ms, value=value))
        log.append(dict(id=root, name='train.step', parent=None, root=root, thread=0,
                        host_ms=0.0, device_ms=50.0))
    r = Readings(_cell(), 3, 1.0, 1.0, Slice(steps, 1.0, []))
    import benchmark.harness.spans as spans
    orig = spans.program_log
    spans.program_log = lambda: log
    try:
        got = {n: manifest.metric_reader(n)(r) for n in ('moe_ms.train', 'route_ms.train',
                                                          'expert_skew.train')}
    finally:
        spans.program_log = orig
    assert got == {'moe_ms.train': 5.0, 'route_ms.train': 1.0, 'expert_skew.train': 2.0}
    names = {p['name'] for p in _cell().per_layer}
    assert {'moe_ms.train', 'route_ms.train', 'expert_skew.train', 'attn_roofline.train',
            'mfu_pct.train'} <= names


def test_a_tiny_cell_of_the_family_is_correct_on_the_cpu():
    """The family's `TINY` widths, in f32: the program's plain paths
    against the reference read round-off, far inside the card's limits."""
    cell = tiny_cell(CELL, dtype='float32')
    seed = 2 ** 31 + 23
    out = runner.run(cell, seed, 0.2, False, 'cpu', time.time())
    checks = runner.check(cell, seed, out['_outputs'], 'cpu')
    assert gaps.passes(checks), checks
    assert checks['loss_gap']['value'] < 1e-6 and checks['grad_gap']['value'] < 1e-5
