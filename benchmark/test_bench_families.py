"""The family modules (`families/<family>.py`) hold all that the harness
knows of a model family; every cell reads what it read before that code
moved there.  The literals are the parent's: the harness at commit
ef536802f3686425416dfe2250c334b389b6eb2b (weights, work counts and
kernels in `weights.py`, `work.py` and `entries/*.py`) printed them, at
each cell's batch and length and at full size; `matmul_params` and the
step's FLOPs are pinned in `test_bench_work.py`."""
import hashlib
import json

import pytest
import torch

from benchmark.conftest import tiny_cell
from benchmark.harness import families, manifest, traffic, work
from benchmark.harness.weights import layout, make_flat

K1_21 = (50783846400, 169328640, 'bfloat16')        # one K1 call at 21 x 1024
K2_21 = (135423590400, 406831104, 'bfloat16')
K1_64 = (154769817600, 509607936, 'bfloat16')       # at 64 x 1024
K2_64 = (412719513600, 1220542464, 'bfloat16')
K3 = [(19025362944, 412090368, 'bfloat16'),         # a local and an LSH layer at 32 x 2048
      (38050725888, 824180736, 'bfloat16')]
K4 = [(47563407360, 1019215872, 'bfloat16'), (95126814720, 2038431744, 'bfloat16')]

TFXL_LAYOUT = ('9bde8697f43162042a43a4f5dc84b8e51784d55b8bcda4bc4ddb944864a9823d', 158,
               ['embed/weight', [1190, 768], 'normal'])
REFORMER_LAYOUT = ('b86fa69b9ad8e40bf407f9280be7dbbdcf49feb7f770b93dc88c18d0f62a1bd4', 145,
                   ['embed/weight', [422, 768], 'normal'])
LAST_LEAF = ['layers/11/ffn/ln/bias', [768], 'zeros']

PINNED = {   # cell: (layout sha256, leaves, first leaf), forward's calls, forward and backward's
    'tfxl-22-11.train': (TFXL_LAYOUT, {'rel_attn_fwd': [K1_21] * 12},
                         {'rel_attn_fwd': [K1_21] * 12, 'rel_attn_bwd': [K2_21] * 12}),
    'tfxl-22-11.score': (TFXL_LAYOUT, {'rel_attn_fwd': [K1_64] * 12},
                         {'rel_attn_fwd': [K1_64] * 12, 'rel_attn_bwd': [K2_64] * 12}),
    'reformer-22-04.train': (REFORMER_LAYOUT, {'window_attn_fwd': K3 * 6},
                             {'window_attn_fwd': K3 * 6, 'window_attn_bwd': K4 * 6}),
    'reformer-22-04.score': (REFORMER_LAYOUT, {'window_attn_fwd': K3 * 6},
                             {'window_attn_fwd': K3 * 6, 'window_attn_bwd': K4 * 6}),
}

OP_KERNELS = {
    'rel_attn_bwd': ['k2_dkdv_tc', 'k2_dq_tc', 'k2_dkdv_slab', 'k2_dq_slab', 'row_dot_kernel',
                     'row_dot_wide'],
    'rel_attn_fwd': ['k1_tc', 'k1_slab'],
    'window_attn_bwd': ['k4_tc', 'k4_dq_tc', 'k4_dkdv_tc', 'k4_dq_slab', 'k4_dkdv_slab',
                        'row_dot_kernel', 'row_dot_wide'],
    'window_attn_fwd': ['k3_tc', 'k3_union_tc', 'k3_slab'],
}

# the reference's float64 sums of its logits on the CPU at the family's
# `TINY` widths (4 rows; weights and rows from seed 3), of their absolute
# values, a few logits [b, t, v], and the sum of the weights
LOGITS = {
    'tfxl-22-11.train': dict(
        shape=[4, 64, 1190], sum=385.35641124812526, abs_sum=39222.84188994171,
        at={(0, 0, 0): -0.0639645904302597, (1, 5, 7): -0.007300376892089844,
            (2, 10, 595): -0.027144091203808784, (3, 63, 1189): -0.2499571144580841},
        weights_sum=266.84777505703926),
    'reformer-22-04.train': dict(
        shape=[4, 128, 422], sum=1263.6580537857217, abs_sum=26919.838328584643,
        at={(0, 0, 0): 0.0012094964040443301, (1, 5, 7): 0.14213840663433075,
            (2, 10, 211): -0.0032465762924402952, (3, 127, 421): -0.04535120353102684},
        weights_sum=328.381636458899),
}


@pytest.mark.parametrize('name', sorted(PINNED))
def test_layout_and_attention_calls_are_the_parents(name):
    cell = manifest.find_cell(name)
    cfg, B, T = cell.config, cell.traffic['batch'], cell.traffic['seq_len']
    (digest, n, first), fwd, fwd_bwd = PINNED[name]
    leaves = [[k, list(s), kind] for k, s, kind in layout(cfg['family'], cfg['model'])]
    assert (len(leaves), leaves[0], leaves[-1]) == (n, first, LAST_LEAF)
    assert hashlib.sha256(json.dumps(leaves).encode()).hexdigest() == digest
    assert work.attention_calls(cfg, B, T, backward=False) == fwd
    assert work.attention_calls(cfg, B, T, backward=True) == fwd_bwd
    assert set(fwd_bwd) <= set(manifest.op_kernels())


def test_op_kernels_keep_the_parents():
    """The parent's ops keep their kernel names; a later `kernels/*.json`
    may add ops and names."""
    kernels = manifest.op_kernels()
    assert {op: kernels[op] for op in OP_KERNELS} == OP_KERNELS


@pytest.mark.parametrize('name', [w['name'] for w in manifest.load_manifest()['workloads']])
def test_every_call_of_a_cell_has_kernel_names(name):
    """Each op that a cell's forward and backward call has a `kernels/*.json`."""
    cell = manifest.find_cell(name)
    calls = work.attention_calls(cell.config, cell.traffic['batch'], cell.traffic['seq_len'], True)
    assert calls and set(calls) <= set(manifest.op_kernels())


@pytest.mark.parametrize('name', sorted(LOGITS))
def test_reference_logits_are_the_parents(name):
    """The same seed gives the same weights, rows and reference logits.
    Within a few float32 roundings, which another CPU's vector units may
    order differently; a wrong weight or module reads 1e-2 or more."""
    cell = tiny_cell(name)
    cfg, want = cell.config, LOGITS[name]
    flat = make_flat(cfg['family'], cfg['model'], 3, 'cpu')
    ids = torch.from_numpy(traffic.make_pool(cell.traffic, cfg, 3)[0]['input_ids']).long()
    with torch.no_grad():
        lg = families.reference(cfg).logits(flat, ids, cfg['model']).double()
    assert list(lg.shape) == want['shape']
    assert float(sum(t.double().sum() for t in flat.values())) == pytest.approx(
        want['weights_sum'], rel=1e-9)
    assert abs(float(lg.sum()) - want['sum']) <= 1e-6 * want['abs_sum']
    assert float(lg.abs().sum()) == pytest.approx(want['abs_sum'], rel=1e-6)
    for at, v in want['at'].items():
        assert float(lg[at]) == pytest.approx(v, rel=1e-5, abs=1e-7)


def test_a_missing_family_names_the_file_to_add():
    with pytest.raises(ModuleNotFoundError, match='benchmark/families/no_such_family.py'):
        families.get('no_such_family')
    with pytest.raises(ModuleNotFoundError, match='benchmark/reference/no_such_model.py'):
        families.reference({'reference': 'no_such_model'})
    with pytest.raises(ValueError):
        families.get('transfo_xl.sub')
