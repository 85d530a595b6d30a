"""The yardstick's work counts at small shapes, against hand counts and
against the program's own pair counts (`_key_mask`, `visible_pairs`)."""
import json

import numpy as np
import pytest
import torch

from benchmark.harness import work
from benchmark.harness.manifest import ROOT


@pytest.mark.parametrize('T, S, M, mv, window, pairs', [
    (4, 4, 0, 0, 0, 10),        # causal 4 x 4
    (2, 4, 2, 1, 0, 5),         # memory of 2, one valid: 2 + 3 keys
    (4, 4, 0, 0, 2, 7),         # window 2: 1 + 2 + 2 + 2
    (3, 5, 2, 2, 0, 12),        # full memory: 3 + 4 + 5
])
def test_causal_pairs_by_hand(T, S, M, mv, window, pairs):
    assert work.causal_pairs(T, S, M, mv, window) == pairs


@pytest.mark.parametrize('T, S, M, mv, window', [(64, 64, 0, 0, 0), (32, 96, 64, 40, 0),
                                                 (48, 48, 0, 0, 16), (16, 48, 32, 32, 20)])
def test_causal_pairs_match_the_programs_key_mask(T, S, M, mv, window):
    from musicnlp_tpu_torch.ops.flash_attention import _key_mask
    mask = _key_mask(T, S, M, mv, window, 'cpu')
    assert work.causal_pairs(T, S, M, mv, window) == int(mask.sum())


@pytest.mark.parametrize('T, chunk, pairs', [(8, 4, 36), (4, 4, 10), (12, 4, 62)])
def test_window_pairs_by_hand_and_the_programs_count(T, chunk, pairs):
    from musicnlp_tpu_torch.ops.chunked_attention_kernel import visible_pairs
    assert work.window_pairs(T, chunk) == pairs
    pos = torch.arange(T, dtype=torch.int32).expand(3, T).contiguous()
    assert visible_pairs(pos, pos, chunk) == 3 * pairs


def test_op_work_by_hand():
    # K1: BN 2, T = S 4, H 16, one head, bf16: 3 products x 2 x 16 x 10 pairs x 2 rows
    assert work.rel_attn_fwd(2, 4, 4, 0, 16, 1, 'bfloat16') == (1920, 1568, 'bfloat16')
    # K2: 8 products; bytes 2 (4 x 128 + 2 x 128 + 128) + 32 + 2 x 2 x 128 + 4 (2 x 128 + 128)
    assert work.rel_attn_bwd(2, 4, 4, 0, 16, 1, 'bfloat16') == (5120, 3872, 'bfloat16')
    # K3: G 3, T 8, D 16, chunk 4: 2 products x 2 x 16 x 36 pairs x 3; (4 x 2 x 16 + 12) x 24
    assert work.window_attn_fwd(3, 8, 16, 4, 'bfloat16') == (6912, 3360, 'bfloat16')
    assert work.window_attn_bwd(3, 8, 16, 4, 'bfloat16') == (17280, (192 + 16 + 128) * 24,
                                                            'bfloat16')


def test_bounds_use_the_published_peaks():
    assert work.bound_s(989e12, 0, 'bfloat16') == pytest.approx(1.0)
    assert work.bound_s(0, 3.35e12, 'bfloat16') == pytest.approx(1.0)
    assert work.bound_s(495e12 / 3, 0, 'float32') == pytest.approx(1.0)


def _config(name):
    with open(ROOT / 'benchmark' / 'configs' / f'{name}.json') as f:
        return json.load(f)


@pytest.mark.parametrize('name, params', [('tfxl-base-22-11', 85_848_576),
                                          ('reformer-base-22-04', 81_719_808)])
def test_matmul_params_by_hand_and_from_the_programs_leaves(name, params):
    cfg = _config(name)
    assert work.matmul_params(cfg) == params
    from benchmark.harness import program
    flat = program.model(cfg, 'cpu').init_flat(0)
    head = 'embed/weight' if cfg['family'] == 'transfo_xl' else 'lm_head/w'   # tied or not
    per_token = [k for k in flat if k.endswith(('qkv', '/o', 'w1/w', 'w2/w', 'qk', '/v', '/k'))
                 or k == head]
    assert sum(int(np.prod(flat[k].shape)) for k in per_token) == params


@pytest.mark.parametrize('name, B, T, params, forward', [   # the parent's counts (ef536802)
    ('tfxl-base-22-11', 21, 1024, 85_848_576, 4_330_572_742_656.0),
    ('tfxl-base-22-11', 64, 1024, 85_848_576, 13_138_573_393_920.0),
    ('reformer-base-22-04', 32, 2048, 81_719_808, 11_053_635_207_168.0)])
def test_model_flops_at_the_cells_shapes_are_pinned(name, B, T, params, forward):
    cfg = _config(name)
    assert work.matmul_params(cfg) == params
    assert work.forward_flops(cfg, B, T) == forward
    assert work.train_flops(cfg, B, T) == 3.0 * forward


def test_step_flops_at_the_cells_shapes():
    tf, rf = _config('tfxl-base-22-11'), _config('reformer-base-22-04')
    per_tok_tf = work.train_flops(tf, 21, 1024) / (21 * 1024)
    per_tok_rf = work.train_flops(rf, 32, 2048) / (32 * 2048)
    assert 5.5e8 < per_tok_tf < 6.5e8 and 4.8e8 < per_tok_rf < 5.4e8
    calls = work.attention_calls(rf, 32, 2048, backward=True)
    assert len(calls['window_attn_fwd']) == 12 and len(calls['window_attn_bwd']) == 12
    assert all(work.bytes_bound_lsh(c) for cs in calls.values() for c in cs)
