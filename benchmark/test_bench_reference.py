"""The plain reference against the program's CPU path at tiny sizes (both
families), and the benchmark's frozen inputs against the program's."""
import json
import time

import numpy as np
import pytest
import torch

from benchmark.conftest import tiny_cell
from benchmark.harness import program, runner, traffic
from benchmark.harness.entries import score_batch, train_step
from benchmark.harness.seeds import sub_seed
from benchmark.harness.weights import layout, make_flat, nest
from benchmark.reference import common, reformer, transfo_xl

CELLS = ('tfxl-22-11.train', 'reformer-22-04.train')
REFS = {'transfo_xl': transfo_xl, 'reformer': reformer}


@pytest.mark.parametrize('name', CELLS)
def test_weights_have_the_programs_layout(name):
    cfg = tiny_cell(name).config
    ours = {k: tuple(s) for k, s, _ in layout(cfg['family'], cfg['model'])}
    theirs = {k: tuple(v.shape) for k, v in program.model(cfg, 'cpu').init_flat(0).items()}
    assert ours == theirs


def test_weights_come_from_the_seed():
    cfg = tiny_cell(CELLS[0]).config
    a, b = (make_flat(cfg['family'], cfg['model'], 5, 'cpu') for _ in range(2))
    c = make_flat(cfg['family'], cfg['model'], 6, 'cpu')
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a['embed/weight'], c['embed/weight'])


@pytest.mark.parametrize('kind', ['degree', 'midi'])
def test_frozen_vocab_is_the_programs(kind):
    from musicnlp_tpu_torch.vocab import MusicTokenizer, key_inkey_mask
    tok = MusicTokenizer(pitch_kind=kind)
    v = traffic.vocab(kind)
    assert list(v.tokens) == [tok.vocab.id2tok[i] for i in range(len(tok.vocab))]
    assert (v.pad_id, v.eos_id) == (tok.pad_token_id, tok.eos_token_id)
    assert np.array_equal(v.pitch_class, np.asarray(tok.vocab.id_pitch_class_table))
    assert np.array_equal(v.inkey, np.asarray(key_inkey_mask, bool).T)


def test_rows_follow_the_seed_and_the_song_contract():
    cell = tiny_cell(CELLS[0])
    a = traffic.make_pool(cell.traffic, cell.config, 9)
    b = traffic.make_pool(cell.traffic, cell.config, 9)
    assert all(np.array_equal(x['input_ids'], y['input_ids']) for x, y in zip(a, b))
    v = traffic.vocab('degree')
    for batch in a:
        ids, labels = batch['input_ids'], batch['labels']
        assert ids.shape == (4, 64) and (batch['key_scores'].sum(1) == 1).all()
        assert (ids[:, 0] == v.tok2id['TimeSig_4/4']).all()
        assert v.tokens[ids[0, 2]].startswith('Key_')
        assert ((ids == v.eos_id).sum(1) == 1).all()
        assert ((labels == -100) == (ids == v.pad_id)).all()
    rows = np.concatenate([x['input_ids'] for x in a])
    assert len({r.tobytes() for r in rows}) == len(rows)


@pytest.mark.parametrize('name', CELLS)
def test_reference_logits_equal_the_programs_in_f32(name):
    cell = tiny_cell(name, dtype='float32')
    cfg = cell.config
    flat = make_flat(cfg['family'], cfg['model'], 3, 'cpu')
    ids = torch.from_numpy(traffic.make_pool(cell.traffic, cfg, 4)[0]['input_ids']).long()
    with torch.no_grad():
        ours = REFS[cfg['family']].logits(flat, ids, cfg['model'])
        mdl = program.model(cfg, 'cpu')
        out = mdl.forward(nest(flat), ids)
        theirs = out[0] if isinstance(out, tuple) else out
    assert float((ours - theirs).abs().max()) <= 1e-4 * float(theirs.abs().max())


@pytest.mark.parametrize('name', CELLS)
def test_training_check_reads_round_off_in_f32(name):
    """The program's training steps in f32 (dropout on) against the
    reference's: the same draws, so the gaps are f32 round-off."""
    cell = tiny_cell(name, dtype='float32')
    out = runner.run(cell, 2 ** 31 + 11, 0.2, False, 'cpu', time.time())
    nums = train_step.numbers(cell, None, out['_outputs'],
                              train_step.reference_outputs(cell, 2 ** 31 + 11, 'cpu'))
    assert nums['loss_gap'] < 1e-6 and nums['grad_gap'] < 1e-5 and nums['logit_gap'] < 1e-5
    assert nums['update_gap'] < 1e-2      # AdamW divides round-off by near-zero moments
    assert out['attempted'] >= 1 and out['metrics']['train_tokens_per_s']['value'] > 0


@pytest.mark.parametrize('name', ['tfxl-22-11.score', 'reformer-22-04.score'])
def test_scoring_check_reads_round_off_in_f32(name):
    cell = tiny_cell(name, dtype='float32')
    seed = 77
    out = runner.run(cell, seed, 0.2, False, 'cpu', time.time())
    checks = runner.check(cell, seed, out['_outputs'], 'cpu')
    assert checks['loss_gap']['value'] < 1e-6 and checks['pred_logit_gap']['value'] < 1e-4
    assert checks['logit_gap']['value'] < 1e-5 and checks['far_pred_count']['value'] == 0
    assert checks['acc_count_gap']['value'] < 1e-3 and checks['ikr_count_gap']['value'] < 1e-2
    assert len(out['_outputs']['batches']) == score_batch.SAMPLE


def test_bf16_row_sums_round_after_every_addition():
    """Row 1 gathered three times: 1 + 2^-9 + 2^-9 is 1 + 2^-8 in float32,
    but each 2^-9 is a quarter of bfloat16's step at 1 and rounds away."""
    table = torch.zeros(3, 2, requires_grad=True)
    ids = torch.tensor([[1, 0, 1, 1]])
    g = torch.tensor([[[1.0, 1.0], [2.0, 0.5], [2 ** -9, 0.0], [2 ** -9, 0.0]]])
    plain = torch.autograd.grad((common.lookup(table, ids) * g).sum(), table)[0]
    sums = common.Bf16RowSums()
    rows = sums(table, ids)
    assert torch.equal(torch.autograd.grad((rows * g).sum(), table)[0], torch.zeros(3, 2))
    witness = sums.table_grad()
    assert float(plain[1, 0]) == 1 + 2 ** -8 and float(witness[1, 0]) == 1.0
    assert torch.equal(witness[0], plain[0]) and torch.equal(witness[2], plain[2])


@pytest.mark.parametrize('name', CELLS)
def test_checked_steps_run_at_the_peak_learning_rate(name):
    """Both sides start the optimizer at the end of the warmup: the
    schedule's peak, where the step and the weight decay move every leaf."""
    cell = tiny_cell(name)
    rec = cell.config['recipe']
    start = train_step.start_count(rec)
    assert start > train_step.CHECKED
    assert common.warmup_cosine(rec['learning_rate'], *common.schedule(rec), start) == \
        rec['learning_rate']
    s = train_step.Session(cell, 4, 'cpu')
    assert int(s.opt_state['count']) == start + train_step.CHECKED
    assert s.trainer.opt.sched(start) == pytest.approx(rec['learning_rate'], rel=1e-6)
    s.free()


def test_reference_draws_the_programs_dropout():
    """Dropout on and off give different losses, and the reference with the
    program's draws agrees with the program where one without does not."""
    cell = tiny_cell(CELLS[0], dtype='float32')
    seed = 5
    out = runner.run(cell, seed, 0.2, False, 'cpu', time.time())['_outputs']
    ref = train_step.reference_outputs(cell, seed, 'cpu')
    assert abs(out['losses'][0] - ref['losses'][0]) < 1e-5
    cell.config['model']['dropout'] = 0.0
    plain = train_step.reference_outputs(cell, seed, 'cpu')
    assert abs(out['losses'][0] - plain['losses'][0]) > 1e-3
    assert sub_seed(seed, 'dropout') != sub_seed(seed, 'weights')


def test_seeds_take_large_values():
    assert sub_seed(2 ** 31 + 5, 'rows') != sub_seed(2 ** 31 + 6, 'rows')
    assert 0 <= sub_seed(-3, 'weights') < 2 ** 63
    json.dumps(sub_seed(2 ** 40, 'sample'))
