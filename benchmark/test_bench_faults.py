"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a run
on the CPU, at a tiny size, with limits set between that size's sound
readings and its faults' (the cells' own limits are set at their own size
on the card): first sound (correct), then with one fault planted in the
program the run drives.  A single chip has no exchange between chips to
leave out.
"""
import time
import types

import pytest
import torch

from benchmark.conftest import tiny_cell
from benchmark.harness import gaps, program, runner

TRAIN_LIMITS = dict(loss_gap=1e-3, logit_gap=0.03, grad_gap=0.05, lookup_grad_gap=0.05,
                    update_gap=0.3)
SCORE_LIMITS = dict(loss_gap=1e-3, logit_gap=0.03, pred_logit_gap=1e-3, far_pred_count=0.5,
                    acc_count_gap=0.5, ikr_count_gap=0.5)


def _correct(cell, prog, seed=2 ** 31 + 3):
    out = runner.run(cell, seed, 0.05, False, 'cpu', time.time(), prog=prog)
    checks = runner.check(cell, seed, out['_outputs'], 'cpu')
    return gaps.passes(checks), checks


def _prog(**over):
    return types.SimpleNamespace(**dict({k: getattr(program, k) for k in program.__all__}, **over))


def _trainer_with(patch):
    def make(*a, **kw):
        t = program.trainer(*a, **kw)
        patch(t)
        return t
    return make


def _state_unchanged(t):
    t.opt.step = lambda params, grads, state: None


def _half_batch(t):
    inner = t.train_step

    def half(params, state, batch):
        n = batch['input_ids'].shape[0] // 2
        return inner(params, state, {k: v[:n] for k, v in batch.items()})
    t.train_step = half


@pytest.mark.parametrize('name', ['tfxl-22-11.train', 'reformer-22-04.train'])
@pytest.mark.parametrize('fault', [_state_unchanged, _half_batch])
def test_training_faults_are_not_correct(name, fault):
    cell = tiny_cell(name, **TRAIN_LIMITS)
    ok, checks = _correct(cell, _prog())
    assert ok, checks
    ok, checks = _correct(cell, _prog(trainer=_trainer_with(fault)))
    assert not ok, checks


def _flipped_head(mdl):
    """The model's head with one position's logits negated: its prediction
    becomes the token it scored lowest."""
    inner = mdl._lm_head

    def head(params, h):
        out = inner(params, h)
        out = out.clone()
        out[0, 5] = -out[0, 5]
        return out
    mdl._lm_head = head
    return mdl


def _scores_half(mdl, params, ids, labels, ikr, key_scores=None, n_seg=1):
    n = ids.shape[0] // 2
    return program.score_batch(mdl, params, ids[:n], labels[:n], ikr,
                               None if key_scores is None else key_scores[:n], n_seg)


@pytest.mark.parametrize('name', ['tfxl-22-11.score', 'reformer-22-04.score'])
@pytest.mark.parametrize('fault', ['altered_prediction', 'half_batch'])
def test_scoring_faults_are_not_correct(name, fault):
    cell = tiny_cell(name, **SCORE_LIMITS)
    ok, checks = _correct(cell, _prog())
    assert ok, checks
    if fault == 'altered_prediction':
        prog = _prog(model=lambda cfg, device: _flipped_head(program.model(cfg, device)))
    else:
        prog = _prog(score_batch=_scores_half)
    ok, checks = _correct(cell, prog)
    assert not ok, checks


def test_a_sound_f32_run_reads_far_inside_the_tiny_limits():
    cell = tiny_cell('tfxl-22-11.train', dtype='float32', **TRAIN_LIMITS)
    ok, checks = _correct(cell, _prog())
    assert ok and checks['loss_gap']['value'] < 1e-6, checks
    assert torch.get_num_threads() == 1
