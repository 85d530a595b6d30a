"""The port's spans (`utils/profiling.span`): off without a profiler (no
`record_function`, no CUDA event, nothing logged); under `torch.profiler`
a training step's and a scored batch's spans nest as the model runs them,
children inside their parent, each in the Chrome trace inside its root; no
result changes with the profiler on.  `span_kernels` on a hand-made trace,
and the Trainer's `data_wait_s`."""
import copy
import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from musicnlp_tpu_torch.models.reformer import Reformer, ReformerConfig
from musicnlp_tpu_torch.models.transformer_xl import TransfoXL, TransfoXLConfig
from musicnlp_tpu_torch.trainer import train as ttrain
from musicnlp_tpu_torch.trainer.eval import score_batch
from musicnlp_tpu_torch.trainer.metrics import IkrMetric
from musicnlp_tpu_torch.utils import checkpoint as ckpt
from musicnlp_tpu_torch.utils import profiling
from musicnlp_tpu_torch.vocab import MusicTokenizer

N_LAYER = 2
B, T = 2, 32
TOK = MusicTokenizer(pitch_kind='midi', model_max_length=T)
MODELS = {
    'transfo_xl': lambda: TransfoXL(TransfoXLConfig(
        vocab_size=TOK.vocab_size, model_size='test', d_model=32, n_head=2, d_head=16,
        d_inner=64, n_layer=N_LAYER, mem_len=16, clamp_len=T, max_length=T, dtype='float32'),
        device='cpu'),
    'reformer': lambda: Reformer(ReformerConfig(
        vocab_size=TOK.vocab_size, model_size='test', d_model=32, n_head=2, d_head=16, d_ff=64,
        attn_layers=('local', 'lsh'), max_length=T, axial_pos_shape=(4, 8), local_chunk=8,
        lsh_chunk=8, n_hashes=2, dtype='float32'), device='cpu'),
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Rows:
    """The Trainer's dataset contract over fixed rows; `wait` seconds pass
    before the first batch."""

    def __init__(self, ids, wait=0.0):
        self.ids, self.wait = ids, wait

    def __len__(self):
        return len(self.ids)

    def batches(self, batch_size, shuffle=True, seed=None, drop_last=True):
        time.sleep(self.wait)
        for i in range(0, len(self.ids) - batch_size + 1, batch_size):
            ids = self.ids[i:i + batch_size]
            yield dict(input_ids=ids, labels=ids, key_scores=np.ones((len(ids), 24), np.float32))


def _ids(n=B, seed=0):
    return np.random.default_rng(seed).integers(0, TOK.vocab_size, (n, T)).astype(np.int32)


def _batch():
    ids = torch.from_numpy(_ids()).long()
    labels = ids.clone()
    labels[:, -3:] = -100
    return dict(input_ids=ids, labels=labels, key_scores=torch.rand(
        B, 24, generator=torch.Generator().manual_seed(1)))


def _setup(family):
    model = MODELS[family]()
    args = ttrain.TrainArgs(batch_size=B, learning_rate=1e-3, num_train_epochs=1,
                            lr_scheduler_type='constant')
    trainer = ttrain.Trainer(model, TOK, _Rows(_ids()), None, args=args, out_dir='unused')
    params = model.init(seed=3)
    for t in ckpt.flatten(params).values():
        t.requires_grad_(True)
    return model, trainer, params


def _train_step(model, trainer, params):
    return trainer.train_step(params, trainer.opt.init(params), _batch())


def _score(model, trainer, params):
    b = _batch()
    return score_batch(model, params, b['input_ids'], b['labels'], IkrMetric(TOK),
                       b['key_scores'])


ENTRIES = {'train': _train_step, 'score': _score}


@pytest.mark.parametrize('family', list(MODELS))
@pytest.mark.parametrize('entry', list(ENTRIES))
def test_spans_do_nothing_without_a_profiler(family, entry, monkeypatch):
    entered, events = [], []

    class Counting(torch.profiler.record_function):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    def event(*a, **kw):
        events.append(kw)
        raise AssertionError('a span recorded a CUDA event with no profiler running')
    monkeypatch.setattr(torch.profiler, 'record_function', Counting)
    monkeypatch.setattr(torch.autograd.profiler, 'record_function', Counting)
    monkeypatch.setattr(torch.cuda, 'is_initialized', lambda: True)
    monkeypatch.setattr(torch.cuda, 'Event', event)
    profiling.clear_span_log()
    model, trainer, params = _setup(family)
    ENTRIES[entry](model, trainer, params)
    assert profiling.span(profiling.SPANS[0]) is profiling.span('model.attn')
    assert entered == [] and events == [] and profiling.span_log() == []


def _children(log, parent):
    return [s for s in log if s['parent'] == parent['id']]


@pytest.mark.parametrize('family', list(MODELS))
@pytest.mark.parametrize('entry', list(ENTRIES))
def test_spans_nest_under_the_profiler(family, entry, tmp_path):
    model, trainer, params = _setup(family)
    profiling.clear_span_log()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ENTRIES[entry](model, trainer, params)
    log = profiling.span_log()
    roots = [s for s in log if s['parent'] is None]
    assert [s['name'] for s in roots] == ['train.step' if entry == 'train' else 'score.batch']
    root = roots[0]
    assert all(s['root'] == root['id'] for s in log) and {s['name'] for s in log} <= set(
        profiling.SPANS)
    if entry == 'train':
        phases = _children(log, root)
        assert [s['name'] for s in phases] == ['train.forward', 'train.backward',
                                               'train.optimizer']
        model_parent = phases[0]
        assert _children(log, phases[1]) == _children(log, phases[2]) == []
    else:
        model_parent = root
    sections = [s['name'] for s in _children(log, model_parent)]
    assert sections == ['model.attn', 'model.ffn'] * N_LAYER + ['model.head']
    for s in log:
        assert s['device_ms'] is None and s['host_ms'] >= 0
        kids = _children(log, s)
        assert sum(k['host_ms'] for k in kids) <= s['host_ms']
    path = str(tmp_path / 'trace.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
        ann = [e for e in json.load(f)['traceEvents'] if e.get('ph') == 'X'
               and e.get('cat') == 'user_annotation' and e['name'] in profiling.SPANS]
    assert sorted(e['name'] for e in ann) == sorted(s['name'] for s in log)
    top = next(e for e in ann if e['name'] == root['name'])
    t0, t1 = float(top['ts']), float(top['ts']) + float(top['dur'])
    for e in ann:
        assert t0 <= float(e['ts']) and float(e['ts']) + float(e['dur']) <= t1 + 1e-3, e


def _run_both(family, entry):
    """(profiler off, profiler on) results of one call from the same state
    and generator seed."""
    model, trainer, params = _setup(family)
    params_on = copy.deepcopy(params)
    outs = []
    for p, on in ((params, False), (params_on, True)):
        trainer.generator.manual_seed(11)
        state = trainer.opt.init(p)
        if on:
            with profile(activities=[ProfilerActivity.CPU]):
                out = entry(trainer, p, state)
        else:
            out = entry(trainer, p, state)
        outs.append((out, ckpt.flatten(p)))
    return outs


@pytest.mark.parametrize('family', list(MODELS))
def test_the_profiler_changes_no_result(family):
    def grads(trainer, p, state):
        loss, mets, g = trainer.loss_and_grads(p, _batch())
        return dict(loss=loss, **{k: v for k, v in mets.items()}, **g)

    def step(trainer, p, state):
        return trainer.train_step(p, state, _batch())

    def score(trainer, p, state):
        return _score(trainer.model, trainer, p)

    for entry in (grads, step, score):
        (off, p_off), (on, p_on) = _run_both(family, entry)
        assert off.keys() == on.keys()
        for k in off:
            assert torch.equal(off[k], on[k]), (entry.__name__, k)
        for k in p_off:
            assert torch.equal(p_off[k], p_on[k]), (entry.__name__, k)


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = dict(name=name, cat=cat, ph='X', ts=ts, dur=dur, tid=tid, pid=1)
    if corr is not None:
        e['args'] = dict(correlation=corr)
    return e


TRACE = [
    _x('train.step', 'user_annotation', 20, 40),               # a warm-up unit
    _x('cudaLaunchKernel', 'cuda_runtime', 30, 2, corr=7),
    _x('cudaLaunchKernel', 'cuda_runtime', 70, 2, corr=5),      # between the units
    _x('train.step', 'user_annotation', 100, 200),
    _x('train.forward', 'user_annotation', 100, 50),
    _x('model.attn', 'user_annotation', 110, 20),
    _x('cudaLaunchKernel', 'cuda_runtime', 115, 2, corr=1),
    _x('cudaMemcpyAsync', 'cuda_runtime', 140, 2, corr=6),
    _x('train.backward', 'user_annotation', 150, 100),
    _x('cudaLaunchKernel', 'cuda_runtime', 160, 2, tid=2, corr=2),     # autograd's thread
    _x('model.attn', 'user_annotation', 195, 15, tid=2),                # a recompute there
    _x('cudaLaunchKernel', 'cuda_runtime', 200, 2, tid=2, corr=3),
    _x('aten::add_', 'cpu_op', 255, 10),
    _x('train.optimizer', 'user_annotation', 250, 50),
    _x('cudaLaunchKernel', 'cuda_runtime', 260, 2, corr=4),
    _x('bench.feed', 'user_annotation', 60, 30),                # not a program span
    _x('warm', 'kernel', 40, 3, tid=7, corr=7),
    _x('between', 'kernel', 80, 3, tid=7, corr=5),
    _x('k1', 'kernel', 120, 10, tid=7, corr=1),
    _x('Memcpy HtoD', 'gpu_memcpy', 145, 4, tid=7, corr=6),
    _x('k2', 'kernel', 170, 20, tid=7, corr=2),
    _x('k2', 'kernel', 205, 5, tid=7, corr=3),
    _x('adam', 'kernel', 265, 7, tid=7, corr=4),
    _x('adam', 'kernel', 275, 1, tid=7, corr=99),               # no launch in the trace
]


def test_span_kernels_attributes_each_kernel_to_its_launching_span(tmp_path):
    path = tmp_path / 'trace.json'
    path.write_text(json.dumps(dict(traceEvents=TRACE)))
    got = profiling.span_kernels(str(path))
    assert {k: {n: round(ms * 1e3) for n, ms in v.items()} for k, v in got.items()} == {
        'train.step': {'warm': 3}, None: {'between': 3}, 'model.attn': {'k1': 10, 'k2': 5},
        'train.forward': {'Memcpy HtoD': 4}, 'train.backward': {'k2': 20},
        'train.optimizer': {'adam': 7}}
    last = profiling.span_kernels(str(path), units=1)
    assert set(last) == {'model.attn', 'train.forward', 'train.backward', 'train.optimizer'}
    assert profiling.span_kernels(str(path), units=3) == {}


def test_trainer_logs_its_data_wait(tmp_path):
    model = MODELS['transfo_xl']()
    args = ttrain.TrainArgs(batch_size=B, learning_rate=1e-3, num_train_epochs=1,
                            save_per_epoch=False, lr_scheduler_type='constant')
    wait = 0.2
    trainer = ttrain.Trainer(model, TOK, _Rows(_ids(3 * B), wait=wait), None, args=args,
                             out_dir=str(tmp_path))
    t0 = time.perf_counter()
    res = trainer.train()
    wall = time.perf_counter() - t0
    rec = res['history'][0]
    assert wait <= rec['data_wait_s'] <= wall
    log = [json.loads(line) for line in open(trainer.log_path)]
    assert log[-1]['data_wait_s'] == rec['data_wait_s'] and 'train_tokens_per_sec' in log[-1]
