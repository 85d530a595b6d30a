"""The readers of the program's spans (`harness/spans.py`): on a hand-made
span log, the last `steps` roots and nothing outside them; None without a
slice, with too few roots or without device times.  On the card, a tiny
traced cell of each entry gives each of its span metrics a value."""
import time

import pytest
import torch

from benchmark.conftest import tiny_cell
from benchmark.harness import manifest, runner, spans, trace
from benchmark.harness.readers import Readings
from musicnlp_tpu_torch.utils import profiling

SPAN_METRICS = {
    'train': {'forward_ms.train': 'train.forward', 'backward_ms.train': 'train.backward',
              'optimizer_ms.train': 'train.optimizer'},
    'score': {'attention_ms.score': 'model.attn', 'ffn_ms.score': 'model.ffn',
              'head_ms.score': 'model.head'},
}


def _rec(i, name, parent, root, ms):
    return dict(id=i, name=name, parent=parent, root=root, thread=1, host_ms=ms, device_ms=ms)


def _step_log(first_id, scale):
    """One training step's records, in the order they close."""
    i = first_id
    return [_rec(i + 2, 'model.attn', i + 1, i, 2.0 * scale),
            _rec(i + 3, 'model.ffn', i + 1, i, 3.0 * scale),
            _rec(i + 4, 'model.head', i + 1, i, 1.0 * scale),
            _rec(i + 1, 'train.forward', i, i, 7.0 * scale),
            _rec(i + 5, 'train.backward', i, i, 11.0 * scale),
            _rec(i + 6, 'train.optimizer', i, i, 5.0 * scale),
            _rec(i, 'train.step', None, i, 24.0 * scale)]


def _readings(steps):
    sl = trace.Slice(steps=steps, window_s=1.0, ops=[]) if steps else None
    return Readings(tiny_cell('tfxl-22-11.train'), units=4, window_s=1.0, host_s=0.1, slice=sl)


LOG = (_step_log(1, 100.0)                                        # a warm-up step
       + [_rec(50, 'model.attn', None, 50, 1000.0)]               # a recompute: no root
       + _step_log(10, 1.0) + _step_log(20, 2.0))


def test_readers_take_the_last_roots_only():
    r = _readings(2)
    assert spans.span_ms(r, ('train.forward',), LOG) == pytest.approx((7 + 14) / 2)
    assert spans.span_ms(r, ('model.attn',), LOG) == pytest.approx((2 + 4) / 2)
    assert spans.span_ms(r, ('train.forward', 'train.backward', 'train.optimizer'), LOG) \
        == pytest.approx((23 + 46) / 2)
    assert spans.span_ms(_readings(3), ('train.backward',), LOG) == pytest.approx(
        (1100 + 11 + 22) / 3)


def test_readers_find_nothing_to_read():
    assert spans.span_ms(_readings(0), ('train.forward',), LOG) is None
    assert spans.span_ms(_readings(4), ('train.forward',), LOG) is None
    assert spans.span_ms(_readings(2), ('score.batch',), LOG) is None
    assert spans.span_ms(_readings(2), ('train.forward',), []) is None
    cpu = [dict(s, device_ms=None) for s in LOG]
    assert spans.span_ms(_readings(2), ('train.forward',), cpu) is None


def test_readers_of_a_program_without_a_span_log(monkeypatch):
    monkeypatch.delattr(profiling, 'span_log')
    assert spans.program_log() == []
    assert spans.forward_ms(_readings(1)) is None


def test_each_span_metric_has_its_reader_and_entry(monkeypatch):
    m = manifest.load_manifest()
    per = {p['name']: p for p in m['per_layer']}
    monkeypatch.setattr(spans, 'program_log', lambda: LOG)
    r = _readings(2)
    for entry, metrics in SPAN_METRICS.items():
        for name, span_name in metrics.items():
            p = per[name]
            assert (p['source'], p['unit'], p['better'], p['layer']) == (
                'program_span', 'ms', 'lower', 'model step')
            assert p['workloads'] == [w['name'] for w in m['workloads']
                                      if w['name'].endswith('.' + entry)]
            assert span_name in profiling.SPANS
            want = spans.span_ms(r, (span_name,), LOG)
            assert want is not None and manifest.metric_reader(name)(r) == want, name


@pytest.mark.cuda
@pytest.mark.parametrize('cell', ['tfxl-22-11.train', 'reformer-22-04.train',
                                  'tfxl-22-11.score', 'reformer-22-04.score'])
def test_a_tiny_traced_cell_reads_its_spans_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    c = tiny_cell(cell)
    out = runner.run(c, 2 ** 31 + 5, 0.5, True, 'cuda', time.time())
    entry = cell.rsplit('.', 1)[1]
    for name in SPAN_METRICS[entry]:
        assert out['metrics'][name]['value'] > 0, name
    log = profiling.span_log()
    roots = [s for s in log if s['parent'] is None and s['name'] in spans.ROOTS]
    roots = roots[-runner.TRACE_STEPS:]
    for root in roots:
        kids = [s for s in log if s['parent'] == root['id']]
        assert root['device_ms'] > 0 and all(s['device_ms'] >= 0 for s in kids)
        assert sum(s['device_ms'] for s in kids) <= root['device_ms'] * (1 + 1e-6) + 1e-3
        if entry == 'train':
            assert [s['name'] for s in kids] == ['train.forward', 'train.backward',
                                                 'train.optimizer']
