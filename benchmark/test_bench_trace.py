"""The trace reader on a hand-made Chrome trace: busy time, idle gaps named
by the innermost host activity, kernel times by whole name, and the
readers that use them."""
import pytest

from benchmark.conftest import tiny_cell
from benchmark.harness import readers, trace


def _x(name, cat, ts, dur, tid=1):
    return dict(name=name, cat=cat, ph='X', ts=ts, dur=dur, tid=tid, pid=1)


EVENTS = [
    _x('bench.slice', 'user_annotation', 100, 100),
    _x('bench.train_step', 'user_annotation', 100, 60),
    _x('aten::add_', 'cpu_op', 110, 20),
    _x('cudaLaunchKernel', 'cuda_runtime', 115, 5),
    _x('bench.fetch', 'user_annotation', 170, 30),
    _x('void k1_tc<__nv_bfloat16, 64>(...)', 'kernel', 120, 10, tid=7),
    _x('void k1_tc_other(...)', 'kernel', 125, 10, tid=7),        # overlaps; not K1 by name
    _x('elementwise_kernel', 'kernel', 150, 20, tid=7),
    _x('Memcpy HtoD', 'gpu_memcpy', 90, 20, tid=8),               # clipped to 100-110
    _x('late kernel', 'kernel', 195, 20, tid=7),                   # clipped to 195-200
    _x('other thread op', 'cpu_op', 100, 100, tid=2),
]


def test_slice_busy_gaps_and_names():
    sl = trace.parse(EVENTS, steps=2)
    assert sl.window_s == pytest.approx(100e-6)
    # device: 100-110, 120-135, 150-170, 195-200 -> 50 us busy
    assert sl.busy_s == pytest.approx(50e-6)
    assert sl.time_of(['k1_tc']) == pytest.approx(10e-6)
    assert sl.time_of(['k1_tc', 'elementwise_kernel']) == pytest.approx(30e-6)
    gaps = dict((n, round(t * 1e6)) for n, t in sl.gaps)
    # 110-120 under aten::add_ (mid 115 also under cudaLaunchKernel 115-120: innermost)
    assert gaps == {'cudaLaunchKernel': 10, 'bench.train_step': 15, 'bench.fetch': 25}
    top = sl.top_ops(2)
    assert top[0][0] == 'elementwise_kernel' and top[0][1] == pytest.approx(20e-6)
    assert sl.top_gaps(1)[0][0] == 'bench.fetch'


def test_readers_on_a_slice():
    cell = tiny_cell('tfxl-22-11.train')
    sl = trace.parse(EVENTS, steps=2)
    r = readers.Readings(cell, units=4, window_s=2.0, host_s=0.4, slice=sl)
    assert readers.host_ms_per_unit(r) == pytest.approx(100.0)
    # 25 us busy a traced step against 0.5 s a step in the window
    assert readers.device_idle_pct(r) == pytest.approx(100.0 * (1 - 25e-6 / 0.5))
    assert readers.attn_roofline_pct(r) > 0
    assert readers.mfu_pct(r) > 0
    none = readers.Readings(cell, units=0, window_s=1.0, host_s=0.0, slice=None)
    assert readers.attn_roofline_pct(none) is None and readers.device_idle_pct(none) is None
    assert readers.host_ms_per_unit(none) is None and readers.mfu_pct(none) is None
