"""Each cell run briefly on the card through the benchmark's command: the
result line's keys, `correct`, and the metrics of each kind of run.  Marked
`cuda`; without a card they skip."""
import json
import subprocess
import sys

import pytest
import torch

from benchmark.harness import manifest

M = manifest.load_manifest()


def _card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')


@pytest.mark.cuda
@pytest.mark.parametrize('cell', [w['name'] for w in M['workloads']])
@pytest.mark.parametrize('traced', [0, 1])
def test_cell_runs_on_the_card(cell, traced):
    _card()
    out = subprocess.run([sys.executable, 'benchmark/run.py', '--workload', cell, '--seed',
                          str(2 ** 31 + 17), '--seconds', '2', '--trace', str(traced)],
                         capture_output=True, text=True, timeout=900, cwd=manifest.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res)[-1] == 'checks' and res['correct'], res['checks']
    c = manifest.find_cell(cell)
    want = {p['name'] for p in c.per_layer} if traced else {e['name'] for e in c.end_to_end}
    assert set(res['metrics']) == want
    assert res['device']['platform'] == 'gpu' and res['device']['count'] == 1
    if traced:
        assert 0 < res['device']['busy_s'] <= res['device']['window_s']
        assert res['breakdown']['device_ops'] and res['breakdown']['idle_gaps']
