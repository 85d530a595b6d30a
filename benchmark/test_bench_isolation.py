"""Neither a run nor the reference loads JAX or the JAX package, and the
reference loads nothing of the program: checked on the modules a fresh
interpreter holds after each has run, and on every import in the sources."""
import json
import subprocess
import sys

import pytest

from benchmark.harness import isolation, manifest

RUN = '''
import json, sys, time
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from benchmark.conftest import tiny_cell
from benchmark.harness import isolation, runner
for name in ('tfxl-22-11.train', 'reformer-22-04.score'):
    cell = tiny_cell(name)
    out = runner.run(cell, 1, 0.05, False, 'cpu', time.time())
    runner.check(cell, 1, out['_outputs'], 'cpu')
print(json.dumps(isolation.loaded(isolation.FORBIDDEN_RUN)))
'''

REFERENCE = '''
import json, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from benchmark.reference import common, reformer, transfo_xl
from benchmark.harness import isolation
from benchmark.harness.weights import make_flat
for fam, ref, m in (('transfo_xl', transfo_xl, dict(vocab_size=50, d_model=32, n_head=2,
                    d_head=16, d_inner=64, n_layer=1, clamp_len=16, init_std=0.02)),
                    ('reformer', reformer, dict(vocab_size=50, d_model=32, n_head=2, d_head=16,
                    d_ff=64, attn_layers=['local', 'lsh'], axial_pos_shape=[4, 8],
                    local_chunk=8, lsh_chunk=8, n_hashes=2, lsh_seed=77, ln_eps=1e-5,
                    init_std=0.02))):
    flat = make_flat(fam, m, 0, 'cpu')
    ids = torch.randint(0, 50, (2, 32))
    for prec in common.PRECISIONS:
        ref.logits(flat, ids, m, prec).sum()
print(json.dumps(isolation.loaded(isolation.FORBIDDEN_REFERENCE)))
'''


@pytest.mark.parametrize('script, name', [(RUN, 'run'), (REFERENCE, 'reference')])
def test_fresh_interpreter_loads_nothing_forbidden(script, name):
    out = subprocess.run([sys.executable, '-c', script.format(root=str(manifest.ROOT))],
                         capture_output=True, text=True, timeout=600, cwd=manifest.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [], name


def test_sources_import_nothing_forbidden():
    for path in manifest.BENCH_DIR.rglob('*.py'):
        tops = isolation.imported_tops(path)
        assert not tops & set(isolation.FORBIDDEN_RUN), path
        if 'families' in path.parts:        # the program's classes only as strings
            assert 'musicnlp_tpu_torch' not in tops, path
        if 'reference' in path.parts:
            assert not tops & set(isolation.FORBIDDEN_REFERENCE), path
            assert not any(t == 'benchmark' for t in tops) or all(
                line.split()[1].startswith('benchmark.reference')
                for line in path.read_text().splitlines()
                if line.startswith(('from benchmark', 'import benchmark'))), path


def test_names_are_compared_whole():
    assert isolation.top('musicnlp_tpu_torch.ops') == 'musicnlp_tpu_torch'
    assert 'musicnlp_tpu_torch' not in isolation.FORBIDDEN_RUN
    sys.modules['jaxlib_lookalike_for_test'] = sys
    try:
        assert 'jaxlib_lookalike_for_test' not in isolation.loaded()
    finally:
        del sys.modules['jaxlib_lookalike_for_test']
