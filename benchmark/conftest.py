"""Shared pieces of the benchmark's CPU tests: its cells cut to a tiny
width and depth, with the program on the CPU (its kernels' plain paths)."""
import copy

import pytest
import torch

from benchmark.harness import manifest

TINY_MODEL = {
    'transfo_xl': dict(d_model=64, n_head=4, d_head=16, d_inner=128, n_layer=2, max_length=64,
                       clamp_len=64, mem_len=32),
    'reformer': dict(d_model=64, n_head=4, d_head=16, d_ff=128, attn_layers=['local', 'lsh'],
                     max_length=128, axial_pos_shape=[8, 16], local_chunk=16, lsh_chunk=16),
}


def tiny_cell(name: str, dtype: str = None, **limits) -> manifest.Cell:
    """`name`'s cell at a tiny size: 4 rows, 6 pool batches; `dtype`
    overrides the configuration's, `limits` its limits."""
    cell = manifest.find_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg['model'].update(TINY_MODEL[cfg['family']])
    if dtype:
        cfg['model']['dtype'] = dtype
    cfg['reference_block_rows'] = 2
    traffic = dict(cell.traffic, batch=4, seq_len=cfg['model']['max_length'], pool=6)
    return manifest.Cell(name, cfg, traffic, dict(cell.limits, **limits), 1, cell.end_to_end,
                         cell.per_layer)


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny torch ops run fastest on one thread, and several test workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
