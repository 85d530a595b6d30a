"""Shared pieces of the benchmark's CPU tests: its cells cut to a tiny
width and depth (each family's `TINY`), with the program on the CPU (its
kernels' plain paths)."""
import copy

import pytest
import torch

from benchmark.harness import families, manifest


def tiny_cell(name: str, dtype: str = None, **limits) -> manifest.Cell:
    """`name`'s cell at a tiny size: 4 rows, 6 pool batches; `dtype`
    overrides the configuration's, `limits` its limits."""
    cell = manifest.find_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg['model'].update(families.get(cfg['family']).TINY)
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
