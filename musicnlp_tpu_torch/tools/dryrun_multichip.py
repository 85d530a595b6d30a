"""One full sharded train step of each model family on an n-rank world.

Counterpart of `dryrun_multichip` in the JAX package's `__graft_entry__.py`:
on a (data, model) mesh of n processes (model 2 when n is even), one
`Trainer.train_step` -- loss, gradients summed over the data ranks, the
logical gradient norm and clip, AdamW -- of the TF-XL debug model, of the
Reformer debug model, and of the debug trunk over a 262,144-unit
vocabulary with the tied table row-sharded over `model` (`shard_vocab`),
each from seeded weights and a seeded batch.  Rank 0 prints one line per
model, the JAX function's three lines.

    python -m musicnlp_tpu_torch.tools.dryrun_multichip --n 4            # gloo, CPU
    python -m musicnlp_tpu_torch.tools.dryrun_multichip --n 4 --device cuda   # NCCL, 1 GPU a rank

Each rank is a spawned process that joins the world through
`parallel.mesh.init_distributed` (the environment `torch.distributed.run`
would set, on a free localhost port).
"""
from __future__ import annotations

import argparse
import math
import multiprocessing as mp
import os
import queue
import socket
import sys
import time
from dataclasses import replace
from typing import List

import numpy as np

__all__ = ['dryrun_multichip']

VOCAB_262K = 262144


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _step(model, mesh, seed: int) -> dict:
    """One Trainer.train_step of `model` on its rows of a seeded global batch."""
    from musicnlp_tpu_torch.parallel import mesh as mesh_lib
    from musicnlp_tpu_torch.trainer.train import TrainArgs, Trainer
    from musicnlp_tpu_torch.utils.checkpoint import flatten
    from musicnlp_tpu_torch.vocab import MusicTokenizer, N_KEY

    B = 2 * mesh.n_batch
    T = model.cfg.max_length
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, model.cfg.vocab_size, (B, T)).astype(np.int32)
    batch = dict(input_ids=ids, labels=np.where(ids % 11 == 0, -100, ids).astype(np.int32),
                 key_scores=np.abs(rng.standard_normal((B, N_KEY))).astype(np.float32))
    args = TrainArgs(batch_size=B, learning_rate=1e-3, weight_decay=1e-4,
                     lr_scheduler_type='constant', max_grad_norm=1.0, seed=seed)
    trainer = Trainer(model, MusicTokenizer(pitch_kind='midi'), (), args=args, mesh=mesh)
    params, opt_state = trainer.init_state()
    for t in flatten(params).values():
        t.requires_grad_(True)
    i, n = mesh.batch_index, mesh.n_batch
    rows = {k: v[i * (B // n):(i + 1) * (B // n)] for k, v in batch.items()}
    mets = trainer.train_step(params, opt_state, mesh_lib.make_global_batch(rows, mesh))
    return {k: float(v) for k, v in mets.items()}


def _worker(rank: int, n: int, port: int, device: str, out) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank),
                      MASTER_ADDR='localhost', MASTER_PORT=str(port))
    import torch
    import torch.distributed as dist

    from musicnlp_tpu_torch.models.reformer import Reformer, ReformerConfig
    from musicnlp_tpu_torch.models.transformer_xl import TransfoXL, TransfoXLConfig
    from musicnlp_tpu_torch.parallel import mesh as mesh_lib

    if device == 'cpu':
        torch.set_num_threads(1)
    mesh_lib.init_distributed(device=device, timeout_s=300)
    try:
        n_model = 2 if n % 2 == 0 else 1
        mesh = mesh_lib.make_mesh(n_data=n // n_model, n_model=n_model, device=device)
        dev = mesh.device
        cfg = TransfoXLConfig.from_size('debug', vocab_size=422, dtype='float32')
        m = _step(TransfoXL(cfg, device=dev), mesh, 1)
        lines = [f'dryrun_multichip(n={n}, mesh={mesh.shape}): loss={m["loss"]:.4f} '
                 f'ntp_acc={m["ntp_acc"]:.4f} ikr={m["ikr"]:.4f}']
        rcfg = ReformerConfig.from_size('debug', vocab_size=422, dtype='float32')
        m = _step(Reformer(rcfg, device=dev), mesh, 11)
        lines.append(f'dryrun_multichip reformer(n={n}): loss={m["loss"]:.4f} '
                     f'ntp_acc={m["ntp_acc"]:.4f}')
        vcfg = replace(TransfoXLConfig.from_size('debug', vocab_size=VOCAB_262K,
                                                 dtype='float32'),
                       shard_vocab=True, head_chunk=8192)
        m = _step(TransfoXL(vcfg, device=dev), mesh, 21)
        lines.append(f'dryrun_multichip shard_vocab 262k(n={n}): loss={m["loss"]:.4f} '
                     f'(ln V = {math.log(VOCAB_262K):.4f}) ntp_acc={m["ntp_acc"]:.4f}')
        if rank == 0:
            out.put(lines)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: str = 'cpu', timeout_s: float = 600) -> List[str]:
    """Run the three steps on `n_devices` spawned ranks (gloo on the CPU,
    NCCL with one GPU a rank on 'cuda'); print and return rank 0's lines.
    Raises if a rank fails or the run outlasts `timeout_s`."""
    ctx = mp.get_context('spawn')
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_worker, args=(r, n_devices, port, device, out))
             for r in range(n_devices)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    lines = None
    try:
        # a rank that fails leaves the others waiting in a collective: stop at
        # the first nonzero exit code instead of at the deadline
        while any(p.is_alive() for p in procs) or lines is None:
            if time.monotonic() > deadline:
                raise RuntimeError(f'dryrun_multichip: not done within {timeout_s} s')
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            try:
                lines = out.get(timeout=0.5) if lines is None else lines
            except queue.Empty:
                continue
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 0.1))
        codes = [p.exitcode for p in procs]
        if codes != [0] * n_devices or lines is None:
            raise RuntimeError(f'dryrun_multichip: rank exit codes {codes}')
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    for line in lines:
        print(line, flush=True)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--n', type=int, default=4, help='ranks (model 2 when even)')
    ap.add_argument('--device', default='cpu', choices=('cpu', 'cuda'))
    a = ap.parse_args(argv)
    dryrun_multichip(a.n, a.device)
    return 0


if __name__ == '__main__':
    sys.exit(main())
