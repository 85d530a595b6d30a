"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): `python3 chip_smoke.py`.

Drives the port's main paths -- TF-XL base training, scoring and generation
(the 22-11 recipe: d_model 768, 12 heads x 64, 12 layers, degree vocab 1190,
max_length 1024, mem_len 512, clamp_len 1024, bf16, batch 21, AdamW with
weight decay 0.1) and the Reformer's (the 22-04 recipe: base, d_model 768,
12 heads x 64, 12 layers alternating local and LSH attention, 2 hashes,
chunk 64, 64 buckets, midi vocab 422, max_length 2048, bf16, dropout 0.05,
batch 32, sampling with top_p 0.9), on weights made from a seed with numpy
in the JAX layout and carried in through `params_from_jax` -- and holds
every kernel of those paths against its plain PyTorch version on the card.

Phases (each prints a line; any failure raises and the exit code is not 0):
  1. device and build: the card's name and power limit, `nvcc` of every
     kernel source in `musicnlp_tpu_torch/csrc/`, all started together; the
     tensor-core instructions (HMMA / HGMMA) in the SASS of each K2 / K4
     kernel -- the bf16 kernels must have some, the f32 ones keep FMAs;
  2. K1 (forward) and K2 (backward) against their plain versions on CUDA
     tensors: the base shapes (scoring B 8 and training B 21, bf16 and f32),
     a memory + window case and a head-dim-16 ragged case; times of each
     kernel, its plain version and a one-call PyTorch yardstick the port
     never calls (`scaled_dot_product_attention` with the positional term as
     a float mask; for K2 its backward, with the mask requiring grad); K2's
     achieved TFLOP/s (`k2_work`'s operations over its time);
  3. the training path, counts set to 0 before and read after:
     `Trainer.train` for one epoch of 6 steps of 21 x 1024 seeded synthetic
     songs (dropout 0.1, warmup-cosine AdamW, eval with a padded final batch,
     a checkpoint), `load_trained` + `score_batch` on the run; a 20-step
     overfit on one batch; resume from the epoch-0 checkpoint against an
     uninterrupted run (dropout 0); one step at n_seg 2 (memory 512);
     step time, tokens/s, peak memory and a torch.profiler split of a step;
  4. the scoring and generation paths, counts set to 0 before and read
     after: `score_batch` (loss, NTP accuracy, IKR) on 8 x 1024 ids, then
     `MusicGenerator.generate` for 4 key-augmented unconditional prompts
     (sample, top_k 8, max_length 1024) with a bf16 and an int8 KV cache, and
     one greedy request with early exit, checked against the full-length run;
  5. the card against the port's own CPU run in f32: the loss at batch 1
     (12 layers) and one training step's gradients (depth 2, dropout 0);
     scoring throughput and a torch.profiler breakdown of one scoring batch
     and of 8 decode steps (device time by kernel, busy share);
  6. the Reformer, counts set to 0 before each path and read after: K3
     (forward) and K4 (backward, with an lse cotangent) against their plain
     versions were held in phase 2b (the 22-04 local and LSH shapes in bf16
     and f32, a padded case, a D 32 / chunk 32 single-block case, a bf16
     D 16 / chunk 32 case; times of each kernel, its plain version and an
     SDPA yardstick over the unfolded windows; K4's achieved TFLOP/s);
     `Trainer.train` for 4 steps of 32 x 2048 synthetic songs (12 K3 + 12
     K4 launches per step), `load_trained` + `score_batch` on the
     run, step time, memory and a profile, a 15-step overfit; one f32 step
     at depth 2 on the card against the CPU (on shared branches); then
     `score_batch` at 8 x 2048 (12 K3 launches, no K4) and
     `MusicGenerator.generate` for 4 sampled songs (top_p 0.9) with a bf16
     and an int8 LSH cache (no kernel launch);
  7. K5 (the mask / softmax chain) and K6 (the multiply-add chain) against
     their plain versions at the roofline tool's shape (G 64 x [8, 64, 128]
     f32, K 4 and 32), their times at K 1024 beside the plain versions' and
     the bound from the card's own FP32 / SFU lanes and clock, the SASS of
     each loop (instructions per pass); then the roofline tool
     (`tools/vpu_roofline.roofline`, counts set to 0 before and read after)
     with phase 2b's K3 LSH time as its in-situ comparator;
  8. the user's path through the command line, in process (`cli.main`),
     counted: a step-kind combined JSON of 64 seeded synthetic songs ->
     `dataset` -> `train --recipe 22-11 --epochs 1` (2 steps of 21 x 1024
     with key insertion, pitch shift, channel mixup and random crop; 12 K1
     per forward, 12 K2 per step) -> `generate` (4 songs, top_k 8, and one
     conditioned on a rendered song with its key from `KeyFinder`) -> every
     written .mid / .mxl re-read by the port's io; then `train --recipe 22-04
     --epochs 1` (1 step of 32 x 2048; 12 K3 + 12 K4 per step) -> `generate`
     (4 songs, top_p 0.9); wall time per command, the epochs' tokens/s,
     decode tok/s (with phase 4's request repeated after the CLI's, in the
     same process state), and the device-busy share of the recipes' own
     input pipeline feeding training steps.
The line before the last holds the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.  Details go to chiprun_out/chip_smoke.json;
training runs write under build/chip_smoke_runs/, removed at the end.
Without CUDA, or without the package beside it, it fails before any result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from musicnlp_tpu_torch import cli
from musicnlp_tpu_torch.io import parse_file, read_midi
from musicnlp_tpu_torch.kernels.build import build_all
from musicnlp_tpu_torch.models.reformer import Reformer, ReformerConfig
from musicnlp_tpu_torch.models.transformer_xl import TransfoXL, TransfoXLConfig
from musicnlp_tpu_torch.ops import chunked_attention as ca
from musicnlp_tpu_torch.ops import chunked_attention_kernel as ck
from musicnlp_tpu_torch.ops import flash_attention as fa
from musicnlp_tpu_torch.ops import roofline_kernels as rk
from musicnlp_tpu_torch.preprocess.dataset import SongDataset
from musicnlp_tpu_torch.preprocess.key_finder import KeyFinder
from musicnlp_tpu_torch.preprocess.music_converter import MusicConverter
from musicnlp_tpu_torch.tools import vpu_roofline as vr
from musicnlp_tpu_torch.trainer import train as tr
from musicnlp_tpu_torch.trainer.eval import MusicGenerator, load_trained, score_batch
from musicnlp_tpu_torch.trainer.metrics import IkrMetric
from musicnlp_tpu_torch.utils.checkpoint import flatten, params_from_jax
from musicnlp_tpu_torch.utils.prefetch import prefetch
from musicnlp_tpu_torch.vocab import MusicTokenizer, MusicVocabulary, N_KEY, key_ordinal2str

HBM_BYTES_PER_S = 3.35e12                        # H100 SXM (NVIDIA data sheet)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}   # dense bf16 tensor / f32
SEED = 0
K1_REPLACES = 'musicnlp_tpu/ops/pallas/flash_attention.py:115 (_make_fwd, via _fwd_call :354)'
K2_REPLACES = ('musicnlp_tpu/ops/pallas/flash_attention.py:194 (_make_bwd_fused, via '
               '_flash_bwd :412)')
# K1 vs plain, per case: ctx (bf16 output rounding ~ 2^-8 of |ctx| <= ~3;
# p rounded against the running vs the global max) and lse (same f32 scores,
# other summation order)
TOL = {torch.float32: dict(ctx=1e-4, lse=1e-3), torch.bfloat16: dict(ctx=2e-2, lse=1e-3)}
# K2 vs plain, each output's largest error over its largest entry: f32 sums
# in other orders (dG by atomics, in an order that changes from run to run);
# bf16 also rounds p and ds to bf16, and a rounding that flips moves an ulp
TOL_K2 = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# card vs CPU f32 gradients, over each tensor's largest entry: the same f32
# arithmetic summed in other orders over 1024-2048 positions and two layers
# (the Reformer's on the same LSH buckets and relu branches, SharedBranches)
TOL_GRAD = 1e-4
K3_REPLACES = ('musicnlp_tpu/ops/pallas/chunked_attention_kernel.py:308 (_make_fwd, via '
               '_fwd_call :417)')
K4_REPLACES = ('musicnlp_tpu/ops/pallas/chunked_attention_kernel.py:336 (_make_bwd, via '
               '_core_bwd :449)')
# K3 vs plain: ctx (bf16 output rounding ~ 2^-8 of |ctx| <= ~3) and lse
# (the same f32 scores summed in another order)
TOL_K3 = TOL
# K4 vs plain, each output's largest error over its largest entry: f32 sums
# in other orders; bf16 also rounds p and ds, and a rounding that flips moves
# an ulp
TOL_K4 = TOL_K2
GEN_LEN = 1024                                   # Reformer generation length (tokens)
K5_REPLACES = 'scripts/vpu_roofline.py:39 (_mask_chain_kernel, via run_chain :90)'
K6_REPLACES = 'scripts/vpu_roofline.py:63 (_muladd_kernel, via run_muladd :111)'
ROOFLINE_K = 1024                                # passes of the timed K5 / K6 calls
# K5 vs plain: each entry within one bf16 ulp (f32 sums in other orders may
# flip a bf16 rounding); K6 vs plain: bit-equal (the plain version's f64
# product and sum are exact, so it rounds once per pass, as the FMA does)

# the tensor-core kernels of K2 / K4 (bf16), by name in each library's SASS
TC_KERNELS = {'flash_rel_attn_bwd': ('k2_dkdv_tc', 'k2_dq_tc'),
              'chunked_window_attn_bwd': ('k4_tc',)}
FMA_KERNELS = {'flash_rel_attn_bwd': ('k2_dkdv_kernel', 'k2_dq_kernel'),
               'chunked_window_attn_bwd': ('chunked_window_attn_bwd_kernel',)}
SASS_MMA = {}                                    # library -> {function: HMMA + HGMMA}, phase 1
RUN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build', 'chip_smoke_runs')
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'chiprun_out')


def log(msg: str):
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile(fn) -> dict:
    """Device time by kernel over one call of `fn` (torch.profiler, CUPTI):
    wall time, summed kernel time, busy share and the top kernels."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, 'self_device_time_total', None)
        if dev_us is None:
            dev_us = getattr(ev, 'self_cuda_time_total', 0.0)
        if dev_us > 0 and getattr(ev, 'device_type', None) != torch.autograd.DeviceType.CPU:
            rows.append(dict(name=ev.key, device_ms=dev_us / 1e3, count=ev.count))
    rows.sort(key=lambda r: -r['device_ms'])
    device_ms = sum(r['device_ms'] for r in rows)
    return dict(wall_ms=wall_ms, device_ms=device_ms, busy_share=device_ms / wall_ms,
                n_kernels=sum(r['count'] for r in rows), top=rows[:15])


def tensor_core_check(report):
    """HMMA / HGMMA instructions in the SASS of every K2 / K4 kernel: each bf16
    kernel must have some (an FMA-only build is not the tensor-core design),
    the f32 kernels none (their parity rests on f32 FMAs)."""
    for lib, tc_names in TC_KERNELS.items():
        SASS_MMA[lib] = counts = vr.tensor_core_counts(lib)
        for name in tc_names + FMA_KERNELS[lib]:
            fns = [c for f, c in counts.items() if name in f]
            if not fns or (name in tc_names and min(fns) == 0) or \
                    (name not in tc_names and any(fns)):
                raise AssertionError(f'{lib}: tensor-core instructions of {name}: {counts}')
    log(f'[sass] HMMA/HGMMA per kernel function: {json.dumps(SASS_MMA)}')
    report['sass_tensor_core_instructions'] = dict(SASS_MMA)


def mma_instructions(lib, dtype, template_args):
    """Tensor-core instructions of the kernels a call of `lib` runs in this
    dtype, at these template arguments (a mangled-name fragment)."""
    names = TC_KERNELS[lib] if dtype == torch.bfloat16 else FMA_KERNELS[lib]
    return sum(c for f, c in SASS_MMA[lib].items()
               if template_args in f and any(n in f for n in names))


# ------------------------------------------------------------------ K1 cases
def k1_inputs(dev, dtype, B, N, T, M, H, clamp, seed):
    g = torch.Generator(device='cpu').manual_seed(seed)
    S = M + T
    mk = lambda *s: torch.randn(*s, generator=g).to(dev, dtype)
    Wr = (torch.randn(N * H, N, H, generator=g) * 0.02).to(dev)
    return (mk(B * N, T, H), mk(B * N, T, H), mk(B * N, S, H), mk(B * N, S, H),
            fa.distance_table(Wr, T, S, M, clamp, dtype))


def k1_work(rw, k, g, T, S, M, mem_valid, window, dtype):
    """(flops, bytes) this call needs: 3 H-long products (AC, BD, PV) per
    visible (q, k) pair; each input read once, each output written once."""
    BN, _, H = rw.shape
    visible = int(fa._key_mask(T, S, M, mem_valid, window, rw.device).sum())
    flops = 3 * 2 * H * visible * BN
    e = rw.element_size()
    nbytes = e * (2 * BN * T * H + 2 * BN * S * H + g.numel() + BN * T * H) + 4 * BN * T
    return flops, nbytes


def sdpa_yardstick(rw, rr, k, v, g, T, S, M, mem_valid, window, scale):
    """One PyTorch call for the same function: SDPA with BD*scale + mask as
    a float attn_mask (built outside the timed call)."""
    BN, N = rw.shape[0], g.shape[0]
    u = (T - 1 - torch.arange(T, device=rw.device)[:, None]
         + torch.arange(S, device=rw.device)[None, :])
    bias = torch.empty(BN, T, S, dtype=rw.dtype, device=rw.device)
    ok = fa._key_mask(T, S, M, mem_valid, window, rw.device)
    for b in range(BN):                           # [T, T+S] row at a time: bounded memory
        s1 = rr[b].float() @ g[b % N].float().T
        bias[b] = torch.where(ok, torch.gather(s1, 1, u) * scale,
                              torch.tensor(float('-inf'), device=rw.device)).to(rw.dtype)
    fn = lambda: torch.nn.functional.scaled_dot_product_attention(rw, k, v, attn_mask=bias,
                                                                  scale=scale)
    fn.bias = bias
    return fn


def k1_case(dev, name, dtype, B, N, T, M, H, clamp, mem_valid, window, seed, timed):
    rw, rr, k, v, g = k1_inputs(dev, dtype, B, N, T, M, H, clamp, seed)
    S = M + T
    scale = H ** -0.5
    mvt = torch.tensor(mem_valid, dtype=torch.int32, device=dev)
    saved = fa.LAUNCHES['flash_rel_attn_fwd']
    ctx, lse = fa.flash_rel_attn_fwd(rw, rr, k, v, g, mvt, M=M, scale=scale, window=window)
    ref, ref_lse = fa.flash_rel_attn_fwd_plain(rw, rr, k, v, g, mvt, M=M, scale=scale,
                                               window=window)
    torch.cuda.synchronize()
    err = float((ctx.float() - ref.float()).abs().max())
    lse_err = float((lse - ref_lse).abs().max())
    tol = TOL[dtype]
    rec = dict(case=name, dtype=str(dtype).split('.')[-1], BN=B * N, T=T, S=S, M=M, H=H,
               clamp=clamp, mem_valid=mem_valid, window=window, max_abs_err=err,
               lse_max_abs_err=lse_err, tol_ctx=tol['ctx'], tol_lse=tol['lse'])
    if timed:
        rec['ms'] = time_ms(lambda: fa.flash_rel_attn_fwd(rw, rr, k, v, g, mvt, M=M, scale=scale,
                                                          window=window))
        rec['plain_ms'] = time_ms(lambda: fa.flash_rel_attn_fwd_plain(
            rw, rr, k, v, g, mvt, M=M, scale=scale, window=window), iters=3)
        rec['library_ms'] = time_ms(sdpa_yardstick(rw, rr, k, v, g, T, S, M, mem_valid,
                                                   window, scale))
        flops, nbytes = k1_work(rw, k, g, T, S, M, mem_valid, window, dtype)
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        rec.update(flops=flops, bytes=nbytes, bound_ms=max(t_ops, t_bytes),
                   bound_by='operations' if t_ops >= t_bytes else 'bytes')
    fa.LAUNCHES['flash_rel_attn_fwd'] = saved    # comparison launches do not count
    log(f'[k1] {json.dumps(rec)}')
    if not (math.isfinite(err) and err <= tol['ctx'] and lse_err <= tol['lse']):
        raise AssertionError(f'K1 disagrees with its plain version in case {name}: '
                             f'ctx {err} (tol {tol["ctx"]}), lse {lse_err} (tol {tol["lse"]})')
    return rec


# ------------------------------------------------------------------ K2 cases
def k2_work(rw, k, g, T, S, M, mem_valid, window):
    """(flops, bytes) this call needs: 8 H-long products per visible (q, k)
    pair (scores AC and BD, dP, dV, dK, dRW, dRR, dG); inputs rw, rr, out,
    dO, k, v, G and lse read once (delta = dO . O is the call's own), outputs
    drw, drr (input dtype), dk, dv and dG (f32) written once."""
    BN, _, H = rw.shape
    visible = int(fa._key_mask(T, S, M, mem_valid, window, rw.device).sum())
    flops = 8 * 2 * H * visible * BN
    e = rw.element_size()
    nbytes = (e * (4 * BN * T * H + 2 * BN * S * H + g.numel()) + 4 * BN * T
              + e * 2 * BN * T * H + 4 * (2 * BN * S * H + g.numel()))
    return flops, nbytes


def sdpa_bwd_yardstick(rw, rr, k, v, g, d_out, T, S, M, mem_valid, window, scale):
    """One PyTorch call for the same gradients: the backward of SDPA with
    BD*scale + mask as a float attn_mask that requires grad (its gradient is
    dBD), the forward run once outside the timed call."""
    bias = sdpa_yardstick(rw, rr, k, v, g, T, S, M, mem_valid, window, scale).bias
    ins = [t.detach().requires_grad_(True) for t in (rw, k, v)] + [bias.requires_grad_(True)]
    out = torch.nn.functional.scaled_dot_product_attention(*ins[:3], attn_mask=ins[3],
                                                           scale=scale)
    grads = torch.autograd.grad(out, ins, d_out, retain_graph=True)
    if grads[3] is None:
        raise AssertionError('SDPA returned no gradient for its float mask')
    return lambda: torch.autograd.grad(out, ins, d_out, retain_graph=True)


def k2_case(dev, name, dtype, B, N, T, M, H, clamp, mem_valid, window, seed, timed):
    rw, rr, k, v, g = k1_inputs(dev, dtype, B, N, T, M, H, clamp, seed)
    S = M + T
    scale = H ** -0.5
    mvt = torch.tensor(mem_valid, dtype=torch.int32, device=dev)
    saved = dict(fa.LAUNCHES)
    out, lse = fa.flash_rel_attn_fwd(rw, rr, k, v, g, mvt, M=M, scale=scale, window=window)
    d_out = k1_inputs(dev, dtype, B, N, T, 0, H, clamp, seed + 100)[0]
    args = (rw, rr, k, v, g, out, d_out, lse, mvt)
    kw = dict(M=M, scale=scale, window=window)
    got = fa.flash_rel_attn_bwd(*args, **kw)
    ref = fa.flash_rel_attn_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    errs = {n: float((a.float() - b.float()).abs().max()) for n, a, b in
            zip(('drw', 'drr', 'dk', 'dv', 'dG'), got, ref)}
    rel = {n: errs[n] / max(float(b.float().abs().max()), 1e-30) for n, b in
           zip(('drw', 'drr', 'dk', 'dv', 'dG'), ref)}
    del got, ref
    rec = dict(case=name, dtype=str(dtype).split('.')[-1], BN=B * N, T=T, S=S, M=M, H=H,
               clamp=clamp, mem_valid=mem_valid, window=window, max_abs_err=max(errs.values()),
               abs_err=errs, rel_err=rel, tol_rel=TOL_K2[dtype],
               tensor_core_instructions=mma_instructions('flash_rel_attn_bwd', dtype,
                                                         f'Li{H}E'))
    if timed:
        rec['ms'] = time_ms(lambda: fa.flash_rel_attn_bwd(*args, **kw))
        rec['plain_ms'] = time_ms(lambda: fa.flash_rel_attn_bwd_plain(*args, **kw), iters=3)
        rec['library_ms'] = time_ms(sdpa_bwd_yardstick(rw, rr, k, v, g, d_out, T, S, M,
                                                       mem_valid, window, scale))
        flops, nbytes = k2_work(rw, k, g, T, S, M, mem_valid, window)
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        rec.update(flops=flops, bytes=nbytes, bound_ms=max(t_ops, t_bytes),
                   bound_by='operations' if t_ops >= t_bytes else 'bytes',
                   tflops=flops / rec['ms'] / 1e9)
    fa.LAUNCHES.update(saved)                    # comparison launches do not count
    log(f'[k2] {json.dumps(rec)}')
    torch.cuda.empty_cache()
    if not all(math.isfinite(e) and e <= TOL_K2[dtype] for e in rel.values()):
        raise AssertionError(f'K2 disagrees with its plain version in case {name}: {rel} '
                             f'(tol {TOL_K2[dtype]})')
    return rec


# ---------------------------------------------------------------- main path
def base_config(**kw) -> TransfoXLConfig:
    """The 22-11 recipe's model: TF-XL base, degree vocab, seq 1024, mem 512."""
    return TransfoXLConfig.from_size('base', vocab_size=1190, max_length=1024,
                                     **dict(dict(mem_len=512, dropout=0.0), **kw))


def score_inputs(V, B, T, seed, dev):
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(0, V, (B, T)).astype(np.int64)).to(dev)
    return ids, ids.clone()


class SyntheticSongs:
    """Seeded synthetic songs in the Trainer's dataset contract: each row is
    TimeSig, Tempo, Key_* (with `insert_key`, so 'ins-key' IKR reads its key),
    then bars of a repeated (pitch, duration) motif, </s>, and a pad tail
    (labels -100); `key_scores` one-hot on the song's key."""

    def __init__(self, tok: MusicTokenizer, n: int, seed: int, length: int = 1024,
                 insert_key: bool = True):
        rng = np.random.default_rng(seed)
        t2i = tok.vocab.tok2id
        pitches = [i for t, i in t2i.items() if t.startswith('p_')]
        durs = [i for t, i in t2i.items() if t.startswith('d_')]
        self.ids = np.full((n, length), tok.pad_token_id, np.int32)
        self.key_scores = np.zeros((n, N_KEY), np.float32)
        for r in range(n):
            key = int(rng.integers(N_KEY))
            motif = [x for _ in range(8) for x in (rng.choice(pitches), rng.choice(durs))]
            body = []
            while len(body) < int(rng.integers(length // 2, length - 8)):
                body += [t2i['<bar>']] + motif
            row = [t2i['TimeSig_4/4'], t2i['Tempo_120']]
            if insert_key:
                row.append(t2i[f'Key_{key_ordinal2str[key]}'])
            row = (row + body)[:length - 1] + [tok.eos_token_id]
            self.ids[r, :len(row)] = row
            self.key_scores[r, key] = 1.0
        self.labels = np.where(self.ids == tok.pad_token_id, -100, self.ids).astype(np.int32)

    def __len__(self):
        return len(self.ids)

    def batches(self, batch_size, shuffle=True, seed=None, drop_last=True):
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for i in range(0, len(order) - (batch_size - 1 if drop_last else 0), batch_size):
            idx = order[i:i + batch_size]
            yield dict(input_ids=self.ids[idx], labels=self.labels[idx],
                       key_scores=self.key_scores[idx])


def train_args(**kw) -> tr.TrainArgs:
    """The 22-11 recipe's optimizer: the base preset (lr 3e-4, warmup-cosine)
    with batch 21 and weight decay 0.1."""
    return tr.TrainArgs.from_preset('transf-xl', 'base', **dict(tr.RECIPES['22-11']['train_args'],
                                                                **kw))


def step_log(run_dir):
    with open(os.path.join(run_dir, 'train_log.jsonl')) as f:
        return [json.loads(l) for l in f]


def training_path(dev, tok, report):
    """Phase 3: the training path at full width, counted."""
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    cfg = base_config(dropout=0.1)
    steps, B = 6, 21
    train = SyntheticSongs(tok, steps * B, SEED + 10)
    evald = SyntheticSongs(tok, B + 4, SEED + 11)             # a padded final eval batch
    n_eval_batches = 2
    run = os.path.join(RUN_DIR, 'train')
    trainer = tr.Trainer(TransfoXL(cfg), tok, train, evald, out_dir=run, ikr_mode='ins-key',
                         args=train_args(num_train_epochs=1, seed=SEED))
    params = params_from_jax(trainer.model.init_flat(SEED), dev)
    fa.LAUNCHES.update(flash_rel_attn_fwd=0, flash_rel_attn_bwd=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = trainer.train(params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    log_ = step_log(run)
    recs = [r for r in log_ if 'loss' in r]
    ep = [r for r in log_ if 'train_tokens_per_sec' in r][0]
    log(f'[train] 22-11 base, 21x1024, bf16, dropout 0.1: {len(recs)} steps in {wall:.1f} s '
        f'(eval + checkpoint included); losses {[round(r["loss"], 4) for r in recs]}; '
        f'grad_norm {[round(r["grad_norm"], 3) for r in recs]}; lr {[r["lr"] for r in recs]}; '
        f'eval {json.dumps({k: v for k, v in ep.items() if k.startswith("eval_")})}; '
        f'launches {launches}')
    if len(recs) != steps or not all(math.isfinite(r['loss']) and math.isfinite(r['grad_norm'])
                                     for r in recs):
        raise AssertionError(f'training steps missing or not finite: {recs}')
    if launches['flash_rel_attn_bwd'] != steps * cfg.n_layer or \
            launches['flash_rel_attn_fwd'] != (steps + n_eval_batches) * cfg.n_layer:
        raise AssertionError(f'expected {cfg.n_layer} K1 and K2 launches per step: {launches}')
    if not all(math.isfinite(ep[f'eval_{k}']) for k in ('loss', 'ntp_acc', 'ikr')) or \
            not 0 <= ep['eval_ikr'] <= 1:
        raise AssertionError(f'eval metrics out of range: {ep}')

    model, tparams, ttok = load_trained(run, device=dev)
    ids = torch.from_numpy(evald.ids[:8]).to(dev)
    sc = score_batch(model, tparams, ids, torch.from_numpy(evald.labels[:8]).to(dev),
                     IkrMetric(ttok, mode='ins-key'))
    sc = {k: float(v) for k, v in sc.items()}
    log(f'[train] load_trained + score_batch on the run: {json.dumps(sc)}')
    if not all(math.isfinite(v) for v in sc.values()) or sc['loss'] > math.log(cfg.vocab_size) + 1:
        raise AssertionError(f'scoring the trained run failed: {sc}')
    report['train'] = dict(steps=recs, epoch=ep, wall_s=wall, launches=launches, score=sc)
    del model, tparams

    # step time, throughput, peak memory and a profile of one step
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(train.batches(B, seed=1)).items()}
    state = trainer.opt.init(res['params'])
    step = lambda: trainer.train_step(res['params'], state, batch)
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(step, iters=5, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_tok = int((batch['labels'] != -100).sum())
    prof = profile(step)
    top = ', '.join(f'{r["name"][:40]} {r["device_ms"]:.2f}' for r in prof['top'][:6])
    log(f'[train] step {ms:.1f} ms: {B * 1024 / ms * 1e3:.0f} tok/s ({n_tok / ms * 1e3:.0f} '
        f'non-pad tok/s); peak memory {peak:.1f} GiB; profile: wall {prof["wall_ms"]:.1f} ms, '
        f'device busy {prof["device_ms"]:.1f} ms ({prof["busy_share"]:.1%}); top: {top}')
    report['train'].update(step_ms=ms, tok_per_s=B * 1024 / ms * 1e3,
                           nonpad_tok_per_s=n_tok / ms * 1e3, peak_mem_gb=peak, profile=prof)
    del trainer, res, state, batch
    torch.cuda.empty_cache()

    # a 20-step overfit on one batch at a constant lr
    one = SyntheticSongs(tok, B, SEED + 12)
    run = os.path.join(RUN_DIR, 'overfit')
    trainer = tr.Trainer(TransfoXL(cfg), tok, one, None, out_dir=run, args=train_args(
        num_train_epochs=20, lr_scheduler_type='constant', learning_rate=1e-3,
        save_per_epoch=False, seed=SEED))
    trainer.train(params=params_from_jax(trainer.model.init_flat(SEED), dev))
    losses = [r['loss'] for r in step_log(run) if 'loss' in r]
    log(f'[train] overfit one batch, 20 steps, lr 1e-3 constant: {[round(l, 3) for l in losses]}')
    if not (len(losses) == 20 and losses[-1] < 0.8 * losses[0]):
        raise AssertionError(f'the loss did not fall on the overfit batch: {losses}')
    report['overfit_losses'] = losses
    del trainer
    torch.cuda.empty_cache()

    # resume from the epoch-0 checkpoint == an uninterrupted run (dropout 0)
    report['resume'] = resume_check(dev, tok)

    # one step at n_seg 2: segments of 512 over a memory of 512
    trainer = tr.Trainer(TransfoXL(base_config()), tok, train, None, out_dir=run,
                         args=train_args(n_seg=2, seed=SEED))
    params = params_from_jax(trainer.model.init_flat(SEED), dev)
    for t in flatten(params).values():
        t.requires_grad_(True)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(train.batches(B, seed=2)).items()}
    fa.LAUNCHES.update(flash_rel_attn_fwd=0, flash_rel_attn_bwd=0)
    mets = trainer.train_step(params, trainer.opt.init(params), batch)
    torch.cuda.synchronize()
    seg = dict(fa.LAUNCHES)
    mets = {k: float(v) for k, v in mets.items()}
    log(f'[train] n_seg 2 step (segment 512, memory 512): {json.dumps(mets)} launches {seg}')
    if seg != dict(flash_rel_attn_fwd=2 * cfg.n_layer, flash_rel_attn_bwd=2 * cfg.n_layer) or \
            not all(math.isfinite(v) for v in mets.values()):
        raise AssertionError(f'the n_seg 2 step did not run through K1 and K2: {seg} {mets}')
    report['n_seg2'] = dict(metrics=mets, launches=seg)
    del trainer, params, batch
    torch.cuda.empty_cache()
    return launches


def resume_check(dev, tok):
    """Two epochs of 2 steps uninterrupted, against a run killed in epoch 1
    and resumed from its epoch-0 checkpoint by a new Trainer.  K2 adds dG with
    atomics, in an order that changes from run to run, so the runs are not
    bit-equal: Adam's first steps divide g by |g|, so an entry whose gradient
    is near 0 may move by up to 2 lr per step in one run and not the other.
    Held: every entry within 2 * sum(lr), and the resumed epoch's logged
    losses within 1e-3 (relative) of the uninterrupted run's."""
    cfg, B = base_config(), 21
    data = SyntheticSongs(tok, 2 * B, SEED + 13)

    class Crash(SyntheticSongs):
        def __init__(self):
            self.__dict__.update(data.__dict__)

        def batches(self, batch_size, shuffle=True, seed=None, drop_last=True):
            if seed == SEED + 1:
                raise RuntimeError('killed in epoch 1')
            return super().batches(batch_size, shuffle, seed, drop_last)

    def trainer(name, ds):
        return tr.Trainer(TransfoXL(cfg), tok, ds, None, out_dir=os.path.join(RUN_DIR, name),
                          args=train_args(num_train_epochs=2, seed=SEED,
                                          load_best_model_at_end=False))
    full_tr = trainer('full', data)
    full = full_tr.train(params=params_from_jax(full_tr.model.init_flat(SEED), dev))
    part = trainer('part', Crash())
    try:
        part.train(params=params_from_jax(part.model.init_flat(SEED), dev))
        raise AssertionError('the interrupted run was not interrupted')
    except RuntimeError as e:
        if 'killed' not in str(e):
            raise
    resumed_tr = trainer('part', data)
    resumed = resumed_tr.train(resume_from=os.path.join(RUN_DIR, 'part', 'checkpoint-ep0'))
    a, b = ({k: t.detach() for k, t in flatten(r['params']).items()} for r in (full, resumed))
    diffs = {k: float((a[k] - b[k]).abs().max()) for k in a}
    n_diff = sum(int((a[k] != b[k]).sum()) for k in a)
    n_all = sum(t.numel() for t in a.values())
    lr_sum = sum(r['lr'] for r in step_log(os.path.join(RUN_DIR, 'full')) if 'loss' in r)
    la = [r['loss'] for r in step_log(os.path.join(RUN_DIR, 'full')) if 'loss' in r][2:]
    lb = [r['loss'] for r in step_log(os.path.join(RUN_DIR, 'part')) if 'loss' in r][-2:]
    worst = max(diffs, key=diffs.get)
    rec = dict(max_abs_diff=diffs[worst], worst=worst, entries_differing=n_diff,
               entries=n_all, lr_sum=lr_sum, losses_full=la, losses_resumed=lb,
               opt_count=(int(full['opt_state']['count']), int(resumed['opt_state']['count'])))
    log(f'[train] resume from epoch 0 vs uninterrupted (dropout 0): {json.dumps(rec)}')
    if rec['opt_count'] != (4, 4) or diffs[worst] > 2 * lr_sum or len(lb) != 2 or \
            any(abs(x - y) > 1e-3 * abs(x) for x, y in zip(la, lb)):
        raise AssertionError(f'the resumed run differs from the uninterrupted one: {rec}')
    for d in ('full', 'part'):
        shutil.rmtree(os.path.join(RUN_DIR, d))
    return rec


def card_vs_cpu_grads(dev, report):
    """One training step's gradients in f32, base width, depth 2, B 1, T 1024,
    dropout 0: the card (K1 + K2) against the port's CPU run (plain versions)."""
    cfg = base_config(dtype='float32', n_layer=2)
    rows = SyntheticSongs(MusicTokenizer(pitch_kind='degree'), 1, SEED + 14)
    ids, labels = torch.from_numpy(rows.ids), torch.from_numpy(rows.labels)
    flat = TransfoXL(cfg, device='cpu').init_flat(SEED)
    grads = []
    for device in (dev, torch.device('cpu')):
        model = TransfoXL(cfg, device=device)
        params = params_from_jax(flat, device)
        leaves = flatten(params)
        for t in leaves.values():
            t.requires_grad_(True)
        saved = dict(fa.LAUNCHES)
        loss, _ = model.loss(params, ids.to(device), labels.to(device))
        g = torch.autograd.grad(loss, list(leaves.values()))
        if device.type == 'cuda' and (fa.LAUNCHES['flash_rel_attn_fwd'] - saved['flash_rel_attn_fwd'],
                                      fa.LAUNCHES['flash_rel_attn_bwd'] - saved['flash_rel_attn_bwd']
                                      ) != (cfg.n_layer, cfg.n_layer):
            raise AssertionError('the card step did not run through K1 and K2')
        fa.LAUNCHES.update(saved)
        grads.append((float(loss.detach()), {k: t.detach().cpu() for k, t in zip(leaves, g)}))
    (l_card, g_card), (l_cpu, g_cpu) = grads
    rel = {k: float((g_card[k] - g_cpu[k]).abs().max() / g_cpu[k].abs().max().clamp(min=1e-30))
           for k in g_cpu}
    worst = max(rel, key=rel.get)
    log(f'[train] f32 step, depth 2, B 1: loss card {l_card:.7f} cpu {l_cpu:.7f}; gradients '
        f'worst {worst} {rel[worst]:.2e} of its largest entry (tol {TOL_GRAD})')
    report['grads_card_vs_cpu'] = dict(loss_card=l_card, loss_cpu=l_cpu, rel=rel)
    if rel[worst] > TOL_GRAD or abs(l_card - l_cpu) > 1e-4 * abs(l_cpu):
        raise AssertionError(f'card and CPU f32 gradients disagree: {worst} {rel[worst]}')


def run_generation(model, params, tok, n_req, strategy, seed, **kw):
    gen = MusicGenerator(model, tok, params, augment_key=True)
    keys = ['CMajor', 'AMinor', 'EbMajor', 'F#Minor']
    prompts = [gen.unconditional_prompt(key=keys[i % 4]) for i in range(n_req)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    texts = gen.generate(prompts, strategy=strategy, seed=seed, max_length=1024, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for p, t in zip(prompts, texts):
        toks = t.split()
        if not t.startswith(p) or len(toks) > 1024 or any(x not in tok.vocab.tok2id for x in toks):
            raise AssertionError(f'invalid generated token string: {t[:200]}')
    lens = [len(t.split()) for t in texts]
    new_tok = sum(n - len(p.split()) for n, p in zip(lens, prompts))
    return texts, lens, new_tok, dt


# -------------------------------------------------------------- K3 / K4 cases
def chunked_inputs(dev, dtype, G, T, D, lsh, pads, seed):
    """q, k, v [G, T, D] and int32 positions as the Reformer's layers hand them
    to K3: local layers in order; LSH layers shared-QK (k = q rms-normalised,
    carrying 1/sqrt(D)) with a random permutation of positions per row (the
    bucket sort's); the last `pads` positions as pad keys (kpos = T)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(G, T, D, generator=g, device=dev) for _ in range(3))
    if lsh:
        k = q * torch.rsqrt((q * q).mean(-1, keepdim=True) + 1e-6) / D ** 0.5
        qpos = torch.argsort(torch.rand(G, T, generator=g, device=dev), dim=-1)
    else:
        qpos = torch.arange(T, device=dev).expand(G, T)
    kpos = torch.where(qpos >= T - pads, torch.full_like(qpos, T), qpos) if pads else qpos
    return ([x.to(dtype) for x in (q, k, v)]
            + [p.to(torch.int32).contiguous() for p in (qpos, kpos)])


def chunked_flops(qpos, kpos, chunk, D, products):
    """Operations of a call: `products` D-long products per (query, key)
    pair that these positions make visible."""
    return products * 2 * D * ck.visible_pairs(qpos, kpos, chunk)


def sdpa_window_yardstick(q, k, v, qpos, kpos, chunk, scale, self_bias):
    """One PyTorch call for K3's function: SDPA over the unfolded windows,
    q [G*n, c, D] against k / v [G*n, 2c, D], the position mask and the self
    bias as one float mask built outside the timed call."""
    G, T, D = q.shape
    n = T // chunk
    qw = q.reshape(G * n, chunk, D)
    kw = ck._windows(k, chunk).reshape(G * n, 2 * chunk, D)
    vw = ck._windows(v, chunk).reshape(G * n, 2 * chunk, D)
    qp = qpos.reshape(G * n, chunk, 1)
    kp = ck._pos_windows(kpos, chunk).reshape(G * n, 1, 2 * chunk)
    zero = torch.zeros((), device=q.device)
    bias = torch.where(kp <= qp, torch.where(kp == qp, zero + self_bias, zero),
                       zero + ck.NEG_INF).to(q.dtype)
    fn = lambda: torch.nn.functional.scaled_dot_product_attention(qw, kw, vw, attn_mask=bias,
                                                                  scale=scale)
    fn.args = (qw, kw, vw, bias)
    return fn


def k3_case(dev, name, dtype, G, T, D, chunk, lsh, pads, seed):
    q, k, v, qpos, kpos = chunked_inputs(dev, dtype, G, T, D, lsh, pads, seed)
    scale, self_bias = (1.0, ca.SELF_BIAS) if lsh else (D ** -0.5, 0.0)
    kw = dict(chunk=chunk, scale=scale, self_bias=self_bias)
    saved = dict(ck.LAUNCHES)
    ctx, lse = ck.chunked_window_attn_fwd(q, k, v, qpos, kpos, **kw)
    ref, ref_lse = ck.chunked_window_attn_fwd_plain(q, k, v, qpos, kpos, **kw)
    torch.cuda.synchronize()
    err = float((ctx.float() - ref.float()).abs().max())
    lse_err = float((lse - ref_lse).abs().max())
    del ref, ref_lse
    tol = TOL_K3[dtype]
    rec = dict(case=name, dtype=str(dtype).split('.')[-1], G=G, T=T, D=D, chunk=chunk,
               lsh=lsh, pads=pads, max_abs_err=err, lse_max_abs_err=lse_err,
               tol_ctx=tol['ctx'], tol_lse=tol['lse'])
    rec['ms'] = time_ms(lambda: ck.chunked_window_attn_fwd(q, k, v, qpos, kpos, **kw))
    rec['plain_ms'] = time_ms(lambda: ck.chunked_window_attn_fwd_plain(q, k, v, qpos, kpos,
                                                                       **kw), iters=3)
    rec['library_ms'] = time_ms(sdpa_window_yardstick(q, k, v, qpos, kpos, **kw))
    e = q.element_size()
    # q, k, v and both positions read once; ctx and lse written once
    flops, nbytes = chunked_flops(qpos, kpos, chunk, D, 2), (4 * e * D + 3 * 4) * G * T
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    rec.update(flops=flops, bytes=nbytes, bound_ms=max(t_ops, t_bytes),
               bound_by='operations' if t_ops >= t_bytes else 'bytes')
    ck.LAUNCHES.update(saved)                    # comparison launches do not count
    log(f'[k3] {json.dumps(rec)}')
    torch.cuda.empty_cache()
    if not (math.isfinite(err) and err <= tol['ctx'] and lse_err <= tol['lse']):
        raise AssertionError(f'K3 disagrees with its plain version in case {name}: '
                             f'ctx {err} (tol {tol["ctx"]}), lse {lse_err} (tol {tol["lse"]})')
    return rec


def k4_case(dev, name, dtype, G, T, D, chunk, lsh, pads, seed):
    q, k, v, qpos, kpos = chunked_inputs(dev, dtype, G, T, D, lsh, pads, seed)
    scale, self_bias = (1.0, ca.SELF_BIAS) if lsh else (D ** -0.5, 0.0)
    kw = dict(chunk=chunk, scale=scale, self_bias=self_bias)
    saved = dict(ck.LAUNCHES)
    out, lse = ck.chunked_window_attn_fwd(q, k, v, qpos, kpos, **kw)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    d_out = torch.randn(out.shape, generator=g, device=dev).to(dtype)
    d_lse = torch.randn(lse.shape, generator=g, device=dev)       # a nonzero lse cotangent
    args = (q, k, v, qpos, kpos, out, d_out, lse, d_lse)
    got = ck.chunked_window_attn_bwd(*args, **kw)
    ref = ck.chunked_window_attn_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    names = ('dq', 'dk', 'dv')
    errs = {n: float((a.float() - b.float()).abs().max()) for n, a, b in zip(names, got, ref)}
    rel = {n: errs[n] / max(float(b.float().abs().max()), 1e-30) for n, b in zip(names, ref)}
    del got, ref
    rec = dict(case=name, dtype=str(dtype).split('.')[-1], G=G, T=T, D=D, chunk=chunk,
               lsh=lsh, pads=pads, max_abs_err=max(errs.values()), abs_err=errs, rel_err=rel,
               tol_rel=TOL_K4[dtype],
               tensor_core_instructions=mma_instructions('chunked_window_attn_bwd', dtype,
                                                         f'Li{chunk}ELi{D}E'))
    rec['ms'] = time_ms(lambda: ck.chunked_window_attn_bwd(*args, **kw))
    rec['plain_ms'] = time_ms(lambda: ck.chunked_window_attn_bwd_plain(*args, **kw), iters=3)
    ys = sdpa_window_yardstick(q, k, v, qpos, kpos, **kw)
    ins = [t.detach().requires_grad_(True) for t in ys.args[:3]]
    y = torch.nn.functional.scaled_dot_product_attention(*ins, attn_mask=ys.args[3], scale=scale)
    d_y = d_out.reshape(y.shape)
    rec['library_ms'] = time_ms(lambda: torch.autograd.grad(y, ins, d_y, retain_graph=True))
    del ys, ins, y
    e = q.element_size()
    # q, k, v, out, dO (input dtype), positions, lse, dlse read once; dq in
    # the input dtype, dk and dv in f32 written once
    flops = chunked_flops(qpos, kpos, chunk, D, 5)
    nbytes = (6 * e * D + 4 * 4 + 2 * 4 * D) * G * T
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    rec.update(flops=flops, bytes=nbytes, bound_ms=max(t_ops, t_bytes),
               bound_by='operations' if t_ops >= t_bytes else 'bytes',
               tflops=flops / rec['ms'] / 1e9)
    ck.LAUNCHES.update(saved)                    # comparison launches do not count
    log(f'[k4] {json.dumps(rec)}')
    torch.cuda.empty_cache()
    if not all(math.isfinite(x) and x <= TOL_K4[dtype] for x in rel.values()):
        raise AssertionError(f'K4 disagrees with its plain version in case {name}: {rel} '
                             f'(tol {TOL_K4[dtype]})')
    return rec


# ------------------------------------------------------------ Reformer paths
def reformer_config(**kw) -> ReformerConfig:
    """The 22-04 recipe's model: Reformer base (d_model 768, 12 heads x 64,
    12 layers alternating local and LSH, 2 hashes, chunk 64, 64 buckets at
    2048), midi vocab 422, max_length 2048, bf16, dropout 0.05."""
    r = tr.RECIPES['22-04']
    return ReformerConfig.from_size(r['model_size'], vocab_size=422,
                                    max_length=r['max_length'], **kw)


def reformer_train_args(**kw) -> tr.TrainArgs:
    """The 22-04 recipe's optimizer: the Reformer base preset (lr 3e-4
    warmup-cosine, weight decay 1e-2, clip 1.0) at batch 32."""
    return tr.TrainArgs.from_preset('reformer', 'base',
                                    **dict(tr.RECIPES['22-04']['train_args'], **kw))


def reformer_training_path(dev, tok, report):
    """The Reformer's training path at full width, counted."""
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    cfg = reformer_config()
    n_layer = len(cfg.attn_layers)
    steps, B, T = 4, 32, cfg.max_length
    train = SyntheticSongs(tok, steps * B, SEED + 20, length=T, insert_key=False)
    evald = SyntheticSongs(tok, B + 4, SEED + 21, length=T, insert_key=False)
    n_eval_batches = 2
    run = os.path.join(RUN_DIR, 'reformer')
    trainer = tr.Trainer(Reformer(cfg), tok, train, evald, out_dir=run,
                         args=reformer_train_args(num_train_epochs=1, seed=SEED))
    params = params_from_jax(trainer.model.init_flat(SEED), dev)
    ck.LAUNCHES.update(chunked_window_attn_fwd=0, chunked_window_attn_bwd=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = trainer.train(params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    log_ = step_log(run)
    recs = [r for r in log_ if 'loss' in r]
    ep = [r for r in log_ if 'train_tokens_per_sec' in r][0]
    log(f'[reformer-train] 22-04 base, {B}x{T}, bf16, dropout 0.05: {len(recs)} steps in '
        f'{wall:.1f} s (eval + checkpoint included); losses '
        f'{[round(r["loss"], 4) for r in recs]}; grad_norm '
        f'{[round(r["grad_norm"], 3) for r in recs]}; lr {[r["lr"] for r in recs]}; eval '
        f'{json.dumps({k: v for k, v in ep.items() if k.startswith("eval_")})}; '
        f'launches {launches}')
    if len(recs) != steps or not all(math.isfinite(r['loss']) and math.isfinite(r['grad_norm'])
                                     for r in recs):
        raise AssertionError(f'Reformer training steps missing or not finite: {recs}')
    if launches != dict(chunked_window_attn_fwd=(steps + n_eval_batches) * n_layer,
                        chunked_window_attn_bwd=steps * n_layer):
        raise AssertionError(f'expected {n_layer} K3 and K4 launches per step: {launches}')
    if not all(math.isfinite(ep[f'eval_{k}']) for k in ('loss', 'ntp_acc', 'ikr')) or \
            not 0 <= ep['eval_ikr'] <= 1:
        raise AssertionError(f'Reformer eval metrics out of range: {ep}')
    with open(os.path.join(run, 'meta.json')) as f:
        if json.load(f)['model_name'] != 'reformer':
            raise AssertionError('meta.json does not name the Reformer')

    model, tparams, ttok = load_trained(run, device=dev)
    ids = torch.from_numpy(evald.ids[:8]).to(dev)
    sc = score_batch(model, tparams, ids, torch.from_numpy(evald.labels[:8]).to(dev),
                     IkrMetric(ttok, mode='vanilla'),
                     torch.from_numpy(evald.key_scores[:8]).to(dev))
    sc = {k: float(v) for k, v in sc.items()}
    log(f'[reformer-train] load_trained + score_batch on the run: {json.dumps(sc)}')
    if not isinstance(model, Reformer) or not all(math.isfinite(v) for v in sc.values()) or \
            sc['loss'] > math.log(cfg.vocab_size) + 1:
        raise AssertionError(f'scoring the trained Reformer run failed: {sc}')
    report['reformer_train'] = dict(steps=recs, epoch=ep, wall_s=wall, launches=launches,
                                    score=sc)
    del model, tparams

    # step time, throughput, peak memory and a profile of one step
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(train.batches(B, seed=1)).items()}
    state = trainer.opt.init(res['params'])
    step = lambda: trainer.train_step(res['params'], state, batch)
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(step, iters=3, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_tok = int((batch['labels'] != -100).sum())
    prof = profile(step)
    top = ', '.join(f'{r["name"][:40]} {r["device_ms"]:.2f}' for r in prof['top'][:8])
    log(f'[reformer-train] step {ms:.1f} ms: {B * T / ms * 1e3:.0f} tok/s ({n_tok / ms * 1e3:.0f} '
        f'non-pad tok/s); peak memory {peak:.1f} GiB; profile: wall {prof["wall_ms"]:.1f} ms, '
        f'device busy {prof["device_ms"]:.1f} ms ({prof["busy_share"]:.1%}); top: {top}')
    report['reformer_train'].update(step_ms=ms, tok_per_s=B * T / ms * 1e3,
                                    nonpad_tok_per_s=n_tok / ms * 1e3, peak_mem_gb=peak,
                                    profile=prof)
    del trainer, res, state, batch
    torch.cuda.empty_cache()

    # a short overfit on one batch at a constant lr
    one = SyntheticSongs(tok, B, SEED + 22, length=T, insert_key=False)
    run = os.path.join(RUN_DIR, 'reformer-overfit')
    n_over = 15
    trainer = tr.Trainer(Reformer(cfg), tok, one, None, out_dir=run, args=reformer_train_args(
        num_train_epochs=n_over, lr_scheduler_type='constant', learning_rate=1e-3,
        save_per_epoch=False, seed=SEED))
    trainer.train(params=params_from_jax(trainer.model.init_flat(SEED), dev))
    losses = [r['loss'] for r in step_log(run) if 'loss' in r]
    log(f'[reformer-train] overfit one batch, {n_over} steps, lr 1e-3 constant: '
        f'{[round(l, 3) for l in losses]}')
    if not (len(losses) == n_over and losses[-1] < 0.8 * losses[0]):
        raise AssertionError(f'the Reformer loss did not fall on the overfit batch: {losses}')
    report['reformer_overfit_losses'] = losses
    del trainer
    torch.cuda.empty_cache()
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    return launches


class SharedBranches:
    """Within the block, the two places where the Reformer branches on a
    computed value -- the LSH bucket argmax (`lsh_buckets`) and the FFN relu
    (`torch.relu`) -- keep what they compute in `seen`; with `replaying` set
    they use `recorded` instead (in order, moved to the run's device) and
    count the entries their own arithmetic would have changed.  The card and
    the CPU sum in other orders, so a hash on a near-tie may land in another
    bucket, and a relu input within rounding of 0 may take the other side of
    the kink, which moves that token's share of an FFN weight gradient by a
    whole entry; sharing both holds the runs to the same branches, so the
    gradients can be held at f32 summation-order tolerance."""

    def __init__(self):
        self.seen = dict(buckets=[], relu=[])
        self.recorded = dict(buckets=[], relu=[])
        self.replaying = False
        self.differ, self.total = dict(buckets=0, relu=0), dict(buckets=0, relu=0)
        self.real = (ca.lsh_buckets, torch.relu)

    def _share(self, kind, value):
        if not self.replaying:
            self.seen[kind].append(value)
            return value
        want = self.recorded[kind].pop(0).to(value.device)
        self.differ[kind] += int((want != value).sum())
        self.total[kind] += value.numel()
        return want

    def buckets(self, x, rots):
        return self._share('buckets', self.real[0](x, rots))

    def relu(self, x):
        return torch.where(self._share('relu', x > 0), x, torch.zeros_like(x))

    def __enter__(self):
        ca.lsh_buckets, torch.relu = self.buckets, self.relu
        return self

    def __exit__(self, *exc):
        ca.lsh_buckets, torch.relu = self.real


def reformer_card_vs_cpu(dev, report):
    """One f32 training step's loss and gradients, base width, depth 2 (one
    local and one LSH layer), B 1, T 2048, dropout 0: the card (K3 + K4)
    against the port's CPU run (plain versions), on the same branches
    (`SharedBranches`)."""
    cfg = reformer_config(dtype='float32', attn_layers=('local', 'lsh'))
    rows = SyntheticSongs(MusicTokenizer(pitch_kind='midi'), 1, SEED + 23,
                          length=cfg.max_length, insert_key=False)
    ids, labels = torch.from_numpy(rows.ids), torch.from_numpy(rows.labels)
    flat = Reformer(cfg, device='cpu').init_flat(SEED)
    out = []
    with SharedBranches() as shared:
        for device in (dev, torch.device('cpu')):
            model = Reformer(cfg, device=device)
            params = params_from_jax(flat, device)
            leaves = flatten(params)
            for t in leaves.values():
                t.requires_grad_(True)
            saved = dict(ck.LAUNCHES)
            loss, _ = model.loss(params, ids.to(device), labels.to(device))
            g = torch.autograd.grad(loss, list(leaves.values()))
            if not out and (
                    ck.LAUNCHES['chunked_window_attn_fwd'] - saved['chunked_window_attn_fwd'],
                    ck.LAUNCHES['chunked_window_attn_bwd'] - saved['chunked_window_attn_bwd']
            ) != (2, 2):
                raise AssertionError('the card step did not run through K3 and K4')
            ck.LAUNCHES.update(saved)
            out.append((float(loss.detach()), {k: t.detach().cpu() for k, t in zip(leaves, g)}))
            shared.recorded, shared.replaying = shared.seen, True    # the CPU takes the card's
    (l_card, g_card), (l_cpu, g_cpu) = out
    rel = {k: float((g_card[k] - g_cpu[k]).abs().max() / g_cpu[k].abs().max().clamp(min=1e-30))
           for k in g_cpu}
    worst = max(rel, key=rel.get)
    flips = {k: f'{shared.differ[k]} of {shared.total[k]}' for k in shared.total}
    log(f'[reformer-train] f32 step, depth 2, B 1: loss card {l_card:.7f} cpu {l_cpu:.7f}; '
        f'gradients worst {worst} {rel[worst]:.2e} of its largest entry (tol {TOL_GRAD}); '
        f'CPU branches that differ from the card\'s (the card\'s are used): {flips}')
    report['reformer_grads_card_vs_cpu'] = dict(loss_card=l_card, loss_cpu=l_cpu, rel=rel,
                                                branches_differing=shared.differ,
                                                branches=shared.total)
    if rel[worst] > TOL_GRAD or abs(l_card - l_cpu) > 1e-5 * abs(l_cpu):
        raise AssertionError(f'card and CPU f32 Reformer gradients disagree: {worst} '
                             f'{rel[worst]}')


def reformer_score_and_generate(dev, tok, report):
    """The Reformer's scoring and generation paths, counted, and their times."""
    cfg = reformer_config(dropout=0.0)
    model = Reformer(cfg)
    params = params_from_jax(model.init_flat(SEED), dev)
    ikr = IkrMetric(tok, mode='vanilla')
    ids, labels = score_inputs(cfg.vocab_size, 8, cfg.max_length, SEED + 2, dev)
    key_scores = torch.from_numpy(
        np.random.default_rng(SEED + 3).random((8, N_KEY)).astype(np.float32)).to(dev)
    n_layer = len(cfg.attn_layers)

    def score():
        return score_batch(model, params, ids, labels, ikr, key_scores)
    ck.LAUNCHES.update(chunked_window_attn_fwd=0, chunked_window_attn_bwd=0)
    mets = score()
    torch.cuda.synchronize()
    per_forward = dict(ck.LAUNCHES)
    mets = {k: float(v) for k, v in mets.items()}
    log(f'[reformer-score] base bf16 8x{cfg.max_length}: {json.dumps(mets)} launches '
        f'{per_forward}')
    if per_forward != dict(chunked_window_attn_fwd=n_layer, chunked_window_attn_bwd=0):
        raise AssertionError(f'expected {n_layer} K3 launches and no K4 in one forward: '
                             f'{per_forward}')
    if not all(math.isfinite(v) for v in mets.values()) or \
            abs(mets['loss'] - math.log(cfg.vocab_size)) > 0.5 or not 0 <= mets['ikr'] <= 1:
        raise AssertionError(f'Reformer scoring metrics out of range: {mets}')
    n_iter = 5
    ms = time_ms(score, iters=n_iter, warmup=1)
    if ck.LAUNCHES['chunked_window_attn_fwd'] != n_layer * (n_iter + 2):
        raise AssertionError('K3 launches per forward changed during the timing loop')
    score_prof = profile(score)
    top = ', '.join(f'{r["name"][:40]} {r["device_ms"]:.3f}' for r in score_prof['top'][:6])
    log(f'[reformer-score] throughput: {ms:.2f} ms/batch, {ids.numel() / ms * 1e3:.0f} tok/s; '
        f'profile: wall {score_prof["wall_ms"]:.2f} ms, device busy '
        f'{score_prof["device_ms"]:.2f} ms ({score_prof["busy_share"]:.1%}); top: {top}')

    ck.LAUNCHES.update(chunked_window_attn_fwd=0, chunked_window_attn_bwd=0)
    gen_rec = {}
    for quant in (None, 'int8'):
        qmodel = Reformer(dataclasses.replace(cfg, decode_cache_quant=quant))
        gen = MusicGenerator(qmodel, tok, params)
        prompts = [gen.unconditional_prompt(time_sig=ts, tempo=tp) for ts, tp in
                   (((4, 4), 120), ((3, 4), 90), ((6, 8), 100), ((2, 4), 140))]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        texts = gen.generate(prompts, strategy='sample', seed=SEED, max_length=GEN_LEN,
                             **{k: v for k, v in tr.RECIPES['22-04']['generation'].items()
                                if k != 'strategy'})
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        for p, t in zip(prompts, texts):
            toks = t.split()
            if not t.startswith(p) or len(toks) > GEN_LEN or \
                    any(x not in tok.vocab.tok2id for x in toks):
                raise AssertionError(f'invalid generated token string: {t[:200]}')
        lens = [len(t.split()) for t in texts]
        new_tok = sum(n - len(p.split()) for n, p in zip(lens, prompts))
        label = quant or 'bf16'
        gen_rec[label] = dict(lengths=lens, new_tokens=new_tok, seconds=dt,
                              decode_tok_per_s=new_tok / dt, sample=texts[0][:160])
        log(f'[reformer-generate] sample top_p=0.9, {label} LSH cache, 4 requests: lengths '
            f'{lens}, {new_tok / dt:.1f} decode tok/s ({dt:.1f} s)')
    gen_launches = dict(ck.LAUNCHES)
    if any(gen_launches.values()):
        raise AssertionError(f'Reformer decode runs no kernel: {gen_launches}')
    dparams = model.compute_params(params)
    state = model.init_decode_state(4)
    tok_in = ids[:4, 0]
    for _ in range(4):                            # warm the decode path
        _, state = model.decode_step(dparams, tok_in, state)

    def decode8():
        nonlocal state
        for _ in range(8):
            _, state = model.decode_step(dparams, tok_in, state)
    decode_prof = profile(decode8)
    log(f'[profile] Reformer, 8 decode steps: wall {decode_prof["wall_ms"]:.2f} ms, device busy '
        f'{decode_prof["device_ms"]:.2f} ms ({decode_prof["busy_share"]:.1%})')
    report['reformer_score'] = dict(metrics=mets, launches=per_forward, ms=ms,
                                    tok_per_s=ids.numel() / ms * 1e3, profile=score_prof)
    report['reformer_generate'] = dict(runs=gen_rec, launches=gen_launches,
                                       profile_decode=decode_prof)
    return per_forward


# ------------------------------------------------------------ K5 / K6 (phase 7)
def roofline_phase(dev, k3_ms, report):
    """Phase 7: K5 and K6 against their plain versions, their times and
    bounds at K = ROOFLINE_K, the SASS of their loops, then the roofline tool
    (the kernels' main path), counted."""
    s, kp, qp = vr.chain_inputs(dev, seed=SEED)
    # a second set of positions where masked, valid and self keys all shape a
    # row (the tool's positions make every row's softmax its self key)
    kp_mixed = (torch.arange(rk.W, dtype=torch.int32, device=dev) - 40).expand_as(kp).clone()
    kp_mixed[:, :, ::5] = 10 ** 6
    saved = dict(rk.LAUNCHES)
    checks, err5, err6 = [], 0.0, 0.0
    for K, kpos in ((4, kp), (32, kp), (4, kp_mixed)):
        got5, want5 = rk.mask_chain(s, kpos, qp, K), rk.mask_chain_plain(s, kpos, qp, K)
        got6, want6 = rk.muladd_chain(s, K), rk.muladd_chain_plain(s, K)
        torch.cuda.synchronize()
        d5, d6 = (got5 - want5).abs(), (got6 - want6).abs()
        rec = dict(K=K, positions='tool' if kpos is kp else 'mixed',
                   k5_max_abs_err=float(d5.max()),
                   k5_within_one_bf16_ulp=bool((d5 <= 2.0 ** -7 * want5.abs()).all()),
                   k5_bit_equal_share=float((got5 == want5).float().mean()),
                   k6_max_abs_err=float(d6.max()),
                   k6_rel_err=float(d6.max()) / max(float(want6.abs().max()), 1e-30))
        log(f'[k5/k6] {json.dumps(rec)}')
        checks.append(rec)
        if not (rec['k5_within_one_bf16_ulp'] and rec['k6_max_abs_err'] == 0.0):
            raise AssertionError(f'K5 or K6 disagrees with its plain version: {rec}')
        err5, err6 = max(err5, rec['k5_max_abs_err']), max(err6, rec['k6_max_abs_err'])
    rates = vr.card_rates(dev)
    log(f'[k5/k6] card rates: {json.dumps(rates)}')
    os.makedirs(OUT_DIR, exist_ok=True)
    rows = {}
    for name, fn, plain, err in (
            ('mask_chain', lambda: rk.mask_chain(s, kp, qp, ROOFLINE_K),
             lambda: rk.mask_chain_plain(s, kp, qp, ROOFLINE_K), err5),
            ('muladd_chain', lambda: rk.muladd_chain(s, ROOFLINE_K),
             lambda: rk.muladd_chain_plain(s, ROOFLINE_K), err6)):
        sass = vr.sass_loop(name)
        with open(os.path.join(OUT_DIR, f'{name}.sass'), 'w') as f:
            f.write(sass.pop('sass'))
        rows[name] = dict(K=ROOFLINE_K, elems=s.numel(), max_abs_err=err,
                          ms=time_ms(fn, iters=5, warmup=1),
                          plain_ms=time_ms(plain, iters=3, warmup=1), library_ms=None,
                          **vr.bound(name, ROOFLINE_K, s.numel(), rates), sass=sass)
        log(f'[{name}] {json.dumps(rows[name])}')
    rk.LAUNCHES.update(saved)                    # comparison launches do not count

    rk.LAUNCHES.update(mask_chain=0, muladd_chain=0)
    res = vr.roofline(k3_ms=k3_ms, device=dev)
    torch.cuda.synchronize()
    launches = dict(rk.LAUNCHES)
    log(f'[roofline] {json.dumps(res)}')
    with open(os.path.join(OUT_DIR, 'vpu_roofline.json'), 'w') as f:
        json.dump(res, f, indent=2)
    per_kernel = len(vr.K_PAIR) * (1 + vr.REPEATS)     # warm-up + repeats per K
    if launches != dict(mask_chain=per_kernel, muladd_chain=per_kernel):
        raise AssertionError(f'the roofline tool did not run through K5 and K6: {launches}')
    if not (res['mask_chain_ns_per_pass'] > 0 and res['muladd_ns_per_pass'] > 0
            and math.isfinite(res['mask_chain_share_of_k3'])):
        raise AssertionError(f'the roofline figures are not positive: {res}')
    report.update(roofline_checks=checks, roofline_kernels=rows, roofline=res,
                  roofline_launches=launches)
    return rows, launches


# ------------------------------------------------------- the CLI path (phase 8)
def synthetic_songs(n, n_bar, seed):
    """n seeded step-kind songs, the extractor's records ({'score', 'keys',
    'title'}): 4/4 bars of a melody in quarter notes (a triplet or a rest now
    and then) over a bass in half notes, key scores for three keys.  n_bar
    150 gives ~2,600 tokens: enough to fill 2048."""
    rng = np.random.default_rng(seed)
    toks = list(MusicVocabulary(pitch_kind='step').tok2id)
    octave = lambda t: t.split('/')[-1].split('_')[0]
    high = [t for t in toks if t.startswith('p_') and octave(t) in ('4', '5')]
    low = [t for t in toks if t.startswith('p_') and octave(t) in ('2', '3')]
    keys = [key_ordinal2str[i] for i in range(N_KEY)]
    songs = []
    for i in range(n):
        out = ['TimeSig_4/4', 'Tempo_120']
        for _ in range(n_bar):
            out += ['<bar>', '<melody>']
            for _ in range(4):
                u = rng.random()
                if u < 0.1:
                    out += ['<tup>', *rng.choice(high, 3), 'd_1', '</tup>']
                else:
                    out += ['p_r' if u < 0.2 else str(rng.choice(high)), 'd_1']
            out += ['<bass>', str(rng.choice(low)), 'd_2', str(rng.choice(low)), 'd_2']
        out.append('</s>')
        songs.append(dict(score=' '.join(out), title=f'synthetic-{i}',
                          keys={str(k): float(rng.random())
                                for k in rng.choice(keys, 3, replace=False)}))
    return songs


def run_cli(argv):
    """`cli.main(argv)` on the card -> wall seconds; a non-zero exit raises."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    torch.cuda.empty_cache()
    log(f'[cli] {" ".join(argv[:2])} ... exit {rc} in {dt:.1f} s')
    if rc != 0:
        raise AssertionError(f'`{" ".join(argv)}` exited {rc}')
    return dt


class DecodeTimer:
    """Records each `MusicGenerator.generate` call the CLI makes: its prompts,
    raw outputs and card time, so decode tok/s counts the sampled tokens
    before repair."""

    def __init__(self):
        self.calls = []
        self.real = MusicGenerator.generate

    def __enter__(self):
        timer = self

        def generate(gen, prompts, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            texts = timer.real(gen, prompts, **kw)
            torch.cuda.synchronize()
            timer.calls.append((prompts, texts, time.perf_counter() - t0))
            return texts
        MusicGenerator.generate = generate
        return self

    def __exit__(self, *exc):
        MusicGenerator.generate = self.real

    def summary(self, vocab):
        prompts, texts, dt = self.calls[-1]
        for t in texts:
            if any(x not in vocab.tok2id for x in t.split()):
                raise AssertionError(f'a generated token is not in the vocabulary: {t[:200]}')
        new = sum(len(t.split()) - len(p.split()) for p, t in zip(prompts, texts))
        return dict(lengths=[len(t.split()) for t in texts], new_tokens=new, seconds=dt,
                    decode_tok_per_s=new / dt)


def check_rendered(out_dir, n):
    """Every .mxl the generate command wrote parses with the port's io to
    its song's bars (at least one); every .mid parses too, to at least one bar
    when the song sounds a note (a MIDI file of rests holds no track); ->
    (bar counts, share of bar_durations_valid)."""
    sides = sorted(f for f in os.listdir(out_dir) if f.endswith('.json'))
    if len(sides) != n:
        raise AssertionError(f'{out_dir}: {len(sides)} songs written, expected {n}')
    bars, valid = [], []
    for side in sides:
        stem = os.path.join(out_dir, side[:-len('.json')])
        with open(stem + '.json') as f:
            rec = json.load(f)
        n_bar = rec['text'].split().count('<bar>')
        n_mxl = len(parse_file(stem + '.mxl').parts[0].measures)
        n_mid = max((len(part.measures) for part in read_midi(stem + '.mid').parts), default=0)
        sounds = any(x.startswith('p_') and x != 'p_r' for x in rec['text'].split())
        if n_mxl != n_bar or n_bar < 1 or (sounds and n_mid < 1) or n_mid > n_bar:
            raise AssertionError(f'{stem}: {n_bar} bars written, {n_mxl} read from the MXL, '
                                 f'{n_mid} from the MIDI')
        bars.append(dict(mxl=n_mxl, midi=n_mid, tokens=len(rec['text'].split())))
        valid.append(bool(rec['bar_durations_valid']))
    return bars, sum(valid) / len(valid)


def pipeline_profile(recipe, ds_dir, dev):
    """Device-busy share of the recipe's own input pipeline (AugmentedDataset
    batches through `prefetch`, to the card) feeding training steps: one
    epoch of `setup_recipe`'s Trainer on the dataset, eval and checkpoints
    left out."""
    trainer = tr.setup_recipe(recipe, SongDataset.load(os.path.join(ds_dir, 'train.npz')),
                              out_dir=os.path.join(RUN_DIR, 'profile'), device=dev)
    params = params_from_jax(trainer.model.init_flat(SEED), dev)
    for t in flatten(params).values():
        t.requires_grad_(True)
    state = trainer.opt.init(params)
    B = trainer.args.batch_size

    def epoch():
        for batch in prefetch(trainer.train_dataset.batches(B, shuffle=True, seed=SEED)):
            trainer.train_step(params, state, tr._to_device(batch, dev))
    prof = profile(epoch)
    steps = len(trainer.train_dataset) // B
    del trainer, params, state
    torch.cuda.empty_cache()
    return dict(steps=steps, **{k: prof[k] for k in ('wall_ms', 'device_ms', 'busy_share',
                                                     'n_kernels')}, top=prof['top'][:6])


def cli_path(dev, report):
    """Phase 8: dataset -> train --recipe 22-11 -> generate (unconditional and
    conditional) -> re-read; train --recipe 22-04 -> generate; counted."""
    root = os.path.join(RUN_DIR, 'cli')
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    combined, ds = os.path.join(root, 'combined.json'), os.path.join(root, 'dataset')
    songs = synthetic_songs(64, 150, SEED + 30)
    with open(combined, 'w') as f:
        json.dump(dict(music=songs, n_song=len(songs), extractor_meta={}), f)
    rec = dict(walls={})
    rec['walls']['dataset'] = run_cli(['dataset', combined, '--out', ds, '--pitch-kind', 'step',
                                       '--test-frac', '0.1'])
    with open(os.path.join(ds, 'meta.json')) as f:
        meta = json.load(f)
    if (meta['n_train'], meta['n_test']) != (58, 6):
        raise AssertionError(f'dataset split: {meta}')

    # 22-11: TF-XL base, degree vocab 1190, 1024 / mem 512, batch 21
    run = os.path.join(root, '22-11')
    fa.LAUNCHES.update(flash_rel_attn_fwd=0, flash_rel_attn_bwd=0)
    rec['walls']['train 22-11'] = run_cli(['train', '--dataset', ds, '--out', run, '--recipe',
                                           '22-11', '--epochs', '1'])
    launches_1122 = dict(fa.LAUNCHES)
    log_ = step_log(run)
    steps = [r for r in log_ if 'loss' in r]
    ep = [r for r in log_ if 'train_tokens_per_sec' in r][0]
    n_layer = base_config().n_layer
    n_steps, n_eval = 58 // 21, 1
    log(f'[cli] train 22-11: losses {[round(r["loss"], 4) for r in steps]}, epoch '
        f'{ep["train_tokens_per_sec"]:.0f} non-pad tok/s, eval loss {ep["eval_loss"]:.4f} '
        f'ikr {ep["eval_ikr"]:.4f}; launches {launches_1122}')
    if len(steps) != n_steps or not all(math.isfinite(r['loss']) for r in steps) or \
            launches_1122 != dict(flash_rel_attn_fwd=n_layer * (n_steps + n_eval),
                                  flash_rel_attn_bwd=n_layer * n_steps):
        raise AssertionError(f'the 22-11 CLI run: {steps} {launches_1122}')
    if not os.path.exists(os.path.join(run, 'trained.npz')):
        raise AssertionError('the 22-11 CLI run wrote no trained.npz')
    rec['train_22_11'] = dict(steps=steps, epoch=ep, launches=launches_1122)

    gen_dir = os.path.join(root, 'gen-22-11')
    fa.LAUNCHES.update(flash_rel_attn_fwd=0, flash_rel_attn_bwd=0)
    dtok = MusicTokenizer(pitch_kind='degree')
    with DecodeTimer() as timer:
        rec['walls']['generate 22-11'] = run_cli([
            'generate', '--model-dir', run, '--out', gen_dir, '--n', '4', '--key', 'CMajor',
            '--top-k', '8', '--max-length', '1024', '--seed', str(SEED)])
        rec['generate_22_11'] = timer.summary(dtok.vocab)
        # a prompt from a rendered song: 8 bars of a training song as an
        # extracted MXL, its key from KeyFinder, the first 4 bars via mxl2str
        toks = songs[0]['score'].split()
        ninth_bar = [i for i, x in enumerate(toks) if x == '<bar>'][8]
        text = ' '.join(toks[:ninth_bar] + ['</s>'])
        prompt_mxl = os.path.join(root, 'prompt.mxl')
        MusicConverter(mode='full').str2score(text, pitch_kind='step',
                                              title='prompt').write_mxl(prompt_mxl)
        keys = KeyFinder(parse_file(prompt_mxl))(return_type='dict')
        key = max(keys, key=keys.get)
        cond_dir = os.path.join(root, 'gen-22-11-cond')
        rec['walls']['generate 22-11 conditional'] = run_cli([
            'generate', '--model-dir', run, '--out', cond_dir, '--n', '1', '--key', key,
            '--condition-on', prompt_mxl, '--n-bar', '4', '--top-k', '8', '--max-length',
            '1024', '--seed', str(SEED)])
        rec['generate_22_11_conditional'] = dict(key=key, **timer.summary(dtok.vocab))
    # phase 4's request (seeded weights, 4 keys, top_k 8) in this process
    # state: the CLI's decode is held against it as well as against phase 4
    model = TransfoXL(base_config())
    _, lens, new_tok, dt = run_generation(model, params_from_jax(model.init_flat(SEED), dev),
                                          dtok, 4, 'sample', SEED, top_k=8)
    rec['generate_22_11_seeded_after_cli'] = dict(lengths=lens, new_tokens=new_tok, seconds=dt,
                                                  decode_tok_per_s=new_tok / dt)
    del model
    if any(fa.LAUNCHES.values()):
        raise AssertionError(f'generation runs the plain decode step, no kernel: {fa.LAUNCHES}')
    (prompt,), _, _ = timer.calls[-1]
    if prompt.split()[2] != f'Key_{key}' or prompt.split().count('<bar>') != 4:
        raise AssertionError(f'the conditional prompt is not 4 bars in {key}: {prompt}')
    bars, valid = check_rendered(gen_dir, 4)
    cbars, cvalid = check_rendered(cond_dir, 1)
    rec['rendered_22_11'] = dict(bars=bars, bar_durations_valid_share=valid,
                                 conditional_bars=cbars, conditional_valid=cvalid)
    log(f'[cli] generate 22-11: {json.dumps(rec["generate_22_11"])}; conditional on {key}: '
        f'{json.dumps(rec["generate_22_11_conditional"])}; phase 4\'s request after them: '
        f'{json.dumps(rec["generate_22_11_seeded_after_cli"])}; re-read bars {bars} + {cbars}, '
        f'bar_durations_valid {valid:.2f} / {cvalid:.2f}')
    rec['profile_22_11'] = pipeline_profile('22-11', ds, dev)
    log(f'[cli] 22-11 input pipeline + steps: {json.dumps(rec["profile_22_11"])}')
    shutil.rmtree(run)

    # 22-04: Reformer base, midi vocab 422, 2048, batch 32
    run = os.path.join(root, '22-04')
    ck.LAUNCHES.update(chunked_window_attn_fwd=0, chunked_window_attn_bwd=0)
    rec['walls']['train 22-04'] = run_cli(['train', '--dataset', ds, '--out', run, '--recipe',
                                           '22-04', '--epochs', '1'])
    launches_2204 = dict(ck.LAUNCHES)
    log_ = step_log(run)
    steps = [r for r in log_ if 'loss' in r]
    ep = [r for r in log_ if 'train_tokens_per_sec' in r][0]
    n_layer = len(reformer_config().attn_layers)
    n_steps = 58 // 32
    log(f'[cli] train 22-04: losses {[round(r["loss"], 4) for r in steps]}, epoch '
        f'{ep["train_tokens_per_sec"]:.0f} non-pad tok/s, eval loss {ep["eval_loss"]:.4f}; '
        f'launches {launches_2204}')
    if len(steps) != n_steps or not all(math.isfinite(r['loss']) for r in steps) or \
            launches_2204 != dict(chunked_window_attn_fwd=n_layer * (n_steps + n_eval),
                                  chunked_window_attn_bwd=n_layer * n_steps):
        raise AssertionError(f'the 22-04 CLI run: {steps} {launches_2204}')
    rec['train_22_04'] = dict(steps=steps, epoch=ep, launches=launches_2204)
    gen_dir = os.path.join(root, 'gen-22-04')
    ck.LAUNCHES.update(chunked_window_attn_fwd=0, chunked_window_attn_bwd=0)
    with DecodeTimer() as timer:
        rec['walls']['generate 22-04'] = run_cli([
            'generate', '--model-dir', run, '--out', gen_dir, '--n', '4', '--top-p', '0.9',
            '--max-length', str(GEN_LEN), '--seed', str(SEED)])
        rec['generate_22_04'] = timer.summary(MusicTokenizer(pitch_kind='midi').vocab)
    if any(ck.LAUNCHES.values()):
        raise AssertionError(f'Reformer decode runs no kernel: {ck.LAUNCHES}')
    bars, valid = check_rendered(gen_dir, 4)
    rec['rendered_22_04'] = dict(bars=bars, bar_durations_valid_share=valid)
    log(f'[cli] generate 22-04: {json.dumps(rec["generate_22_04"])}; re-read bars {bars}, '
        f'bar_durations_valid {valid:.2f}')
    rec['profile_22_04'] = pipeline_profile('22-04', ds, dev)
    log(f'[cli] 22-04 input pipeline + steps: {json.dumps(rec["profile_22_04"])}')
    log(f'[cli] wall seconds per command: {json.dumps(rec["walls"])}')
    report['cli'] = rec
    shutil.rmtree(root, ignore_errors=True)
    return launches_1122, launches_2204


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')
    t_start = time.perf_counter()
    report = dict(started=time.strftime('%Y-%m-%d %H:%M:%S'))

    # 1. device and build
    card = gpu_name_and_power()
    log(f'[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} | '
        f'{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}')
    t0 = time.perf_counter()
    built = build_all()
    build_s = time.perf_counter() - t0
    for name, info in built.items():
        ptx = ' '.join(l.strip() for l in info['ptxas'].splitlines() if 'registers' in l)
        log(f'[build] {name}: {info["seconds"]:.1f} s cached={info["cached"]} {ptx}')
    log(f'[build] all kernels, in parallel: {build_s:.1f} s')
    report.update(card=card, build_seconds=build_s)
    tensor_core_check(report)

    # 2. K1 and K2 against their plain versions on the card
    k1 = [
        k1_case(dev, 'base-bf16', torch.bfloat16, 8, 12, 1024, 0, 64, 1024, 0, 0, 1, True),
        k1_case(dev, 'base-f32', torch.float32, 8, 12, 1024, 0, 64, 1024, 0, 0, 2, True),
        k1_case(dev, 'train-bf16', torch.bfloat16, 21, 12, 1024, 0, 64, 1024, 0, 0, 7, True),
        k1_case(dev, 'memory-window-bf16', torch.bfloat16, 8, 12, 1024, 512, 64, 96, 300, 512,
                3, False),
        k1_case(dev, 'memory-window-f32', torch.float32, 2, 12, 1024, 512, 64, 96, 300, 512,
                4, False),
        k1_case(dev, 'debug-h16-ragged', torch.float32, 4, 8, 333, 64, 16, 64, 40, 0, 5, False),
        k1_case(dev, 'debug-h16-ragged-bf16', torch.bfloat16, 4, 8, 333, 64, 16, 64, 64, 0, 6,
                False),
    ]
    k2 = [
        k2_case(dev, 'train-bf16', torch.bfloat16, 21, 12, 1024, 0, 64, 1024, 0, 0, 21, True),
        k2_case(dev, 'train-f32', torch.float32, 21, 12, 1024, 0, 64, 1024, 0, 0, 22, True),
        k2_case(dev, 'memory-window-bf16', torch.bfloat16, 8, 12, 1024, 512, 64, 96, 300, 512,
                23, False),
        k2_case(dev, 'memory-window-f32', torch.float32, 2, 12, 1024, 512, 64, 96, 300, 512,
                24, False),
        k2_case(dev, 'debug-h16-ragged', torch.float32, 4, 8, 333, 64, 16, 64, 40, 0, 25, False),
        k2_case(dev, 'debug-h16-ragged-bf16', torch.bfloat16, 4, 8, 333, 64, 16, 64, 64, 0, 26,
                False),
    ]
    report.update(k1_cases=k1, k2_cases=k2)

    # 2b. K3 and K4 against their plain versions on the card: the 22-04
    # shapes (training batch 32: local G = 32 x 12, LSH G = 32 x 12 x 2)
    k3 = [
        k3_case(dev, 'lsh-bf16', torch.bfloat16, 768, 2048, 64, 64, True, 0, 31),
        k3_case(dev, 'lsh-f32', torch.float32, 768, 2048, 64, 64, True, 0, 32),
        k3_case(dev, 'local-bf16', torch.bfloat16, 384, 2048, 64, 64, False, 0, 33),
        k3_case(dev, 'local-f32', torch.float32, 384, 2048, 64, 64, False, 0, 34),
        k3_case(dev, 'local-padded-bf16', torch.bfloat16, 384, 2048, 64, 64, False, 300, 35),
        k3_case(dev, 'lsh-padded-f32', torch.float32, 96, 2048, 64, 64, True, 300, 36),
        k3_case(dev, 'd32-chunk32-single-block', torch.float32, 8, 32, 32, 32, True, 4, 37),
    ]
    k4 = [
        k4_case(dev, 'lsh-bf16', torch.bfloat16, 768, 2048, 64, 64, True, 0, 41),
        k4_case(dev, 'lsh-f32', torch.float32, 768, 2048, 64, 64, True, 0, 42),
        k4_case(dev, 'local-bf16', torch.bfloat16, 384, 2048, 64, 64, False, 0, 43),
        k4_case(dev, 'local-padded-f32', torch.float32, 96, 2048, 64, 64, False, 300, 44),
        k4_case(dev, 'd32-chunk32-single-block', torch.float32, 8, 32, 32, 32, True, 4, 45),
        k4_case(dev, 'd16-chunk32-padded-bf16', torch.bfloat16, 48, 512, 16, 32, True, 40, 46),
    ]
    report.update(k3_cases=k3, k4_cases=k4)

    # 3. the training path, counted
    tok = MusicTokenizer(pitch_kind='degree', model_max_length=1024)
    train_launches = training_path(dev, tok, report)

    # 4. the scoring and generation paths, counted
    cfg = base_config()
    model = TransfoXL(cfg)
    params = params_from_jax(model.init_flat(SEED), dev)
    ikr = IkrMetric(tok, mode='ins-key')
    ids, labels = score_inputs(cfg.vocab_size, 8, 1024, SEED + 1, dev)

    fa.LAUNCHES.update(flash_rel_attn_fwd=0, flash_rel_attn_bwd=0)
    mets = score_batch(model, params, ids, labels, ikr)
    torch.cuda.synchronize()
    per_forward = fa.LAUNCHES['flash_rel_attn_fwd']
    mets = {k: float(v) for k, v in mets.items()}
    log(f'[score] base bf16 8x1024: {json.dumps(mets)} K1 launches {per_forward}')
    if per_forward != cfg.n_layer or fa.LAUNCHES['flash_rel_attn_bwd']:
        raise AssertionError(f'K1 launched {per_forward} times in one forward, '
                             f'expected {cfg.n_layer} (and no K2): {fa.LAUNCHES}')
    if not all(math.isfinite(v) for v in mets.values()) or \
            abs(mets['loss'] - math.log(cfg.vocab_size)) > 0.5 or not 0 <= mets['ikr'] <= 1:
        raise AssertionError(f'scoring metrics out of range: {mets}')

    fa.LAUNCHES.update(flash_rel_attn_fwd=0, flash_rel_attn_bwd=0)
    gen_rec = {}
    for quant in (None, 'int8'):
        qmodel = TransfoXL(dataclasses.replace(cfg, decode_cache_quant=quant))
        texts, lens, new_tok, dt = run_generation(qmodel, params, tok, 4, 'sample', SEED,
                                                  top_k=8)
        label = quant or 'bf16'
        gen_rec[label] = dict(lengths=lens, new_tokens=new_tok, seconds=dt,
                              decode_tok_per_s=new_tok / dt, sample=texts[0][:160])
        log(f'[generate] sample top_k=8, {label} cache, 4 requests: lengths {lens}, '
            f'{new_tok / dt:.1f} decode tok/s ({dt:.1f} s)')

    # greedy with early exit: raise </s>'s bias so the song ends; the early-exit
    # output must equal the full-length run's
    eos_params = dict(params, out_bias=params['out_bias'].clone())
    eos_params['out_bias'][tok.eos_token_id] = 5.0
    (g_fast,), lens_fast, _, dt_fast = run_generation(model, eos_params, tok, 1, 'greedy', SEED,
                                                      early_exit_chunk=128)
    (g_full,), _, _, dt_full = run_generation(model, eos_params, tok, 1, 'greedy', SEED,
                                              early_exit_chunk=0)
    if g_fast != g_full or not g_fast.endswith('</s>'):
        raise AssertionError(f'early exit changed the greedy output: {g_fast!r} vs {g_full!r}')
    gen_rec['greedy_early_exit'] = dict(length=lens_fast[0], seconds=dt_fast,
                                        full_run_seconds=dt_full)
    log(f'[generate] greedy, early exit: length {lens_fast[0]}, {dt_fast:.2f} s '
        f'(all 1023 steps: {dt_full:.2f} s), outputs identical')
    gen_launches = dict(fa.LAUNCHES)
    if gen_launches['flash_rel_attn_fwd'] or gen_launches['flash_rel_attn_bwd']:
        raise AssertionError(f'generation runs the plain decode step, no kernel: {gen_launches}')
    report.update(score=mets, generate=gen_rec, train_path_launches=train_launches,
                  score_path_launches=per_forward, generate_path_launches=gen_launches)

    # 5. f32 on the card vs the port's CPU f32 run, and throughput
    cfg32 = base_config(dtype='float32')
    m32, m32_cpu = TransfoXL(cfg32), TransfoXL(cfg32, device='cpu')
    flat = m32.init_flat(SEED)
    p32, p32_cpu = params_from_jax(flat, dev), params_from_jax(flat, 'cpu')
    saved = fa.LAUNCHES['flash_rel_attn_fwd']
    with torch.no_grad():
        l_card, _ = m32.loss(p32, ids[:1], labels[:1])
        l_cpu, _ = m32_cpu.loss(p32_cpu, ids[:1].cpu(), labels[:1].cpu())
    if fa.LAUNCHES['flash_rel_attn_fwd'] - saved != cfg32.n_layer:
        raise AssertionError('the f32 forward on the card did not run through K1')
    rel = abs(float(l_card) - float(l_cpu)) / abs(float(l_cpu))
    log(f'[score] f32 loss B=1: card {float(l_card):.7f} cpu {float(l_cpu):.7f} rel {rel:.2e}')
    if rel > 1e-4:
        raise AssertionError(f'card and CPU f32 losses disagree: {rel}')
    del m32, p32, p32_cpu
    card_vs_cpu_grads(dev, report)

    fa.LAUNCHES['flash_rel_attn_fwd'] = 0
    n_iter = 5
    ms = time_ms(lambda: score_batch(model, params, ids, labels, ikr), iters=n_iter, warmup=1)
    if fa.LAUNCHES['flash_rel_attn_fwd'] != cfg.n_layer * (n_iter + 1):
        raise AssertionError('K1 launches per forward changed during the timing loop')
    score_tps = ids.numel() / (ms / 1e3)
    log(f'[score] throughput base bf16 8x1024: {ms:.2f} ms/batch, {score_tps:.0f} tok/s')
    score_prof = profile(lambda: score_batch(model, params, ids, labels, ikr))
    dparams = model.compute_params(params)
    state = model.init_decode_state(4)
    tok_in = ids[:4, 0]
    for _ in range(4):                            # warm the decode path
        _, state = model.decode_step(dparams, tok_in, state)

    def decode8():
        nonlocal state
        for _ in range(8):
            _, state = model.decode_step(dparams, tok_in, state)
    decode_prof = profile(decode8)
    for label, prof in (('score batch', score_prof), ('8 decode steps', decode_prof)):
        top = ', '.join(f'{r["name"][:40]} {r["device_ms"]:.3f}' for r in prof['top'][:5])
        log(f'[profile] {label}: wall {prof["wall_ms"]:.2f} ms, device busy '
            f'{prof["device_ms"]:.2f} ms ({prof["busy_share"]:.1%}); top: {top}')
    report.update(profile_score=score_prof, profile_decode=decode_prof)
    report.update(f32_loss_card=float(l_card), f32_loss_cpu=float(l_cpu), f32_rel=rel,
                  score_ms=ms, score_tok_per_s=score_tps)
    del model, params, dparams, state
    torch.cuda.empty_cache()

    # 6. the Reformer (22-04): training, scoring and generation, each counted,
    # and the card against the port's CPU run in f32
    rtok = MusicTokenizer(pitch_kind='midi', model_max_length=2048)
    reformer_train_launches = reformer_training_path(dev, rtok, report)
    reformer_card_vs_cpu(dev, report)
    reformer_score_and_generate(dev, rtok, report)
    torch.cuda.empty_cache()

    # 7. K5 and K6, and the roofline tool with phase 2b's K3 LSH time (bf16)
    roofline_rows, roofline_launches = roofline_phase(dev, k3[0]['ms'], report)

    # 8. the user's path through the command line
    cli_path(dev, report)
    report.update(peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                  seconds=time.perf_counter() - t_start)
    shutil.rmtree(RUN_DIR, ignore_errors=True)

    def row(name, case, replaces, launches):
        return dict(name=name, route='cuda', source=f'musicnlp_tpu_torch/csrc/{name}.cu',
                    replaces=replaces, launches=launches, max_abs_err=case['max_abs_err'],
                    ms=case['ms'], plain_ms=case['plain_ms'], bound_ms=case['bound_ms'],
                    bound_by=case['bound_by'], library_ms=case['library_ms'])
    # times at the training shapes (TF-XL 21 x 1024, Reformer LSH 32 x 2048,
    # bf16); launches of each model's training path
    kernels = [row('flash_rel_attn_fwd', k1[2], K1_REPLACES,
                   train_launches['flash_rel_attn_fwd']),
               row('flash_rel_attn_bwd', k2[0], K2_REPLACES,
                   train_launches['flash_rel_attn_bwd']),
               row('chunked_window_attn_fwd', k3[0], K3_REPLACES,
                   reformer_train_launches['chunked_window_attn_fwd']),
               row('chunked_window_attn_bwd', k4[0], K4_REPLACES,
                   reformer_train_launches['chunked_window_attn_bwd']),
               # K5 / K6: one call of K = 1024 passes; launches of the roofline tool
               row('mask_chain', roofline_rows['mask_chain'], K5_REPLACES,
                   roofline_launches['mask_chain']),
               row('muladd_chain', roofline_rows['muladd_chain'], K6_REPLACES,
                   roofline_launches['muladd_chain'])]
    report['kernels'] = kernels
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, 'chip_smoke.json'), 'w') as f:
        json.dump(report, f, indent=1)
    log(f'[done] {report["seconds"]:.1f} s')
    print(card)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
