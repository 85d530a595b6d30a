"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): `python3 chip_smoke.py`.

Drives the port's main paths -- TF-XL base training, scoring and generation
(the 22-11 recipe: d_model 768, 12 heads x 64, 12 layers, degree vocab 1190,
max_length 1024, mem_len 512, clamp_len 1024, bf16, batch 21, AdamW with
weight decay 0.1), on weights made from a seed with numpy in the JAX layout
and carried in through `params_from_jax` -- and holds every kernel of those
paths against its plain PyTorch version on the card.

Phases (each prints a line; any failure raises and the exit code is not 0):
  1. device and build: the card's name and power limit, `nvcc` of every
     kernel source in `musicnlp_tpu_torch/csrc/`, all started together;
  2. K1 (forward) and K2 (backward) against their plain versions on CUDA
     tensors: the base shapes (scoring B 8 and training B 21, bf16 and f32),
     a memory + window case and a head-dim-16 ragged case; times of each
     kernel, its plain version and a one-call PyTorch yardstick the port
     never calls (`scaled_dot_product_attention` with the positional term as
     a float mask; for K2 its backward, with the mask requiring grad);
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
     and of 8 decode steps (device time by kernel, busy share).
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

from musicnlp_tpu_torch.kernels.build import build_all
from musicnlp_tpu_torch.models.transformer_xl import TransfoXL, TransfoXLConfig
from musicnlp_tpu_torch.ops import flash_attention as fa
from musicnlp_tpu_torch.trainer import train as tr
from musicnlp_tpu_torch.trainer.eval import MusicGenerator, load_trained, score_batch
from musicnlp_tpu_torch.trainer.metrics import IkrMetric
from musicnlp_tpu_torch.utils.checkpoint import flatten, params_from_jax
from musicnlp_tpu_torch.vocab import MusicTokenizer, N_KEY, key_ordinal2str

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
# arithmetic summed in other orders over 1024 positions and two layers
TOL_GRAD = 1e-4
RUN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build', 'chip_smoke_runs')


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
    pair (scores AC and BD, dP, dV, dK, dRW, dRR, dG); inputs rw, rr, k, v,
    dO, G, lse, delta read once, outputs drw, drr (input dtype), dk, dv and
    dG (f32) written once."""
    BN, _, H = rw.shape
    visible = int(fa._key_mask(T, S, M, mem_valid, window, rw.device).sum())
    flops = 8 * 2 * H * visible * BN
    e = rw.element_size()
    nbytes = (e * (3 * BN * T * H + 2 * BN * S * H + g.numel()) + 4 * 2 * BN * T
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
               abs_err=errs, rel_err=rel, tol_rel=TOL_K2[dtype])
    if timed:
        rec['ms'] = time_ms(lambda: fa.flash_rel_attn_bwd(*args, **kw))
        rec['plain_ms'] = time_ms(lambda: fa.flash_rel_attn_bwd_plain(*args, **kw), iters=3)
        rec['library_ms'] = time_ms(sdpa_bwd_yardstick(rw, rr, k, v, g, d_out, T, S, M,
                                                       mem_valid, window, scale))
        flops, nbytes = k2_work(rw, k, g, T, S, M, mem_valid, window)
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        rec.update(flops=flops, bytes=nbytes, bound_ms=max(t_ops, t_bytes),
                   bound_by='operations' if t_ops >= t_bytes else 'bytes')
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
    TimeSig, Tempo, Key_*, then bars of a repeated (pitch, duration) motif,
    </s>, and a pad tail (labels -100) -- so 'ins-key' IKR reads its key."""

    def __init__(self, tok: MusicTokenizer, n: int, seed: int, length: int = 1024):
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
            row = [t2i['TimeSig_4/4'], t2i['Tempo_120'], t2i[f'Key_{key_ordinal2str[key]}']]
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


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')
    t_start = time.perf_counter()
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'chiprun_out')
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
                  score_ms=ms, score_tok_per_s=score_tps,
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                  seconds=time.perf_counter() - t_start)
    shutil.rmtree(RUN_DIR, ignore_errors=True)

    def row(name, case, replaces, launches):
        return dict(name=name, route='cuda', source=f'musicnlp_tpu_torch/csrc/{name}.cu',
                    replaces=replaces, launches=launches, max_abs_err=case['max_abs_err'],
                    ms=case['ms'], plain_ms=case['plain_ms'], bound_ms=case['bound_ms'],
                    bound_by=case['bound_by'], library_ms=case['library_ms'])
    # times at the training shape (21 x 1024, bf16); launches of the training path
    kernels = [row('flash_rel_attn_fwd', k1[2], K1_REPLACES,
                   train_launches['flash_rel_attn_fwd']),
               row('flash_rel_attn_bwd', k2[0], K2_REPLACES,
                   train_launches['flash_rel_attn_bwd'])]
    report['kernels'] = kernels
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, 'chip_smoke.json'), 'w') as f:
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
