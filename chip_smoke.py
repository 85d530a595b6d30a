"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): `python3 chip_smoke.py`.

Drives the port's main path -- TF-XL base scoring and generation (the 22-11
recipe: d_model 768, 12 heads x 64, 12 layers, degree vocab 1190, max_length
1024, mem_len 512, clamp_len 1024, bf16), on weights made from a seed with
numpy in the JAX layout and carried in through `params_from_jax` -- and holds
every kernel of that path against its plain PyTorch version on the card.

Phases (each prints a line; any failure raises and the exit code is not 0):
  1. device and build: the card's name and power limit, `nvcc` of every
     kernel source in `musicnlp_tpu_torch/csrc/`;
  2. K1 against its plain version on CUDA tensors at the base shape (bf16 and
     f32), a memory + window case and a head-dim-16 ragged case; times of the
     kernel, the plain version and `scaled_dot_product_attention` with the
     positional term as a float mask (the yardstick; the port never calls it);
  3. the main path, with the launch counts set to 0 before and read after:
     `score_batch` (loss, NTP accuracy, IKR) on 8 x 1024 ids, then
     `MusicGenerator.generate` for 4 key-augmented unconditional prompts
     (sample, top_k 8, max_length 1024) with a bf16 and an int8 KV cache, and
     one greedy request with early exit, checked against the full-length run;
  4. the card's f32 loss against the port's own CPU f32 run at batch 1,
     scoring throughput, and a torch.profiler breakdown of one scoring batch
     and of 8 decode steps (device time by kernel, busy share).
The line before the last holds the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.  Details go to chiprun_out/chip_smoke.json.
Without CUDA, or without the package beside it, it fails before any result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from musicnlp_tpu_torch.kernels.build import SOURCES, build
from musicnlp_tpu_torch.models.transformer_xl import TransfoXL, TransfoXLConfig
from musicnlp_tpu_torch.ops import flash_attention as fa
from musicnlp_tpu_torch.trainer.eval import MusicGenerator, score_batch
from musicnlp_tpu_torch.trainer.metrics import IkrMetric
from musicnlp_tpu_torch.utils.checkpoint import params_from_jax
from musicnlp_tpu_torch.vocab import MusicTokenizer

HBM_BYTES_PER_S = 3.35e12                        # H100 SXM (NVIDIA data sheet)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}   # dense bf16 tensor / f32
SEED = 0
K1_REPLACES = 'musicnlp_tpu/ops/pallas/flash_attention.py:115 (_make_fwd, via _fwd_call :354)'
# K1 vs plain, per case: ctx (bf16 output rounding ~ 2^-8 of |ctx| <= ~3;
# p rounded against the running vs the global max) and lse (same f32 scores,
# other summation order)
TOL = {torch.float32: dict(ctx=1e-4, lse=1e-3), torch.bfloat16: dict(ctx=2e-2, lse=1e-3)}


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


# ---------------------------------------------------------------- main path
def base_config(**kw) -> TransfoXLConfig:
    """The 22-11 recipe's model: TF-XL base, degree vocab, seq 1024, mem 512."""
    return TransfoXLConfig.from_size('base', vocab_size=1190, max_length=1024, mem_len=512,
                                     dropout=0.0, **kw)


def score_inputs(V, B, T, seed, dev):
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(0, V, (B, T)).astype(np.int64)).to(dev)
    return ids, ids.clone()


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
    built = {name: build(name) for name in SOURCES}
    build_s = time.perf_counter() - t0
    for name, info in built.items():
        ptx = ' '.join(l.strip() for l in info['ptxas'].splitlines() if 'registers' in l)
        log(f'[build] {name}: {info["seconds"]:.1f} s cached={info["cached"]} {ptx}')
    log(f'[build] all kernels: {build_s:.1f} s')
    report.update(card=card, build_seconds=build_s)

    # 2. K1 against its plain version on the card
    cases = [
        k1_case(dev, 'base-bf16', torch.bfloat16, 8, 12, 1024, 0, 64, 1024, 0, 0, 1, True),
        k1_case(dev, 'base-f32', torch.float32, 8, 12, 1024, 0, 64, 1024, 0, 0, 2, True),
        k1_case(dev, 'memory-window-bf16', torch.bfloat16, 8, 12, 1024, 512, 64, 96, 300, 512,
                3, False),
        k1_case(dev, 'memory-window-f32', torch.float32, 2, 12, 1024, 512, 64, 96, 300, 512,
                4, False),
        k1_case(dev, 'debug-h16-ragged', torch.float32, 4, 8, 333, 64, 16, 64, 40, 0, 5, False),
        k1_case(dev, 'debug-h16-ragged-bf16', torch.bfloat16, 4, 8, 333, 64, 16, 64, 64, 0, 6,
                False),
    ]
    report['k1_cases'] = cases

    # 3. the main path, counted
    tok = MusicTokenizer(pitch_kind='degree', model_max_length=1024)
    cfg = base_config()
    model = TransfoXL(cfg)
    params = params_from_jax(model.init_flat(SEED), dev)
    ikr = IkrMetric(tok, mode='ins-key')
    ids, labels = score_inputs(cfg.vocab_size, 8, 1024, SEED + 1, dev)

    fa.LAUNCHES['flash_rel_attn_fwd'] = 0
    mets = score_batch(model, params, ids, labels, ikr)
    torch.cuda.synchronize()
    per_forward = fa.LAUNCHES['flash_rel_attn_fwd']
    mets = {k: float(v) for k, v in mets.items()}
    log(f'[score] base bf16 8x1024: {json.dumps(mets)} K1 launches {per_forward}')
    if per_forward != cfg.n_layer:
        raise AssertionError(f'K1 launched {per_forward} times in one forward, '
                             f'expected {cfg.n_layer}')
    if not all(math.isfinite(v) for v in mets.values()) or \
            abs(mets['loss'] - math.log(cfg.vocab_size)) > 0.5 or not 0 <= mets['ikr'] <= 1:
        raise AssertionError(f'scoring metrics out of range: {mets}')

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
    main_launches = fa.LAUNCHES['flash_rel_attn_fwd']
    if main_launches == 0:
        raise AssertionError('the main path never launched K1')
    report.update(score=mets, generate=gen_rec, main_path_launches=main_launches)

    # 4. f32 on the card vs the port's CPU f32 run, and throughput
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

    base = cases[0]
    kernels = [dict(name='flash_rel_attn_fwd', route='cuda',
                    source='musicnlp_tpu_torch/csrc/flash_rel_attn_fwd.cu',
                    replaces=K1_REPLACES, launches=main_launches,
                    max_abs_err=base['max_abs_err'], ms=base['ms'], plain_ms=base['plain_ms'],
                    bound_ms=base['bound_ms'], bound_by=base['bound_by'],
                    library_ms=base['library_ms'])]
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
