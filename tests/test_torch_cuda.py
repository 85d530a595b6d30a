"""K1-K6 on the card against their plain versions (K1-K4 also at head dim
128, in f16 and, for K3 / K4, at chunks other than 32 / 64: ROADMAP C.1;
K1-K4 run every bf16 and f16 call on their tensor-core kernels),
the tiled CE's card path (bf16 tiles on the tensor cores) against the dense
CE, the dense layers' epilogue (`bias_act`) against its plain version at the
FFN's shapes, forward and backward, and twice per FFN in both models,
C.1's three model configurations launching K1-K4, a `device_trace` that
names K1 / K2, and `PitchEmbedding` on the card against the CPU (needs an
NVIDIA GPU and nvcc).

Run on a GPU machine with `python -m pytest -m cuda tests/test_torch_cuda.py`;
elsewhere these tests skip.  `chip_smoke.py` holds both kernels against the
plain versions at the model's real shapes."""
import dataclasses
import time

import numpy as np
import pytest
import torch

from musicnlp_tpu_torch.models.reformer import Reformer, ReformerConfig
from musicnlp_tpu_torch.models.transformer_xl import TransfoXL, TransfoXLConfig
from musicnlp_tpu_torch.ops import chunked_attention_kernel as ck
from musicnlp_tpu_torch.ops import layers as tl
from musicnlp_tpu_torch.ops import roofline_kernels as rk
from musicnlp_tpu_torch.ops.flash_attention import (
    LAUNCHES, FlashRelAttn, distance_table, flash_rel_attn_bwd, flash_rel_attn_bwd_plain,
    flash_rel_attn_fwd, flash_rel_attn_fwd_plain,
)
from musicnlp_tpu_torch.preprocess.melody_grid import GridVocab
from musicnlp_tpu_torch.tools import vpu_roofline as vr
from musicnlp_tpu_torch.trainer.melody_w2v import PitchEmbedding
from musicnlp_tpu_torch.utils.profiling import device_trace, step_kernels
from tests.slab_configs import with_cfg
from tests.test_torch_tf32x3 import k4 as k4_reference, k4_scores

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (K1-K6 are CUDA kernels with no CPU mode)')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _inputs(dev, dtype, BN, N, T, M, H, clamp, seed=0):
    g = torch.Generator(device='cpu').manual_seed(seed)
    S = M + T
    mk = lambda *s: torch.randn(*s, generator=g).to(dev, dtype)
    Wr = torch.randn(8 * H, N, H, generator=g).to(dev) * 0.05
    return (mk(BN, T, H), mk(BN, T, H), mk(BN, S, H), mk(BN, S, H),
            distance_table(Wr, T, S, M, clamp, dtype))


# output tolerance of the 16-bit dtypes: the output's rounding (bf16 2^-8,
# f16 2^-11 relative), and p rounded before PV
TOL16 = {torch.bfloat16: 2e-2, torch.float16: 5e-3}
DTYPES = [torch.float32, torch.bfloat16, torch.float16]


# H, T, M, mem_valid, window, clamp; the fourth: a ragged T with memory, a
# window and mem_valid < M (every edge of the tensor-core kernels' skew
# windows); then H 128 (f32: the slab kernels' two slabs of 64; bf16 / f16:
# the tensor-core kernels' two-warp groups), one over six ragged q and key
# tiles with a window and no memory; the last two: head dims above 128 (the
# slab kernels in every dtype, four and six slabs)
CASES = [(64, 128, 0, 0, 0, 1024), (32, 96, 64, 17, 40, 33), (16, 77, 30, 30, 0, 17),
         (64, 200, 100, 37, 150, 64), (128, 96, 64, 17, 40, 33), (128, 200, 100, 37, 150, 64),
         (128, 333, 0, 0, 150, 1024), (256, 96, 64, 17, 40, 33), (384, 130, 0, 0, 60, 64)]


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('H,T,M,mv,window,clamp', CASES)
def test_k1_matches_plain(dev, dtype, H, T, M, mv, window, clamp):
    rw, rr, k, v, g = _inputs(dev, dtype, 6, 3, T, M, H, clamp)
    mvt = torch.tensor(mv, dtype=torch.int32, device=dev)
    ctx, lse = flash_rel_attn_fwd(rw, rr, k, v, g, mvt, M=M, scale=H ** -0.5, window=window)
    ref, ref_lse = flash_rel_attn_fwd_plain(rw, rr, k, v, g, mv, M=M, scale=H ** -0.5,
                                            window=window)
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == torch.float32 else TOL16[dtype]
    torch.testing.assert_close(ctx.float(), ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)




def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('H,T,M,mv,window,clamp', CASES)
def test_k2_matches_plain(dev, dtype, H, T, M, mv, window, clamp):
    """Every K2 output against the plain backward on the same inputs, error
    relative to the output's largest entry: f32 sums in other orders (dG by
    atomics, in an order that changes from run to run) -> 1e-5; bf16 / f16
    also round p and ds, and a rounding that flips moves one ulp -> 2e-2 /
    5e-3."""
    rw, rr, k, v, g = _inputs(dev, dtype, 6, 3, T, M, H, clamp)
    mvt = torch.tensor(mv, dtype=torch.int32, device=dev)
    scale = H ** -0.5
    out, lse = flash_rel_attn_fwd(rw, rr, k, v, g, mvt, M=M, scale=scale, window=window)
    d_out = torch.randn(out.shape, generator=torch.Generator().manual_seed(1)).to(dev, dtype)
    before = LAUNCHES['flash_rel_attn_bwd']
    got = flash_rel_attn_bwd(rw, rr, k, v, g, out, d_out, lse, mvt, M=M, scale=scale,
                             window=window)
    want = flash_rel_attn_bwd_plain(rw, rr, k, v, g, out, d_out, lse, mv, M=M, scale=scale,
                                    window=window)
    torch.cuda.synchronize()
    assert LAUNCHES['flash_rel_attn_bwd'] == before + 1
    tol = 1e-5 if dtype == torch.float32 else TOL16[dtype]
    for name, a, b in zip(('drw', 'drr', 'dk', 'dv', 'dG'), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _rel_err(a, b) <= tol, (name, _rel_err(a, b))


def test_flash_rel_attn_gradients_match_autograd_of_plain(dev):
    """FlashRelAttn (K1 forward, K2 backward) against autograd through the
    plain forward, f32, every input's gradient; a strided upstream gradient
    as the model hands it."""
    H, T, M, mv, window, clamp = 32, 96, 64, 17, 40, 33
    ins = [t.requires_grad_(True) for t in _inputs(dev, torch.float32, 6, 3, T, M, H, clamp)]
    d_out = torch.randn(2, T, 3, H, device=dev).transpose(1, 2).reshape(6, T, H)
    mvt = torch.tensor(mv, dtype=torch.int32, device=dev)
    got = torch.autograd.grad(FlashRelAttn.apply(*ins, mvt, M, H ** -0.5, window), ins, d_out)
    ref, _ = flash_rel_attn_fwd_plain(*ins, mv, M=M, scale=H ** -0.5, window=window)
    want = torch.autograd.grad(ref, ins, d_out)
    for name, a, b in zip(('rw', 'rr', 'k', 'v', 'g_tab'), got, want):
        assert _rel_err(a, b) <= 1e-5, (name, _rel_err(a, b))


def test_forward_launches_k1_once_per_layer(dev):
    cfg = TransfoXLConfig.from_size('debug', vocab_size=422, dtype='float32')
    model = TransfoXL(cfg)
    params = model.init(seed=0)
    ids = torch.randint(0, 422, (2, 64), device=dev)
    LAUNCHES['flash_rel_attn_fwd'] = 0
    with torch.no_grad():
        model.forward(params, ids)
    assert LAUNCHES['flash_rel_attn_fwd'] == cfg.n_layer


def test_loss_backward_launches_k2_once_per_layer(dev):
    cfg = TransfoXLConfig.from_size('debug', vocab_size=422, dtype='float32')
    model = TransfoXL(cfg)
    params = model.init(seed=0)
    leaves = [params['layers'][0]['attn']['r'].requires_grad_(True)]
    ids = torch.randint(0, 422, (2, 64), device=dev)
    LAUNCHES['flash_rel_attn_bwd'] = 0
    loss, _ = model.loss(params, ids, ids)
    (grad,) = torch.autograd.grad(loss, leaves)
    assert LAUNCHES['flash_rel_attn_bwd'] == cfg.n_layer
    assert bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0


def _chunked_inputs(dev, dtype, G, T, D, perm, pads, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(G, T, D, generator=g).to(dev, dtype) for _ in range(3))
    if perm:
        qpos = torch.stack([torch.randperm(T, generator=g) for _ in range(G)])
    else:
        qpos = torch.arange(T).expand(G, T)
    kpos = torch.where(qpos >= T - pads, torch.full_like(qpos, T), qpos) if pads else qpos
    return q, k, v, qpos.to(dev, torch.int32).contiguous(), kpos.to(dev, torch.int32).contiguous()


CHUNKED = [   # G, T, D, chunk, perm, pads, scale, self_bias
    (4, 256, 64, 64, False, 0, 0.125, 0.0), (4, 256, 64, 64, True, 0, 1.0, -1e5),
    (3, 192, 32, 32, False, 40, 0.25, 0.0), (2, 32, 16, 32, True, 5, 1.0, -1e5),
    (3, 160, 16, 32, True, 9, 1.0, -1e5),
    # several runs of consecutive chunks per row (the bf16 kernel's blocks),
    # the last a run of one chunk
    (2, 1088, 64, 64, False, 0, 0.125, 0.0), (2, 2176, 16, 32, True, 11, 1.0, -1e5),
    # the tiled kernels: chunk 128 (a 64-row tile inside one chunk), D 128,
    # chunk 16 and 8 (a tile over several chunks), a ragged last tile
    (3, 512, 64, 128, True, 7, 1.0, -1e5), (2, 384, 128, 128, False, 0, 0.088, 0.0),
    (2, 256, 128, 64, True, 3, 1.0, -1e5), (3, 160, 32, 16, True, 9, 1.0, -1e5),
    (2, 200, 16, 8, False, 4, 0.25, 0.0),
    # more ragged tiles over chunk 16, ten tiles at chunk 128 / D 128, and
    # chunk 48, whose chunks cross the 64-row tiles' edges
    (2, 480, 32, 16, True, 9, 1.0, -1e5), (1, 640, 128, 128, True, 40, 1.0, -1e5),
    (2, 288, 64, 48, False, 17, 0.125, 0.0),
    # head dims above 128: the slab walks (four slabs of 64), LSH and local
    (2, 256, 256, 64, True, 9, 1.0, -1e5), (1, 288, 256, 48, False, 17, 0.0625, 0.0),
]


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('G,T,D,chunk,perm,pads,scale,self_bias', CHUNKED)
def test_k3_k4_match_plain(dev, dtype, G, T, D, chunk, perm, pads, scale, self_bias):
    """K3 (ctx, lse) and K4 (dq, dk, dv with a nonzero lse cotangent) against
    their plain versions: f32 sums in other orders -> 1e-5; bf16 / f16 round
    p and ds, and a rounding that flips moves one ulp -> 2e-2 / 5e-3 of each
    output's max."""
    q, k, v, qpos, kpos = _chunked_inputs(dev, dtype, G, T, D, perm, pads)
    kw = dict(chunk=chunk, scale=scale, self_bias=self_bias)
    before = dict(ck.LAUNCHES)
    out, lse = ck.chunked_window_attn_fwd(q, k, v, qpos, kpos, **kw)
    ref, ref_lse = ck.chunked_window_attn_fwd_plain(q, k, v, qpos, kpos, **kw)
    d_out = torch.randn(out.shape, generator=torch.Generator().manual_seed(1)).to(dev, dtype)
    d_lse = torch.randn(lse.shape, generator=torch.Generator().manual_seed(2)).to(dev)
    args = (q, k, v, qpos, kpos, out, d_out, lse, d_lse)
    got = ck.chunked_window_attn_bwd(*args, **kw)
    want = ck.chunked_window_attn_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    assert ck.LAUNCHES == {n: before[n] + 1 for n in before}
    tol = 1e-5 if dtype == torch.float32 else TOL16[dtype]
    assert _rel_err(out, ref) <= tol and float((lse - ref_lse).abs().max()) <= 1e-3
    for name, a, b in zip(('dq', 'dk', 'dv'), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _rel_err(a, b) <= tol, (name, _rel_err(a, b))


@pytest.mark.parametrize('G,T,D,chunk,pads', [(1, 640, 128, 128, 40), (2, 256, 256, 64, 9)])
def test_f32_k4_is_closer_to_f64_than_plain(dev, G, T, D, chunk, pads):
    """The f32 cases of test_k3_k4_match_plain with unnormalised LSH keys
    (scale 1: scores up to ~50, where an f32 add rounds at ~4e-6): K4's dq,
    dk, dv lie no farther from the f64 backward on the same inputs (out and
    lse K3's; a row's own key keeps its f32 score, which lse holds) than the
    plain f32 backward does.  Prints both errors."""
    q, k, v, qpos, kpos = _chunked_inputs(dev, torch.float32, G, T, D, True, pads)
    kw = dict(chunk=chunk, scale=1.0, self_bias=-1e5)
    out, lse = ck.chunked_window_attn_fwd(q, k, v, qpos, kpos, **kw)
    d_out = torch.randn(out.shape, generator=torch.Generator().manual_seed(1)).to(dev)
    d_lse = torch.randn(lse.shape, generator=torch.Generator().manual_seed(2)).to(dev)
    args = (q, k, v, qpos, kpos, out, d_out, lse, d_lse)
    got = ck.chunked_window_attn_bwd(*args, **kw)
    plain = ck.chunked_window_attn_bwd_plain(*args, **kw)
    own = ((q.double() * k.double()).sum(-1).float() - 1e5).double()
    f64 = [x.double() for x in (q, k, v)]
    want = k4_reference(*f64, qpos.long(), kpos.long(), out.double(), d_out.double(),
                        lse.double(), d_lse.double(), chunk, 1.0, -1e5, torch.matmul, own)
    torch.cuda.synchronize()
    err = lambda a, b: float((a.double() - b).abs().max() / b.abs().max())
    for name, a, b, c in zip(('dq', 'dk', 'dv'), got, plain, want):
        print(f'[f64] G {G} T {T} D {D} chunk {chunk} {name}: kernel {err(a, c):.3e} '
              f'plain {err(b, c):.3e} kernel-vs-plain {_rel_err(a, b):.3e}')
        assert err(a, c) <= err(b, c), (name, err(a, c), err(b, c))


def _k3_f64(q, k, v, qpos, kpos, chunk, scale, self_bias, own):
    """K3's forward in f64 (chunked_window_attn_fwd_plain's function) ->
    (ctx, lse); `own` [G, T]: each row's own-key score (kpos == qpos)."""
    G, T, D = q.shape
    s = k4_scores(q, k, qpos, kpos, chunk, scale, self_bias, torch.matmul, own)
    lse = torch.logsumexp(s, -1)
    ctx = torch.exp(s - lse[..., None]) @ ck._windows(v, chunk)
    return ctx.reshape(G, T, D), lse.reshape(G, T)


@pytest.mark.parametrize('G,T,D,chunk,pads', [(1, 640, 128, 128, 40), (2, 256, 256, 64, 9)])
def test_f32_k3_is_closer_to_f64_than_plain(dev, G, T, D, chunk, pads):
    """The f32 K3 cases of test_k3_k4_match_plain with unnormalised LSH keys
    (scale 1: scores up to ~50, where an f32 add rounds at ~4e-6): K3's ctx
    (over its largest entry) and lse lie no farther from the f64 forward on
    the same inputs than the plain f32 forward does.  A row's own key keeps
    its f32 score in the f64 forward, and lse is compared on the rows that
    see another key: a row that sees only its own key holds lse = fl(s +
    self_bias) on a grid of 2^-7 (pinned bit for bit by the CPU schedule
    tests).  Prints both errors."""
    q, k, v, qpos, kpos = _chunked_inputs(dev, torch.float32, G, T, D, True, pads)
    kw = dict(chunk=chunk, scale=1.0, self_bias=-1e5)
    got, got_lse = ck.chunked_window_attn_fwd(q, k, v, qpos, kpos, **kw)
    plain, plain_lse = ck.chunked_window_attn_fwd_plain(q, k, v, qpos, kpos, **kw)
    own = ((q.double() * k.double()).sum(-1).float() - 1e5).double()
    want, want_lse = _k3_f64(q.double(), k.double(), v.double(), qpos.long(), kpos.long(),
                             chunk, 1.0, -1e5, own)
    torch.cuda.synchronize()
    rows = want_lse > -5e4
    err = lambda a, b: float((a.double() - b).abs().max() / b.abs().max())
    lerr = lambda a: float((a.double() - want_lse)[rows].abs().max())
    print(f'[f64] G {G} T {T} D {D} chunk {chunk}: ctx kernel {err(got, want):.3e} plain '
          f'{err(plain, want):.3e}; lse kernel {lerr(got_lse):.3e} plain {lerr(plain_lse):.3e} '
          f'({int(rows.sum())} rows)')
    assert err(got, want) <= err(plain, want)
    assert lerr(got_lse) <= lerr(plain_lse)


@pytest.mark.parametrize('name,kernels', [
    ('flash_rel_attn_bwd', ('k2_dkdv_tc', 'k2_dq_tc', 'k2_dkdv_slab', 'k2_dq_slab')),
    ('chunked_window_attn_bwd', ('k4_tc', 'k4_dq_tc', 'k4_dkdv_tc', 'k4_dq_slab',
                                 'k4_dkdv_slab')),
    ('flash_rel_attn_fwd', ('k1_tc', 'k1_slab')),
    ('chunked_window_attn_fwd', ('k3_tc', 'k3_union_tc', 'k3_slab')),
])
def test_bf16_backward_kernels_run_on_tensor_cores(dev, name, kernels):
    """The tensor-core kernels of K1-K4 (every bf16 and f16 call up to head
    dim 128: K1 / K2's k1_tc and k2_*_tc, K3's k3_tc and its tiled walk
    k3_union_tc, K4's k4_tc and its tiled split k4_dq_tc / k4_dkdv_tc; and
    the slab kernels, which run every f32 call of K1-K4 and every call above
    head dim 128) hold tensor-core instructions (HMMA for mma.sync, HGMMA for
    wgmma) in `cuobjdump -sass` of the built library, in every
    instantiation, and are built for both bf16 and f16 (K1's and K2's at
    head dim 128), the slab kernels also for f32 (3xTF32).  No FMA kernel is
    left in any of the four libraries: the only other function is the
    backward's row-dot pass (delta), which takes every dtype and holds no
    tensor-core instruction."""
    counts = vr.tensor_core_counts(name)
    for kern in kernels:
        fns = [c for f, c in counts.items() if kern in f]
        assert fns and all(c > 0 for c in fns), (kern, counts)
        parts = ('__nv_bfloat16', '6__half') + (('If',) if kern.endswith('_slab') else ())
        for part in parts:
            assert any(kern in f and part in f for f in counts), (kern, part, counts)
    if name.startswith('flash_rel_attn'):
        assert all(any(k in f and 'Li128E' in f for f in counts)
                   for k in kernels if k.endswith('_tc')), counts
    fma = {f: c for f, c in counts.items() if '_tc' not in f and '_slab' not in f}
    assert not any(fma.values()), counts
    assert all('row_dot' in f for f in fma), fma
    assert any('row_dot' in f for f in fma) == name.endswith('_bwd'), fma


def _slab_hmma(name, kernels, dtype, D):
    """HMMA + HGMMA of the slab kernels `kernels` of library `name` in the
    instance a call at head dim D in this dtype runs: <dtype, W, ZS> as the
    C entry's `with_cfg` picks them (read from the source), found by the
    mangled template arguments in `cuobjdump -sass`."""
    part = {torch.float32: 'If', torch.bfloat16: '__nv_bfloat16', torch.float16: '6__half'}[dtype]
    W, *zs = with_cfg(name, D, dtype == torch.float32)
    zs = dict(zip(kernels, zs if len(zs) == len(kernels) else zs * len(kernels)))
    counts = vr.tensor_core_counts(name)
    return {k: sum(c for f, c in counts.items() if k in f and f'{part}Li{W}ELi{zs[k]}EE' in f)
            for k in kernels}


@pytest.mark.parametrize('chunk', [16, 64, 128])
@pytest.mark.parametrize('D', [32, 64, 128, 256])
def test_f32_k4_runs_on_the_slab_kernels(dev, chunk, D):
    """Every f32 K4 call runs k4_dq_slab / k4_dkdv_slab (3xTF32 on the
    tensor cores: their f32 instance of `with_cfg` at D holds HMMA):
    dq, dk, dv against the plain backward within 1e-5 of each output's max,
    LSH-permuted positions with pad keys and the self bias, T ragged against
    the 64-row tiles."""
    assert all(_slab_hmma('chunked_window_attn_bwd', ('k4_dq_slab', 'k4_dkdv_slab'),
                          torch.float32, D).values())
    G, T = 2, 5 * chunk if chunk < 64 else 3 * chunk
    q, k, v, qpos, kpos = _chunked_inputs(dev, torch.float32, G, T, D, True, 9, seed=D + chunk)
    k = q * torch.rsqrt((q * q).mean(-1, keepdim=True) + 1e-6) / D ** 0.5
    kw = dict(chunk=chunk, scale=1.0, self_bias=-1e5)
    out, lse = ck.chunked_window_attn_fwd(q, k, v, qpos, kpos, **kw)
    d_out = torch.randn(out.shape, generator=torch.Generator().manual_seed(1)).to(dev)
    d_lse = torch.randn(lse.shape, generator=torch.Generator().manual_seed(2)).to(dev)
    args = (q, k, v, qpos, kpos, out, d_out, lse, d_lse)
    before = ck.LAUNCHES['chunked_window_attn_bwd']
    got = ck.chunked_window_attn_bwd(*args, **kw)
    want = ck.chunked_window_attn_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    assert ck.LAUNCHES['chunked_window_attn_bwd'] == before + 1
    for name, a, b in zip(('dq', 'dk', 'dv'), got, want):
        assert _rel_err(a, b) <= 1e-5, (name, _rel_err(a, b))


@pytest.mark.parametrize('chunk', [16, 64, 128])
@pytest.mark.parametrize('D', [32, 64, 128, 256])
def test_f32_k3_runs_on_the_slab_kernels(dev, chunk, D):
    """Every f32 K3 call runs k3_slab (3xTF32 on the tensor cores: its f32
    instance of `with_cfg` at D holds HMMA): ctx within 1e-5 of its largest
    entry and lse within 1e-5 of each value (1e-3 at least) against the
    plain forward, LSH-permuted positions with pad keys and the self bias,
    T ragged against the 64-row tiles."""
    assert all(_slab_hmma('chunked_window_attn_fwd', ('k3_slab',), torch.float32, D).values())
    G, T = 2, 5 * chunk if chunk < 64 else 3 * chunk
    q, k, v, qpos, kpos = _chunked_inputs(dev, torch.float32, G, T, D, True, 9, seed=D + chunk)
    k = q * torch.rsqrt((q * q).mean(-1, keepdim=True) + 1e-6) / D ** 0.5
    kw = dict(chunk=chunk, scale=1.0, self_bias=-1e5)
    before = ck.LAUNCHES['chunked_window_attn_fwd']
    out, lse = ck.chunked_window_attn_fwd(q, k, v, qpos, kpos, **kw)
    ref, ref_lse = ck.chunked_window_attn_fwd_plain(q, k, v, qpos, kpos, **kw)
    torch.cuda.synchronize()
    assert ck.LAUNCHES['chunked_window_attn_fwd'] == before + 1
    assert _rel_err(out, ref) <= 1e-5, _rel_err(out, ref)
    assert bool(((lse - ref_lse).abs() <= (1e-5 * ref_lse.abs()).clamp(min=1e-3)).all())


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_forward_slab_kernels_split_the_output_slabs(dev, dtype):
    """At head dim 640 (ten slabs of 64) k1_slab and k3_slab hold at most
    eight output slabs a block (`with_cfg`), so grid z splits them over two
    blocks, each scoring the tile pairs again: ctx and lse against the plain
    forwards (ctx 2e-5 / 2e-2, lse 1e-4 / 1e-3 in f32 / bf16)."""
    H = 640
    assert with_cfg('flash_rel_attn_fwd', H, dtype == torch.float32)[1] < H // 64
    assert with_cfg('chunked_window_attn_fwd', H, dtype == torch.float32)[1] < H // 64
    tol = 2e-5 if dtype == torch.float32 else TOL16[dtype]
    ltol = 1e-4 if dtype == torch.float32 else 1e-3
    rw, rr, k, v, g = _inputs(dev, dtype, 4, 2, 130, 64, H, 33)
    mvt = torch.tensor(17, dtype=torch.int32, device=dev)
    ctx, lse = flash_rel_attn_fwd(rw, rr, k, v, g, mvt, M=64, scale=H ** -0.5, window=40)
    ref, ref_lse = flash_rel_attn_fwd_plain(rw, rr, k, v, g, 17, M=64, scale=H ** -0.5,
                                            window=40)
    torch.cuda.synchronize()
    torch.testing.assert_close(ctx.float(), ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=ltol)
    q, k, v, qpos, kpos = _chunked_inputs(dev, dtype, 2, 320, H, True, 9)
    kw = dict(chunk=64, scale=H ** -0.5, self_bias=-1e5)
    out, lse = ck.chunked_window_attn_fwd(q, k, v, qpos, kpos, **kw)
    ref, ref_lse = ck.chunked_window_attn_fwd_plain(q, k, v, qpos, kpos, **kw)
    torch.cuda.synchronize()
    assert _rel_err(out, ref) <= (1e-5 if dtype == torch.float32 else tol)
    assert float((lse - ref_lse).abs().max()) <= 1e-3


@pytest.mark.parametrize('H,dtype', [(64, torch.float32), (128, torch.float32),
                                     (256, torch.float32), (384, torch.bfloat16)])
def test_k2_slab_kernels_match_plain(dev, H, dtype):
    """k2_dkdv_slab / k2_dq_slab (every f32 K2 call, in 3xTF32, and 16 bits
    above head dim 128) hold HMMA in the instance the call runs (`with_cfg`
    at H) and match the plain backward: 1e-5 of each
    output's max in f32, 2e-2 in bf16, on a ragged T with memory, mem_valid
    and a window."""
    assert all(_slab_hmma('flash_rel_attn_bwd', ('k2_dkdv_slab', 'k2_dq_slab'), dtype,
                          H).values())
    B, N, T, M, mv, window, clamp = 2, 2, 200, 100, 37, 150, 64
    rw, rr, k, v, g = _inputs(dev, dtype, B * N, N, T, M, H, clamp, seed=H)
    scale, mvt = H ** -0.5, torch.tensor(mv, dtype=torch.int32, device=dev)
    out, lse = flash_rel_attn_fwd(rw, rr, k, v, g, mvt, M=M, scale=scale, window=window)
    d_out = torch.randn(out.shape, generator=torch.Generator().manual_seed(3)).to(dev, dtype)
    got = flash_rel_attn_bwd(rw, rr, k, v, g, out, d_out, lse, mvt, M=M, scale=scale,
                             window=window)
    want = flash_rel_attn_bwd_plain(rw, rr, k, v, g, out, d_out, lse, mv, M=M, scale=scale,
                                    window=window)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else TOL16[dtype]
    for name, a, b in zip(('drw', 'drr', 'dk', 'dv', 'dG'), got, want):
        assert _rel_err(a, b) <= tol, (name, _rel_err(a, b))


def test_reformer_forward_and_backward_launch_once_per_layer(dev):
    """One K3 launch per attention layer in a forward, one K4 per layer in the
    backward, and the card's f32 loss equals the CPU's."""
    cfg = ReformerConfig.from_size('debug-large', vocab_size=422, dtype='float32', n_hashes=2)
    model = Reformer(cfg)
    params = model.init(seed=0)
    ids = torch.randint(0, 422, (2, 512), device=dev)
    leaf = params['embed']['weight'].requires_grad_(True)        # below every layer
    ck.LAUNCHES.update(chunked_window_attn_fwd=0, chunked_window_attn_bwd=0)
    loss, _ = model.loss(params, ids, ids)
    assert ck.LAUNCHES == dict(chunked_window_attn_fwd=6, chunked_window_attn_bwd=0)
    (grad,) = torch.autograd.grad(loss, [leaf])
    assert ck.LAUNCHES == dict(chunked_window_attn_fwd=6, chunked_window_attn_bwd=6)
    assert bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0
    cpu = Reformer(cfg, device='cpu')
    cpu_loss, _ = cpu.loss(cpu.init(seed=0), ids.cpu(), ids.cpu())
    assert abs(float(loss.detach()) - float(cpu_loss)) <= 1e-4 * abs(float(cpu_loss))


@pytest.mark.parametrize('K', [1, 4, 32])
def test_k5_k6_match_plain(dev, K):
    """K5 (the mask / softmax chain) within one bf16 ulp of its plain version
    (f32 sums in other orders, ex2.approx and an approximate reciprocal per
    row may flip a bf16 rounding), on mixed positions and on positions whose
    even m have every key masked (1/128 exactly); K6 (the FMA chain)
    bit-equal to it (the plain version's f64 product and sum are exact, so
    it rounds once per pass, as the FMA does).  One launch each per input."""
    g = torch.Generator(device=dev).manual_seed(K)
    s = torch.randn(3, 8, 64, rk.W, generator=g, device=dev)
    kp = (torch.arange(rk.W, dtype=torch.int32, device=dev) - 40).expand(3, 8, rk.W).contiguous()
    qp = torch.arange(64, dtype=torch.int32, device=dev).expand(3, 8, 64).contiguous()
    kp[:, :, ::5] = 10 ** 6                    # masked keys beside the valid and self ones
    kp_masked = kp.clone()
    kp_masked[:, ::2] = 10 ** 6                # all-masked rows
    before = dict(rk.LAUNCHES)
    got5, got6 = rk.mask_chain(s, kp, qp, K), rk.muladd_chain(s, K)
    got5m = rk.mask_chain(s, kp_masked, qp, K)
    want5, want6 = rk.mask_chain_plain(s, kp, qp, K), rk.muladd_chain_plain(s, K)
    want5m = rk.mask_chain_plain(s, kp_masked, qp, K)
    torch.cuda.synchronize()
    assert rk.LAUNCHES == dict(mask_chain=before['mask_chain'] + 2,
                               muladd_chain=before['muladd_chain'] + 1)
    for got, want in ((got5, want5), (got5m, want5m)):
        assert bool(((got - want).abs() <= 2.0 ** -7 * want.abs()).all())
    assert bool((got5m[:, ::2] == 1 / rk.W).all())
    assert got6.equal(want6)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_tiled_ce_matches_dense_on_card(dev, dtype):
    """The tiled CE on CUDA tensors (bf16 operands on the tensor cores with
    f32 results, the backward's products from the bf16-rounded logit
    gradient) against the dense CE of the same f32 products: loss, preds
    where the top two logits are apart, and the gradients."""
    from musicnlp_tpu_torch.ops.losses import chunked_shifted_ce_loss, shifted_ce_loss
    g = torch.Generator(device='cpu').manual_seed(0)
    B, T, d, V = 2, 65, 64, 3000
    h = torch.randn(B, T, d, generator=g).to(dev, dtype)
    w = (torch.randn(V, d, generator=g) * 0.3).to(dev, dtype)
    b = (torch.randn(V, generator=g) * 0.1).to(dev)
    lab = torch.randint(0, V, (B, T), generator=g).to(dev)
    lab[0, :5] = -100
    ins = [x.detach().requires_grad_(True) for x in (h, w, b)]
    loss, n, preds = chunked_shifted_ce_loss(*ins[:1], lab, *ins[1:], chunk=1024)
    grads = torch.autograd.grad(loss, ins)
    ref_ins = [x.detach().requires_grad_(True) for x in (h, w, b)]
    logits = ref_ins[0].float() @ ref_ins[1].float().T + ref_ins[2]
    ref, ref_n = shifted_ce_loss(logits, lab)
    ref_grads = torch.autograd.grad(ref, ref_ins)
    torch.cuda.synchronize()
    assert float(n) == float(ref_n)
    torch.testing.assert_close(loss, ref, rtol=1e-5 if dtype == torch.float32 else 1e-3, atol=0)
    top2 = logits.detach().topk(2, dim=-1).values
    apart = (top2[..., 0] - top2[..., 1]) > 1e-2 * top2[..., 0].abs().clamp(min=1)
    assert torch.equal(preds[:, :-1][apart[:, :-1]], logits.argmax(-1)[:, :-1][apart[:, :-1]])
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for a, e in zip(grads, ref_grads):
        assert float((a.float() - e.float()).abs().max() / e.float().abs().max()) < tol


def _c1_model(name):
    """(card model, CPU model): C.1's three configurations at a small size."""
    if name == 'tfxl-d128':
        cfg = TransfoXLConfig.from_size('debug', vocab_size=422, d_model=256, n_head=2,
                                        d_head=128, n_layer=2, dtype='float32')
        return TransfoXL(cfg), TransfoXL(cfg, device='cpu')
    if name == 'tfxl-fp16':
        cfg = TransfoXLConfig.from_size('debug', vocab_size=422, n_layer=2, dtype='float16')
        return TransfoXL(cfg), TransfoXL(dataclasses.replace(cfg, dtype='float32'), device='cpu')
    if name == 'tfxl-d192':
        cfg = TransfoXLConfig.from_size('debug', vocab_size=422, d_model=384, n_head=2,
                                        d_head=192, n_layer=2, dtype='float32')
        return TransfoXL(cfg), TransfoXL(cfg, device='cpu')
    if name == 'reformer-d256':
        cfg = ReformerConfig.from_size('debug-large', vocab_size=422, dtype='float32',
                                       attn_layers=('local', 'local'), d_head=256)
        return Reformer(cfg), Reformer(cfg, device='cpu')
    cfg = ReformerConfig.from_size('debug-large', vocab_size=422, dtype='float32',
                                   attn_layers=('local', 'local'), local_chunk=128)
    return Reformer(cfg), Reformer(cfg, device='cpu')


@pytest.mark.parametrize('name', ['tfxl-d128', 'tfxl-fp16', 'reformer-chunk128', 'tfxl-d192',
                                  'reformer-d256'])
def test_c1_shapes_launch_the_kernels_on_the_card(dev, name):
    """C.1 / C.2: a head dim 128, float16, a Reformer chunk of 128 and head
    dims above 128 (192, zero-padded to 256; 256) launch K1 / K2 or K3 / K4
    once per layer, forward and backward, and the logits equal the CPU's f32
    logits: 1e-4 of the max in f32, 2e-2 in f16 (FP16_REL of
    tests/test_torch_dispatch.py)."""
    model, cpu = _c1_model(name)
    params, cpu_params = model.init(seed=0), cpu.init(seed=0)
    T = 512 if name.startswith('reformer') else 64
    ids = torch.randint(0, 422, (2, T), generator=torch.Generator().manual_seed(0))
    leaf = params['embed']['weight'].requires_grad_(True)
    LAUNCHES.update(flash_rel_attn_fwd=0, flash_rel_attn_bwd=0)
    ck.LAUNCHES.update(chunked_window_attn_fwd=0, chunked_window_attn_bwd=0)
    loss, _ = model.loss(params, ids.to(dev), ids.to(dev))
    (grad,) = torch.autograd.grad(loss, [leaf])
    torch.cuda.synchronize()
    launched = (*LAUNCHES.values(), *ck.LAUNCHES.values())
    assert launched == ((0, 0, 2, 2) if name.startswith('reformer') else (2, 2, 0, 0))
    assert bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0
    with torch.no_grad():
        got = model.forward(params, ids.to(dev))
        want = cpu.forward(cpu_params, ids)
    got, want = (x[0] if isinstance(x, tuple) else x for x in (got, want))
    tol = 2e-2 if name == 'tfxl-fp16' else 1e-4
    assert _rel_err(got.cpu(), want) <= tol


def test_launch_checks_refuse_what_the_kernels_do_not_take(dev):
    """Called directly, the kernel wrappers raise for a head dim they do not
    take (192: the modules pad it to 256) and a dtype other than f32 / bf16 /
    f16."""
    rw, rr, k, v, g = _inputs(dev, torch.float32, 2, 1, 64, 0, 192, 64)
    with pytest.raises(ValueError, match='head dims'):
        flash_rel_attn_fwd(rw, rr, k, v, g, 0, M=0, scale=0.1)
    f64 = [t.double() for t in _inputs(dev, torch.float32, 2, 1, 64, 0, 64, 64)]
    with pytest.raises(TypeError, match='float16'):
        flash_rel_attn_fwd(*f64, 0, M=0, scale=0.1)
    q, k, v, qpos, kpos = _chunked_inputs(dev, torch.float32, 2, 256, 192, False, 0)
    with pytest.raises(ValueError, match='head dims'):
        ck.chunked_window_attn_fwd(q, k, v, qpos, kpos, chunk=128, scale=0.1)


def test_device_trace_names_k1_and_k2(dev, tmp_path):
    """A bf16 TF-XL step (d_head 64) inside `device_trace`, after a warm-up
    step, a synchronise and a pause: the Chrome trace names k1_tc,
    k2_dkdv_tc and k2_dq_tc once per layer in the step `step_kernels` reads.
    One step runs before the recording, so the first use of each product
    shape (cuBLAS's choice of kernel, 65-184 ms on an H100) leaves no gap in
    the traced warm-up step longer than the pause."""
    cfg = TransfoXLConfig.from_size('debug', vocab_size=422, d_model=128, n_head=2, d_head=64,
                                    n_layer=2)
    model = TransfoXL(cfg)
    params = model.init(seed=0)
    leaf = params['layers'][0]['attn']['qkv'].requires_grad_(True)
    ids = torch.randint(0, 422, (2, 64), device=dev)

    def step():
        loss, _ = model.loss(params, ids, ids)
        torch.autograd.grad(loss, [leaf])
    step()
    torch.cuda.synchronize()
    with device_trace(str(tmp_path)) as path:
        step()
        torch.cuda.synchronize()
        time.sleep(0.02)
        step()
    kernels = step_kernels(path)
    for name in ('k1_tc', 'k2_dkdv_tc', 'k2_dq_tc'):
        assert sum(n for k, n in kernels.items() if name in k) == cfg.n_layer, (name, kernels)


def test_pitch_embedding_on_the_card_matches_the_cpu(dev):
    """The same seed on the card and the CPU: emb_in within 1e-4 of its max
    (`index_add_` sums the row gradients in another order on the card)."""
    rng = np.random.default_rng(0)
    songs = [rng.integers(GridVocab.N_SPECIAL + 40, GridVocab.N_SPECIAL + 90, 400).tolist()
             for _ in range(6)]
    card = PitchEmbedding(vector_size=32, window=5, seed=3)
    cpu = PitchEmbedding(vector_size=32, window=5, seed=3, device='cpu')
    got, want = card(songs, epochs=2, batch_size=1024), cpu(songs, epochs=2, batch_size=1024)
    assert float(np.abs(got - want).max()) <= 1e-4 * float(np.abs(want).max())
    np.testing.assert_allclose(card.losses, cpu.losses, rtol=1e-5)


# (rows, d_in, d_out): the FFN's w1 and w2 at scoring's 65,536 tokens, w1 at
# TF-XL training's 21,504
BIAS_ACT_SHAPES = [(65536, 768, 3072), (65536, 3072, 768), (21504, 768, 3072)]


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('n,d_in,d_out', BIAS_ACT_SHAPES)
def test_bias_act_matches_plain_at_the_ffn_shapes(dev, n, d_in, d_out, dtype):
    """The kernel against its plain version on the f32 product, with a
    nonzero bias, with and without the relu: the same f32 add and one
    rounding, bit for bit, one launch each.  Then `dense`'s backward
    against the f32 arithmetic it stands for on the same relu branches:
    dx and dw in the activations' dtype (one bf16 rounding of a sum), db
    summed in f32."""
    g = torch.Generator().manual_seed(n + d_out)
    x = torch.randn(n, d_in, generator=g).to(dev, dtype)
    w = (torch.randn(d_in, d_out, generator=g) * 0.02).to(dev)
    b = (torch.randn(d_out, generator=g) * 0.02).to(dev)
    y = tl.f32_product(x, w.to(dtype))
    for act in (None, 'relu'):
        launches = tl.LAUNCHES['bias_act']
        got = tl.bias_act(y, b, act, dtype)
        assert tl.LAUNCHES['bias_act'] == launches + 1
        assert torch.equal(got, tl.bias_act_plain(y, b, act, dtype)), act
    leaves = [t.requires_grad_(True) for t in (x, w, b)]
    out = tl.dense(dict(w=w, b=b), x, act='relu')
    assert torch.equal(out, tl.bias_act_plain(y, b.detach(), 'relu', dtype))
    cot = torch.randn(n, d_out, generator=g).to(dev, dtype)
    dx, dw, db = torch.autograd.grad(out, leaves, cot)
    assert (dx.dtype, dw.dtype, db.dtype) == (dtype, torch.float32, torch.float32)
    gm = torch.where(out > 0, cot, torch.zeros_like(cot)).float()
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for name, a, e in (('dx', dx, gm @ w.detach().to(dtype).float().T),
                       ('dw', dw, x.detach().float().T @ gm), ('db', db, gm.sum(0))):
        assert _rel_err(a.float(), e) <= tol, (name, _rel_err(a.float(), e))


def test_bias_act_takes_ragged_widths_views_and_every_dtype(dev):
    """Widths that are not a multiple of 8 and a bias at an address off 16
    bytes take the kernel's scalar loop; a strided product is made
    contiguous; f16 output, no bias, zero rows; every case bit-equal to the
    plain version."""
    g = torch.Generator().manual_seed(3)
    big = torch.randn(300, 104, generator=g).to(dev)
    bias = torch.randn(105, generator=g).to(dev) * 0.02
    cases = [(big[:, :100], bias[:100]), (big[:, :100].contiguous(), bias[1:101]),
             (big[:, 1:], bias[:103]), (big, bias[1:]), (big, None), (big[:0], bias[:104])]
    for y, b in cases:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            for act in (None, 'relu'):
                got = tl.bias_act(y, b, act, dtype)
                assert got.shape == y.shape and got.dtype == dtype
                assert torch.equal(got, tl.bias_act_plain(y, b, act, dtype)), \
                    (tuple(y.shape), b is None, dtype, act)


@pytest.mark.parametrize('family', ['transf-xl', 'reformer'])
def test_bias_act_launches_twice_per_ffn(dev, family):
    """A 12-layer forward in bf16 launches `bias_act` 24 times: w1 with the
    relu and w2, once each in every FFN."""
    if family == 'transf-xl':
        model = TransfoXL(TransfoXLConfig.from_size('debug', vocab_size=422, n_layer=12))
        T = 64
    else:
        cfg = ReformerConfig.from_size('debug-large', vocab_size=422,
                                       attn_layers=('local', 'lsh') * 6)
        model = Reformer(cfg)
        T = 512
    params = model.init(seed=0)
    ids = torch.randint(0, 422, (2, T), device=dev)
    tl.LAUNCHES['bias_act'] = 0
    with torch.no_grad():
        model.forward(params, ids)
    assert tl.LAUNCHES['bias_act'] == 24
