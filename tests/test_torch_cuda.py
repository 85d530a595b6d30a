"""K1-K6 on the card against their plain versions (needs an NVIDIA GPU and
nvcc).

Run on a GPU machine with `python -m pytest -m cuda tests/test_torch_cuda.py`;
elsewhere these tests skip.  `chip_smoke.py` holds both kernels against the
plain versions at the model's real shapes."""
import pytest
import torch

from musicnlp_tpu_torch.models.reformer import Reformer, ReformerConfig
from musicnlp_tpu_torch.models.transformer_xl import TransfoXL, TransfoXLConfig
from musicnlp_tpu_torch.ops import chunked_attention_kernel as ck
from musicnlp_tpu_torch.ops import roofline_kernels as rk
from musicnlp_tpu_torch.ops.flash_attention import (
    LAUNCHES, FlashRelAttn, distance_table, flash_rel_attn_bwd, flash_rel_attn_bwd_plain,
    flash_rel_attn_fwd, flash_rel_attn_fwd_plain,
)
from musicnlp_tpu_torch.tools import vpu_roofline as vr

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


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('H,T,M,mv,window,clamp', [
    (64, 128, 0, 0, 0, 1024), (32, 96, 64, 17, 40, 33), (16, 77, 30, 30, 0, 17),
])
def test_k1_matches_plain(dev, dtype, H, T, M, mv, window, clamp):
    rw, rr, k, v, g = _inputs(dev, dtype, 6, 3, T, M, H, clamp)
    mvt = torch.tensor(mv, dtype=torch.int32, device=dev)
    ctx, lse = flash_rel_attn_fwd(rw, rr, k, v, g, mvt, M=M, scale=H ** -0.5, window=window)
    ref, ref_lse = flash_rel_attn_fwd_plain(rw, rr, k, v, g, mv, M=M, scale=H ** -0.5,
                                            window=window)
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == torch.float32 else 2e-2      # bf16 output rounding
    torch.testing.assert_close(ctx.float(), ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)


# H, T, M, mem_valid, window, clamp; the last: a ragged T with memory, a
# window and mem_valid < M (every edge of the bf16 kernels' skew windows)
CASES = [(64, 128, 0, 0, 0, 1024), (32, 96, 64, 17, 40, 33), (16, 77, 30, 30, 0, 17),
         (64, 200, 100, 37, 150, 64)]


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('H,T,M,mv,window,clamp', CASES)
def test_k2_matches_plain(dev, dtype, H, T, M, mv, window, clamp):
    """Every K2 output against the plain backward on the same inputs, error
    relative to the output's largest entry: f32 sums in other orders (dG by
    atomics, in an order that changes from run to run) -> 1e-5; bf16 also
    rounds p and ds, and a rounding that flips moves one ulp -> 2e-2."""
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
    tol = 1e-5 if dtype == torch.float32 else 2e-2
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
]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('G,T,D,chunk,perm,pads,scale,self_bias', CHUNKED)
def test_k3_k4_match_plain(dev, dtype, G, T, D, chunk, perm, pads, scale, self_bias):
    """K3 (ctx, lse) and K4 (dq, dk, dv with a nonzero lse cotangent) against
    their plain versions: f32 sums in other orders -> 1e-5; bf16 rounds p and
    ds, and a rounding that flips moves one ulp -> 2e-2 of each output's max."""
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
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert _rel_err(out, ref) <= tol and float((lse - ref_lse).abs().max()) <= 1e-3
    for name, a, b in zip(('dq', 'dk', 'dv'), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _rel_err(a, b) <= tol, (name, _rel_err(a, b))


@pytest.mark.parametrize('name,kernels', [
    ('flash_rel_attn_bwd', ('k2_dkdv_tc', 'k2_dq_tc')), ('chunked_window_attn_bwd', ('k4_tc',)),
])
def test_bf16_backward_kernels_run_on_tensor_cores(dev, name, kernels):
    """The bf16 kernels of K2 and K4 hold tensor-core instructions (HMMA for
    mma.sync, HGMMA for wgmma) in `cuobjdump -sass` of the built library; the
    f32 kernels keep their FMA code (TF32 would break the f32 parity)."""
    counts = vr.tensor_core_counts(name)
    for kern in kernels:
        fns = [c for f, c in counts.items() if kern in f]
        assert fns and all(c > 0 for c in fns), (kern, counts)
    fma = [c for f, c in counts.items() if '_tc' not in f]
    assert fma and not any(fma), counts


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
    (f32 sums in other orders may flip a bf16 rounding); K6 (the FMA chain)
    bit-equal to it (the plain version's f64 product and sum are exact, so
    it rounds once per pass, as the FMA does).  One launch each."""
    g = torch.Generator(device=dev).manual_seed(K)
    s = torch.randn(3, 8, 64, rk.W, generator=g, device=dev)
    kp = (torch.arange(rk.W, dtype=torch.int32, device=dev) - 40).expand(3, 8, rk.W).contiguous()
    qp = torch.arange(64, dtype=torch.int32, device=dev).expand(3, 8, 64).contiguous()
    kp[:, :, ::5] = 10 ** 6                    # masked keys beside the valid and self ones
    before = dict(rk.LAUNCHES)
    got5, got6 = rk.mask_chain(s, kp, qp, K), rk.muladd_chain(s, K)
    want5, want6 = rk.mask_chain_plain(s, kp, qp, K), rk.muladd_chain_plain(s, K)
    torch.cuda.synchronize()
    assert rk.LAUNCHES == {n: before[n] + 1 for n in before}
    assert bool(((got5 - want5).abs() <= 2.0 ** -7 * want5.abs()).all())
    assert got6.equal(want6)
