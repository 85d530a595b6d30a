"""K2's module, port vs JAX: the plain backward against autograd, and the
gradients of the port's `fused_rel_attn` (K1 forward + K2 backward through
`FlashRelAttn`; on the CPU their plain versions) against `jax.grad` of the
Pallas `fused_rel_attn` in interpret mode, including the dG -> dW_r route."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicnlp_tpu.ops import attention as ja
from musicnlp_tpu.ops.pallas.flash_attention import fused_rel_attn as j_fused
from musicnlp_tpu_torch.ops import flash_attention as fa
from tests.torch_parity import np_of, randn, to_torch

# f32 on both sides; the two backward formulas sum in other orders
PLAIN_TOL = dict(rtol=1e-5, atol=1e-5)
# the tolerance tests/test_flash_attention.py holds the Pallas backward to
GRAD_TOL = dict(rtol=5e-3, atol=5e-3)
J_FUSED = functools.partial(j_fused, bq=64, bk=64, interpret=True)


def _attn_params(d_model=128, n_head=4, seed=0):
    p = ja.rel_attn_init(jax.random.PRNGKey(seed), d_model, n_head, d_model // n_head)
    p['r_w_bias'] = jnp.asarray(randn(seed + 1, n_head, d_model // n_head, scale=0.1))
    p['r_r_bias'] = jnp.asarray(randn(seed + 2, n_head, d_model // n_head, scale=0.1))
    p['ln']['scale'] = jnp.asarray(1.0 + randn(seed + 3, d_model, scale=0.1))
    p['ln']['bias'] = jnp.asarray(randn(seed + 4, d_model, scale=0.1))
    return p


def _leaves(tp):
    return {'qkv': tp['qkv'], 'r': tp['r'], 'o': tp['o'], 'r_w_bias': tp['r_w_bias'],
            'r_r_bias': tp['r_r_bias'], 'ln/scale': tp['ln']['scale'],
            'ln/bias': tp['ln']['bias']}


def _grads_both(jp, x, mems, valid, seed, **kw):
    """d/d(x, params) of sum(out * w) for a fixed numpy w, through both packages."""
    w = None

    def j_loss(p, x_):
        out = J_FUSED(p, x_, None if mems is None else jnp.asarray(mems),
                      jnp.asarray(valid), **kw)
        return jnp.sum(out * w)
    tp = to_torch(jp)
    leaves = _leaves(tp)
    for t in leaves.values():
        t.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = fa.fused_rel_attn(tp, tx, None if mems is None else torch.from_numpy(mems),
                            torch.tensor(valid, dtype=torch.int32), **kw)
    w = randn(seed, *out.shape)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), [tx, *leaves.values()])
    jg_p, jg_x = jax.grad(j_loss, argnums=(0, 1))(jp, jnp.asarray(x))
    want = [jg_x] + [jg_p[k] if '/' not in k else jg_p['ln'][k.split('/')[1]]
                     for k in leaves]
    return dict(zip(['x', *leaves], got)), dict(zip(['x', *leaves], want))


def _assert_grads(got, want, keys=None):
    for k in keys or got:
        np.testing.assert_allclose(np_of(got[k]), np_of(want[k]), **GRAD_TOL, err_msg=k)


@pytest.mark.parametrize('T,M,mv,window,clamp', [
    (40, 0, 0, 0, 17), (40, 24, 10, 20, 96), (70, 64, 64, 0, 33), (33, 30, 0, 16, 1024),
])
def test_bwd_plain_matches_autograd_of_fwd_plain(T, M, mv, window, clamp):
    """K2's plain version == autograd through K1's plain version, every output."""
    rng = np.random.default_rng(T + M)
    BN, N, H = 6, 3, 16
    S = M + T
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
    rw, rr, k, v = (mk(BN, T, H).requires_grad_(True), mk(BN, T, H).requires_grad_(True),
                    mk(BN, S, H).requires_grad_(True), mk(BN, S, H).requires_grad_(True))
    g = fa.distance_table(mk(48, N, H) * 0.1, T, S, M, clamp, torch.float32)
    g.requires_grad_(True)
    out, lse = fa.flash_rel_attn_fwd_plain(rw, rr, k, v, g, mv, M=M, scale=0.25, window=window)
    d_out = mk(BN, T, H)
    want = torch.autograd.grad(out, (rw, rr, k, v, g), d_out)
    det = [t.detach() for t in (rw, rr, k, v, g)]
    got = fa.flash_rel_attn_bwd(*det, out.detach(), d_out, lse.detach(), mv, M=M, scale=0.25,
                                window=window)
    for name, a, b in zip(('drw', 'drr', 'dk', 'dv', 'dG'), got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **PLAIN_TOL, err_msg=name)


def test_bwd_wrapper_counts_only_launches():
    """On CPU tensors the wrapper takes the plain version and counts nothing."""
    rng = np.random.default_rng(3)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
    rw, rr, k, v = t(2, 8, 16), t(2, 8, 16), t(2, 8, 16), t(2, 8, 16)
    g = t(2, 16, 16)
    out, lse = fa.flash_rel_attn_fwd(rw, rr, k, v, g, 0, M=0, scale=0.25)
    before = dict(fa.LAUNCHES)
    drw, drr, dk, dv, dg = fa.flash_rel_attn_bwd(rw, rr, k, v, g, out, t(2, 8, 16), lse, 0,
                                                 M=0, scale=0.25)
    assert fa.LAUNCHES == before
    assert dk.dtype == dv.dtype == dg.dtype == torch.float32 and dg.shape == (2, 16, 16)
    with pytest.raises(ValueError, match='CUDA'):
        m = torch.empty(2, 8, 16, device='meta')
        fa.flash_rel_attn_bwd(m, m, m, m, torch.empty(2, 16, 16, device='meta'), m, m,
                              torch.empty(2, 8, device='meta'), 0, M=0, scale=0.25)


@pytest.mark.parametrize('clamp', [1024, 96, 17])
def test_module_grads_match_pallas_no_mem(clamp):
    jp = _attn_params(seed=11)
    got, want = _grads_both(jp, randn(21, 1, 128, 128), None, 0, 22, clamp_len=clamp)
    _assert_grads(got, want)


@pytest.mark.parametrize('valid', [0, 17, 64])
def test_module_grads_match_pallas_with_memory(valid):
    jp = _attn_params(seed=13)
    got, want = _grads_both(jp, randn(23, 1, 64, 128), randn(24, 1, 64, 128), valid, 25,
                            clamp_len=80)
    _assert_grads(got, want)


@pytest.mark.parametrize('window,with_mem', [(16, False), (40, True)])
def test_module_grads_match_pallas_window(window, with_mem):
    jp = _attn_params(seed=17)
    mems = randn(27, 1, 64, 128) if with_mem else None
    got, want = _grads_both(jp, randn(26, 1, 128, 128), mems, 64 if with_mem else 0, 28,
                            clamp_len=96, window=window)
    _assert_grads(got, want)


@pytest.mark.parametrize('clamp,with_mem', [(17, True), (40, False)])
def test_dw_r_through_distance_table_matches_u_form(clamp, with_mem):
    """W_r's gradient: the port sends K2's dG through autograd of the
    distance table (clamped rows share R(clamp)); the TPU kernel forms it
    from sin/cos U factors with a separate clamped-distance term.  Both must
    give the same dW_r, here with most distances past the clamp."""
    jp = _attn_params(seed=31)
    mems = randn(33, 2, 64, 128) if with_mem else None
    got, want = _grads_both(jp, randn(32, 2, 64, 128), mems, 40 if with_mem else 0, 34,
                            clamp_len=clamp)
    _assert_grads(got, want, keys=['r', 'r_r_bias'])
    assert float(np.abs(np_of(want['r'])).max()) > 1e-3    # the term is exercised
