"""Port vs JAX: layers, rel_shift / rel_attn, the K1 module (plain version on
the CPU against the Pallas kernel in interpret mode), and the decode step."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicnlp_tpu.ops import attention as ja
from musicnlp_tpu.ops import layers as jl
from musicnlp_tpu.ops.pallas.flash_attention import fused_rel_attn as j_fused
from musicnlp_tpu_torch.ops import attention as ta
from musicnlp_tpu_torch.ops import layers as tl
from musicnlp_tpu_torch.ops.flash_attention import (
    LAUNCHES, distance_table, flash_rel_attn_fwd, fused_rel_attn as t_fused,
)
from tests.torch_parity import np_of, randn, to_torch

# f32 on both sides; the sums run in another order -> 1e-5 on unit-scale outputs
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# attention outputs are layer-normed sums over up to 192 keys
ATTN_TOL = dict(rtol=1e-4, atol=1e-4)
# the tolerance tests/test_flash_attention.py holds the Pallas kernel to
KERNEL_TOL = dict(rtol=2e-3, atol=2e-3)
J_FUSED = functools.partial(j_fused, bq=64, bk=64, interpret=True)


def _attn_params(d_model=128, n_head=4, seed=0):
    p = ja.rel_attn_init(jax.random.PRNGKey(seed), d_model, n_head, d_model // n_head)
    # non-zero biases so both relative terms are exercised
    p['r_w_bias'] = jnp.asarray(randn(seed + 1, n_head, d_model // n_head, scale=0.1))
    p['r_r_bias'] = jnp.asarray(randn(seed + 2, n_head, d_model // n_head, scale=0.1))
    p['ln']['scale'] = jnp.asarray(1.0 + randn(seed + 3, d_model, scale=0.1))
    p['ln']['bias'] = jnp.asarray(randn(seed + 4, d_model, scale=0.1))
    return p, to_torch(p)


def test_layer_norm_ffn_sinusoid():
    rng = jax.random.PRNGKey(0)
    pf = jl.ffn_init(rng, 64, 128)
    pf['ln']['scale'] = jnp.asarray(1.0 + randn(1, 64, scale=0.1))
    tf = to_torch(pf)
    x = randn(2, 3, 10, 64)
    np.testing.assert_allclose(np_of(tl.layer_norm(tf['ln'], torch.from_numpy(x))),
                               np_of(jl.layer_norm(pf['ln'], jnp.asarray(x))), **F32_TOL)
    np.testing.assert_allclose(np_of(tl.ffn(tf, torch.from_numpy(x))),
                               np_of(jl.ffn(pf, jnp.asarray(x))), **F32_TOL)
    pos = np.arange(37, -1, -1, dtype=np.float32)
    np.testing.assert_allclose(np_of(tl.sinusoid_pos_emb(torch.from_numpy(pos), 64)),
                               np_of(jl.sinusoid_pos_emb(jnp.asarray(pos), 64)), **F32_TOL)


def test_dropout_is_inverted_and_seeded():
    x = torch.ones(4, 1000)
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    a, b = tl.dropout(x, 0.25, g1, False), tl.dropout(x, 0.25, g2, False)
    assert torch.equal(a, b)
    assert set(torch.unique(a).tolist()) <= {0.0, (x / 0.75)[0, 0].item()}
    assert torch.equal(tl.dropout(x, 0.25, g1, True), x)


def test_rel_shift_matches_jax():
    x = randn(5, 2, 3, 7, 11)
    np.testing.assert_array_equal(np_of(ta.rel_shift(torch.from_numpy(x))),
                                  np_of(ja.rel_shift(jnp.asarray(x))))


@pytest.mark.parametrize('clamp', [1024, 96, 17])
def test_rel_attn_no_mem(clamp):
    jp, tp = _attn_params()
    x = randn(6, 2, 128, 128)
    want = ja.rel_attn(jp, jnp.asarray(x), None, 0, clamp_len=clamp)
    got = ta.rel_attn(tp, torch.from_numpy(x), None, 0, clamp_len=clamp)
    np.testing.assert_allclose(np_of(got), np_of(want), **ATTN_TOL)


@pytest.mark.parametrize('valid', [0, 17, 64])
@pytest.mark.parametrize('window', [None, 40])
def test_rel_attn_memory(valid, window):
    jp, tp = _attn_params(seed=7)
    x, mems = randn(8, 2, 64, 128), randn(9, 2, 64, 128)
    want = ja.rel_attn(jp, jnp.asarray(x), jnp.asarray(mems), valid, clamp_len=80,
                       window=window)
    got = ta.rel_attn(tp, torch.from_numpy(x), torch.from_numpy(mems),
                      torch.tensor(valid, dtype=torch.int32), clamp_len=80, window=window)
    np.testing.assert_allclose(np_of(got), np_of(want), **ATTN_TOL)


def test_rel_attn_key_padding_mask():
    jp, tp = _attn_params(seed=3)
    x = randn(10, 2, 32, 128)
    mask = np.ones((2, 32), bool)
    mask[1, 20:] = False
    want = ja.rel_attn(jp, jnp.asarray(x), None, 0, clamp_len=96, attn_mask=jnp.asarray(mask))
    got = ta.rel_attn(tp, torch.from_numpy(x), None, 0, clamp_len=96,
                      attn_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(np_of(got), np_of(want), **ATTN_TOL)


# ------------------------------------------------------------ K1's module
@pytest.mark.parametrize('clamp', [1024, 96, 17])
def test_k1_module_matches_pallas_no_mem(clamp):
    jp, tp = _attn_params()
    x = randn(11, 2, 128, 128)
    want = J_FUSED(jp, jnp.asarray(x), None, 0, clamp_len=clamp)
    got = t_fused(tp, torch.from_numpy(x), None, 0, clamp_len=clamp)
    np.testing.assert_allclose(np_of(got), np_of(want), **KERNEL_TOL)
    # and the fused path equals the port's own oracle to f32 rounding
    ref = ta.rel_attn(tp, torch.from_numpy(x), None, 0, clamp_len=clamp)
    np.testing.assert_allclose(np_of(got), np_of(ref), **ATTN_TOL)


@pytest.mark.parametrize('valid', [0, 17, 64])
def test_k1_module_matches_pallas_with_memory(valid):
    jp, tp = _attn_params(seed=7)
    x, mems = randn(12, 2, 64, 128), randn(13, 2, 64, 128)
    want = J_FUSED(jp, jnp.asarray(x), jnp.asarray(mems), jnp.asarray(valid), clamp_len=80)
    got = t_fused(tp, torch.from_numpy(x), torch.from_numpy(mems),
                  torch.tensor(valid, dtype=torch.int32), clamp_len=80)
    np.testing.assert_allclose(np_of(got), np_of(want), **KERNEL_TOL)


@pytest.mark.parametrize('window,with_mem', [(16, False), (40, True)])
def test_k1_module_matches_pallas_window(window, with_mem):
    jp, tp = _attn_params(seed=17)
    x = randn(14, 1, 128, 128)
    mems = randn(15, 1, 64, 128) if with_mem else None
    valid = 64 if with_mem else 0
    want = J_FUSED(jp, jnp.asarray(x), None if mems is None else jnp.asarray(mems),
                   jnp.asarray(valid), clamp_len=96, window=window)
    got = t_fused(tp, torch.from_numpy(x), None if mems is None else torch.from_numpy(mems),
                  valid, clamp_len=96, window=window)
    np.testing.assert_allclose(np_of(got), np_of(want), **KERNEL_TOL)


@pytest.mark.parametrize('T,M,valid,window,clamp', [(50, 0, 0, 0, 17), (37, 30, 11, 24, 20)])
def test_k1_module_ragged_small_head(T, M, valid, window, clamp):
    """H = 16 and lengths that are no multiple of a tile: the port's fused path
    (which K1 computes on the card) against the JAX oracle rel_attn."""
    jp, tp = _attn_params(d_model=64, n_head=4, seed=21)
    x = randn(16, 2, T, 64)
    mems = randn(17, 2, M, 64) if M else None
    kw = dict(clamp_len=clamp, window=window or None)
    want = ja.rel_attn(jp, jnp.asarray(x), None if mems is None else jnp.asarray(mems),
                       valid, **kw)
    got = t_fused(tp, torch.from_numpy(x), None if mems is None else torch.from_numpy(mems),
                  valid, **kw)
    np.testing.assert_allclose(np_of(got), np_of(want), **ATTN_TOL)


def test_k1_wrapper_cpu_plain_lse_and_counter():
    """On CPU tensors the wrapper computes the plain version (no launch) and
    its lse is the log-partition of the masked, scaled scores."""
    rng = np.random.default_rng(0)
    BN, N, T, M, H = 4, 2, 24, 8, 16
    S = M + T
    rw, rr = (torch.from_numpy(rng.standard_normal((BN, T, H), dtype=np.float32))
              for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((BN, S, H), dtype=np.float32))
            for _ in range(2))
    Wr = torch.from_numpy(rng.standard_normal((32, N, H), dtype=np.float32)) * 0.1
    g = distance_table(Wr, T, S, M, 20, torch.float32)
    before = LAUNCHES['flash_rel_attn_fwd']
    ctx, lse = flash_rel_attn_fwd(rw, rr, k, v, g, 5, M=M, scale=0.25, window=12)
    assert LAUNCHES['flash_rel_attn_fwd'] == before
    # brute force: score[q, k] = (rw.k + rr.g[T-1-q+k]) * scale, masked
    bd = torch.stack([torch.stack([rr[b, q] @ g[b % N, T - 1 - q:T - 1 - q + S].T
                                   for q in range(T)]) for b in range(BN)])
    s = (rw @ k.transpose(1, 2) + bd) * 0.25
    qi, ki = torch.arange(T)[:, None], torch.arange(S)[None, :]
    d = M + qi - ki
    ok = (d >= 0) & (d < 12) & (ki >= M - 5)
    s = torch.where(ok, s, torch.tensor(-1e30))
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(), **F32_TOL)
    np.testing.assert_allclose(ctx.numpy(), (torch.softmax(s, -1) @ v).numpy(), **F32_TOL)


# ------------------------------------------------------------- decode step
def _decode_inputs(seed, B=2, M=24, N=4, H=32):
    rng = np.random.default_rng(seed)
    ck = rng.standard_normal((B, M, N, H), dtype=np.float32)
    cv = rng.standard_normal((B, M, N, H), dtype=np.float32)
    step = 30                                    # the ring has wrapped once
    pos = np.array([step - 1 - ((step - 1 - s) % M) for s in range(M)], np.int32)
    pos[[3, 7]] = -1                             # two empty slots
    return ck, cv, pos, step


def test_quantize_kv_rows_matches_jax():
    x = randn(30, 2, 5, 4, 16)
    jq, js = ja.quantize_kv_rows(jnp.asarray(x))
    tq, ts = ta.quantize_kv_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7)


@pytest.mark.parametrize('window', [None, 20])
def test_decode_step_dense_cache(window):
    jp, tp = _attn_params(seed=31)
    ck, cv, pos, step = _decode_inputs(32)
    x = randn(33, 2, 1, 128)
    want = ja.rel_attn_decode_step(jp, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
                                   jnp.asarray(pos), jnp.asarray(step), clamp_len=20,
                                   window=window)
    got = ta.rel_attn_decode_step(tp, torch.from_numpy(x), torch.from_numpy(ck),
                                  torch.from_numpy(cv), torch.from_numpy(pos), step,
                                  clamp_len=20, window=window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np_of(g), np_of(w), **ATTN_TOL)


def test_decode_step_int8_cache():
    jp, tp = _attn_params(seed=41)
    ck, cv, pos, step = _decode_inputs(42)
    (kq, ks), (vq, vs) = ja.quantize_kv_rows(jnp.asarray(ck)), ja.quantize_kv_rows(jnp.asarray(cv))
    x = randn(43, 2, 1, 128)
    want = ja.rel_attn_decode_step(jp, jnp.asarray(x), kq, vq, jnp.asarray(pos),
                                   jnp.asarray(step), clamp_len=1024,
                                   cache_k_scale=ks, cache_v_scale=vs)
    t = lambda a: torch.from_numpy(np.array(a))
    got = ta.rel_attn_decode_step(tp, torch.from_numpy(x), t(kq), t(vq), t(pos), step,
                                  clamp_len=1024, cache_k_scale=t(ks), cache_v_scale=t(vs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(np_of(g), np_of(w), **ATTN_TOL)


@pytest.mark.parametrize('B,with_mem', [(1, False), (1, True), (3, True)])
def test_k1_module_hands_the_kernel_dense_rows(monkeypatch, B, with_mem):
    """The kernel takes contiguous [BN, T, H] rows; the module must hand it
    such rows at every batch size (B = 1 makes reshape return views)."""
    import musicnlp_tpu_torch.ops.flash_attention as fa
    seen = []
    real = fa.flash_rel_attn_fwd

    def spy(*args, **kw):
        seen.append(all(t.is_contiguous() for t in args[:5]))
        return real(*args, **kw)
    monkeypatch.setattr(fa, 'flash_rel_attn_fwd', spy)
    _, tp = _attn_params(d_model=64, n_head=4, seed=5)
    mems = torch.from_numpy(randn(19, B, 8, 64)) if with_mem else None
    fa.fused_rel_attn(tp, torch.from_numpy(randn(18, B, 16, 64)), mems, 8 if with_mem else 0,
                      clamp_len=32)
    assert seen == [True]
