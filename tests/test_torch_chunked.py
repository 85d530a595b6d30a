"""The chunked-window kernels' module (K3, K4) and the Reformer's attention ops,
port vs JAX at small sizes (f32 on the CPU): the plain K3 / K4 against the
Pallas kernel in interpret mode (and its custom VJP), `local_attention` and
`lsh_attention` against the JAX module's jnp path, and the LSH rotations
against `jax.random`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicnlp_tpu.ops import chunked_attention as jca
from musicnlp_tpu.ops.pallas.chunked_attention_kernel import (
    chunked_window_attn as pallas_chunked_window_attn)
from musicnlp_tpu_torch.ops import chunked_attention as tca
from musicnlp_tpu_torch.ops import chunked_attention_kernel as tck
from musicnlp_tpu_torch.utils import jax_rng
from tests.torch_parity import np_of, randn

# the JAX kernel tests' own tolerance (tests/test_chunked_kernel.py)
K3_TOL = dict(rtol=2e-4, atol=2e-4)
# gradients through the interpret-mode kernel: the TPU backward sums its
# overlapping windows in another order
K4_TOL = dict(rtol=2e-3, atol=2e-3)
# the attention ops against the JAX module's jnp path, f32
OP_TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(G, T, D, seed, perm=False, pads=0):
    """q, k, v [G, T, D] and int32 positions (a per-row permutation for
    LSH-like cases; the trailing `pads` slots marked as pad keys)."""
    q, k, v = (randn(seed + i, G, T, D) for i in range(3))
    rng = np.random.default_rng(seed + 3)
    if perm:
        qpos = np.stack([rng.permutation(T) for _ in range(G)]).astype(np.int32)
    else:
        qpos = np.broadcast_to(np.arange(T, dtype=np.int32), (G, T)).copy()
    kpos = qpos.copy()
    if pads:
        kpos[:, T - pads:] = T
    return q, k, v, qpos, kpos


CASES = {   # (G, T, D, chunk, perm, pads, scale, self_bias)
    'local': (3, 256, 32, 32, False, 0, 0.125, 0.0),
    'lsh-permuted': (3, 256, 32, 32, True, 0, 1.0, -1e5),
    'padded': (3, 256, 32, 32, False, 40, 0.125, 0.0),
    'lsh-padded': (2, 128, 16, 16, True, 24, 1.0, -1e5),
    'single-block': (2, 64, 32, 32, False, 0, 0.2, 0.0),
}


@pytest.mark.parametrize('case', list(CASES))
def test_k3_plain_matches_pallas(case):
    G, T, D, chunk, perm, pads, scale, self_bias = CASES[case]
    q, k, v, qpos, kpos = _inputs(G, T, D, 1, perm, pads)
    want, want_lse = pallas_chunked_window_attn(
        *map(jnp.asarray, (q, k, v, qpos, kpos)), chunk=chunk, scale=scale,
        self_bias=self_bias, interpret=True, form='windows')
    got, got_lse = tck.chunked_window_attn_fwd(
        *map(torch.from_numpy, (q, k, v, qpos, kpos)), chunk=chunk, scale=scale,
        self_bias=self_bias)
    assert got.dtype == torch.float32 and got_lse.dtype == torch.float32
    np.testing.assert_allclose(np_of(got), np_of(want), **K3_TOL)
    np.testing.assert_allclose(np_of(got_lse), np_of(want_lse), **K3_TOL)


@pytest.mark.parametrize('case', ['local', 'lsh-permuted', 'lsh-padded'])
def test_k4_plain_matches_pallas_vjp(case):
    """dq, dk, dv of a loss on both outputs (ctx and lse): the port's
    ChunkedWindowAttn (plain K4 on the CPU) against jax.grad through the
    Pallas kernel's custom VJP in interpret mode."""
    G, T, D, chunk, perm, pads, scale, self_bias = CASES[case]
    q, k, v, qpos, kpos = _inputs(G, T, D, 5, perm, pads)
    w_out, w_lse = randn(20, G, T, D), randn(21, G, T)

    def jloss(q, k, v):
        o, l = pallas_chunked_window_attn(q, k, v, jnp.asarray(qpos), jnp.asarray(kpos),
                                          chunk=chunk, scale=scale, self_bias=self_bias,
                                          interpret=True, form='windows')
        return jnp.sum(o * w_out) + jnp.sum(l * w_lse)
    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ins = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o, l = tck.chunked_window_attn(*ins, torch.from_numpy(qpos), torch.from_numpy(kpos),
                                   chunk=chunk, scale=scale, self_bias=self_bias)
    loss = (o * torch.from_numpy(w_out)).sum() + (l * torch.from_numpy(w_lse)).sum()
    got = torch.autograd.grad(loss, ins)
    for name, a, b in zip('qkv', got, want):
        np.testing.assert_allclose(np_of(a), np_of(b), **K4_TOL, err_msg=name)


@pytest.mark.parametrize('perm,pads', [(True, 0), (False, 10)])
def test_k4_plain_is_the_gradient_of_the_plain_k3(perm, pads):
    """The plain backward against autograd through the plain forward, f32,
    both outputs.  Every query here sees at least one key: on a query whose
    whole window is masked, K4 (like the TPU kernel) keeps ds = p (dp - delta
    + dlse) scale with p uniform, where autograd of the constant row gives 0."""
    q, k, v, qpos, kpos = _inputs(2, 96, 16, 7, perm=perm, pads=pads)
    ins = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    pos = [torch.from_numpy(x) for x in (qpos, kpos)]
    kw = dict(chunk=32, scale=0.7, self_bias=-1e5)
    o, l = tck.chunked_window_attn_fwd_plain(*ins, *pos, **kw)
    d_out, d_lse = torch.from_numpy(randn(30, 2, 96, 16)), torch.from_numpy(randn(31, 2, 96))
    want = torch.autograd.grad((o * d_out).sum() + (l * d_lse).sum(), ins)
    got = tck.chunked_window_attn_bwd_plain(*[t.detach() for t in ins], *pos, o.detach(), d_out,
                                            l.detach(), d_lse, **kw)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_visible_pairs_counts_the_window():
    q, k, v, qpos, kpos = _inputs(1, 64, 16, 0)
    # chunk 0: 1..32 keys; chunk 1: 33..64 keys (32 look-back + causal own)
    want = sum(range(1, 33)) + sum(range(33, 65))
    assert tck.visible_pairs(torch.from_numpy(qpos), torch.from_numpy(kpos), 32) == want


def test_wrapper_rejects_bad_shapes():
    q, k, v, qpos, kpos = map(torch.from_numpy, _inputs(1, 64, 16, 0))
    with pytest.raises(ValueError, match='multiple'):
        tck.chunked_window_attn_fwd(q, k, v, qpos, kpos, chunk=48, scale=1.0)
    with pytest.raises(ValueError, match='qpos'):
        tck.chunked_window_attn_fwd(q, k, v, qpos[:, :32], kpos, chunk=32, scale=1.0)


# ---------------------------------------------------------------- attention ops
def _pad_mask(B, T, real):
    return np.arange(T)[None, :] < np.asarray(real)[:, None]


@pytest.mark.parametrize('padded', [False, True])
def test_local_attention_matches_jax(padded):
    B, H, T, D, chunk = 2, 3, 128, 16, 32
    q, k, v = (randn(40 + i, B, H, T, D) for i in range(3))
    pm = _pad_mask(B, T, [T, 77]) if padded else None
    want = jca.local_attention(*map(jnp.asarray, (q, k, v)), chunk=chunk,
                               pad_mask=None if pm is None else jnp.asarray(pm))
    got = tca.local_attention(*map(torch.from_numpy, (q, k, v)), chunk=chunk,
                              pad_mask=None if pm is None else torch.from_numpy(pm))
    np.testing.assert_allclose(np_of(got), np_of(want), **OP_TOL)


def _margin(x, rots):
    """Smallest gap between the two largest entries of [proj; -proj]."""
    proj = np.einsum('...d,rdb->r...b', x, rots)
    top = np.sort(np.concatenate([proj, -proj], axis=-1), axis=-1)
    return float((top[..., -1] - top[..., -2]).min())


@pytest.mark.parametrize('n_hashes,padded', [(1, False), (2, False), (2, True)])
def test_lsh_attention_matches_jax(n_hashes, padded):
    """Same rotations into both (JAX's draw): outputs on real rows, and the
    gradients of a loss over them."""
    B, H, T, D, chunk, nb = 2, 2, 128, 16, 32, 8
    qk, v = randn(50, B, H, T, D), randn(51, B, H, T, D)
    key = jax.random.fold_in(jax.random.PRNGKey(77), 3)
    rots = np.array(jax.random.normal(key, (n_hashes, D, nb // 2), jnp.float32))
    pm = _pad_mask(B, T, [T, 90]) if padded else None
    w = randn(52, B, H, T, D)
    real = np.ones((B, 1, T, 1), np.float32) if pm is None else pm[:, None, :, None]

    def jfn(qk, v):
        out = jca.lsh_attention(qk, v, chunk=chunk, n_hashes=n_hashes, n_buckets=nb,
                                rng_rot=key, pad_mask=None if pm is None else jnp.asarray(pm))
        return out, jnp.sum(out * w * real)
    want = jax.jit(jfn)(jnp.asarray(qk), jnp.asarray(v))[0]
    jg = jax.jit(jax.grad(lambda a, b: jfn(a, b)[1], argnums=(0, 1)))(jnp.asarray(qk),
                                                                      jnp.asarray(v))
    ins = [torch.from_numpy(x).requires_grad_(True) for x in (qk, v)]
    got = tca.lsh_attention(*ins, chunk=chunk, n_hashes=n_hashes, n_buckets=nb,
                            rots=torch.from_numpy(rots),
                            pad_mask=None if pm is None else torch.from_numpy(pm))
    tg = torch.autograd.grad((got * torch.from_numpy(w * real)).sum(), ins)
    np.testing.assert_allclose(np_of(got) * real, np_of(want) * real, **OP_TOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(np_of(a), np_of(b), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('layer,shape', [(1, (2, 64, 32)), (3, (2, 16, 4)), (11, (1, 32, 8))])
def test_rotations_and_buckets_match_jax(layer, shape):
    """The numpy threefry reproduces JAX's keys and uniform bits exactly and
    its normals to a few ulp (erfinv's log1p differs); on inputs whose top-2
    projection margin exceeds that error the bucket ids are identical."""
    key = jax.random.fold_in(jax.random.PRNGKey(77), layer)
    nkey = jax_rng.fold_in(jax_rng.prng_key(77), layer)
    np.testing.assert_array_equal(nkey, np.asarray(jax.random.key_data(key)))
    np.testing.assert_array_equal(
        jax_rng.uniform(nkey, shape, -1.0, 1.0),
        np.asarray(jax.random.uniform(key, shape, jnp.float32, -1.0, 1.0)))
    want = np.asarray(jax.random.normal(key, shape, jnp.float32))
    got = tca.lsh_rotations(77, layer, *shape[:2], 2 * shape[2]).numpy()
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert float(np.max(np.abs(got - want) / ulp)) <= 4
    x = randn(60 + layer, 3, 200, shape[1])
    # the largest projection error the rotation gap can cause, against the
    # smallest top-2 gap of these inputs: no bucket can flip
    err = float(np.einsum('gtd,rdb->grtb', np.abs(x), np.abs(got - want)).max())
    assert _margin(x, want) > 2 * err
    jb = np.asarray(jnp.argmax(jnp.concatenate(
        [jnp.einsum('gtd,rdb->grtb', x, want), -jnp.einsum('gtd,rdb->grtb', x, want)], -1), -1))
    tb = tca.lsh_buckets(torch.from_numpy(x), torch.from_numpy(got)).permute(1, 0, 2).numpy()
    np.testing.assert_array_equal(tb, jb)
