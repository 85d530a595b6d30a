"""The widened attention kernels (ROADMAP C.1, C.2), on the CPU: K1 / K2 and
K3 / K4 take head dims 16 / 32 / 64 / 128 and every multiple of 128 and any
chunk, in f32, bf16 and f16, and the modules zero-pad any other head dim to
the next of them (above 128, the next multiple of 128, as the TPU kernels
pad to lanes of 128), so every layer the JAX package sends to its TPU
kernels goes through the kernels' wrappers here (their plain versions on
the CPU).  Head-dim-128 and -256 TF-XLs, padded head dims (48 -> 64, 192 ->
256), an f16 TF-XL, a chunk-128 Reformer and a head-dim-256 Reformer match
the JAX package in f32 at 1e-4 of each tensor's max."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicnlp_tpu.models.reformer import Reformer as JReformer, ReformerConfig as JRConfig
from musicnlp_tpu.models.transformer_xl import TransfoXL as JTfxl, TransfoXLConfig as JTConfig
from musicnlp_tpu.utils import checkpoint as jckpt
from musicnlp_tpu_torch.models import transformer_xl as txl
from musicnlp_tpu_torch.models.reformer import Reformer, ReformerConfig
from musicnlp_tpu_torch.models.transformer_xl import TransfoXL, TransfoXLConfig
from musicnlp_tpu_torch.ops import chunked_attention as ca
from musicnlp_tpu_torch.ops import chunked_attention_kernel as ck
from musicnlp_tpu_torch.ops import flash_attention as fa
from musicnlp_tpu_torch.utils import checkpoint as tckpt
from tests.test_torch_reformer import margins  # noqa: F401  (LSH near-tie guard)
from tests.torch_parity import np_of, perturb, randn, to_torch

REL = 1e-4              # f32, port vs JAX: other summation orders, of each tensor's max
SELF_REL = 1e-5         # f32, padded wrappers (K4's plain backward) vs autograd, unpadded
FP16_REL = 2e-2         # float16 vs float32 logits, of the max (10-bit mantissa, 2 layers)
V = 300

TFXL_128 = dict(model_size='test', d_model=256, n_head=2, d_head=128, d_inner=256, n_layer=2,
                mem_len=16, clamp_len=48, max_length=64, dropout=0.0, dtype='float32')
# chunk 128 in both layer kinds: two chunks at T 256, one hash round per layer
REFORMER_128 = dict(model_size='test', d_model=64, n_head=2, d_head=32, d_ff=128,
                    attn_layers=('local', 'lsh'), max_length=256, axial_pos_shape=(16, 16),
                    local_chunk=128, lsh_chunk=128, n_hashes=2, dropout=0.0, dtype='float32')


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def calls(monkeypatch):
    """Records (head dim, dtype) of each FlashRelAttn and (chunk, head dim,
    dtype) of each ChunkedWindowAttn call, and each plain rel_attn layer."""
    rec = {'flash': [], 'window': [], 'rel_attn': 0}
    flash, window, rel = fa.FlashRelAttn.apply, ck.ChunkedWindowAttn.apply, txl.rel_attn

    def on_flash(rw3, *a):
        rec['flash'].append((rw3.shape[-1], rw3.dtype))
        return flash(rw3, *a)

    def on_window(q, k, v, qpos, kpos, chunk, *a):
        rec['window'].append((chunk, q.shape[-1], q.dtype))
        return window(q, k, v, qpos, kpos, chunk, *a)

    def on_rel(*a, **kw):
        rec['rel_attn'] += 1
        return rel(*a, **kw)
    monkeypatch.setattr(fa.FlashRelAttn, 'apply', on_flash)
    monkeypatch.setattr(ck.ChunkedWindowAttn, 'apply', on_window)
    monkeypatch.setattr(txl, 'rel_attn', on_rel)
    return rec


def _rel_err(got, want) -> float:
    got, want = np_of(got), np_of(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-12)


def _ids(seed, B, T):
    return np.random.default_rng(seed).integers(0, V, (B, T)).astype(np.int32)


# ------------------------------------------------------------ kernel sets
@pytest.mark.parametrize('mod', [fa, ck], ids=['K1-K2', 'K3-K4'])
def test_kernels_take_head_dims_to_128_in_three_dtypes(mod):
    """The head dims the kernels take, in f32, bf16 and f16: up to 128 the
    next of 16 / 32 / 64 / 128, and (since C.2) above 128 the next multiple
    of 128 (the TPU kernels' `_pad_to` lanes); every padded dim is one the
    launch check takes, and no other dim up to 1,024 is."""
    assert set(mod._DTYPE_CODE) == {torch.float32, torch.bfloat16, torch.float16}
    for d in range(1, 1025):
        want = next(h for h in (16, 32, 64, 128) if h >= d) if d <= 128 else -(-d // 128) * 128
        assert mod.kernel_head_dim(d) == want, d
        assert mod.takes_head_dim(mod.kernel_head_dim(d))
        assert mod.takes_head_dim(d) == (d in (16, 32, 64, 128) or d % 128 == 0), d


# ---------------------------------------------------------------------- TF-XL
def _tfxl_pair(**kw):
    jm = JTfxl(JTConfig(vocab_size=V, **dict(TFXL_128, **kw)))
    jp = perturb(jm.init(jax.random.PRNGKey(0)), 1)
    tm = TransfoXL(TransfoXLConfig(vocab_size=V, **dict(TFXL_128, **kw)), device='cpu')
    return jm, jp, tm, to_torch(jp)


def _tfxl_matches_jax(jm, jp, tm, tp, d_model):
    """Logits with and without memory, the loss and every gradient."""
    ids = _ids(1, 2, 32)
    got, _, _ = tm.forward(tp, torch.from_numpy(ids))
    want, _, _ = jax.jit(jm.forward)(jp, jnp.asarray(ids))
    assert _rel_err(got, want) <= REL
    mems = randn(2, 2, 2, 16, d_model)
    got, _, _ = tm.forward(tp, torch.from_numpy(ids), mems=torch.from_numpy(mems), mem_valid=10)
    want, _, _ = jax.jit(jm.forward)(jp, jnp.asarray(ids), mems=jnp.asarray(mems),
                                     mem_valid=10)
    assert _rel_err(got, want) <= REL

    labels = np.where(ids % 7 == 0, -100, ids).astype(np.int32)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(ids), jnp.asarray(labels)), has_aux=True))(jp)
    flat = tckpt.flatten(tp)
    for t in flat.values():
        t.requires_grad_(True)
    tl, _ = tm.loss(tp, torch.from_numpy(ids), torch.from_numpy(labels))
    grads = torch.autograd.grad(tl, list(flat.values()))
    assert abs(float(tl.detach()) - float(jl)) <= REL * abs(float(jl))
    jflat = jckpt._flatten(jg)
    for key, g in zip(flat, grads):
        assert _rel_err(g, jflat[key]) <= REL, key


def test_head_dim_128_tfxl_runs_the_kernels_and_matches_jax(calls):
    """d_head 128: every layer goes through FlashRelAttn at H 128 (K1 / K2
    on the card), none through the plain rel_attn; logits with and without
    memory, the loss and every gradient equal JAX's."""
    _tfxl_matches_jax(*_tfxl_pair(), d_model=256)
    assert set(calls['flash']) == {(128, torch.float32)} and calls['rel_attn'] == 0
    assert len(calls['flash']) == 3 * TFXL_128['n_layer']      # 2 forwards, 1 loss


def test_odd_head_dim_tfxl_runs_padded_and_matches_jax(calls):
    """d_head 48 runs K1 / K2 zero-padded to 64 at the layer's own scale
    1/sqrt(48); logits, the loss and every gradient equal JAX's."""
    _tfxl_matches_jax(*_tfxl_pair(d_model=96, d_head=48), d_model=96)
    assert set(calls['flash']) == {(64, torch.float32)} and calls['rel_attn'] == 0


@pytest.mark.parametrize('d_model,d_head,kernel_dim', [(512, 256, 256), (384, 192, 256)])
def test_head_dims_above_128_tfxl_run_the_kernels_and_match_jax(calls, d_model, d_head,
                                                              kernel_dim):
    """d_head 256, and 192 zero-padded to 256 at its own scale 1/sqrt(192):
    every layer goes through FlashRelAttn at H 256 (K1 / K2's slab kernels
    on the card), none through the plain rel_attn; logits with and without
    memory, the loss and every gradient equal JAX's."""
    _tfxl_matches_jax(*_tfxl_pair(d_model=d_model, d_head=d_head, d_inner=128), d_model=d_model)
    assert set(calls['flash']) == {(kernel_dim, torch.float32)} and calls['rel_attn'] == 0
    assert len(calls['flash']) == 3 * TFXL_128['n_layer']


def test_fp16_tfxl_runs_the_kernels(calls):
    """float16 goes through FlashRelAttn in f16 (K1 / K2's tensor-core
    kernels on the card) and stays near the f32 model's logits."""
    cfg = TransfoXLConfig(vocab_size=V, **dict(TFXL_128, d_model=64, d_head=32,
                                               dtype='float16'))
    f16 = TransfoXL(cfg, device='cpu')
    f32 = TransfoXL(dataclasses.replace(cfg, dtype='float32'), device='cpu')
    tp = f32.init(0)
    ids = torch.from_numpy(_ids(2, 2, 32))
    got, _, _ = f16.forward(tp, ids)
    want, _, _ = f32.forward(tp, ids)
    assert calls['flash'] == [(32, torch.float16)] * 2 + [(32, torch.float32)] * 2
    assert calls['rel_attn'] == 0
    assert torch.isfinite(got).all() and _rel_err(got, want) <= FP16_REL


# ------------------------------------------------------------------- Reformer
def test_chunk_128_reformer_runs_the_kernels_and_matches_jax(calls, margins):  # noqa: F811
    """local_chunk = lsh_chunk = 128: both layers' window attention goes
    through ChunkedWindowAttn at chunk 128 (K3 / K4's tiled kernels on the
    card); logits, the loss and every gradient equal JAX's."""
    jm = JReformer(JRConfig(vocab_size=V, **REFORMER_128))
    jp = perturb(jm.init(jax.random.PRNGKey(0)), 1)
    tm = Reformer(ReformerConfig(vocab_size=V, **REFORMER_128), device='cpu')
    tp = to_torch(jp)
    ids = _ids(4, 2, 256)
    got = tm.forward(tp, torch.from_numpy(ids))
    assert calls['window'] == [(128, 32, torch.float32)] * 2
    assert _rel_err(got, jax.jit(jm.forward)(jp, jnp.asarray(ids))) <= REL

    labels = np.where(ids % 5 == 0, -100, ids).astype(np.int32)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(ids), jnp.asarray(labels)), has_aux=True))(jp)
    flat = tckpt.flatten(tp)
    for t in flat.values():
        t.requires_grad_(True)
    tl, _ = tm.loss(tp, torch.from_numpy(ids), torch.from_numpy(labels))
    grads = torch.autograd.grad(tl, list(flat.values()))
    assert abs(float(tl.detach()) - float(jl)) <= REL * abs(float(jl))
    jflat = jckpt._flatten(jg)
    for key, g in zip(flat, grads):
        assert _rel_err(g, jflat[key]) <= REL, key
    assert margins.smallest() > 0


def test_head_dim_256_reformer_runs_the_kernels_and_matches_jax(calls, margins):  # noqa: F811
    """d_head 256 (two heads of 256 at d_model 64): both layers' window
    attention goes through ChunkedWindowAttn at head dim 256 (K3 / K4's slab
    kernels on the card); logits, the loss and every gradient equal JAX's."""
    cfg = dict(REFORMER_128, d_head=256, local_chunk=64, lsh_chunk=64, max_length=128,
               axial_pos_shape=(8, 16))
    jm = JReformer(JRConfig(vocab_size=V, **cfg))
    jp = perturb(jm.init(jax.random.PRNGKey(0)), 1)
    tm = Reformer(ReformerConfig(vocab_size=V, **cfg), device='cpu')
    tp = to_torch(jp)
    ids = _ids(5, 2, 128)
    got = tm.forward(tp, torch.from_numpy(ids))
    assert calls['window'] == [(64, 256, torch.float32)] * 2
    assert _rel_err(got, jax.jit(jm.forward)(jp, jnp.asarray(ids))) <= REL

    labels = np.where(ids % 5 == 0, -100, ids).astype(np.int32)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(ids), jnp.asarray(labels)), has_aux=True))(jp)
    flat = tckpt.flatten(tp)
    for t in flat.values():
        t.requires_grad_(True)
    tl, _ = tm.loss(tp, torch.from_numpy(ids), torch.from_numpy(labels))
    grads = torch.autograd.grad(tl, list(flat.values()))
    assert abs(float(tl.detach()) - float(jl)) <= REL * abs(float(jl))
    jflat = jckpt._flatten(jg)
    for key, g in zip(flat, grads):
        assert _rel_err(g, jflat[key]) <= REL, key
    assert margins.smallest() > 0


@pytest.mark.parametrize('chunk,D,Dk', [(128, 32, 32), (64, 48, 64), (16, 24, 32)])
def test_padded_window_attention_equals_the_unpadded_plain(calls, chunk, D, Dk):
    """The module's window attention at head dim D runs the wrappers at Dk
    (zero-padded) and equals autograd through the unpadded plain forward --
    ctx, lse and the gradients of q, k, v for both outputs' cotangents -- with
    pad keys and the LSH self bias."""
    G, T = 3, 4 * chunk
    q, k, v = (torch.from_numpy(randn(s, G, T, D)).requires_grad_(True) for s in (1, 2, 3))
    qpos = torch.arange(T, dtype=torch.int32).expand(G, T).contiguous()
    kpos = torch.where(torch.arange(T) < T - 5, torch.arange(T), torch.tensor(T)).to(
        torch.int32).expand(G, T).contiguous()
    d_out, d_lse = torch.from_numpy(randn(4, G, T, D)), torch.from_numpy(randn(5, G, T))
    kw = dict(chunk=chunk, scale=D ** -0.5, self_bias=-1e5)
    out, lse = ca._window_attn(q, k, v, qpos, kpos, **kw)
    assert calls['window'] == [(chunk, Dk, torch.float32)]
    got = torch.autograd.grad((out, lse), (q, k, v), (d_out, d_lse))
    w_out, w_lse = ck.chunked_window_attn_fwd_plain(q, k, v, qpos, kpos, **kw)
    assert _rel_err(out, w_out) <= SELF_REL and _rel_err(lse, w_lse) <= SELF_REL
    want = torch.autograd.grad((w_out, w_lse), (q, k, v), (d_out, d_lse))
    for g, w in zip(got, want):
        assert _rel_err(g, w) <= SELF_REL


def test_preset_head_dims_run_unpadded(calls):
    """The presets' heads (32 here, 64 in 22-11 / 22-04) reach the wrappers
    as they are: no padding, no plain layer."""
    tm = TransfoXL(TransfoXLConfig(vocab_size=V, **dict(TFXL_128, d_model=64, d_head=32)),
                   device='cpu')
    rm = Reformer(ReformerConfig(vocab_size=V, **dict(REFORMER_128, local_chunk=64,
                                                      lsh_chunk=64)), device='cpu')
    tm.forward(tm.init(0), torch.from_numpy(_ids(6, 1, 16)))
    rm.forward(rm.init(0), torch.from_numpy(_ids(7, 1, 256)))
    assert calls['flash'] == [(32, torch.float32)] * 2 and calls['rel_attn'] == 0
    assert calls['window'] == [(64, 32, torch.float32)] * 2
