"""`remat_attn` (TF-XL) and `remat` (the Reformer, native and two-stream)
on the CPU in f32 at a small width: against the same step without them,
with dropout 0.1 on one generator seed (loss, every gradient, and the
generator's state after the step), with the recomputed attention forward
counted (K1 / K3's plain versions run twice per layer); and against the JAX
package with its `remat_attn` / `remat`, deterministic."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicnlp_tpu.models.reformer import Reformer as JReformer, ReformerConfig as JRConfig
from musicnlp_tpu.models.transformer_xl import TransfoXL as JTransfoXL
from musicnlp_tpu.models.transformer_xl import TransfoXLConfig as JTConfig
from musicnlp_tpu.utils.checkpoint import _flatten as jflatten
from musicnlp_tpu.vocab import MusicTokenizer as JTok
from musicnlp_tpu_torch.models.reformer import Reformer, ReformerConfig
from musicnlp_tpu_torch.models.transformer_xl import TransfoXL, TransfoXLConfig
from musicnlp_tpu_torch.ops import chunked_attention_kernel as ck
from musicnlp_tpu_torch.ops import flash_attention as fa
from musicnlp_tpu_torch.utils import checkpoint as tckpt
from tests.test_torch_reformer import CFG as REFORMER_CFG, margins  # noqa: F401 (fixture)
from tests.test_torch_train import CFG as TFXL_CFG
from tests.torch_parity import np_of, perturb, to_torch

SELF_REL = 1e-6      # remat on vs off: the same f32 arithmetic, of each gradient's max
JAX_REL = 1e-4       # port vs JAX gradients (other summation orders), as test_torch_train
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny models run faster on one thread, and several test workers on one
    machine would otherwise oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def forward_calls(monkeypatch):
    """Calls of K1's and K3's plain forwards (what the wrappers run on CPU
    tensors), by kernel."""
    calls = dict(k1=0, k3=0)

    def spy(module, name, key):
        real = getattr(module, name)

        def run(*a, **kw):
            calls[key] += 1
            return real(*a, **kw)
        monkeypatch.setattr(module, name, run)
    spy(fa, 'flash_rel_attn_fwd_plain', 'k1')
    spy(ck, 'chunked_window_attn_fwd_plain', 'k3')
    return calls


def _assert_rel(got, want, rel, msg=''):
    got, want = np_of(got), np_of(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    assert float(np.abs(got - want).max()) <= rel * scale, (msg, np.abs(got - want).max(), scale)


def _step(model, flat_np, ids, labels, seed, n_seg=1):
    """Loss, gradients and the generator's state after one dropout step."""
    params = tckpt.params_from_jax(flat_np, 'cpu')
    leaves = tckpt.flatten(params)
    for t in leaves.values():
        t.requires_grad_(True)
    gen = torch.Generator().manual_seed(seed)
    loss, _ = model.loss(params, torch.from_numpy(ids), torch.from_numpy(labels),
                         generator=gen, deterministic=False, n_seg=n_seg)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True,
                                materialize_grads=True)
    return float(loss.detach()), dict(zip(leaves, grads)), gen.get_state()


def _compare_self(off, on):
    (l0, g0, s0), (l1, g1, s1) = off, on
    assert l1 == l0
    assert torch.equal(s1, s0)
    for k in g0:
        _assert_rel(g1[k], g0[k], SELF_REL, k)


@pytest.mark.parametrize('n_seg', [1, 2])
def test_tfxl_remat_attn_equals_plain_step(forward_calls, n_seg):
    """Dropout 0.1 (after each attention, in the FFN, on the embedding): the
    recompute replays the attention's dropout draws, so the step is the same
    and the generator ends where it would have; K1 runs once more per layer
    and segment."""
    V = JTok(pitch_kind='degree').vocab_size
    cfg = TransfoXLConfig(vocab_size=V, **dict(TFXL_CFG, dropout=0.1))
    flat = TransfoXL(cfg, device='cpu').init_flat(3)
    ids = np.random.default_rng(4).integers(0, V, (2, 64)).astype(np.int64)
    labels = np.where(ids % 5 == 0, -100, ids)
    runs = []
    for remat in (False, True):
        forward_calls['k1'] = 0
        m = TransfoXL(dataclasses.replace(cfg, remat_attn=remat), device='cpu')
        runs.append(_step(m, flat, ids, labels, seed=11, n_seg=n_seg))
        assert forward_calls['k1'] == cfg.n_layer * n_seg * (2 if remat else 1)
    _compare_self(*runs)
    other = _step(TransfoXL(cfg, device='cpu'), flat, ids, labels, seed=12, n_seg=n_seg)
    assert other[0] != runs[0][0]          # the draws do depend on the seed


@pytest.mark.parametrize('hf_compat', [False, True], ids=['standard', 'two-stream'])
def test_reformer_remat_equals_plain_step(forward_calls, hf_compat):
    """Dropout 0.1 lies outside the recomputed blocks, and the LSH rotations
    are fixed draws, so a recomputed block buckets as its forward did: the
    same loss, gradients and generator state; K3 runs twice per layer."""
    V = JTok(pitch_kind='midi').vocab_size
    cfg = ReformerConfig(vocab_size=V, **dict(REFORMER_CFG, dropout=0.1, hf_compat=hf_compat))
    flat = Reformer(cfg, device='cpu').init_flat(5)
    ids = np.random.default_rng(6).integers(0, V, (2, 128)).astype(np.int64)
    labels = np.where(ids % 5 == 0, -100, ids)
    runs = []
    for remat in (False, True):
        forward_calls['k3'] = 0
        m = Reformer(dataclasses.replace(cfg, remat=remat), device='cpu')
        runs.append(_step(m, flat, ids, labels, seed=13))
        assert forward_calls['k3'] == len(cfg.attn_layers) * (2 if remat else 1)
    _compare_self(*runs)


def test_remat_under_no_grad_runs_once(forward_calls):
    """Scoring (no autograd) is a plain forward: one K1 / K3 per layer."""
    V = JTok(pitch_kind='degree').vocab_size
    cfg = TransfoXLConfig(vocab_size=V, **dict(TFXL_CFG, remat_attn=True))
    m = TransfoXL(cfg, device='cpu')
    with torch.no_grad():
        m.loss(m.init(0), torch.zeros(1, 64, dtype=torch.long), torch.zeros(1, 64,
                                                                           dtype=torch.long))
    assert forward_calls['k1'] == cfg.n_layer


def test_tfxl_remat_attn_matches_jax():
    """Deterministic: loss and gradients with remat_attn == the JAX model
    with its remat_attn."""
    V = JTok(pitch_kind='degree').vocab_size
    cfg = dict(TFXL_CFG, remat_attn=True)
    jm = JTransfoXL(JTConfig(vocab_size=V, **cfg))
    jp = perturb(jm.init(jax.random.PRNGKey(0)), 2)
    tm = TransfoXL(TransfoXLConfig(vocab_size=V, **cfg), device='cpu')
    ids = np.random.default_rng(7).integers(0, V, (2, 64)).astype(np.int32)
    labels = np.where(ids % 5 == 0, -100, ids).astype(np.int32)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(ids), jnp.asarray(labels)), has_aux=True))(jp)
    tp = to_torch(jp)
    flat = tckpt.flatten(tp)
    for t in flat.values():
        t.requires_grad_(True)
    tl, _ = tm.loss(tp, torch.from_numpy(ids), torch.from_numpy(labels))
    grads = torch.autograd.grad(tl, list(flat.values()))
    np.testing.assert_allclose(float(tl.detach()), float(jl), **LOSS_TOL)
    jflat = jflatten(jg)
    for key, g in zip(flat, grads):
        _assert_rel(g, jflat[key], JAX_REL, key)


@pytest.mark.parametrize('hf_compat', [False, True], ids=['standard', 'two-stream'])
def test_reformer_remat_matches_jax(margins, hf_compat):  # noqa: F811
    """Deterministic: loss and gradients with remat == the JAX model with
    its remat, over four chunks and two hash rounds (the LSH hashes the port
    computed are far from a near-tie)."""
    V = JTok(pitch_kind='midi').vocab_size
    cfg = dict(REFORMER_CFG, remat=True, hf_compat=hf_compat)
    jm = JReformer(JRConfig(vocab_size=V, **cfg))
    jp = perturb(jm.init(jax.random.PRNGKey(1)), 3)
    tm = Reformer(ReformerConfig(vocab_size=V, **cfg), device='cpu')
    ids = np.random.default_rng(8).integers(0, V, (2, 128)).astype(np.int32)
    labels = np.where(ids % 5 == 0, -100, ids).astype(np.int32)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(ids), jnp.asarray(labels)), has_aux=True))(jp)
    tp = to_torch(jp)
    flat = tckpt.flatten(tp)
    for t in flat.values():
        t.requires_grad_(True)
    tl, _ = tm.loss(tp, torch.from_numpy(ids), torch.from_numpy(labels))
    grads = torch.autograd.grad(tl, list(flat.values()), allow_unused=True,
                                materialize_grads=True)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **LOSS_TOL)
    jflat = jflatten(jg)
    assert set(jflat) == set(flat)
    for key, g in zip(flat, grads):
        _assert_rel(g, jflat[key], JAX_REL, key)
    assert margins.smallest() > 0
