"""The large-vocab heads of the port against the JAX package's, in f32 on
the CPU: the tiled CE (`ce_tile_scan`, `chunked_shifted_ce_loss`, TF-XL's
`head_chunk`) against JAX and against the port's dense CE, the 262,144-unit
tier at a narrow width, the adaptive head in `forward` and `decode_step`,
and `load_trained` keeping both knobs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicnlp_tpu.models.transformer_xl import TransfoXL as JModel, TransfoXLConfig as JConfig
from musicnlp_tpu.ops import losses as jlosses
from musicnlp_tpu.trainer.train import asdict_config, describe_tokenizer
from musicnlp_tpu.utils import checkpoint as jckpt
from musicnlp_tpu.vocab import MusicTokenizer as JTok
from musicnlp_tpu_torch.models.transformer_xl import TransfoXL, TransfoXLConfig
from musicnlp_tpu_torch.ops import losses as tlosses
from musicnlp_tpu_torch.trainer.eval import load_trained
from musicnlp_tpu_torch.utils.checkpoint import flatten
from tests.torch_parity import np_of, perturb, randn, to_torch

CFG = dict(model_size='test', d_model=64, n_head=2, d_head=32, d_inner=128, n_layer=2,
           mem_len=16, clamp_len=32, max_length=64, dropout=0.0, dtype='float32')


@pytest.fixture(autouse=True)
def one_thread():
    """Small products run as fast on one thread, and several test workers
    on one machine would otherwise oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_max(a, b):
    a, b = np_of(a), np_of(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _labels(seed, B, T, V, hi=None):
    lab = np.random.default_rng(seed).integers(0, hi or V, (B, T)).astype(np.int32)
    lab[0, 3:7] = -100
    lab[-1, -2:] = -100
    return lab


@pytest.mark.parametrize('V,chunk', [(300, 128), (1190, 96), (1024, None)])
def test_tiled_ce_equals_jax_and_dense(V, chunk):
    """loss (relative 1e-5), preds identical, gradients of h, the embedding
    and the bias within 1e-5 of their max: V 300 in padded tiles of 128,
    V 1190 in non-dividing tiles of 96, and one tile of the whole vocab."""
    B, T, d = 3, 21, 32
    h, w = randn(1, B, T, d), randn(2, V, d, scale=0.3)
    b, lab = randn(3, V, scale=0.1), _labels(4, B, T, V)
    jloss = lambda h_, w_, b_: jlosses.chunked_shifted_ce_loss(h_, jnp.asarray(lab), w_, b_,
                                                               chunk=chunk or 8192)
    (jl, (jn, jp)), jg = jax.value_and_grad(lambda *a: (lambda o: (o[0], o[1:]))(jloss(*a)),
                                            (0, 1, 2), has_aux=True)(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b))
    ins = [torch.tensor(x, requires_grad=True) for x in (h, w, b)]
    tl, tn, tp = tlosses.chunked_shifted_ce_loss(ins[0], torch.from_numpy(lab), ins[1], ins[2],
                                                 chunk=chunk or 8192)
    tg = torch.autograd.grad(tl, ins)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert float(tn) == float(jn)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    for name, a, e in zip(('h', 'embed', 'bias'), tg, jg):
        assert _rel_max(a, e) < 1e-5, name
    # the dense CE of the same logits
    ins_d = [torch.tensor(x, requires_grad=True) for x in (h, w, b)]
    logits = ins_d[0] @ ins_d[1].T + ins_d[2]
    dl, dn = tlosses.shifted_ce_loss(logits, torch.from_numpy(lab))
    dg = torch.autograd.grad(dl, ins_d)
    np.testing.assert_allclose(float(tl.detach()), float(dl.detach()), rtol=1e-5)
    assert float(tn) == float(dn)
    assert torch.equal(tp[:, :-1], logits.argmax(-1)[:, :-1])
    assert torch.equal(tp[:, -1], tp[:, -2])
    for name, a, e in zip(('h', 'embed', 'bias'), tg, dg):
        assert _rel_max(a, e) < 1e-5, name


def test_tile_scan_row_block_with_offset():
    """A row block with lo_base > 0 (one shard of a vocab): labels outside
    [lo_base, lo_base + Vl) add 0, the argmax is in global ids, pad rows
    never claim a label; values and gradients equal JAX's."""
    B, T, d, V, lo_base, chunk = 2, 9, 16, 200, 150, 64
    h, w, b = randn(5, B, T, d), randn(6, V, d, scale=0.3), randn(7, V, scale=0.1)
    lb = np.random.default_rng(8).integers(0, 500, (B, T)).astype(np.int32)
    lb[0, :3] = [150 + 200, 150 + 199, 149]      # past the block, its last row, before it
    jfn = lambda h_, w_, b_: jlosses.ce_tile_scan(h_, jnp.asarray(lb), w_, b_, chunk=chunk,
                                                  lo_base=lo_base)
    want = jfn(jnp.asarray(h), jnp.asarray(w), jnp.asarray(b))
    ins = [torch.tensor(x, requires_grad=True) for x in (h, w, b)]
    got = tlosses.ce_tile_scan(ins[0], torch.from_numpy(lb), ins[1], ins[2], chunk=chunk,
                               lo_base=lo_base)
    for g, e in zip(got[:3], want[:3]):
        np.testing.assert_allclose(np_of(g), np_of(e), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert float(got[1][0, 0].detach()) == 0.0 and float(got[1][0, 2].detach()) == 0.0
    jg = jax.grad(lambda *a: jnp.sum(jfn(*a)[0] - 2 * jfn(*a)[1]), (0, 1, 2))(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b))
    tg = torch.autograd.grad((got[0] - 2 * got[1]).sum(), ins)
    for a, e in zip(tg, jg):
        assert _rel_max(a, e) < 1e-5


def test_argmax_ties_keep_the_first_tile():
    """Equal maxima in two tiles: the strict `>` keeps the earlier tile's
    id, as the dense argmax does."""
    h = torch.ones(1, 2, 4)
    w = torch.zeros(10, 4)
    w[[2, 7]] = 1.0                                   # tiles [0, 4), [4, 8), [8, 10)
    lse, tgt, run_max, run_arg = tlosses.ce_tile_scan(h, torch.zeros(1, 2, dtype=torch.long), w,
                                                      torch.zeros(10), chunk=4)
    assert run_arg.tolist() == [[2, 2]] and run_max.tolist() == [[4.0, 4.0]]
    jl = jlosses.ce_tile_scan(jnp.ones((1, 2, 4)), jnp.zeros((1, 2), jnp.int32),
                              jnp.asarray(w.numpy()), jnp.zeros(10), chunk=4)
    assert np.asarray(jl[3]).tolist() == [[2, 2]]


@pytest.fixture(scope='module')
def pair():
    vocab = JTok(pitch_kind='degree').vocab_size
    jm = JModel(JConfig(vocab_size=vocab, **CFG))
    jp = perturb(jm.init(jax.random.PRNGKey(0)), 1)
    return jm, jp, to_torch(jp)


def test_model_loss_with_head_chunk_equals_jax(pair):
    """TransfoXL.loss with head_chunk (1190 in tiles of 256): loss, metrics,
    preds and every parameter's gradient against the JAX model's."""
    jm, jp, tp = pair
    cfg = dataclasses.replace(jm.cfg, head_chunk=256)
    jmc, tm = JModel(cfg), TransfoXL(TransfoXLConfig(**{
        k: v for k, v in dataclasses.asdict(cfg).items()
        if k in TransfoXLConfig.__dataclass_fields__}), device='cpu')
    ids = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 48)).astype(np.int32)
    lab = ids.copy()
    lab[1, 30:] = -100
    (jl, jmets), jg = jax.jit(jax.value_and_grad(
        lambda p: jmc.loss(p, jnp.asarray(ids), jnp.asarray(lab)), has_aux=True))(jp)
    leaves = {k: v.requires_grad_(True) for k, v in flatten(tp).items()}
    tl, tmets = tm.loss(tp, torch.from_numpy(ids), torch.from_numpy(lab))
    tg = dict(zip(leaves, torch.autograd.grad(tl, list(leaves.values()))))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert float(tmets['ntp_acc']) == pytest.approx(float(jmets['ntp_acc']), abs=1e-6)
    np.testing.assert_array_equal(tmets['preds'].numpy(), np.asarray(jmets['preds']))
    for k, e in jckpt._flatten(jg).items():
        assert _rel_max(tg[k], e) < 1e-5, k
    for p in leaves.values():
        p.requires_grad_(False)


def test_head_chunk_refusals(pair):
    """The JAX model's two asserts: head_chunk with the adaptive head, and
    head_chunk with segment training."""
    jm, jp, tp = pair
    ids = torch.zeros(1, 16, dtype=torch.long)
    base = TransfoXLConfig(vocab_size=jm.cfg.vocab_size, **CFG)
    with pytest.raises(ValueError, match='adaptive'):
        TransfoXL(dataclasses.replace(base, head_chunk=256, adaptive_cutoffs=(1000,)),
                  device='cpu').loss(tp, ids, ids)
    with pytest.raises(ValueError, match='n_seg'):
        TransfoXL(dataclasses.replace(base, head_chunk=256), device='cpu').loss(tp, ids, ids,
                                                                             n_seg=2)
    with pytest.raises(AssertionError, match='adaptive'):
        JModel(dataclasses.replace(jm.cfg, head_chunk=256, adaptive_cutoffs=(1000,))).loss(
            jp, jnp.zeros((1, 16), jnp.int32), jnp.zeros((1, 16), jnp.int32))
    with pytest.raises(AssertionError, match='n_seg'):
        JModel(dataclasses.replace(jm.cfg, head_chunk=256)).loss(
            jp, jnp.zeros((1, 16), jnp.int32), jnp.zeros((1, 16), jnp.int32), n_seg=2)


def test_262k_vocab_trains_through_the_tiled_head():
    """The 262,144-unit tier at d_model 64 (as the JAX package's own test
    runs it): the loss is ~ln V and equals the JAX model's, and the
    gradient reaches the embedding, with no [B, T, V] tensor."""
    cfg = JConfig(vocab_size=262144, head_chunk=16384, **CFG)
    jm = JModel(cfg)
    jp = jm.init(jax.random.PRNGKey(2))
    tm = TransfoXL(TransfoXLConfig(vocab_size=262144, head_chunk=16384, **CFG), device='cpu')
    tp = to_torch(jp)
    ids = np.random.default_rng(3).integers(0, 262144, (2, 64)).astype(np.int32)
    jl, _ = jax.jit(jm.loss)(jp, jnp.asarray(ids), jnp.asarray(ids))
    w = tp['embed']['weight'].requires_grad_(True)
    tl, mets = tm.loss(tp, torch.from_numpy(ids), torch.from_numpy(ids))
    assert abs(float(tl.detach()) - np.log(262144)) < 0.5
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    (gw,) = torch.autograd.grad(tl, [w])
    assert float(gw.norm()) > 0 and mets['preds'].shape == (2, 64)


@pytest.fixture(scope='module')
def adaptive():
    """JAX and port TF-XL with adaptive_cutoffs (1000,) over the degree
    vocab, with cluster parameters drawn with numpy."""
    vocab = JTok(pitch_kind='degree').vocab_size
    cfg = dict(CFG, vocab_size=vocab, adaptive_cutoffs=(1000,))
    jm = JModel(JConfig(**cfg))
    jp = perturb(jm.init(jax.random.PRNGKey(4)), 5)
    jp['adaptive'] = dict(cluster_w=jnp.asarray(randn(6, 1, cfg['d_model'], scale=0.3)),
                          cluster_b=jnp.asarray(randn(7, 1, scale=0.5)))
    tm = TransfoXL(TransfoXLConfig(**cfg), device='cpu')
    assert {k: v.shape for k, v in tm.init_flat(0).items()} == \
        {k: np.shape(v) for k, v in jckpt._flatten(jp).items()}
    return jm, jp, tm, to_torch(jp)


def test_adaptive_log_probs_equal_jax(adaptive):
    """forward's adaptive log-probs equal JAX's, and each position's
    log-probs sum to 1 in probability."""
    jm, jp, tm, tp = adaptive
    ids = np.random.default_rng(10).integers(0, tm.cfg.vocab_size, (2, 40)).astype(np.int32)
    want, _, _ = jax.jit(jm.forward)(jp, jnp.asarray(ids))
    got, _, _ = tm.forward(tp, torch.from_numpy(ids))
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=1e-4, atol=1e-4)
    assert float(torch.logsumexp(got, -1).abs().max()) < 1e-5
    lab = ids.copy()
    jl, _ = jax.jit(jm.loss)(jp, jnp.asarray(ids), jnp.asarray(lab))
    tl, _ = tm.loss(tp, torch.from_numpy(ids), torch.from_numpy(lab))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


def test_adaptive_decode_steps_equal_jax(adaptive):
    """decode_step scores through the adaptive head too: step by step
    against JAX's decode (past the ring's wrap), and against the port's own
    forward while the prefix fits the ring."""
    jm, jp, tm, tp = adaptive
    ids = np.random.default_rng(11).integers(0, tm.cfg.vocab_size, (2, 20)).astype(np.int32)
    js, ts = jm.init_decode_state(2), tm.init_decode_state(2)
    step = jax.jit(jm.decode_step)
    full, _, _ = tm.forward(tp, torch.from_numpy(ids))
    for t in range(20):
        jl, js = step(jp, jnp.asarray(ids[:, t]), js)
        tl, ts = tm.decode_step(tp, torch.from_numpy(ids[:, t]), ts)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
        if t < tm.cfg.mem_len:
            np.testing.assert_allclose(tl.numpy(), full[:, t].numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('knob', [dict(head_chunk=256), dict(adaptive_cutoffs=(1000,))])
def test_load_trained_keeps_head_knobs(knob, adaptive, tmp_path):
    """A run directory written by the JAX package with head_chunk or
    adaptive_cutoffs loads into a model with the same knob, scoring as
    the JAX model does."""
    jm, jp, _, _ = adaptive
    cfg = dataclasses.replace(jm.cfg, **{'adaptive_cutoffs': None, **knob})
    jmk = JModel(cfg)
    params = jp if cfg.adaptive_cutoffs else {k: v for k, v in jp.items() if k != 'adaptive'}
    jckpt.save_pytree(str(tmp_path / 'trained'), params)
    tok = JTok(pitch_kind='degree', model_max_length=cfg.max_length)
    jckpt.save_meta(str(tmp_path / 'meta.json'), dict(
        model_name='transf-xl', config=asdict_config(cfg),
        tokenizer=describe_tokenizer(tok, str(tmp_path))))
    model, tp, _ = load_trained(str(tmp_path), device='cpu')
    assert model.cfg.head_chunk == cfg.head_chunk
    assert model.cfg.adaptive_cutoffs == cfg.adaptive_cutoffs
    ids = np.random.default_rng(12).integers(0, cfg.vocab_size, (1, 24)).astype(np.int32)
    want, _ = jax.jit(jmk.loss)(params, jnp.asarray(ids), jnp.asarray(ids))
    got, _ = model.loss(tp, torch.from_numpy(ids), torch.from_numpy(ids))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
