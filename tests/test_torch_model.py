"""The slice as a whole, port vs JAX at a small width (f32 on the CPU):
TF-XL forward / loss / metrics, decode, generation, checkpoints."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicnlp_tpu.models.transformer_xl import TransfoXL as JModel, TransfoXLConfig as JConfig
from musicnlp_tpu.ops import losses as jlosses
from musicnlp_tpu.ops import sampling as jsamp
from musicnlp_tpu.trainer import metrics as jmetrics
from musicnlp_tpu.trainer.eval import MusicGenerator as JGen
from musicnlp_tpu.trainer.train import asdict_config, describe_tokenizer
from musicnlp_tpu.utils import checkpoint as jckpt
from musicnlp_tpu.vocab import MusicTokenizer as JTok, key_inkey_mask as _jv_inkey_mask
from musicnlp_tpu_torch.models.transformer_xl import TransfoXL, TransfoXLConfig
from musicnlp_tpu_torch.ops import losses as tlosses
from musicnlp_tpu_torch.ops import sampling as tsamp
from musicnlp_tpu_torch.trainer import metrics as tmetrics
from musicnlp_tpu_torch.trainer.eval import MusicGenerator, load_trained, score_batch
from musicnlp_tpu_torch.utils import checkpoint as tckpt
from musicnlp_tpu_torch.vocab import MusicTokenizer
from tests.torch_parity import np_of, perturb, randn, to_torch

# f32 logits of a 4-layer model; the two packages sum in other orders
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)

CFG = dict(model_size='test', d_model=128, n_head=4, d_head=32, d_inner=256, n_layer=4,
           mem_len=32, clamp_len=48, max_length=96, dropout=0.1, dtype='float32')


@pytest.fixture(scope='module')
def pair():
    """(JAX model, JAX params, port model, port params) on the degree vocab."""
    vocab = JTok(pitch_kind='degree').vocab_size
    jm = JModel(JConfig(vocab_size=vocab, **CFG))
    jp = perturb(jm.init(jax.random.PRNGKey(0)), 1)
    tm = TransfoXL(TransfoXLConfig(vocab_size=vocab, **CFG), device='cpu')
    return jm, jp, tm, to_torch(jp)


def _ids(seed, B, T, V):
    return np.random.default_rng(seed).integers(0, V, (B, T)).astype(np.int32)


def test_config_presets_match():
    for size in ('debug', 'tiny', 'small', 'base', 'large'):
        a = JConfig.from_size(size, vocab_size=1190, max_length=1024, mem_len=512)
        b = TransfoXLConfig.from_size(size, vocab_size=1190, max_length=1024, mem_len=512)
        ja, tb = dataclasses.asdict(a), dataclasses.asdict(b)
        assert tb == {k: ja[k] for k in tb}


def test_forward_no_memory(pair):
    jm, jp, tm, tp = pair
    ids = _ids(1, 2, 64, tm.cfg.vocab_size)
    want, _, _ = jm.forward(jp, jnp.asarray(ids))
    got, _, _ = tm.forward(tp, torch.from_numpy(ids))
    np.testing.assert_allclose(np_of(got), np_of(want), **LOGIT_TOL)


def test_forward_with_memory(pair):
    jm, jp, tm, tp = pair
    ids = _ids(2, 2, 48, tm.cfg.vocab_size)
    jmems, jvalid = jm.init_mems(2)
    tmems, tvalid = tm.init_mems(2)
    for s in (slice(0, 24), slice(24, 48)):
        want, jmems, jvalid = jm.forward(jp, jnp.asarray(ids[:, s]), mems=jmems, mem_valid=jvalid)
        got, tmems, tvalid = tm.forward(tp, torch.from_numpy(ids[:, s]), mems=tmems,
                                        mem_valid=tvalid)
        np.testing.assert_allclose(np_of(got), np_of(want), **LOGIT_TOL)
        np.testing.assert_allclose(np_of(tmems), np_of(jmems), **LOGIT_TOL)
        assert int(tvalid) == int(jvalid)


@pytest.mark.parametrize('mode', ['vanilla', 'ins-key'])
def test_loss_and_metrics(pair, mode):
    """score_batch (loss, NTP accuracy, IKR) == the JAX Trainer's eval step."""
    jm, jp, tm, tp = pair
    ids = _ids(3, 3, 64, tm.cfg.vocab_size)
    labels = ids.copy()
    labels[1, 40:] = jlosses.PT_LOSS_PAD
    key_scores = np.random.default_rng(4).random((3, 24)).astype(np.float32)
    jtok, ttok = JTok(pitch_kind='degree'), MusicTokenizer(pitch_kind='degree')

    loss, mets = jm.loss(jp, jnp.asarray(ids), jnp.asarray(labels))
    jikr = jmetrics.IkrMetric(jtok, mode=mode)
    want_ikr = jikr(np.asarray(mets['preds']), labels, key_scores)
    got = score_batch(tm, tp, torch.from_numpy(ids), torch.from_numpy(labels),
                      tmetrics.IkrMetric(ttok, mode=mode), torch.from_numpy(key_scores))
    np.testing.assert_allclose(float(got['loss']), float(loss), rtol=1e-5)
    assert float(got['ntp_acc']) == pytest.approx(float(mets['ntp_acc']), abs=1e-6)
    assert float(got['n_tok']) == float(mets['n_tok'])
    np.testing.assert_allclose(float(got['ikr']), want_ikr, rtol=1e-5)


def test_losses_and_compute_metrics_direct():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 16, 422)).astype(np.float32)
    labels = rng.integers(0, 422, (2, 16)).astype(np.int32)
    labels[0, 9:] = -100
    jl_, jn = jlosses.shifted_ce_loss(jnp.asarray(logits), jnp.asarray(labels))
    tl_, tn = tlosses.shifted_ce_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(tl_), float(jl_), rtol=1e-6)
    assert float(tn) == float(jn)
    assert float(tlosses.ntp_accuracy(torch.from_numpy(logits), torch.from_numpy(labels))) == \
        pytest.approx(float(jlosses.ntp_accuracy(jnp.asarray(logits), jnp.asarray(labels))))
    preds = logits.argmax(-1)
    ks = rng.random((2, 24)).astype(np.float32)
    vocab = JTok(pitch_kind='degree').vocab
    pc, mask = np.asarray(vocab.id_pitch_class_table, np.int32), np.asarray(_jv_inkey_mask)
    ids = rng.integers(0, len(pc), (3, 40)).astype(np.int32)
    valid = rng.random((3, 40)) > 0.2
    ko = np.array([0, 7, 23], np.int32)
    for kw in (dict(), dict(valid=valid), dict(valid=valid, key_ordinal=ko)):
        want = float(jlosses.ikr_from_ids(jnp.asarray(ids), jnp.asarray(ks[:1].repeat(3, 0)),
                                          jnp.asarray(pc), jnp.asarray(mask),
                                          **{k: jnp.asarray(v) for k, v in kw.items()}))
        got = float(tlosses.ikr_from_ids(torch.from_numpy(ids), torch.from_numpy(ks[:1].repeat(3, 0)),
                                         torch.from_numpy(pc), torch.from_numpy(mask),
                                         **{k: torch.from_numpy(v) for k, v in kw.items()}))
        assert got == pytest.approx(want, rel=1e-6), kw
    for mode in ('vanilla', 'ins-key'):
        a = jmetrics.ComputeMetrics(JTok(pitch_kind='midi'), mode=mode)(preds, labels, ks)
        b = tmetrics.ComputeMetrics(MusicTokenizer(pitch_kind='midi'), mode=mode)(preds, labels, ks)
        assert b['ntp_acc'] == pytest.approx(a['ntp_acc'], abs=1e-6)
        assert b['ikr'] == pytest.approx(a['ikr'], rel=1e-5, abs=1e-7)


# ------------------------------------------------------------------ decode
def test_decode_matches_forward(pair):
    """KV ring-cache decode == the full forward (prefix < mem_len)."""
    _, _, tm, tp = pair
    ids = torch.from_numpy(_ids(6, 2, 24, tm.cfg.vocab_size))
    logits, _, _ = tm.forward(tp, ids)
    st = tm.init_decode_state(2)
    outs = []
    for t in range(24):
        lg, st = tm.decode_step(tp, ids[:, t], st)
        outs.append(lg)
    dec = torch.stack(outs, 1)
    np.testing.assert_allclose(dec.numpy(), logits.numpy(), **LOGIT_TOL)
    assert torch.equal(dec.argmax(-1), logits.argmax(-1))


def test_decode_window_matches_forward():
    """With attn_window = mem_len the ring decode equals forward() past the
    wrap, exactly the windowed attention it implements."""
    cfg = TransfoXLConfig(vocab_size=200, **{**CFG, 'mem_len': 16, 'attn_window': 16})
    tm = TransfoXL(cfg, device='cpu')
    tp = tm.init(seed=3)
    ids = torch.from_numpy(_ids(7, 2, 40, 200))
    logits, _, _ = tm.forward(tp, ids)
    st = tm.init_decode_state(2)
    dec = []
    for t in range(40):
        lg, st = tm.decode_step(tp, ids[:, t], st)
        dec.append(lg)
    np.testing.assert_allclose(torch.stack(dec, 1).numpy(), logits.numpy(), **LOGIT_TOL)


@pytest.mark.parametrize('quant', [None, 'int8'])
def test_decode_steps_match_jax(pair, quant):
    """Port decode == JAX decode step by step, through the ring wrap."""
    jm, jp, tm, tp = pair
    jm = JModel(dataclasses.replace(jm.cfg, decode_cache_quant=quant))
    tm = TransfoXL(dataclasses.replace(tm.cfg, decode_cache_quant=quant), device='cpu')
    ids = _ids(8, 2, 40, tm.cfg.vocab_size)                 # 40 > mem_len = 32
    js, ts = jm.init_decode_state(2), tm.init_decode_state(2)
    step = jax.jit(jm.decode_step)
    for t in range(40):
        jl_, js = step(jp, jnp.asarray(ids[:, t]), js)
        tl_, ts = tm.decode_step(tp, torch.from_numpy(ids[:, t]), ts)
        # int8: a row scale that rounds a hair differently moves one code
        tol = LOGIT_TOL if quant is None else dict(rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(tl_.numpy(), np.asarray(jl_), **tol, err_msg=f'step {t}')
    if quant:
        assert ts.cache_k.dtype == torch.int8
        ex = TransfoXL.expand_decode_state(ts, 2)
        assert ex.k_scale.shape[1] == 4
        sel = TransfoXL.select_decode_state(ex, torch.tensor([0, 3]))
        assert sel.v_scale.shape[1] == 2


def test_decode_ring_wraps(pair):
    _, _, tm, tp = pair
    st = tm.init_decode_state(1)
    tok = torch.zeros(1, dtype=torch.int64)
    for _ in range(tm.cfg.mem_len + 8):
        lg, st = tm.decode_step(tp, tok, st)
        tok = lg.argmax(-1)
    assert st.step == tm.cfg.mem_len + 8
    assert bool((st.cache_pos >= 0).all())


# --------------------------------------------------------------- sampling
@pytest.mark.parametrize('cfg', [
    dict(top_k=8), dict(top_p=0.9), dict(typical_p=0.5), dict(temperature=0.7, top_k=20),
    dict(repetition_penalty=1.3, top_p=0.8),
])
def test_process_logits_matches_jax(cfg):
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((4, 300)).astype(np.float32) * 3
    counts = rng.integers(0, 2, (4, 300)).astype(np.int32)
    sc_j, sc_t = jsamp.SampleConfig(**cfg), tsamp.SampleConfig(**cfg)
    want = np.asarray(jsamp.process_logits(jnp.asarray(logits), sc_j, jnp.asarray(counts)))
    got = tsamp.process_logits(torch.from_numpy(logits), sc_t, torch.from_numpy(counts)).numpy()
    np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _prompts(V, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, V, (3, 6)).astype(np.int32)
    plen = np.array([6, 2, 4], np.int32)
    return ids, plen


@pytest.mark.parametrize('chunk', [None, 8])
def test_generate_scan_greedy_identical_to_jax(pair, chunk):
    jm, jp, tm, tp = pair
    ids, plen = _prompts(tm.cfg.vocab_size, 10)
    kw = dict(max_length=48, eos_id=3, pad_id=0, vocab_size=tm.cfg.vocab_size,
              early_exit_chunk=chunk)
    want, wl = jsamp.generate_scan(
        lambda t, s: jm.decode_step(jp, t, s), jm.init_decode_state(3), jnp.asarray(ids),
        jnp.asarray(plen), sample_cfg=jsamp.SampleConfig(strategy='greedy'), **kw)
    got, gl = tsamp.generate_scan(
        lambda t, s: tm.decode_step(tp, t, s), tm.init_decode_state(3), torch.from_numpy(ids),
        torch.from_numpy(plen), sample_cfg=tsamp.SampleConfig(strategy='greedy'), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))


def test_early_exit_is_bit_identical():
    """A model that always says eos: every song stops, the loop leaves early,
    and the output equals the full run, for greedy and for sampling."""
    V, eos = 50, 3

    def step(tok, state):
        calls.append(1)
        lg = torch.zeros(tok.shape[0], V)
        lg[:, eos] = 5.0
        return lg, state
    ids, plen = torch.tensor([[7, 8], [9, 0]]), torch.tensor([2, 1])
    for strat in ('greedy', 'sample'):
        outs = []
        for chunk in (None, 4):
            calls = []
            g = torch.Generator().manual_seed(0)
            outs.append(tsamp.generate_scan(
                step, None, ids, plen, max_length=40, eos_id=eos, pad_id=0, vocab_size=V,
                sample_cfg=tsamp.SampleConfig(strategy=strat, top_k=2), generator=g,
                early_exit_chunk=chunk))
            n_calls = len(calls)
        assert n_calls < 39
        for a, b in zip(*outs):
            assert torch.equal(a, b)


# ----------------------------------------------------------- MusicGenerator
@pytest.fixture(scope='module')
def gens():
    jt, tt = JTok(pitch_kind='midi', model_max_length=64), \
        MusicTokenizer(pitch_kind='midi', model_max_length=64)
    cfg = dict(CFG, d_model=64, n_head=2, d_head=32, d_inner=128, n_layer=2, mem_len=32,
               dropout=0.0, max_length=64)
    jm = JModel(JConfig(vocab_size=jt.vocab_size, **cfg))
    jp = perturb(jm.init(jax.random.PRNGKey(5)), 6)
    tm = TransfoXL(TransfoXLConfig(vocab_size=tt.vocab_size, **cfg), device='cpu')
    return JGen(jm, jt, jp), MusicGenerator(tm, tt, to_torch(jp))


def test_music_generator_greedy_identical(gens):
    jg, tg = gens
    prompts = [tg.unconditional_prompt(), tg.unconditional_prompt(time_sig=(3, 4), tempo=90)]
    assert prompts == [jg.unconditional_prompt(), jg.unconditional_prompt((3, 4), 90)]
    want = jg.generate(prompts, strategy='greedy', max_length=64, seed=0)
    got = tg.generate(prompts, strategy='greedy', max_length=64, seed=0)
    assert got == want


def test_music_generator_sample_valid_and_seeded(gens):
    _, tg = gens
    prompts = [tg.unconditional_prompt()] * 3
    a = tg.generate(prompts, strategy='sample', max_length=48, seed=11, top_k=8)
    b = tg.generate(prompts, strategy='sample', max_length=48, seed=11, top_k=8)
    assert a == b
    for text, p in zip(a, prompts):
        assert text.startswith(p) and len(text.split()) <= 48
        assert '[PAD]' not in text
        assert all(t in tg.vocab.tok2id for t in text.split())


# -------------------------------------------------------------- checkpoints
def test_checkpoint_both_ways(pair, tmp_path):
    jm, jp, tm, _ = pair
    ids = _ids(12, 1, 32, tm.cfg.vocab_size)
    want, _, _ = jm.forward(jp, jnp.asarray(ids))
    jckpt.save_pytree(str(tmp_path / 'from_jax'), jp)
    tp = tckpt.restore_pytree(str(tmp_path / 'from_jax'), device='cpu')
    got, _, _ = tm.forward(tp, torch.from_numpy(ids))
    np.testing.assert_allclose(np_of(got), np_of(want), **LOGIT_TOL)

    tckpt.save_pytree(str(tmp_path / 'from_torch'), tp)
    back = jckpt.restore_pytree(str(tmp_path / 'from_torch'), jm.init(jax.random.PRNGKey(1)))
    again, _, _ = jm.forward(back, jnp.asarray(ids))
    np.testing.assert_array_equal(np_of(again), np_of(want))


def test_load_trained_reads_a_jax_run(pair, tmp_path):
    jm, jp, _, _ = pair
    tok = JTok(pitch_kind='degree', model_max_length=96)
    jckpt.save_pytree(str(tmp_path / 'trained'), jp)
    jckpt.save_meta(str(tmp_path / 'meta.json'), dict(
        model_name='transf-xl', config=asdict_config(jm.cfg),
        tokenizer=describe_tokenizer(tok, str(tmp_path))))
    model, params, ttok = load_trained(str(tmp_path), device='cpu')
    assert ttok.vocab_size == tok.vocab_size and ttok.model_max_length == 96
    ids = _ids(13, 1, 20, tok.vocab_size)
    want, _, _ = jm.forward(jp, jnp.asarray(ids))
    got, _, _ = model.forward(params, torch.from_numpy(ids))
    np.testing.assert_allclose(np_of(got), np_of(want), **LOGIT_TOL)


def test_seeded_init_is_the_jax_layout(pair):
    jm, jp, tm, _ = pair
    flat = tm.init_flat(seed=0)
    want = {k: np.shape(v) for k, v in jckpt._flatten(jp).items()}
    assert {k: v.shape for k, v in flat.items()} == want
    assert all(v.dtype == np.float32 for v in flat.values())
    tp2 = tm.init(seed=0)
    assert torch.equal(tp2['layers'][1]['attn']['qkv'],
                       torch.from_numpy(flat['layers/1/attn/qkv']))


def _count_fused(monkeypatch):
    """Counts the layers that run through K1 / K2 (`fused_rel_attn`)."""
    from musicnlp_tpu_torch.models import transformer_xl as txl
    calls = []
    real = txl.fused_rel_attn
    monkeypatch.setattr(txl, 'fused_rel_attn', lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def test_attention_dropout_raises_until_k1_has_it(pair, monkeypatch):
    """K1/K2, like the TPU kernels, have no attention-probability dropout:
    with dropatt > 0 every layer runs the plain rel_attn, as the JAX model
    dispatches it, so a training forward draws the dropout there and never
    reaches K1 / K2, and scoring (deterministic) equals the JAX model's."""
    jm, jp, _, tp = pair
    cfg = dataclasses.replace(TransfoXLConfig(vocab_size=jm.cfg.vocab_size, **CFG), dropatt=0.1)
    tm = TransfoXL(cfg, device='cpu')
    calls = _count_fused(monkeypatch)
    ids = _ids(14, 1, 16, tm.cfg.vocab_size)
    a, _, _ = tm.forward(tp, torch.from_numpy(ids), generator=torch.Generator().manual_seed(0),
                         deterministic=False)
    b, _, _ = tm.forward(tp, torch.from_numpy(ids), generator=torch.Generator().manual_seed(1),
                         deterministic=False)
    assert not calls and torch.isfinite(a).all() and not torch.equal(a, b)
    loss, _ = tm.loss(tp, torch.from_numpy(ids), torch.from_numpy(ids),
                      generator=torch.Generator().manual_seed(0), deterministic=False)
    assert torch.isfinite(loss) and not calls
    got, _, _ = tm.forward(tp, torch.from_numpy(ids))
    want, _, _ = JModel(dataclasses.replace(jm.cfg, dropatt=0.1)).forward(jp, jnp.asarray(ids))
    np.testing.assert_allclose(np_of(got), np_of(want), **LOGIT_TOL)
    assert not calls
    TransfoXL(dataclasses.replace(cfg, dropatt=0.0), device='cpu').forward(
        tp, torch.from_numpy(ids))
    assert len(calls) == cfg.n_layer


@pytest.mark.parametrize('with_memory', [False, True])
def test_forward_with_attn_mask_matches_jax(pair, monkeypatch, with_memory):
    """forward(attn_mask=...) masks padded keys through the plain rel_attn
    in every layer, with and without memory, as the JAX model does."""
    jm, jp, tm, tp = pair
    calls = _count_fused(monkeypatch)
    ids = _ids(15, 2, 24, tm.cfg.vocab_size)
    mask = np.ones((2, 24), bool)
    mask[1, 17:] = False                                # a padded tail
    mask[0, 5] = False
    kw, jkw = {}, {}
    if with_memory:
        jmems, _ = jm.init_mems(2)
        jmems = jnp.asarray(randn(16, *jmems.shape))
        kw = dict(mems=torch.from_numpy(np.array(jmems)), mem_valid=20)
        jkw = dict(mems=jmems, mem_valid=20)
    want, jm_new, _ = jm.forward(jp, jnp.asarray(ids), attn_mask=jnp.asarray(mask), **jkw)
    got, tm_new, _ = tm.forward(tp, torch.from_numpy(ids), attn_mask=torch.from_numpy(mask), **kw)
    np.testing.assert_allclose(np_of(got), np_of(want), **LOGIT_TOL)
    if with_memory:
        np.testing.assert_allclose(np_of(tm_new), np_of(jm_new), **LOGIT_TOL)
    assert not calls
    plain, _, _ = tm.forward(tp, torch.from_numpy(ids), **kw)
    assert len(calls) == tm.cfg.n_layer
    assert not np.allclose(np_of(plain[1, :17]), np_of(got[1, :17]))   # row 0's hole at 5
