"""HF TransfoXLLMHeadModel <-> the port's TF-XL (A.7), f32 on the CPU at a
small width: the counterparts of tests/test_hf_parity.py (log-prob parity
with HF for three head layouts, the `same_length` window, memory across two
segments, the export round trip, the untied-head refusal, decode against
forward, an imported checkpoint that generates and renders), the port's
import against the JAX package's leaf for leaf and its logits against the
JAX model's, and imported parameters through the port's entry points
(`Trainer.train_step`, `score_batch`, `load_trained`).  HF models are
random-init under `torch.manual_seed`; token ids come from numpy seeds."""
import dataclasses
import types

import numpy as np
import pytest
import torch

transformers = pytest.importorskip('transformers')
import jax
import jax.numpy as jnp
from transformers import TransfoXLConfig as HFConfig
from transformers import TransfoXLLMHeadModel

from musicnlp_tpu.models.transformer_xl import TransfoXL as JModel
from musicnlp_tpu.utils import hf_import as jhf
from musicnlp_tpu_torch.models.transformer_xl import TransfoXL, TransfoXLConfig
from musicnlp_tpu_torch.trainer import train as ttrain
from musicnlp_tpu_torch.trainer.eval import MusicGenerator, load_trained, score_batch
from musicnlp_tpu_torch.trainer.metrics import IkrMetric
from musicnlp_tpu_torch.utils import checkpoint as tckpt
from musicnlp_tpu_torch.utils.hf_import import from_hf_transfo_xl, to_hf_transfo_xl
from musicnlp_tpu_torch.vocab import MusicTokenizer
from tests.torch_parity import np_of

# HF's and the port's f32 log-probs: the same arithmetic in other orders
# over two layers (the JAX package's own HF tests hold 2e-4 / 3e-4)
HF_TOL = dict(rtol=2e-4, atol=2e-4)
HF_WINDOW_TOL = dict(rtol=3e-4, atol=3e-4)
JAX_REL = 1e-4                 # port vs JAX logits, of their largest entry


@pytest.fixture(scope='module', autouse=True)
def _type_as_shim():
    """transformers 4.57's deprecated TransfoXL calls `.type_as(dtype=...)`
    (invalid since torch 2.x): shimmed for this module only."""
    orig = torch.Tensor.type_as

    def _type_as(self, other=None, dtype=None):
        return self.to(dtype if dtype is not None else other.dtype)

    torch.Tensor.type_as = _type_as
    yield
    torch.Tensor.type_as = orig


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny models run faster on one thread, and several test workers on one
    machine would otherwise oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hf_model(vocab=120, cutoffs=(), mem_len=16, same_length=True, seed=0):
    cfg = HFConfig(vocab_size=vocab, d_model=32, d_embed=32, n_head=4, d_head=8, d_inner=64,
                   n_layer=2, mem_len=mem_len, clamp_len=64, cutoffs=list(cutoffs), div_val=1,
                   dropout=0.0, dropatt=0.0, untie_r=True, same_length=same_length)
    torch.manual_seed(seed)
    model = TransfoXLLMHeadModel(cfg).eval()
    with torch.no_grad():            # non-zero biases, so the r_w / r_r terms count
        for layer in model.transformer.layers:
            layer.dec_attn.r_w_bias.normal_(0, 0.1)
            layer.dec_attn.r_r_bias.normal_(0, 0.1)
        if len(cutoffs):
            model.crit.cluster_weight.normal_(0, 0.1)
            model.crit.cluster_bias.normal_(0, 0.1)
    return model


def _ids(seed, B, T, V=120):
    return np.random.default_rng(seed).integers(0, V, (B, T)).astype(np.int64)


def _hf_scores(hf, ids, mems=None):
    with torch.no_grad():
        return hf(input_ids=torch.from_numpy(ids), mems=mems)


def _port_logprobs(cfg, params, ids, mems=None, mem_valid=0):
    model = TransfoXL(cfg, device='cpu')
    with torch.no_grad():
        logits, _, _ = model.forward(tckpt.params_from_jax(params, 'cpu'),
                                     torch.from_numpy(ids), mems=mems, mem_valid=mem_valid)
    return (logits if cfg.adaptive_cutoffs else torch.log_softmax(logits, -1)).numpy()


@pytest.mark.parametrize('cutoffs', [(), (48,), (32, 80)])
def test_import_logprob_parity(cutoffs):
    """HF's prediction scores (log-probs) == the imported model's, full
    causal attention (same_length False, no memory)."""
    hf = _hf_model(cutoffs=cutoffs, mem_len=0, same_length=False)
    cfg, params = from_hf_transfo_xl(hf, max_length=64, dtype='float32')
    assert cfg.attn_window is None and cfg.model_size == 'hf-import'
    assert cfg.adaptive_cutoffs == (tuple(cutoffs) or None)
    ids = _ids(1, 2, 24)
    want = _hf_scores(hf, ids).prediction_scores.numpy()
    np.testing.assert_allclose(_port_logprobs(cfg, params, ids), want, **HF_TOL)


def test_import_same_length_window_parity():
    """HF's default same_length=True on a fresh batch: a mem_len-wide window
    with HF's zero memories visible to early queries -- zero mems with
    mem_valid = mem_len on the port."""
    M = 16
    hf = _hf_model(cutoffs=(48,), mem_len=M, same_length=True, seed=5)
    cfg, params = from_hf_transfo_xl(hf, max_length=64, dtype='float32')
    assert cfg.attn_window == M
    ids = _ids(7, 2, 24)
    want = _hf_scores(hf, ids).prediction_scores.numpy()
    zero = torch.zeros(cfg.n_layer, 2, M, cfg.d_model)
    np.testing.assert_allclose(_port_logprobs(cfg, params, ids, zero, M), want,
                               **HF_WINDOW_TOL)


def test_import_memory_parity():
    """Second-segment scores with the first segment's memories: the window
    carries across the boundary."""
    M = 16
    hf = _hf_model(cutoffs=(48,), mem_len=M, same_length=True, seed=3)
    cfg, params = from_hf_transfo_xl(hf, max_length=64, dtype='float32')
    seg1, seg2 = _ids(2, 2, M), _ids(12, 2, 12)
    out1 = _hf_scores(hf, seg1)
    want = _hf_scores(hf, seg2, mems=out1.mems).prediction_scores.numpy()
    # HF mems: [mlen, bsz, d] per layer, layer i's input hiddens
    mems = torch.stack([m.permute(1, 0, 2) for m in out1.mems[:cfg.n_layer]])
    np.testing.assert_allclose(_port_logprobs(cfg, params, seg2, mems, M), want,
                               **HF_WINDOW_TOL)


def test_export_roundtrip():
    """The port's seeded TF-XL -> HF -> HF's scores == the port's (with HF's
    zero memories of a fresh batch); the import of the export gives the
    parameters back."""
    cfg = TransfoXLConfig.from_size('debug', vocab_size=90, max_length=32, dtype='float32',
                                    dropout=0.0)
    model = TransfoXL(cfg, device='cpu')
    flat = model.init_flat(5)
    flat['layers/0/attn/r_w_bias'] = np.random.default_rng(6).standard_normal(
        (cfg.n_head, cfg.d_head)).astype(np.float32) * 0.1
    params = tckpt.params_from_jax(flat, 'cpu')
    hf = to_hf_transfo_xl(cfg, params).eval()
    assert hf.config.same_length is False
    ids = _ids(4, 2, 16, 90)
    want = _hf_scores(hf, ids).prediction_scores.numpy()
    zero = torch.zeros(cfg.n_layer, 2, cfg.mem_len, cfg.d_model)
    got = _port_logprobs(cfg, flat, ids, zero, cfg.mem_len)
    np.testing.assert_allclose(got, want, **HF_TOL)
    _, back = from_hf_transfo_xl(hf)
    back = tckpt.flatten(back)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_export_refuses_a_window_hf_cannot_express():
    cfg = TransfoXLConfig.from_size('debug', vocab_size=90, attn_window=8)
    with pytest.raises(NotImplementedError, match='same_length'):
        to_hf_transfo_xl(cfg, {})


@pytest.mark.parametrize('layout', ['untied', 'div_val', 'd_embed'])
def test_import_refusals(layout):
    """What the port's tied dense / adaptive head cannot express raises, as
    in the JAX package: an untied output embedding, div_val != 1, a
    projected embedding."""
    hf = _hf_model(cutoffs=(), mem_len=0, seed=9)
    hc = hf.config
    if layout == 'untied':
        with torch.no_grad():
            hf.crit.out_layers[0].weight = torch.nn.Parameter(
                torch.randn_like(hf.crit.out_layers[0].weight))
    else:
        hc = types.SimpleNamespace(**hc.to_dict())
        setattr(hc, layout, 2 if layout == 'div_val' else 16)
    for fn in (from_hf_transfo_xl, jhf.from_hf_transfo_xl):
        with pytest.raises(NotImplementedError):
            fn(hf, hf_config=hc)


def test_imported_decode_matches_forward():
    """The KV-ring decode keeps the imported window: decode logits == forward
    logits on the same prefix."""
    hf = _hf_model(cutoffs=(48,), mem_len=8, same_length=True, seed=11)
    cfg, params = from_hf_transfo_xl(hf, max_length=32, dtype='float32')
    model = TransfoXL(cfg, device='cpu')
    tp = tckpt.params_from_jax(params, 'cpu')
    ids = torch.from_numpy(_ids(3, 2, 8))
    st, outs = model.init_decode_state(2), []
    with torch.no_grad():
        for t in range(8):
            lg, st = model.decode_step(tp, ids[:, t], st)
            outs.append(lg)
        fwd, _, _ = model.forward(tp, ids)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), fwd.numpy(), **HF_WINDOW_TOL)


def test_state_dict_and_namespace_import_equal_model_import():
    """A state dict of numpy arrays with a plain namespace of HF's attribute
    names (how a checkpoint arrives where `transformers` is absent) imports
    as the model does."""
    hf = _hf_model(cutoffs=(48,), mem_len=16, seed=13)
    cfg, params = from_hf_transfo_xl(hf, max_length=64)
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    ns = types.SimpleNamespace(**hf.config.to_dict())
    cfg2, params2 = from_hf_transfo_xl(sd, hf_config=ns, max_length=64)
    assert cfg2 == cfg
    a, b = tckpt.flatten(params), tckpt.flatten(params2)
    assert set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError, match='hf_config'):
        from_hf_transfo_xl(sd)


@pytest.mark.parametrize('same_length,cutoffs', [(True, (48,)), (False, ())])
def test_import_equals_jax_leaf_for_leaf(same_length, cutoffs):
    """The port's parameters and config == the JAX package's import, and the
    port's logits == the JAX model's within JAX_REL of their largest entry."""
    hf = _hf_model(cutoffs=cutoffs, mem_len=16, same_length=same_length, seed=17)
    cfg, params = from_hf_transfo_xl(hf, max_length=64, dtype='float32')
    jcfg, jparams = jhf.from_hf_transfo_xl(hf, max_length=64, dtype='float32')
    got, want = tckpt.flatten(params), tckpt.flatten(jparams)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == np.shape(want[k]), k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jd = dataclasses.asdict(jcfg)
    assert {k: jd[k] for k in dataclasses.asdict(cfg)} == dataclasses.asdict(cfg)
    ids = _ids(19, 2, 32)
    mems = np.random.default_rng(20).standard_normal(
        (cfg.n_layer, 2, cfg.mem_len, cfg.d_model)).astype(np.float32)
    jl, _, _ = jax.jit(JModel(jcfg).forward)(jax.tree.map(jnp.asarray, jparams),
                                             jnp.asarray(ids), jnp.asarray(mems), 16)
    with torch.no_grad():
        tl, _, _ = TransfoXL(cfg, device='cpu').forward(
            tckpt.params_from_jax(params, 'cpu'), torch.from_numpy(ids),
            mems=torch.from_numpy(mems), mem_valid=16)
    jl = np_of(jl)
    assert np.abs(tl.numpy() - jl).max() <= JAX_REL * np.abs(jl).max()


def test_imported_params_train_score_and_reload(tmp_path):
    """Imported parameters go through the entry points as native ones do:
    `Trainer.train_step` (dropout on, the window and the adaptive head),
    `score_batch`, and a run directory that `load_trained` reads back into
    the same hf-import config (remat_attn included) and logits."""
    tok = MusicTokenizer(pitch_kind='degree', model_max_length=32)
    hc = HFConfig(vocab_size=tok.vocab_size, d_model=32, d_embed=32, n_head=4, d_head=8,
                  d_inner=64, n_layer=2, mem_len=16, clamp_len=64, cutoffs=[64], div_val=1,
                  dropout=0.1, dropatt=0.0, untie_r=True)
    torch.manual_seed(23)
    cfg, params = from_hf_transfo_xl(TransfoXLLMHeadModel(hc), max_length=32,
                                     dtype='float32', remat_attn=True)
    model = TransfoXL(cfg, device='cpu')
    tp = tckpt.params_from_jax(params, 'cpu')
    ids = torch.from_numpy(_ids(21, 2, 32, tok.vocab_size))
    trainer = ttrain.Trainer(model, tok, np.zeros((4, 32)), out_dir=str(tmp_path / 'run'),
                             args=ttrain.TrainArgs(batch_size=2, learning_rate=1e-3,
                                                   lr_scheduler_type='constant'))
    for t in tckpt.flatten(tp).values():
        t.requires_grad_(True)
    before = tp['adaptive']['cluster_w'].detach().clone()
    mets = trainer.train_step(tp, trainer.opt.init(tp), dict(
        input_ids=ids, labels=ids, key_scores=torch.zeros(2, 24)))
    assert np.isfinite(float(mets['loss'])) and float(mets['grad_norm']) > 0
    assert not torch.equal(tp['adaptive']['cluster_w'], before)
    sc = score_batch(model, tp, ids, ids, IkrMetric(tok), torch.zeros(2, 24))
    assert np.isfinite(float(sc['loss']))

    run = tmp_path / 'saved'
    tckpt.save_pytree(str(run / 'trained'), tp)
    tckpt.save_meta(str(run / 'meta.json'), dict(
        model_name='transf-xl', config=dataclasses.asdict(cfg),
        tokenizer=ttrain.describe_tokenizer(tok, str(run))))
    m2, p2, _ = load_trained(str(run), device='cpu')
    assert m2.cfg == cfg and m2.cfg.model_size == 'hf-import' and m2.cfg.remat_attn
    assert m2.cfg.attn_window == 16 and m2.cfg.adaptive_cutoffs == (64,)
    with torch.no_grad():
        a, _, _ = model.forward(tp, ids)
        b, _, _ = m2.forward(p2, ids)
    assert torch.equal(a, b)


def test_imported_checkpoint_generates(tmp_path):
    """An HF checkpoint at the music vocab size, imported, generates through
    `MusicGenerator` (the windowed KV ring, the adaptive head) to rendered
    MIDI and MusicXML files."""
    tok = MusicTokenizer(pitch_kind='degree')
    hc = HFConfig(vocab_size=tok.vocab_size, d_model=32, d_embed=32, n_head=4, d_head=8,
                  d_inner=64, n_layer=2, mem_len=32, clamp_len=64, cutoffs=[64], div_val=1,
                  dropout=0.0, dropatt=0.0, untie_r=True)
    torch.manual_seed(21)
    cfg, params = from_hf_transfo_xl(TransfoXLLMHeadModel(hc).eval(), max_length=64,
                                     dtype='float32')
    gen = MusicGenerator(TransfoXL(cfg, device='cpu'), tok,
                         tckpt.params_from_jax(params, 'cpu'), out_dir=str(tmp_path))
    outs = gen(mode='unconditional', strategy='sample', n_song=2, max_length=48, top_k=8,
               seed=3)
    assert len(outs) == 2
    for o in outs:
        assert o['midi'] and o['text']
