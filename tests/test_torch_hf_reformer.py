"""HF ReformerModelWithLMHead <-> the port's Reformer in its `hf_compat`
layout (A.7), f32 on the CPU at a small width: the counterparts of
tests/test_hf_reformer_parity.py (logit parity with HF inside one LSH chunk,
the export round trip, the imported model training with `remat`, exact and
incremental decode against forward), the port's import against the JAX
package's leaf for leaf, its loss and gradients against `jax.value_and_grad`,
contrastive search over the two-stream [B, 2 d] hidden against the JAX
package's tokens, and the import's refusals.

HF draws its LSH rotations from unseeded torch RNG, so parity with HF holds
where bucketing cannot matter: a sequence within one LSH chunk.  Local
layers are deterministic and are held across a chunk boundary."""
import dataclasses
import types

import numpy as np
import pytest
import torch

transformers = pytest.importorskip('transformers')
import jax
import jax.numpy as jnp
from transformers import ReformerConfig as HFConfig
from transformers import ReformerModelWithLMHead

from musicnlp_tpu.models.reformer import Reformer as JModel
from musicnlp_tpu.ops import sampling as jsamp
from musicnlp_tpu.utils import hf_import as jhf
from musicnlp_tpu.utils.checkpoint import _flatten as jflatten
from musicnlp_tpu_torch.models.reformer import Reformer, ReformerConfig
from musicnlp_tpu_torch.ops import sampling as tsamp
from musicnlp_tpu_torch.trainer import train as ttrain
from musicnlp_tpu_torch.utils import checkpoint as tckpt
from musicnlp_tpu_torch.utils.hf_import import from_hf_reformer, to_hf_reformer
from musicnlp_tpu_torch.vocab import MusicTokenizer
from tests.torch_parity import np_of

T = 16
HF_TOL = dict(rtol=3e-4, atol=3e-4)     # the JAX package's own HF tests' tolerance
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)  # port vs its own forward / JAX, f32
GRAD_REL = 1e-5                         # of each gradient's largest entry


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny models run faster on one thread, and several test workers on one
    machine would otherwise oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hf_config(attn_layers=('local', 'lsh', 'local'), **kw):
    return HFConfig(**dict(dict(
        vocab_size=100, hidden_size=64, num_attention_heads=2, attention_head_size=32,
        feed_forward_size=128, attn_layers=list(attn_layers), axial_pos_shape=[4, 4],
        axial_pos_embds_dim=[16, 48], max_position_embeddings=T,
        local_attn_chunk_length=8,      # 2 chunks: the look-back counts
        lsh_attn_chunk_length=16,       # 1 chunk: bucket-independent
        num_hashes=2, num_buckets=4, is_decoder=True, hidden_dropout_prob=0.0,
        local_attention_probs_dropout_prob=0.0, lsh_attention_probs_dropout_prob=0.0,
        hidden_act='relu'), **kw))


def _hf_model(seed=0, attn_layers=('local', 'lsh', 'local')):
    torch.manual_seed(seed)
    return ReformerModelWithLMHead(_hf_config(attn_layers)).eval()


def _ids(seed, B, n=T, V=100):
    return np.random.default_rng(seed).integers(0, V, (B, n)).astype(np.int64)


def _port(hf, **kw):
    cfg, params = from_hf_reformer(hf, dtype='float32', **kw)
    return Reformer(cfg, device='cpu'), tckpt.params_from_jax(params, 'cpu')


def test_import_logit_parity():
    hf = _hf_model()
    model, tp = _port(hf)
    assert model.cfg.hf_compat and model.cfg.attn_layers == ('local', 'lsh', 'local')
    assert model.cfg.ln_eps == 1e-12 and model.cfg.model_size == 'hf-import'
    ids = _ids(1, 2)
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids)).logits.numpy()
        got = model.forward(tp, torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, **HF_TOL)


def test_export_roundtrip():
    """The port's seeded hf_compat Reformer -> HF -> the same logits; the
    import of the export gives every leaf back but the local layers' unread
    'qk' (which the import sets to their query, as the JAX package does)."""
    cfg = ReformerConfig(vocab_size=80, model_size='test', d_model=64, n_head=2, d_head=32,
                         d_ff=128, attn_layers=('local', 'lsh'), max_length=T,
                         axial_pos_shape=(4, 4), local_chunk=8, lsh_chunk=16, n_hashes=1,
                         n_buckets=4, dropout=0.0, dtype='float32', hf_compat=True)
    model = Reformer(cfg, device='cpu')
    flat = model.init_flat(3)
    hf = to_hf_reformer(cfg, tckpt.params_from_jax(flat, 'cpu')).eval()
    ids = _ids(2, 2, V=80)
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids)).logits.numpy()
        got = model.forward(tckpt.params_from_jax(flat, 'cpu'), torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, **HF_TOL)
    cfg2, back = from_hf_reformer(hf, dtype='float32')
    assert dataclasses.replace(cfg2, model_size='test') == cfg
    back = tckpt.flatten(back)
    assert set(back) == set(flat)
    for k, v in flat.items():
        want = flat[k.replace('/qk', '/q')] if k == 'layers/0/attn/qk' else v
        np.testing.assert_array_equal(back[k], want, err_msg=k)


def test_import_equals_jax_leaf_for_leaf():
    hf = _hf_model(seed=4)
    cfg, params = from_hf_reformer(hf, dtype='float32')
    jcfg, jparams = jhf.from_hf_reformer(hf, dtype='float32')
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    got, want = tckpt.flatten(params), tckpt.flatten(jparams)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # a state dict of numpy arrays with a namespace of HF's names imports alike
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    cfg2, params2 = from_hf_reformer(sd, hf_config=types.SimpleNamespace(**hf.config.to_dict()),
                                     dtype='float32')
    assert cfg2 == cfg
    assert all(np.array_equal(tckpt.flatten(params2)[k], got[k]) for k in got)


def test_imported_model_trains_with_remat():
    """Loss and every gradient through the reversible stack with `remat`
    (dropout 0) == `jax.value_and_grad` of the JAX package's import, over
    two local chunks and one LSH chunk; the local layers' unread 'qk' gets a
    zero gradient in both."""
    hf = _hf_model(seed=7)
    cfg, params = from_hf_reformer(hf, dtype='float32', remat=True)
    jcfg, jparams = jhf.from_hf_reformer(hf, dtype='float32', remat=True)
    ids = _ids(5, 2)
    labels = np.where(ids % 7 == 0, -100, ids)
    jm = JModel(jcfg)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(ids, jnp.int32), jnp.asarray(labels, jnp.int32)),
        has_aux=True))(jax.tree.map(jnp.asarray, jparams))
    model = Reformer(cfg, device='cpu')
    tp = tckpt.params_from_jax(params, 'cpu')
    flat = tckpt.flatten(tp)
    for t in flat.values():
        t.requires_grad_(True)
    tl, _ = model.loss(tp, torch.from_numpy(ids), torch.from_numpy(labels))
    grads = torch.autograd.grad(tl, list(flat.values()), allow_unused=True)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert {k for k, g in zip(flat, grads) if g is None} == model.unread_leaves() == \
        {'layers/0/attn/qk', 'layers/2/attn/qk'}
    jflat = jflatten(jg)
    for key, g in zip(flat, grads):
        want = np_of(jflat[key])
        if g is None:
            assert not want.any(), key
            continue
        scale = max(float(np.abs(want).max()), 1e-12)
        assert float(np.abs(np_of(g) - want).max()) <= GRAD_REL * scale, key


def test_trainer_zero_fills_only_the_named_unread_leaves(tmp_path):
    """`Trainer.train_step` gives the leaves the model names as unread a
    zero gradient (so weight decay alone moves them) and refuses a leaf that
    the loss cannot reach and the model does not name."""
    model, tp = _port(_hf_model(seed=19, attn_layers=('local', 'lsh')))
    tok = MusicTokenizer(pitch_kind='midi', model_max_length=T)
    trainer = ttrain.Trainer(model, tok, np.zeros((2, T)), out_dir=str(tmp_path / 'run'),
                             args=ttrain.TrainArgs(batch_size=2, learning_rate=1e-3,
                                                   lr_scheduler_type='constant'))
    ids = torch.from_numpy(_ids(21, 2))
    batch = dict(input_ids=ids, labels=ids, key_scores=torch.zeros(2, 24))
    for t in tckpt.flatten(tp).values():
        t.requires_grad_(True)
    qk, q = (tp['layers'][0]['attn'][k].detach().clone() for k in ('qk', 'q'))
    mets = trainer.train_step(tp, trainer.opt.init(tp), batch)
    assert np.isfinite(float(mets['loss']))
    assert not torch.equal(tp['layers'][0]['attn']['q'], q)
    lr = float(np.float32(trainer.lr_sched(0)))
    assert torch.equal(tp['layers'][0]['attn']['qk'].detach(),
                       qk + (trainer.args.weight_decay * qk) * -lr)

    tp['stray'] = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match='stray'):
        trainer.train_step(tp, trainer.opt.init(tp), batch)


@pytest.mark.parametrize('mode', ['exact', 'incremental'])
def test_decode_matches_forward(mode):
    """Imported checkpoints decode through `decode_step_exact` and through the
    incremental step (which carries both streams) == forward on the padded
    prefix, within the first chunk."""
    hf = _hf_model(seed=9 if mode == 'exact' else 13, attn_layers=('local', 'lsh'))
    model, tp = _port(hf)
    ids = torch.from_numpy(_ids(6, 2, 6))
    st = model.init_decode_state_exact(2) if mode == 'exact' else model.init_decode_state(2)
    step = model.decode_step_exact if mode == 'exact' else model.decode_step
    outs = []
    with torch.no_grad():
        for t in range(6):
            lg, st = step(tp, ids[:, t], st)
            outs.append(lg)
        buf = torch.cat([ids, torch.zeros(2, T - 6, dtype=ids.dtype)], 1)
        fwd = model.forward(tp, buf, pad_mask=torch.arange(T).expand(2, T) < 6)[:, :6]
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), fwd.numpy(), **LOGIT_TOL)


def test_contrastive_search_over_both_streams():
    """The hidden of decode_step_with_hidden is the final norm's [B, 2 d]
    output, and contrastive search over it picks the JAX package's tokens."""
    hf = _hf_model(seed=15, attn_layers=('local', 'lsh'))
    model, tp = _port(hf)
    jcfg, jparams = jhf.from_hf_reformer(hf, dtype='float32')
    jm, jp = JModel(jcfg), jax.tree.map(jnp.asarray, jparams)
    assert model.hidden_dim == 2 * model.cfg.d_model == jm.hidden_dim
    st = model.init_decode_state(2)
    _, h, _ = model.decode_step_with_hidden(tp, torch.tensor([1, 2]), st)
    assert h.shape == (2, 2 * model.cfg.d_model)
    ids = _ids(8, 2, 3)
    plen = np.array([3, 2])
    kw = dict(max_length=T, eos_id=3, pad_id=0, top_k=4, penalty_alpha=0.6,
              d_model=model.hidden_dim)
    want, wl = jsamp.contrastive_generate(
        lambda t, s: jm.decode_step_with_hidden(jp, t, s), jm.init_decode_state(2),
        jnp.asarray(ids, jnp.int32), jnp.asarray(plen), expand_state=jm.expand_decode_state,
        select_state=jm.select_decode_state, **kw)
    with torch.no_grad():
        got, gl = tsamp.contrastive_generate(
            lambda t, s: model.decode_step_with_hidden(tp, t, s), model.init_decode_state(2),
            torch.from_numpy(ids), torch.from_numpy(plen), expand_state=model.expand_decode_state,
            hidden_dtype=model.cfg.compute_dtype, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))


@pytest.mark.parametrize('field,value', [
    ('hidden_act', 'gelu'), ('num_buckets', [2, 2]), ('lsh_num_chunks_before', 2),
    ('local_num_chunks_after', 1), ('axial_pos_embds_dim', [32, 32])])
def test_import_refusals(field, value):
    """Layouts the port does not implement raise, as in the JAX package."""
    hf = _hf_model(seed=17)
    hc = types.SimpleNamespace(**hf.config.to_dict())
    setattr(hc, field, value)
    for fn in (from_hf_reformer, jhf.from_hf_reformer):
        with pytest.raises(NotImplementedError):
            fn(hf, hf_config=hc)
