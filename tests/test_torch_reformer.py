"""The Reformer slice as a whole, port vs JAX at a small width (f32 on the CPU):
forward logits (with and without padding), loss and metrics, gradients,
'scan' decode (compute-dtype and int8 caches) and its exact oracle, greedy
generation, two Trainer steps, and run directories read by both packages."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicnlp_tpu.models.reformer import Reformer as JModel, ReformerConfig as JConfig
from musicnlp_tpu.parallel import mesh as mesh_lib
from musicnlp_tpu.trainer import train as jtrain
from musicnlp_tpu.trainer.eval import MusicGenerator as JGen, load_trained as j_load_trained
from musicnlp_tpu.utils import checkpoint as jckpt
from musicnlp_tpu.vocab import MusicTokenizer as JTok
from musicnlp_tpu_torch.models import reformer as treformer
from musicnlp_tpu_torch.models.reformer import (
    Reformer, ReformerConfig, ReformerExactDecodeState)
from musicnlp_tpu_torch.ops import chunked_attention as tca
from musicnlp_tpu_torch.trainer import metrics as tmetrics
from musicnlp_tpu_torch.trainer import train as ttrain
from musicnlp_tpu_torch.trainer.eval import MusicGenerator, load_trained, score_batch
from musicnlp_tpu_torch.utils import checkpoint as tckpt
from musicnlp_tpu_torch.vocab import MusicTokenizer
from tests.test_torch_train import _datasets
from tests.torch_parity import np_of, perturb, to_torch

# f32 logits of a 4-layer model; the two packages sum in other orders
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_REL = 1e-4            # of each gradient tensor's largest entry
PARAM_TOL = dict(rtol=1e-4, atol=2e-5)
# LSH hashes must not sit on a near-tie: each hash's top-2 projection gap
# must exceed the projection change that JAX's own rotations (a few ulp
# away, tests/test_torch_chunked.py) would cause, plus HASH_INPUT_REL of the
# projection for the packages' f32 hash inputs, which differ by a few ulp
HASH_INPUT_REL = 2e-6

# T 128 with chunks of 32: four chunks, eight buckets, two hash rounds
CFG = dict(model_size='test', d_model=64, n_head=4, d_head=16, d_ff=128,
           attn_layers=('local', 'lsh', 'local', 'lsh'), max_length=128,
           axial_pos_shape=(8, 16), local_chunk=32, lsh_chunk=32, n_hashes=2, dropout=0.0,
           dtype='float32')


@pytest.fixture(scope='module')
def pair():
    vocab = JTok(pitch_kind='midi').vocab_size
    jm = JModel(JConfig(vocab_size=vocab, **CFG))
    jp = perturb(jm.init(jax.random.PRNGKey(0)), 1)
    tm = Reformer(ReformerConfig(vocab_size=vocab, **CFG), device='cpu')
    return jm, jp, tm, to_torch(jp)


class _Margins(list):
    """Per hash the port computes: its top-2 projection gap less the largest
    projection error the package differences can cause, [R, ...]."""

    def smallest(self, pad_mask=None):
        """Over every hash; with a pad mask [B, T], over the real positions of
        forward hashes [R, B*N, T] only (pads all go to one extra bucket)."""
        out = []
        for slack in self:
            if pad_mask is not None:
                per_row = slack.shape[1] // len(pad_mask)
                slack = slack[:, torch.as_tensor(pad_mask).repeat_interleave(per_row, 0)]
            out.append(float(slack.min()))
        return min(out)


def _jax_rotations(rots):
    """JAX's draw for the layer whose rotations these are."""
    for layer in range(len(CFG['attn_layers'])):
        key = jax.random.fold_in(jax.random.PRNGKey(77), layer)
        want = torch.from_numpy(np.array(jax.random.normal(key, rots.shape, jnp.float32)))
        if torch.allclose(want, rots, atol=1e-5):
            return want
    raise AssertionError('rotations of no layer')


@pytest.fixture
def margins(monkeypatch):
    seen = _Margins()
    real = tca.lsh_buckets

    def spy(x, rots):
        with torch.no_grad():
            xf = x.float()
            proj = torch.einsum('...d,rdb->r...b', xf, rots.float())
            jproj = torch.einsum('...d,rdb->r...b', xf, _jax_rotations(rots.float()))
            top = torch.cat([proj, -proj], dim=-1).topk(2, dim=-1).values
            err = (proj - jproj).abs().amax(-1) + HASH_INPUT_REL * proj.abs().amax(-1)
            seen.append(top[..., 0] - top[..., 1] - 2 * err)
        return real(x, rots)
    monkeypatch.setattr(tca, 'lsh_buckets', spy)
    monkeypatch.setattr(treformer, 'lsh_buckets', spy)
    return seen


def _ids(seed, B, T, V):
    return np.random.default_rng(seed).integers(0, V, (B, T)).astype(np.int32)


def test_config_presets_match():
    for size in ('debug', 'debug-large', 'tiny', 'small', 'base', 'large'):
        for kw in (dict(), dict(max_length=1024), dict(max_length=4096, n_hashes=4)):
            a = JConfig.from_size(size, vocab_size=422, **kw)
            b = ReformerConfig.from_size(size, vocab_size=422, **kw)
            assert dataclasses.asdict(b) == dataclasses.asdict(a)


@pytest.mark.parametrize('padded', [False, True])
def test_forward_matches_jax(pair, margins, padded):
    """Logits on real rows (a pad query may differ: the JAX jnp path adds the
    self bias on top of a masked self entry, the kernels do not)."""
    jm, jp, tm, tp = pair
    ids = _ids(1, 2, 128, tm.cfg.vocab_size)
    pm = np.arange(128)[None, :] < np.array([128, 83])[:, None] if padded else None
    want = jax.jit(jm.forward)(jp, jnp.asarray(ids),
                               pad_mask=None if pm is None else jnp.asarray(pm))
    got = tm.forward(tp, torch.from_numpy(ids),
                     pad_mask=None if pm is None else torch.from_numpy(pm))
    real = np.ones((2, 128), bool) if pm is None else pm
    np.testing.assert_allclose(np_of(got)[real], np_of(want)[real], **LOGIT_TOL)
    assert len(margins) == 2 and margins.smallest(pm) > 0


@pytest.mark.parametrize('mode', ['vanilla', 'ins-key'])
def test_loss_and_metrics(pair, margins, mode):
    """score_batch (loss, NTP accuracy, IKR) and loss(pad_id=) == the JAX model."""
    jm, jp, tm, tp = pair
    ids = _ids(3, 3, 128, tm.cfg.vocab_size)
    labels = ids.copy()
    labels[1, 70:] = -100
    key_scores = np.random.default_rng(4).random((3, 24)).astype(np.float32)
    jloss = jax.jit(jm.loss, static_argnames='pad_id')
    loss, mets = jloss(jp, jnp.asarray(ids), jnp.asarray(labels))
    got = score_batch(tm, tp, torch.from_numpy(ids), torch.from_numpy(labels),
                      tmetrics.IkrMetric(MusicTokenizer(pitch_kind='midi'), mode=mode),
                      torch.from_numpy(key_scores))
    np.testing.assert_allclose(float(got['loss']), float(loss), **LOSS_TOL)
    assert float(got['ntp_acc']) == pytest.approx(float(mets['ntp_acc']), abs=1e-6)
    assert float(got['n_tok']) == float(mets['n_tok'])
    assert 0.0 <= float(got['ikr']) <= 1.0

    pad_id = int(ids[2, 5])
    jl, jmets = jloss(jp, jnp.asarray(ids), jnp.asarray(labels), pad_id=pad_id)
    tl, tmets = tm.loss(tp, torch.from_numpy(ids), torch.from_numpy(labels), pad_id=pad_id)
    np.testing.assert_allclose(float(tl), float(jl), **LOSS_TOL)
    np.testing.assert_array_equal(tmets['preds'].numpy(), np.asarray(jmets['preds']))
    assert margins.smallest() > 0


def _assert_rel(got, want, rel, msg=''):
    got, want = np_of(got), np_of(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    assert float(np.abs(got - want).max()) <= rel * scale, (msg, np.abs(got - want).max(), scale)


@pytest.mark.parametrize('pad_id', [None, 7])
def test_loss_grads_match_jax(pair, margins, pad_id):
    """Every parameter gradient == jax.grad(Reformer.loss), through K3 / K4's
    plain versions and the gather permutations."""
    jm, jp, tm, tp = pair
    ids = _ids(5, 2, 128, tm.cfg.vocab_size)
    ids[1, 100:] = 7
    labels = np.where(ids == 7, -100, ids).astype(np.int32)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(ids), jnp.asarray(labels), pad_id=pad_id),
        has_aux=True))(jp)
    tp = to_torch(jp)
    flat = tckpt.flatten(tp)
    for t in flat.values():
        t.requires_grad_(True)
    tl, _ = tm.loss(tp, torch.from_numpy(ids), torch.from_numpy(labels), pad_id=pad_id)
    grads = torch.autograd.grad(tl, list(flat.values()))
    np.testing.assert_allclose(float(tl.detach()), float(jl), **LOSS_TOL)
    jflat = jckpt._flatten(jg)
    assert set(jflat) == set(flat)
    for key, g in zip(flat, grads):
        _assert_rel(g, jflat[key], GRAD_REL, key)
    assert margins.smallest(None if pad_id is None else ids != pad_id) > 0


def test_dropout_seeded_and_not_deterministic(pair):
    _, jp, tm, _ = pair
    tm = Reformer(dataclasses.replace(tm.cfg, dropout=0.1), device='cpu')
    tp = to_torch(jp)
    ids = torch.from_numpy(_ids(6, 2, 64, tm.cfg.vocab_size))
    w = tp['layers'][1]['attn']['qk'].requires_grad_(True)

    def run(seed):
        loss, _ = tm.loss(tp, ids, ids, generator=torch.Generator().manual_seed(seed),
                          deterministic=False)
        return float(loss.detach()), torch.autograd.grad(loss, [w])[0]
    (a, ga), (b, gb), (c, _) = run(3), run(3), run(4)
    det, _ = tm.loss(tp, ids, ids)
    assert a == b and torch.equal(ga, gb)
    assert a != c and abs(a - float(det.detach())) > 1e-4


# ------------------------------------------------------------------ decode
@pytest.mark.parametrize('quant,dtype', [(None, 'float32'), ('int8', 'float32'),
                                         (None, 'bfloat16'), ('int8', 'bfloat16')])
def test_decode_steps_match_jax(pair, margins, quant, dtype):
    """Port 'scan' decode == JAX decode step by step with compute-dtype and
    int8 LSH caches: in f32 past the first chunk (where the LSH estimator
    leaves the exact regime); in bf16, the 22-04 compute dtype, over the
    first chunk, where every earlier position is attended whatever its
    bucket (bf16 hash inputs differ by an ulp, so near-ties may flip)."""
    jm, jp, tm, tp = pair
    jm = JModel(dataclasses.replace(jm.cfg, decode_cache_quant=quant, dtype=dtype))
    tm = Reformer(dataclasses.replace(tm.cfg, decode_cache_quant=quant, dtype=dtype),
                  device='cpu')
    n = 44 if dtype == 'float32' else tm.cfg.lsh_chunk
    ids = _ids(8, 2, n, tm.cfg.vocab_size)
    js, ts = jm.init_decode_state(2), tm.init_decode_state(2)
    step = jax.jit(jm.decode_step)
    # int8: a row scale that rounds a hair differently moves one code; bf16:
    # the packages round matmul outputs to bf16 (2^-8) at other points, over
    # four layers (logits here are ~0.6 at most)
    tol = {(None, 'float32'): LOGIT_TOL, ('int8', 'float32'): dict(rtol=1e-3, atol=1e-3)}.get(
        (quant, dtype), dict(rtol=0, atol=3e-2))
    for t in range(n):
        jl, js = step(jp, jnp.asarray(ids[:, t]), js)
        tl, ts = tm.decode_step(tp, torch.from_numpy(ids[:, t]), ts)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol, err_msg=f'step {t}')
    assert ts.step == n and (ts.lsh_k.dtype == torch.int8) == (quant == 'int8')
    assert dtype != 'float32' or margins.smallest() > 0
    ex = Reformer.expand_decode_state(ts, 3)
    assert ex.lsh_k.shape[1] == 6 and ex.lsh_buckets.shape[1] == 6
    sel = tm.select_decode_state(ex, torch.tensor([0, 5]))
    assert torch.equal(sel.lsh_k[:, 1], ts.lsh_k[:, 1])


def test_decode_exact_within_the_first_chunk(pair):
    """Within the first chunk the incremental decode, the exact oracle (a
    padded full forward per step) and one forward over the padded prefix
    agree: every earlier position is attended, whatever its bucket."""
    _, _, tm, tp = pair
    ids = torch.from_numpy(_ids(9, 2, 32, tm.cfg.vocab_size)).long()
    st, inc = tm.init_decode_state(2), []
    for t in range(32):
        lg, st = tm.decode_step(tp, ids[:, t], st)
        inc.append(lg)
    inc = torch.stack(inc, 1)
    buf = torch.cat([ids, torch.zeros(2, 96, dtype=torch.long)], 1)
    full = tm.forward(tp, buf, pad_mask=torch.arange(128)[None].expand(2, 128) < 32)
    np.testing.assert_allclose(inc.numpy(), full[:, :32].numpy(), **LOGIT_TOL)
    for t in (0, 13, 31):
        prefix = torch.where(torch.arange(128) < t, buf, torch.zeros_like(buf))
        exact, nxt = tm.decode_step_exact(tp, ids[:, t], ReformerExactDecodeState(prefix, t))
        assert nxt.step == t + 1 and torch.equal(nxt.buf[:, :t + 1], ids[:, :t + 1])
        np.testing.assert_allclose(exact.numpy(), inc[:, t].numpy(), **LOGIT_TOL)


def test_music_generator_greedy_identical(pair):
    jm, jp, tm, tp = pair
    jt, tt = (cls(pitch_kind='midi', model_max_length=128) for cls in (JTok, MusicTokenizer))
    jg, tg = JGen(jm, jt, jp), MusicGenerator(tm, tt, tp)
    prompts = [tg.unconditional_prompt(), tg.unconditional_prompt(time_sig=(3, 4), tempo=90)]
    want = jg.generate(prompts, strategy='greedy', max_length=48, seed=0)
    got = tg.generate(prompts, strategy='greedy', max_length=48, seed=0)
    assert got == want
    sampled = tg.generate(prompts, strategy='sample', max_length=24, seed=3, top_p=0.9)
    assert sampled == tg.generate(prompts, strategy='sample', max_length=24, seed=3, top_p=0.9)
    assert all(t.startswith(p) for t, p in zip(sampled, prompts))


# ------------------------------------------------------------------ training
def test_seeded_init_is_the_jax_layout(pair):
    jm, jp, tm, _ = pair
    flat = tm.init_flat(seed=0)
    assert {k: v.shape for k, v in flat.items()} == \
        {k: np.shape(v) for k, v in jckpt._flatten(jp).items()}
    assert all(v.dtype == np.float32 for v in flat.values())


def test_trainer_matches_jax_trainer(tmp_path):
    """Both Trainers from the same params over the same batches (dropout 0,
    warmup-cosine, clip, weight decay): each step's logged loss / NTP
    accuracy / IKR / grad norm, the eval metrics with a padded final batch,
    the params after 2 steps, and meta.json's model name."""
    tr_ds, ev_ds, pk = _datasets('vanilla')
    vocab = JTok(pitch_kind=pk).vocab_size
    cfg = dict(CFG, max_length=64, axial_pos_shape=(8, 8))
    args = dict(batch_size=8, eval_batch_size=6, learning_rate=3e-3, weight_decay=0.1,
                lr_scheduler_type='cosine', warmup_ratio=0.5, num_train_epochs=1, seed=5)
    jm = JModel(JConfig(vocab_size=vocab, **cfg))
    jp = perturb(jm.init(jax.random.PRNGKey(2)), 3)
    init = jckpt._flatten(jp)
    mesh = mesh_lib.make_mesh(n_data=1, n_model=1, devices=jax.devices()[:1])
    jtr = jtrain.Trainer(jm, JTok(pitch_kind=pk, model_max_length=64), tr_ds, ev_ds,
                         args=jtrain.TrainArgs(**args), out_dir=str(tmp_path / 'jax'), mesh=mesh)
    jres = jtr.train(params=jp, opt_state=jtr.tx.init(jp))

    tr_ds, ev_ds, _ = _datasets('vanilla')
    ttr = ttrain.Trainer(Reformer(ReformerConfig(vocab_size=vocab, **cfg), device='cpu'),
                         MusicTokenizer(pitch_kind=pk, model_max_length=64), tr_ds, ev_ds,
                         args=ttrain.TrainArgs(**args), out_dir=str(tmp_path / 'torch'))
    tres = ttr.train(params=tckpt.params_from_jax(init, 'cpu'))

    jlog = [json.loads(l) for l in open(jtr.log_path)]
    tlog = [json.loads(l) for l in open(ttr.log_path)]
    steps = [(a, b) for a, b in zip(jlog, tlog) if 'loss' in a]
    assert len(steps) == 2
    for a, b in steps:
        np.testing.assert_allclose(b['loss'], a['loss'], **LOSS_TOL)
        assert b['ntp_acc'] == pytest.approx(a['ntp_acc'], abs=1e-6)
        assert b['ikr'] == pytest.approx(a['ikr'], abs=1e-6)
        assert b['grad_norm'] == pytest.approx(a['grad_norm'], rel=1e-4)
    for k in ('loss', 'ntp_acc', 'ikr'):
        assert tres['history'][0][f'eval_{k}'] == pytest.approx(
            jres['history'][0][f'eval_{k}'], rel=1e-5, abs=1e-6), k
    jt, tt = (jckpt._flatten(jckpt.restore_pytree(str(tmp_path / d / 'trained'), jp))
              for d in ('jax', 'torch'))
    for key in jt:
        np.testing.assert_allclose(tt[key], jt[key], **PARAM_TOL, err_msg=key)
    assert json.load(open(tmp_path / 'torch' / 'meta.json'))['model_name'] == 'reformer'


def test_run_directories_read_by_both_packages(pair, tmp_path):
    """A JAX Reformer run loads in the port's load_trained, and the port's
    run (trained.npz + meta.json) in the JAX one: the same logits."""
    jm, jp, tm, tp = pair
    ids = _ids(12, 1, 64, tm.cfg.vocab_size)
    want = np_of(jax.jit(jm.forward)(jp, jnp.asarray(ids)))
    jtok = JTok(pitch_kind='midi', model_max_length=128)
    jckpt.save_pytree(str(tmp_path / 'jax' / 'trained'), jp)
    jckpt.save_meta(str(tmp_path / 'jax' / 'meta.json'), dict(
        model_name='reformer', config=jtrain.asdict_config(jm.cfg),
        tokenizer=jtrain.describe_tokenizer(jtok, str(tmp_path / 'jax'))))
    model, params, tok = load_trained(str(tmp_path / 'jax'), device='cpu')
    assert isinstance(model, Reformer) and model.cfg == tm.cfg
    assert tok.pitch_kind == 'midi' and tok.model_max_length == 128
    np.testing.assert_allclose(np_of(model.forward(params, torch.from_numpy(ids))), want,
                               **LOGIT_TOL)

    tckpt.save_pytree(str(tmp_path / 'torch' / 'trained'), params)
    tckpt.save_meta(str(tmp_path / 'torch' / 'meta.json'), dict(
        model_name=ttrain._model_name(model), config=dataclasses.asdict(model.cfg),
        tokenizer=ttrain.describe_tokenizer(tok, str(tmp_path / 'torch'))))
    jm2, jp2, _ = j_load_trained(str(tmp_path / 'torch'))
    assert type(jm2).__name__ == 'Reformer' and jm2.cfg == jm.cfg
    np.testing.assert_array_equal(np_of(jax.jit(jm2.forward)(jp2, jnp.asarray(ids))), want)


def test_wiring_builds_the_reformer():
    model, tok = ttrain.get_model_n_tokenizer('reformer', 'debug', pitch_kind='midi',
                                              device='cpu')
    assert isinstance(model, Reformer) and tok.vocab_size == model.cfg.vocab_size == 422
    assert model.cfg.attn_layers == ('local', 'lsh') * 3
    tr = ttrain.get_all_setup('reformer', 'debug', train_dataset=np.zeros((8, 4)),
                              device='cpu')
    assert tr.args.batch_size == 8 and tr.args.learning_rate == 1e-3
    r = ttrain.RECIPES['22-04']
    assert r == jtrain.RECIPES['22-04']
    m, _ = ttrain.get_model_n_tokenizer(r['model_name'], r['model_size'],
                                        pitch_kind=r['pitch_kind'], max_length=r['max_length'],
                                        device='cpu')
    assert (m.cfg.d_model, m.cfg.n_head, len(m.cfg.attn_layers), m.cfg.n_hashes,
            m.cfg.lsh_buckets_at(2048), m.cfg.vocab_size) == (768, 12, 12, 2, 64, 422)
