"""The training slice, port vs JAX at a small width (f32 on the CPU): the
model loss and its gradients (n_seg 1/2/4), the optimizer against optax, the
Trainer against the JAX Trainer, checkpoints and resume, dropout."""
import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from musicnlp_tpu.models.transformer_xl import TransfoXL as JModel, TransfoXLConfig as JConfig
from musicnlp_tpu.parallel import mesh as mesh_lib
from musicnlp_tpu.preprocess.dataset import AugmentedDataset, SongDataset
from musicnlp_tpu.trainer import train as jtrain
from musicnlp_tpu.trainer.eval import load_trained as j_load_trained
from musicnlp_tpu.utils import checkpoint as jckpt
from musicnlp_tpu.vocab import MusicTokenizer as JTok, MusicVocabulary as JVocab
from musicnlp_tpu_torch.models.transformer_xl import TransfoXL, TransfoXLConfig
from musicnlp_tpu_torch.trainer import train as ttrain
from musicnlp_tpu_torch.trainer.eval import load_trained
from musicnlp_tpu_torch.utils import checkpoint as tckpt
from musicnlp_tpu_torch.vocab import MusicTokenizer
from tests.torch_parity import np_of, randn, to_torch

# f32 loss of a small model; the two packages sum in other orders
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
# parameter gradients: relative to each tensor's largest entry (segment
# memory and the rel-shift make the sums run in other orders)
GRAD_REL = 1e-4
# params after a few AdamW steps: an update is lr * m / sqrt(v), so a
# gradient entry near 0 turns f32 rounding into up to ~lr of difference
PARAM_TOL = dict(rtol=1e-4, atol=2e-5)

CFG = dict(model_size='test', d_model=128, n_head=4, d_head=32, d_inner=256, n_layer=2,
           mem_len=32, clamp_len=48, max_length=64, dropout=0.0, dtype='float32')


def _perturb(params, seed):
    """Non-zero biases and layer-norm params so every term is exercised."""
    flat = jckpt._flatten(params)
    rng = np.random.default_rng(seed)
    for k, v in flat.items():
        if k.endswith(('bias', 'r_w_bias', 'r_r_bias', '/b')):
            flat[k] = rng.standard_normal(v.shape).astype(np.float32) * 0.05
        elif k.endswith('scale'):
            flat[k] = 1.0 + rng.standard_normal(v.shape).astype(np.float32) * 0.05
    leaves, treedef = jax.tree_util.tree_flatten_with_path(params)
    keys = ['/'.join(jckpt._path_key(p) for p in path) for path, _ in leaves]
    return jax.tree_util.tree_unflatten(treedef, [jnp.asarray(flat[k]) for k in keys])


def _assert_rel(got, want, rel, msg=''):
    got, want = np_of(got), np_of(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    assert float(np.abs(got - want).max()) <= rel * scale, (msg, np.abs(got - want).max(), scale)


# ------------------------------------------------------------------ model loss
@pytest.fixture(scope='module')
def pair():
    vocab = JTok(pitch_kind='degree').vocab_size
    jm = JModel(JConfig(vocab_size=vocab, **dict(CFG, n_layer=3)))
    jp = _perturb(jm.init(jax.random.PRNGKey(0)), 1)
    tm = TransfoXL(TransfoXLConfig(vocab_size=vocab, **dict(CFG, n_layer=3)), device='cpu')
    return jm, jp, tm


@pytest.mark.parametrize('n_seg', [1, 2, 4])
def test_loss_and_grads_match_jax(pair, n_seg):
    """TransfoXL.loss and every parameter gradient == jax.grad of the JAX
    model.loss (deterministic; on the CPU the JAX model runs rel_attn, the
    port its fused path through the plain K1/K2)."""
    jm, jp, tm = pair
    rng = np.random.default_rng(n_seg)
    ids = rng.integers(0, tm.cfg.vocab_size, (2, 64)).astype(np.int32)
    labels = ids.copy()
    labels[1, 37:] = -100
    labels[0, 16] = -100                         # a pad on a segment boundary

    (jl, jmets), jg = jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(ids), jnp.asarray(labels), n_seg=n_seg),
        has_aux=True)(jp)
    tp = to_torch(jp)
    flat = tckpt.flatten(tp)
    for t in flat.values():
        t.requires_grad_(True)
    tl, tmets = tm.loss(tp, torch.from_numpy(ids), torch.from_numpy(labels), n_seg=n_seg)
    grads = torch.autograd.grad(tl, list(flat.values()))
    np.testing.assert_allclose(float(tl.detach()), float(jl), **LOSS_TOL)
    assert float(tmets['ntp_acc']) == pytest.approx(float(jmets['ntp_acc']), abs=1e-6)
    assert float(tmets['n_tok']) == float(jmets['n_tok'])
    np.testing.assert_array_equal(tmets['preds'].numpy(), np.asarray(jmets['preds']))
    jflat = jckpt._flatten(jg)
    assert set(jflat) == set(flat)
    for key, g in zip(flat, grads):
        _assert_rel(g, jflat[key], GRAD_REL, key)


def test_forward_segments_matches_jax(pair):
    jm, jp, tm = pair
    ids = np.random.default_rng(9).integers(0, tm.cfg.vocab_size, (2, 64)).astype(np.int32)
    want = jm.forward_segments(jp, jnp.asarray(ids), n_seg=4)
    got = tm.forward_segments(to_torch(jp), torch.from_numpy(ids), n_seg=4)
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=1e-4, atol=1e-4)


def test_dropout_seeded_and_not_deterministic(pair):
    """Dropout on: the same generator seed repeats the loss and gradients, and
    the loss differs from the deterministic one."""
    _, jp, tm = pair
    tm = TransfoXL(dataclasses.replace(tm.cfg, dropout=0.1), device='cpu')
    tp = to_torch(jp)
    ids = torch.from_numpy(np.random.default_rng(5).integers(0, 500, (2, 64)))
    r = tp['layers'][0]['attn']['r'].requires_grad_(True)

    def run(seed):
        loss, _ = tm.loss(tp, ids, ids, generator=torch.Generator().manual_seed(seed),
                          deterministic=False, n_seg=2)
        return float(loss.detach()), torch.autograd.grad(loss, [r])[0]
    (a, ga), (b, gb), (c, _) = run(3), run(3), run(4)
    det, _ = tm.loss(tp, ids, ids, n_seg=2)
    assert a == b and torch.equal(ga, gb)
    assert a != c and abs(a - float(det.detach())) > 1e-4


# ------------------------------------------------------------------ optimizer
@pytest.mark.parametrize('sched_kind,k', [('cosine', 1), ('cosine', 2), ('constant', 1)])
def test_optimizer_matches_optax(sched_kind, k):
    """5 micro-steps of fixed numpy gradients through make_optimizer of both
    packages: warmup (lr 0 on the first step), clips that trigger and do not,
    cosine decay, weight decay on every tensor, accumulation k = 2."""
    args = jtrain.TrainArgs(learning_rate=1e-2, weight_decay=0.1, lr_scheduler_type=sched_kind,
                            warmup_ratio=0.3, max_grad_norm=1.0, gradient_accumulation_steps=k)
    targs = ttrain.TrainArgs(**{f.name: getattr(args, f.name)
                                for f in dataclasses.fields(ttrain.TrainArgs)})
    total = 10 * k
    tx, jsched = jtrain.make_optimizer(args, total)
    opt, tsched = ttrain.make_optimizer(targs, total)
    for c in range(total // k + 1):
        assert tsched(c) == pytest.approx(float(jsched(c)), rel=1e-6, abs=1e-12), c
    assert tsched(0) == (0.0 if sched_kind == 'cosine' else pytest.approx(1e-2))

    shapes = {'a': (3, 4), 'b': (5,), 'c': (2, 2, 2)}
    jp = {n: jnp.asarray(randn(i, *s)) for i, (n, s) in enumerate(shapes.items())}
    tp = {n: torch.from_numpy(np.array(v)) for n, v in jp.items()}
    js, ts = tx.init(jp), opt.init(tp)
    for step in range(5):
        # steps 0 and 3 have a global norm above 1 (clipped), the others below
        scale = 2.0 if step in (0, 3) else 0.05
        g = {n: randn(100 + 10 * step + i, *s, scale=scale)
             for i, (n, s) in enumerate(shapes.items())}
        upd, js = tx.update({n: jnp.asarray(v) for n, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step(tp, {n: torch.from_numpy(v) for n, v in g.items()}, ts)
        for n in shapes:
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]), rtol=1e-6, atol=1e-7,
                                       err_msg=f'{n} step {step}')


# ------------------------------------------------------------- Trainer parity
def _songs(n, seed):
    """Synthetic step-kind songs (as tests/test_trainer.py makes them)."""
    rng = np.random.default_rng(seed)
    names = ['C', 'D', 'E', 'F', 'G', 'A', 'B']
    pcs = {'C': 1, 'D': 3, 'E': 5, 'F': 6, 'G': 8, 'A': 10, 'B': 12}
    out = []
    for i in range(n):
        bars = []
        for _ in range(int(rng.integers(3, 9))):
            notes = ' '.join(f'p_{pcs[nm]}/4_{nm} d_1'
                             for nm in (names[int(rng.integers(7))] for _ in range(4)))
            bars.append(f'<bar> <melody> {notes} <bass> p_8/2_G d_2 p_1/3_C d_2')
        out.append(dict(score='TimeSig_4/4 Tempo_120 ' + ' '.join(bars) + ' </s>',
                        keys={'CMajor': 0.9, 'GMajor': 0.4}, title=f'song-{i}'))
    return out


def _datasets(mode):
    """(train, eval) AugmentedDatasets; made anew per Trainer so that both
    packages draw the same augmentation stream from the same seed."""
    sd = SongDataset.from_songs(_songs(20, 0), vocab=JVocab(pitch_kind='step'))
    if mode == 'vanilla':
        tok = JTok(pitch_kind='midi', model_max_length=64)
        kw = {}
    else:
        tok = JTok(pitch_kind='degree', model_max_length=64)
        kw = dict(insert_key=True, pitch_shift=True)
    return (AugmentedDataset(sd, tok, random_crop=False, dataset_split='train', seed=3, **kw),
            AugmentedDataset(sd, tok, random_crop=False, dataset_split='test', seed=4, **kw),
            tok.pitch_kind)


@pytest.mark.parametrize('mode', ['vanilla', 'ins-key'])
def test_trainer_matches_jax_trainer(mode, tmp_path):
    """Both Trainers from the same params over the same batches (dropout 0,
    warmup-cosine, clip, weight decay): the logged loss / NTP accuracy / IKR
    of each step, evaluate() with a padded final batch, and the params after
    2 steps (trained.npz of both runs)."""
    tr_ds, ev_ds, pk = _datasets(mode)
    vocab = JTok(pitch_kind=pk).vocab_size
    args = dict(batch_size=8, eval_batch_size=6, learning_rate=3e-3, weight_decay=0.1,
                lr_scheduler_type='cosine', warmup_ratio=0.5, num_train_epochs=1, seed=5)
    jm = JModel(JConfig(vocab_size=vocab, **CFG))
    jp = _perturb(jm.init(jax.random.PRNGKey(2)), 3)
    init = jckpt._flatten(jp)
    mesh = mesh_lib.make_mesh(n_data=1, n_model=1, devices=jax.devices()[:1])
    jtr = jtrain.Trainer(jm, JTok(pitch_kind=pk, model_max_length=64), tr_ds, ev_ds,
                         args=jtrain.TrainArgs(**args), out_dir=str(tmp_path / 'jax'), mesh=mesh,
                         ikr_mode=mode)
    jres = jtr.train(params=jp, opt_state=jtr.tx.init(jp))

    tr_ds, ev_ds, _ = _datasets(mode)
    tm = TransfoXL(TransfoXLConfig(vocab_size=vocab, **CFG), device='cpu')
    ttr = ttrain.Trainer(tm, MusicTokenizer(pitch_kind=pk, model_max_length=64), tr_ds, ev_ds,
                         args=ttrain.TrainArgs(**args), out_dir=str(tmp_path / 'torch'),
                         ikr_mode=mode)
    tres = ttr.train(params=tckpt.params_from_jax(init, 'cpu'))

    jlog = [json.loads(l) for l in open(jtr.log_path)]
    tlog = [json.loads(l) for l in open(ttr.log_path)]
    assert [sorted(r) for r in tlog] == [sorted(r) for r in jlog]
    steps = [(a, b) for a, b in zip(jlog, tlog) if 'loss' in a]
    assert len(steps) == 2
    for a, b in steps:
        np.testing.assert_allclose(b['loss'], a['loss'], **LOSS_TOL)
        assert b['lr'] == pytest.approx(a['lr'], rel=1e-6)
        assert b['ntp_acc'] == pytest.approx(a['ntp_acc'], abs=1e-6)
        assert b['ikr'] == pytest.approx(a['ikr'], abs=1e-6)
        assert b['n_tok'] == a['n_tok']
        assert b['grad_norm'] == pytest.approx(a['grad_norm'], rel=1e-4)
    assert 0.0 < tlog[0]['ikr'] <= 1.0
    for k in ('loss', 'ntp_acc', 'ikr'):      # 20 eval rows in batches of 6: 2 padded rows
        assert tres['history'][0][f'eval_{k}'] == pytest.approx(
            jres['history'][0][f'eval_{k}'], rel=1e-5, abs=1e-6), k
    jt, tt = (jckpt._flatten(jckpt.restore_pytree(str(tmp_path / d / 'trained'), jp))
              for d in ('jax', 'torch'))
    for key in jt:
        np.testing.assert_allclose(tt[key], jt[key], **PARAM_TOL, err_msg=key)
    assert any(not np.array_equal(tt[k], init[k]) for k in tt)


# ------------------------------------------------------- checkpoints, resume
class _Rows:
    """The Trainer's dataset contract over fixed numpy rows."""

    def __init__(self, ids):
        self.ids = ids

    def __len__(self):
        return len(self.ids)

    def batches(self, batch_size, shuffle=True, seed=None, drop_last=True):
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        stop = len(order) - (batch_size - 1 if drop_last else 0)
        for i in range(0, stop, batch_size):
            idx = order[i:i + batch_size]
            yield dict(input_ids=self.ids[idx], labels=self.ids[idx],
                       key_scores=np.ones((len(idx), 24), np.float32))


@pytest.fixture(scope='module')
def small_run():
    tok = MusicTokenizer(pitch_kind='midi', model_max_length=32)
    cfg = TransfoXLConfig(vocab_size=tok.vocab_size, **dict(CFG, d_model=64, d_head=16,
                                                            d_inner=128, max_length=32))
    ids = np.random.default_rng(0).integers(0, tok.vocab_size, (16, 32)).astype(np.int32)
    return tok, cfg, _Rows(ids)


def _trainer(small_run, out, **kw):
    tok, cfg, ds = small_run
    args = ttrain.TrainArgs(**dict(dict(batch_size=4, learning_rate=1e-3, weight_decay=0.01,
                                        lr_scheduler_type='cosine', num_train_epochs=3,
                                        load_best_model_at_end=False), **kw))
    return ttrain.Trainer(TransfoXL(cfg, device='cpu'), tok, ds, ds, args=args, out_dir=str(out))


class _Crash(_Rows):
    """Dies when epoch 1 asks for its batches (the Trainer seeds epoch e's
    shuffle with seed + e)."""

    def batches(self, batch_size, shuffle=True, seed=None, drop_last=True):
        if seed == ttrain.TrainArgs.seed + 1:
            raise RuntimeError('killed in epoch 1')
        return super().batches(batch_size, shuffle, seed, drop_last)


def test_resume_equals_uninterrupted_run(small_run, tmp_path):
    """A run killed in epoch 1 and resumed from its epoch-0 checkpoint by a
    new Trainer ends with the params and optimizer state of a run that was
    never interrupted, to the bit (warmup-cosine schedule, dropout 0)."""
    tok, cfg, ds = small_run
    full = _trainer(small_run, tmp_path / 'full').train()
    crashing = _trainer(small_run, tmp_path / 'part')
    crashing.train_dataset = _Crash(ds.ids)
    with pytest.raises(RuntimeError, match='killed'):
        crashing.train()
    ck = tmp_path / 'part' / 'checkpoint-ep0'
    assert sorted(os.listdir(ck)) == ['opt_state.npz', 'params.npz', 'state.json']
    res = _trainer(small_run, tmp_path / 'part').train(resume_from=str(ck))
    for key, t in tckpt.flatten(full['params']).items():
        assert torch.equal(tckpt.flatten(res['params'])[key], t), key
    assert int(res['opt_state']['count']) == int(full['opt_state']['count']) == 12
    log = [json.loads(l) for l in open(tmp_path / 'part' / 'train_log.jsonl')]
    assert sorted({r['epoch'] for r in log if 'loss' in r}) == [0, 1, 2]


def test_checkpoints_rotate_keep_best_and_sweep_tmp(small_run, tmp_path):
    orphan = tmp_path / 'checkpoint-ep7.tmp'
    orphan.mkdir(parents=True)
    (orphan / 'params.npz').write_bytes(b'half-written by a killed process')
    tr = _trainer(small_run, tmp_path, num_train_epochs=4, save_total_limit=1,
                  learning_rate=3e-2, lr_scheduler_type='constant')
    tr.train()
    kept = sorted(int(os.path.basename(d).split('ep')[1])
                  for d in glob.glob(str(tmp_path / 'checkpoint-ep*')))
    evals = [(r['eval_loss'], r['epoch']) for r in map(json.loads, open(tr.log_path))
             if 'eval_loss' in r]
    best = min(evals)[1]
    assert kept == sorted({3, best}), (kept, evals)
    assert not [d for d in os.listdir(tmp_path) if d.endswith('.tmp')]


def test_save_checkpoint_is_atomic(small_run, tmp_path, monkeypatch):
    """A save that dies before the rename leaves the old checkpoint whole."""
    tok, cfg, _ = small_run
    params = TransfoXL(cfg, device='cpu').init(seed=1)
    d = str(tmp_path / 'checkpoint-ep0')
    tckpt.save_checkpoint(d, 0, params, {'count': torch.tensor(1)})
    real = tckpt.save_meta

    def dies(path, meta):
        raise KeyboardInterrupt('killed mid-save')
    monkeypatch.setattr(tckpt, 'save_meta', dies)
    with pytest.raises(KeyboardInterrupt):
        tckpt.save_checkpoint(d, 1, params, {'count': torch.tensor(2)})
    monkeypatch.setattr(tckpt, 'save_meta', real)
    _, opt, epoch = tckpt.load_checkpoint(d, 'cpu')
    assert epoch == 0 and int(opt['count']) == 1


def test_trained_run_read_by_both_packages(small_run, tmp_path):
    """The port's trained.npz + meta.json load in both packages' load_trained
    (same logits), and a JAX run's output loads in the port's."""
    tok, cfg, _ = small_run
    tr = _trainer(small_run, tmp_path / 'torch', num_train_epochs=1)
    res = tr.train()
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 32)).astype(np.int32)
    want, _, _ = tr.model.forward(res['params'], torch.from_numpy(ids))
    jm, jp, jtok = j_load_trained(str(tmp_path / 'torch'))
    assert jtok.pitch_kind == 'midi' and jtok.vocab_size == tok.vocab_size
    got, _, _ = jm.forward(jp, jnp.asarray(ids))
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=1e-4, atol=1e-4)
    tm, tp, ttok = load_trained(str(tmp_path / 'torch'), device='cpu')
    again, _, _ = tm.forward(tp, torch.from_numpy(ids))
    np.testing.assert_array_equal(np_of(again), np_of(want))

    jckpt.save_pytree(str(tmp_path / 'jax' / 'trained'), jp)
    jckpt.save_meta(str(tmp_path / 'jax' / 'meta.json'), dict(
        model_name='transf-xl', config=jtrain.asdict_config(jm.cfg),
        tokenizer=jtrain.describe_tokenizer(jtok, str(tmp_path / 'jax'))))
    tm2, tp2, _ = load_trained(str(tmp_path / 'jax'), device='cpu')
    back, _, _ = tm2.forward(tp2, torch.from_numpy(ids))
    np.testing.assert_allclose(np_of(back), np_of(got), rtol=1e-4, atol=1e-4)


def test_wiring_raises_for_later_slices():
    model, tok = ttrain.get_model_n_tokenizer('transf-xl', 'debug', device='cpu')
    assert tok.pitch_kind == 'degree' and model.cfg.vocab_size == tok.vocab_size
    assert ttrain.rebuild_tokenizer(dict(tokenizer=ttrain.describe_tokenizer(tok, '')), '') \
        .vocab_size == tok.vocab_size
    with pytest.raises(NotImplementedError, match='Reformer'):
        ttrain.get_model_n_tokenizer('reformer', 'debug', device='cpu')
    with pytest.raises(NotImplementedError, match='tokenizer'):
        ttrain.get_model_n_tokenizer('transf-xl', 'debug', tokenizer_scheme='wordpiece')
    tr = ttrain.get_all_setup('transf-xl', 'debug', train_dataset=_Rows(np.zeros((4, 8))),
                              device='cpu')
    assert tr.args.batch_size == 2 and tr.args.lr_scheduler_type == 'constant'
    assert ttrain.RECIPES['22-11'] == jtrain.RECIPES['22-11']
    assert ttrain.TrainArgs.presets == jtrain.TrainArgs.presets
