"""Multi-GPU training (A.5), port vs JAX on the CPU: the sharding rules and
mesh coordinates, and a gloo world of 4 CPU processes (one torch thread
each, `tests/torch_parallel_worker.py`) held against the JAX package's
(2, 2) and (2, 1, 2) meshes on 4 of its 8 virtual devices -- the Trainer's
step for both families, the multislice step, the vocab-sharded head, and
one epoch of `Trainer.train` with eval, checkpoints and per-rank loading --
in f32 at dropout 0; a world of one against the mesh-free Trainer; the
distributed entry points' refusals; the dryrun on 4 ranks."""
import dataclasses
import datetime
import json
import multiprocessing as mp
import os
import queue

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from musicnlp_tpu.models.reformer import Reformer as JReformer, ReformerConfig as JRConfig
from musicnlp_tpu.models.transformer_xl import TransfoXL as JModel, TransfoXLConfig as JConfig
from musicnlp_tpu.parallel import mesh as jmesh
from musicnlp_tpu.preprocess.dataset import AugmentedDataset, SongDataset
from musicnlp_tpu.trainer import train as jtrain
from musicnlp_tpu.utils import checkpoint as jckpt
from musicnlp_tpu.vocab import MusicTokenizer as JTok, MusicVocabulary as JVocab, N_KEY
from musicnlp_tpu_torch.models.transformer_xl import TransfoXL, TransfoXLConfig
from musicnlp_tpu_torch.ops import layers as tl
from musicnlp_tpu_torch.parallel import mesh as tmesh
from musicnlp_tpu_torch.tools.dryrun_multichip import dryrun_multichip
from musicnlp_tpu_torch.trainer import train as ttrain
from musicnlp_tpu_torch.trainer.eval import load_trained
from musicnlp_tpu_torch.utils import checkpoint as tckpt
from musicnlp_tpu_torch.vocab import MusicTokenizer
from tests import torch_parallel_worker as worker
from tests.torch_parity import perturb
from tests.test_torch_train import LOSS_TOL, PARAM_TOL, _songs

WORLD = 4
JOB_TIMEOUT_S = 120
TFXL = dict(model_size='test', d_model=32, n_head=4, d_head=8, d_inner=64, n_layer=2,
            mem_len=16, clamp_len=32, max_length=64, dropout=0.0, dtype='float32')
REFORMER = dict(model_size='test', d_model=64, n_head=4, d_head=16, d_ff=128,
                attn_layers=('local', 'lsh', 'local', 'lsh'), max_length=64,
                axial_pos_shape=(8, 8), local_chunk=32, lsh_chunk=32, n_hashes=2,
                dropout=0.0, dtype='float32')
STEP_ARGS = dict(batch_size=8, learning_rate=1e-3, weight_decay=0.0,
                 lr_scheduler_type='constant', num_train_epochs=1)
TOK = dict(pitch_kind='midi', model_max_length=64)


def _jflat(tree):
    return {k: np.asarray(v) for k, v in jckpt._flatten(tree).items()}


def _jspecs(tree, shard_vocab=False):
    specs = jmesh.param_specs(tree, shard_vocab=shard_vocab)
    paths = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {'/'.join(jckpt._path_key(p) for p in path): tuple(s) for path, s in paths}


def _batch(vocab, seed, B=8, T=64):
    """Rows with a different share of -100 labels each (the global mean is
    not the mean of the ranks' means)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (B, T)).astype(np.int32)
    labels = ids.copy()
    for r in range(B):
        labels[r, int(rng.integers(8, T)):] = -100
    return dict(input_ids=ids, labels=labels,
                key_scores=np.abs(rng.standard_normal((B, N_KEY))).astype(np.float32))


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """This process's torch work is tiny; the world's ranks take one thread
    each, and several test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- rules, coords
@pytest.mark.parametrize('shard_vocab', [False, True])
@pytest.mark.parametrize('family', ['transf-xl', 'reformer'])
def test_param_specs_equal_jax(family, shard_vocab):
    if family == 'transf-xl':
        jp = JModel(JConfig.from_size('debug', vocab_size=422)).init(jax.random.PRNGKey(0))
    else:
        jp = JReformer(JRConfig.from_size('debug', vocab_size=422)).init(jax.random.PRNGKey(0))
    want = _jspecs(jp, shard_vocab)
    got = tmesh.param_specs(tckpt.params_from_jax(_jflat(jp), 'cpu'), shard_vocab=shard_vocab)
    assert got == want
    assert any('model' in s for s in got.values())


@pytest.mark.parametrize('multislice', [False, True])
def test_batch_and_replicated_specs_equal_jax(multislice):
    want = {k: tuple(v) for k, v in jmesh.batch_specs(multislice=multislice).items()}
    assert tmesh.batch_specs(multislice=multislice) == want
    tree = {'a': np.zeros((2, 3)), 'b': [np.zeros(4)]}
    assert tmesh.replicated_specs(tree) == {'a': (), 'b/0': ()}
    assert all(tuple(v) == () for v in jax.tree.leaves(
        jmesh.replicated_specs(tree), is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))


@pytest.mark.parametrize('shape', [(2, 2), (2, 1, 2)])
def test_rank_coords_equal_jax_device_positions(shape):
    devs = jax.devices()[:4]
    m = (jmesh.make_mesh(*shape, devices=devs) if len(shape) == 2
         else jmesh.make_multislice_mesh(*shape, devices=devs))
    assert m.devices.shape == shape
    for pos in np.ndindex(*shape):
        rank = devs.index(m.devices[pos])
        assert tmesh.rank_coords(shape, rank) == pos
        names = m.axis_names
        mesh = tmesh.Mesh(names, shape, torch.device('cpu'), rank)
        assert mesh.coords == dict(zip(names, pos))


def test_world_of_one_is_the_trivial_mesh(monkeypatch):
    """No process group: init_distributed is a no-op, the mesh is (1, 1)
    with no group, host_shard is None; a model axis larger than the world and
    NCCL / CUDA without a GPU are refused."""
    for k in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR', 'MASTER_PORT'):
        monkeypatch.delenv(k, raising=False)
    assert tmesh.init_distributed(device='cpu') == 1 and not dist.is_initialized()
    mesh = tmesh.make_mesh(device='cpu')
    assert mesh.shape == {'data': 1, 'model': 1} and mesh.group('model') is None
    assert tmesh.host_shard() is None and tmesh.host_shard(mesh) is None
    with pytest.raises(ValueError, match='not divisible by model=2'):
        tmesh.make_mesh(n_model=2, device='cpu')
    monkeypatch.setenv('RANK', '0')
    monkeypatch.setenv('WORLD_SIZE', '1')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        tmesh.init_distributed(backend='nccl')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        tmesh.init_distributed(device='cuda')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        tmesh.init_distributed()            # the default device is the card
    assert not dist.is_initialized()


def test_shard_vocab_needs_a_mesh_and_refuses_adaptive():
    """TransfoXL(cfg) with shard_vocab constructs without a mesh and refuses
    to train until one is attached (a Trainer attaches its own); on the
    trivial mesh it equals the tiled head; adaptive_cutoffs and segment
    training are refused, as in the JAX package."""
    cfg = TransfoXLConfig(vocab_size=512, **dict(TFXL, head_chunk=96))
    model = TransfoXL(dataclasses.replace(cfg, shard_vocab=True), device='cpu')
    params = model.init(seed=0)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 64)))
    with pytest.raises(ValueError, match='mesh'):
        model.loss(params, ids, ids)
    model.mesh = tmesh.make_mesh(device='cpu')
    loss, mets = model.loss(params, ids, ids)
    want, want_mets = TransfoXL(cfg, device='cpu').loss(params, ids, ids)
    assert float(loss) == float(want) and torch.equal(mets['preds'], want_mets['preds'])
    with pytest.raises(ValueError, match='n_seg'):
        model.loss(params, ids, ids, n_seg=2)
    bad = TransfoXL(dataclasses.replace(cfg, shard_vocab=True, adaptive_cutoffs=(128, 256)),
                    device='cpu', mesh=model.mesh)
    with pytest.raises(ValueError, match='adaptive'):
        bad.loss(params, ids, ids)


# ------------------------------------------------------------ the gloo world
class _World:
    def __init__(self, tmp):
        ctx = mp.get_context('spawn')
        self.results = ctx.Queue()
        self.jobs = [ctx.Queue() for _ in range(WORLD)]
        init = os.path.join(tmp, 'init')
        self.procs = [ctx.Process(target=worker.serve, daemon=True,
                                  args=(r, WORLD, init, self.jobs[r], self.results,
                                        JOB_TIMEOUT_S))
                      for r in range(WORLD)]
        for p in self.procs:
            p.start()

    def run(self, name, **kw):
        """`name`(**kw) on every rank -> the results by rank; raises with a
        rank's traceback if it failed."""
        for q in self.jobs:
            q.put((name, kw))
        out = {}
        while len(out) < WORLD:
            try:
                rank, ok, value = self.results.get(timeout=JOB_TIMEOUT_S + 30)
            except queue.Empty:
                raise AssertionError(f'{name}: ranks {sorted(out)} of {WORLD} answered') from None
            if not ok:
                raise AssertionError(f'{name} failed on rank {rank}:\n{value}')
            out[rank] = value
        return [out[r] for r in range(WORLD)]

    def close(self):
        for q in self.jobs:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    w = _World(str(tmp_path_factory.mktemp('gloo')))
    yield w
    w.close()


def test_world_coords_and_shard_roundtrip(world):
    for shape in ((2, 2), (2, 1, 2)):
        got = world.run('coords', shape=shape)
        for rank, r in enumerate(got):
            assert tuple(r['coords'].values()) == tmesh.rank_coords(shape, rank)
            d, m = (r['coords']['data'], r['coords']['model']) if len(shape) == 2 else \
                (r['coords']['replica'], r['coords']['model'])
            assert r['host_shard'] == (d, 2) and r['batch'] == (d, 2)
    jp = JModel(JConfig.from_size('debug', vocab_size=512)).init(jax.random.PRNGKey(1))
    flat = _jflat(jp)
    flat['out_bias'] = flat['out_bias'].copy()
    flat['out_bias'][3] = -0.0                  # a sign bit that a float sum would drop
    for r in world.run('shard_roundtrip', shape=(2, 2), flat=flat, shard_vocab=True):
        assert set(r['full']) == set(flat)
        for k, v in flat.items():
            assert r['full'][k].tobytes() == v.tobytes(), k
        assert r['local']['embed/weight'] == (256, 128)
        assert r['local']['layers/0/attn/qkv'] == (128, 3, 4, 16)
        assert r['local']['layers/0/ffn/w2/w'] == (256, 128)


def test_row_parallel_dense_sums_f32_partials(world):
    """The row-parallel `dense` on (2, 2) in bf16 sums the two ranks' f32
    partial products over `model` in f32 and rounds once after the bias,
    as the JAX `dense` under sharding: every rank's output is exactly
    bf16(p0 + p1 + b), where rounding each partial first (the unfused
    form) differs in over 5% of outputs.  In f32 each rank's x and w block
    gradients and b's equal the unsharded layer's."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((64, 96)).astype(np.float32)).bfloat16().float()
    w = torch.from_numpy((rng.standard_normal((96, 48)) * 0.05).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(48) * 0.05).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32))
    got = world.run('dense_row_parallel', shape=(2, 2), x=x.numpy(), w=w.numpy(), b=b.numpy(),
                    g=g.numpy())
    part = {r['k']: torch.from_numpy(r['part']) for r in got}
    want = ((part[0] + part[1]) + b).bfloat16().float()
    rounded = (part[0].bfloat16().float() + part[1].bfloat16().float()).bfloat16()
    unfused = (rounded.float() + b).bfloat16().float()
    assert float((unfused != want).float().mean()) > 0.05
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    full = torch.autograd.grad(tl.dense(dict(w=leaves[1], b=leaves[2]), leaves[0]), leaves, g)
    for r in got:
        assert torch.equal(torch.from_numpy(r['out']), want)
        k = slice(r['k'] * 48, (r['k'] + 1) * 48)
        for name, a, e in zip(('dx', 'dw', 'db'), r['grads'], (full[0][:, k], full[1][k],
                                                               full[2])):
            np.testing.assert_allclose(a, e.numpy(), rtol=1e-5, atol=1e-6, err_msg=name)


def _jax_step(jm, jp, tok, batch, mesh):
    tr = jtrain.Trainer(jm, tok, _Len(8), None, args=jtrain.TrainArgs(**STEP_ARGS),
                        out_dir='/nonexistent', mesh=mesh)
    p = jmesh.shard_pytree(jp, jmesh.param_specs(jp), mesh)
    o = jax.jit(tr.tx.init)(p)
    p, _, mets = tr.train_step(p, o, {k: jnp.asarray(v) for k, v in batch.items()},
                               jax.random.PRNGKey(1))
    return {k: float(v) for k, v in mets.items()}, _jflat(jax.device_get(p))


class _Len:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize('family,shape', [('transf-xl', (2, 2)), ('reformer', (2, 2)),
                                          ('transf-xl', (2, 1, 2))])
def test_train_step_matches_jax_mesh(world, family, shape):
    """Trainer.train_step on 4 ranks == the JAX Trainer's step on the same
    mesh: loss, NTP accuracy, IKR and grad norm of the global batch, and
    every parameter after the update, on every rank."""
    tok = JTok(**TOK)
    if family == 'transf-xl':
        cfg = dict(TFXL, vocab_size=tok.vocab_size)
        jm = JModel(JConfig(**cfg))
    else:
        cfg = dict(REFORMER, vocab_size=tok.vocab_size)
        jm = JReformer(JRConfig(**cfg))
    jp = perturb(jm.init(jax.random.PRNGKey(0)), 1)
    flat = _jflat(jp)                           # before the JAX step donates jp's buffers
    batch = _batch(tok.vocab_size, 7)
    devs = jax.devices()[:4]
    mesh = (jmesh.make_mesh(*shape, devices=devs) if len(shape) == 2
            else jmesh.make_multislice_mesh(*shape, devices=devs))
    want, want_params = _jax_step(jm, jp, tok, batch, mesh)
    got = world.run('train_step', shape=shape, family=family, cfg=cfg, flat=flat,
                    batch=batch, args=STEP_ARGS, tok=TOK)
    for r in got:
        assert r['loss'] == pytest.approx(want['loss'], rel=1e-4)
        assert r['ntp_acc'] == pytest.approx(want['ntp_acc'], abs=1e-5)
        assert r['ikr'] == pytest.approx(want['ikr'], abs=1e-5)
        assert r['n_tok'] == want['n_tok']
        assert r['grad_norm'] == pytest.approx(want['grad_norm'], rel=1e-4)
        assert set(r['params']) == set(want_params)
        for k, v in want_params.items():
            assert float(np.abs(r['params'][k] - v).max()) < 1e-4, k
        for k, v in r['params'].items():            # every replica holds the same
            assert np.array_equal(v, got[0]['params'][k]), k


def test_vocab_sharded_head_matches_jax(world):
    """shard_vocab at V 512, head_chunk 96 (a tile that does not divide a
    block) on (2, 2): the loss, n_tok, NTP accuracy and every row's preds
    equal JAX's on its (2, 2) mesh; the gradients within 1e-4."""
    V = 512
    cfg = dict(TFXL, vocab_size=V, head_chunk=96)
    mesh = jmesh.make_mesh(2, 2, devices=jax.devices()[:4])
    jm = JModel(JConfig(**cfg, shard_vocab=True), mesh=mesh)
    jp = jm.init(jax.random.PRNGKey(0))
    ids = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 64), 0, V, jnp.int32))
    labels = np.where(ids % 7 == 0, -100, ids)
    labels[5, 30:] = -100
    ps = jmesh.shard_pytree(jp, jmesh.param_specs(jp, shard_vocab=True), mesh)
    (jl, aux), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(ids), jnp.asarray(labels)), has_aux=True))(ps)
    jg = _jflat(jax.device_get(jg))
    for r in world.run('sharded_head', shape=(2, 2), cfg=cfg, flat=_jflat(jp), ids=ids,
                       labels=labels):
        assert r['embed_rows'] == (V // 2, 32)
        assert r['loss'] == pytest.approx(float(jl), rel=1e-5)
        assert r['n_tok'] == float(aux['n_tok'])
        assert r['ntp_acc'] == pytest.approx(float(aux['ntp_acc']), abs=1e-6)
        np.testing.assert_array_equal(r['preds'], np.asarray(aux['preds']))
        for k, v in jg.items():
            assert float(np.abs(r['grads'][k] - v).max()) < 1e-4, k


def test_one_epoch_matches_jax_mesh(world, tmp_path):
    """One epoch of Trainer.train on (2, 2), each rank loading its rows
    (host_shard), with eval (a padded final batch split over the data ranks)
    and a checkpoint: the logs and trained.npz written by rank 0 equal the
    JAX (2, 2) Trainer's; load_trained reads the npz; the sharded-checkpoint
    backend gives every rank its blocks back."""
    args = dict(batch_size=8, eval_batch_size=6, learning_rate=3e-3, weight_decay=0.1,
                lr_scheduler_type='cosine', warmup_ratio=0.5, num_train_epochs=1, seed=5)
    songs = _songs(20, 0)
    sd = SongDataset.from_songs(songs, vocab=JVocab(pitch_kind='step'))
    tok = JTok(**TOK)
    cfg = dict(TFXL, vocab_size=tok.vocab_size)
    jm = JModel(JConfig(**cfg))
    jp = perturb(jm.init(jax.random.PRNGKey(2)), 3)
    flat = _jflat(jp)
    mesh = jmesh.make_mesh(2, 2, devices=jax.devices()[:4])
    jtr = jtrain.Trainer(jm, tok, AugmentedDataset(sd, tok, random_crop=False, seed=3),
                         AugmentedDataset(sd, tok, random_crop=False, dataset_split='test',
                                          seed=4),
                         args=jtrain.TrainArgs(**args), out_dir=str(tmp_path / 'jax'), mesh=mesh)
    p = jmesh.shard_pytree(jp, jmesh.param_specs(jp), mesh)
    jres = jtr.train(params=p, opt_state=jax.jit(jtr.tx.init)(p))

    out = str(tmp_path / 'torch')
    got = world.run('train_epoch', shape=(2, 2), cfg=cfg, flat=flat, songs=songs,
                    args=args, tok=TOK, out_dir=out)
    jlog = [json.loads(l) for l in open(jtr.log_path)]
    tlog = [json.loads(l) for l in open(os.path.join(out, 'train_log.jsonl'))]
    # the port's epoch records add the loop's wait for data, `data_wait_s`
    assert [sorted(set(r) - {'data_wait_s'}) for r in tlog] == [sorted(r) for r in jlog]
    assert [('data_wait_s' in r) for r in tlog] == [('train_tokens_per_sec' in r)
                                                   for r in jlog]
    steps = [(a, b) for a, b in zip(jlog, tlog) if 'loss' in a]
    assert len(steps) == 2
    for a, b in steps:
        np.testing.assert_allclose(b['loss'], a['loss'], **LOSS_TOL)
        assert b['ntp_acc'] == pytest.approx(a['ntp_acc'], abs=1e-6)
        assert b['ikr'] == pytest.approx(a['ikr'], abs=1e-6)
        assert b['n_tok'] == a['n_tok']
        assert b['grad_norm'] == pytest.approx(a['grad_norm'], rel=1e-4)
    for r in got:
        for k in ('loss', 'ntp_acc', 'ikr'):
            assert r['history'][0][f'eval_{k}'] == pytest.approx(
                jres['history'][0][f'eval_{k}'], rel=1e-5, abs=1e-6), k
        assert r['dcp_roundtrip'] and r['nonzero'] and '.metadata' in r['dcp_files']
        assert r['local']['layers/0/ffn/w1/w'] == (32, 32)
    assert [r['host_shard'] for r in got] == [(0, 2), (0, 2), (1, 2), (1, 2)]
    assert os.path.isdir(os.path.join(out, 'checkpoint-ep0'))
    jt = dict(np.load(str(tmp_path / 'jax' / 'trained.npz')))
    tt = tckpt.load_flat(os.path.join(out, 'trained'))
    assert set(tt) == set(jt)
    for key in jt:
        np.testing.assert_allclose(tt[key], jt[key], **PARAM_TOL, err_msg=key)
    model, params, _ = load_trained(out, device='cpu')
    assert model.cfg.n_head == 4 and params['layers'][0]['attn']['qkv'].shape == (32, 3, 4, 8)


# ----------------------------------------------------------- a world of one
def test_world_of_one_equals_the_mesh_free_trainer(tmp_path):
    """A process group of one (gloo, FileStore) and the mesh built on it:
    the Trainer's epoch gives the same bits as without a process group."""
    tok = MusicTokenizer(pitch_kind='midi', model_max_length=32)
    cfg = TransfoXLConfig(vocab_size=tok.vocab_size, **dict(TFXL, max_length=32))
    rows = _batch(tok.vocab_size, 3, B=8, T=32)

    class Rows:
        def __len__(self):
            return 8

        def batches(self, batch_size, shuffle=True, seed=None, drop_last=True):
            for i in range(0, 8, batch_size):
                yield {k: v[i:i + batch_size] for k, v in rows.items()}

    args = ttrain.TrainArgs(batch_size=4, learning_rate=1e-3, num_train_epochs=2,
                            lr_scheduler_type='cosine', load_best_model_at_end=False)

    def run(name):
        tr = ttrain.Trainer(TransfoXL(cfg, device='cpu'), tok, Rows(), Rows(), args=args,
                            out_dir=str(tmp_path / name))
        res = tr.train()
        return tr, res, [json.loads(l) for l in open(tr.log_path)]

    free, free_res, free_log = run('free')
    assert free.mesh.group('model') is None and not dist.is_initialized()
    store = dist.FileStore(str(tmp_path / 'store'), 1)
    dist.init_process_group('gloo', store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        one, one_res, one_log = run('one')
        assert one.mesh.shape == {'data': 1, 'model': 1} and one.host_shard is None
    finally:
        dist.destroy_process_group()
    timings = ('train_tokens_per_sec', 'data_wait_s')
    assert [{k: v for k, v in r.items() if k not in timings} for r in one_log] == \
        [{k: v for k, v in r.items() if k not in timings} for r in free_log]
    for key, t in tckpt.flatten(free_res['params']).items():
        assert torch.equal(tckpt.flatten(one_res['params'])[key], t), key


def test_dryrun_multichip_on_four_ranks(capsys):
    lines = dryrun_multichip(4)
    assert len(lines) == 3 and capsys.readouterr().out.splitlines()[-3:] == lines
    assert lines[0].startswith("dryrun_multichip(n=4, mesh={'data': 2, 'model': 2})")
    assert 'reformer' in lines[1] and 'shard_vocab 262k' in lines[2]
    for line in lines:
        loss = float(line.split('loss=')[1].split()[0])
        assert np.isfinite(loss) and 0 < loss < 20
