"""The ranks of the gloo world that `tests/test_torch_parallel.py` holds
against the JAX mesh: each is a spawned CPU process (one torch thread) that
joins the world once and then runs the jobs it is sent, each job a function
below called on every rank.  It imports the port only, never JAX."""
import datetime
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

from musicnlp_tpu_torch.models.reformer import Reformer, ReformerConfig
from musicnlp_tpu_torch.models.transformer_xl import TransfoXL, TransfoXLConfig
from musicnlp_tpu_torch.ops import layers
from musicnlp_tpu_torch.parallel import mesh as mesh_lib
from musicnlp_tpu_torch.preprocess.dataset import AugmentedDataset, SongDataset
from musicnlp_tpu_torch.trainer.train import TrainArgs, Trainer
from musicnlp_tpu_torch.utils import checkpoint as ckpt
from musicnlp_tpu_torch.vocab import MusicTokenizer, MusicVocabulary

FAMILIES = {'transf-xl': (TransfoXL, TransfoXLConfig), 'reformer': (Reformer, ReformerConfig)}


def serve(rank, world, init_file, jobs, results, timeout_s):
    """Join the world, then run (name, kwargs) jobs until None arrives; each
    result goes back as (rank, ok, value or traceback)."""
    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=f'file://{init_file}', rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        while (job := jobs.get()) is not None:
            name, kw = job
            try:
                results.put((rank, True, globals()[name](**kw)))
            except BaseException:             # reported to the test, which fails
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def _mesh(shape):
    if len(shape) == 2:
        return mesh_lib.make_mesh(*shape, device='cpu')
    return mesh_lib.make_multislice_mesh(*shape, device='cpu')


def _model(family, cfg, mesh):
    model_cls, cfg_cls = FAMILIES[family]
    return model_cls(cfg_cls(**cfg), device='cpu', mesh=mesh)


def _rows(batch, mesh):
    i, n = mesh.batch_index, mesh.n_batch
    per = len(batch['input_ids']) // n
    return mesh_lib.make_global_batch({k: v[i * per:(i + 1) * per] for k, v in batch.items()},
                                      mesh)


def coords(shape):
    mesh = _mesh(shape)
    return dict(rank=mesh.rank, coords=mesh.coords, batch=(mesh.batch_index, mesh.n_batch),
                host_shard=mesh_lib.host_shard(mesh))


def shard_roundtrip(shape, flat, shard_vocab):
    """shard_pytree then gather_pytree of a full tree -> (the gathered flat
    arrays, this rank's block shapes)."""
    mesh = _mesh(shape)
    tree = ckpt.params_from_jax(flat, 'cpu')
    specs = mesh_lib.param_specs(tree, shard_vocab=shard_vocab)
    local = mesh_lib.shard_pytree(tree, specs, mesh)
    back = mesh_lib.gather_pytree(local, specs, mesh)
    return dict(full=ckpt.params_to_jax(back),
                local={k: tuple(v.shape) for k, v in ckpt.flatten(local).items()})


def dense_row_parallel(shape, x, w, b, g):
    """`ops.layers.dense` as a FFN's row-parallel w2 on this rank's block of
    x's columns and w's rows: in bf16, its f32 partial product and the
    output; in f32, the gradients of this rank's x and w blocks and of b
    for the cotangent g."""
    mesh = _mesh(shape)
    k, h = mesh.model_index, x.shape[-1] // mesh.n_model
    xb, wb = torch.from_numpy(x[:, k * h:(k + 1) * h]), torch.from_numpy(w[k * h:(k + 1) * h])
    bt = torch.from_numpy(b)
    out = layers.dense(dict(w=wb, b=bt), xb.bfloat16(), mesh)
    ins = [t.clone().requires_grad_(True) for t in (xb, wb, bt)]
    y = layers.dense(dict(w=ins[1], b=ins[2]), ins[0], mesh)
    grads = torch.autograd.grad(y, ins, torch.from_numpy(g))
    return dict(k=k, part=layers.f32_product(xb.bfloat16(), wb).numpy(),
                out=out.float().numpy(), grads=[t.numpy() for t in grads])


def train_step(shape, family, cfg, flat, batch, args, tok):
    """One Trainer.train_step on this rank's rows -> the logged metrics and
    the gathered parameters after it."""
    mesh = _mesh(shape)
    trainer = Trainer(_model(family, cfg, mesh), MusicTokenizer(**tok), (),
                      args=TrainArgs(**args), mesh=mesh)
    params = trainer.shard(ckpt.params_from_jax(flat, 'cpu'))
    for t in ckpt.flatten(params).values():
        t.requires_grad_(True)
    mets = trainer.train_step(params, trainer.opt.init(params), _rows(batch, mesh))
    return dict({k: float(v) for k, v in mets.items()},
                params=ckpt.params_to_jax(trainer.gather(params)))


def sharded_head(shape, cfg, flat, ids, labels):
    """TransfoXL.loss with shard_vocab and its gradients (summed over the
    data ranks, gathered over `model`), and the preds of every row."""
    mesh = _mesh(shape)
    model = _model('transf-xl', dict(cfg, shard_vocab=True), mesh)
    trainer = Trainer(model, MusicTokenizer(pitch_kind='midi'), (), mesh=mesh)
    params = trainer.shard(ckpt.params_from_jax(flat, 'cpu'))
    for t in ckpt.flatten(params).values():
        t.requires_grad_(True)
    loss, mets, grads = trainer.loss_and_grads(
        params, _rows(dict(input_ids=ids, labels=labels), mesh))
    preds = mesh_lib.gather_pytree({'preds': mets['preds']},
                                   {'preds': (mesh.batch_axes, None)}, mesh)['preds']
    grads = trainer.gather(ckpt._unflatten(grads))
    return dict(loss=float(loss), n_tok=float(mets['n_tok']), ntp_acc=float(mets['ntp_acc']),
                preds=preds.numpy(), grads=ckpt.params_to_jax(grads),
                embed_rows=tuple(params['embed']['weight'].shape))


def train_epoch(shape, cfg, flat, songs, args, tok, out_dir):
    """One epoch of Trainer.train with eval and a checkpoint, each rank
    loading its rows (host_shard); then this rank's blocks through the
    sharded checkpoint backend and back."""
    mesh = _mesh(shape)
    sd = SongDataset.from_songs(songs, vocab=MusicVocabulary(pitch_kind='step'))
    tk = MusicTokenizer(**tok)
    train = AugmentedDataset(sd, tk, random_crop=False, dataset_split='train', seed=3)
    evald = AugmentedDataset(sd, tk, random_crop=False, dataset_split='test', seed=4)
    trainer = Trainer(_model('transf-xl', cfg, mesh), tk, train, evald, args=TrainArgs(**args),
                      out_dir=out_dir, mesh=mesh)
    res = trainer.train(params=ckpt.params_from_jax(flat, 'cpu'))
    specs = mesh_lib.param_specs(res['params'])
    path = ckpt.save_pytree(os.path.join(out_dir, 'sharded'), res['params'], backend='dcp',
                            mesh=mesh, specs=specs)
    zeros = {k: torch.zeros_like(v) for k, v in ckpt.flatten(res['params']).items()}
    back = ckpt.restore_pytree(path, template=ckpt._unflatten(zeros), mesh=mesh, specs=specs)
    same = all(torch.equal(a.detach(), b) for a, b in
               zip(ckpt.flatten(res['params']).values(), ckpt.flatten(back).values()))
    return dict(history=res['history'], host_shard=trainer.host_shard, dcp_roundtrip=same,
                dcp_files=sorted(os.listdir(path)),
                local={k: tuple(v.shape) for k, v in ckpt.flatten(res['params']).items()},
                nonzero=bool(np.any([float(v.detach().abs().sum()) > 0
                                     for v in ckpt.flatten(res['params']).values()])))
