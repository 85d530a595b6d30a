"""Process groups for data and tensor parallelism, and the sharding rules.

Counterpart of `musicnlp_tpu/parallel/mesh.py`.  The JAX package trains one
GSPMD program over a `(data, model)` device mesh: the batch is sharded over
`data` and Megatron tensor parallelism runs over `model` (attention heads and
FFN columns), with XLA inserting the collectives from the parameters'
shardings.  The port runs one process per GPU (`python -m
torch.distributed.run`), and the collectives are explicit:

  * `Mesh` holds the axis names and sizes, this rank's coordinates (the
    JAX package's row-major reshape of the device list, `model` fastest),
    and one process group per axis of size > 1 (and one for the batch axes
    together on a multislice mesh);
  * `copy_to_model` / `reduce_from_model` are the autograd pair around a
    column- and a row-parallel product: identity forward with an all-reduce
    backward, and an all-reduce forward with an identity backward;
  * `param_specs` gives each leaf its sharding (a tuple of axis names or
    None per dimension, the JAX rules of `_spec_for`), `shard_pytree` slices
    a full tree to this rank's blocks and `gather_pytree` is its inverse.

A world of one process (no process group, or one of size 1) is the trivial
mesh: every collective is skipped, and code that takes a mesh computes what
it computes without one, bit for bit.

Deliberate differences from the JAX package: `host_shard` is (batch index,
batch size) -- one process drives one GPU, so the ranks of one model group
load the same rows -- where the JAX package's is (process index, process
count); and dropout draws come from a generator seeded per data index (the
ranks of one model group draw alike), not from JAX's keys.
"""
from __future__ import annotations

import datetime
import math
import os
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from musicnlp_tpu_torch import resolve_device

__all__ = ['DATA_AXIS', 'MODEL_AXIS', 'REPLICA_AXIS', 'Mesh', 'init_distributed', 'barrier',
           'process_index', 'process_count', 'host_shard', 'make_global_batch', 'make_mesh',
           'make_multislice_mesh', 'rank_coords', 'param_specs', 'batch_specs',
           'replicated_specs', 'shard_pytree', 'gather_pytree', 'copy_to_model',
           'reduce_from_model', 'sum_over_model', 'batch_sum', 'global_mean', 'valid_count',
           'global_loss', 'model_shard',
           'sum_grads_over_batch', 'global_norm']

DATA_AXIS, MODEL_AXIS, REPLICA_AXIS = 'data', 'model', 'replica'
Spec = Tuple[Any, ...]


# --------------------------------------------------------------- the world
def init_distributed(backend: Optional[str] = None,
                     device: Optional[Union[str, torch.device]] = None,
                     timeout_s: Optional[float] = None) -> int:
    """Join the process group that `python -m torch.distributed.run` (or any
    launcher setting RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
    MASTER_PORT) describes; call once per process before building a mesh.
    Returns the world size.

    A no-op when a process group exists or nothing in the environment says
    the launch is distributed.  The device is CUDA unless 'cpu' is asked for:
    `cuda:LOCAL_RANK` (made current) under NCCL, one GPU per rank, or the CPU
    under gloo; `backend` overrides the choice.  Asking for NCCL or CUDA with
    no GPU raises: there is no CPU fallback."""
    wants_cuda = backend == 'nccl' or (device is not None and
                                       torch.device(device).type == 'cuda')
    if wants_cuda and not torch.cuda.is_available():
        raise RuntimeError('NCCL / CUDA asked for, but CUDA is not available; pass '
                           "device='cpu' (gloo) to run on the CPU")
    if dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    if not (env.get('WORLD_SIZE') and env.get('RANK')):
        return 1
    rank, world = int(env['RANK']), int(env['WORLD_SIZE'])
    dev = resolve_device(device)
    if dev.type == 'cuda':
        if dev.index is None:
            dev = torch.device('cuda', int(env.get('LOCAL_RANK', 0)))
        torch.cuda.set_device(dev)
    kw = {} if timeout_s is None else dict(timeout=datetime.timedelta(seconds=timeout_s))
    dist.init_process_group(backend or ('nccl' if dev.type == 'cuda' else 'gloo'),
                            init_method='env://', rank=rank, world_size=world, **kw)
    return world


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier(name: str = 'barrier') -> None:
    """Sync point of every process (a no-op in a single process); used around
    checkpoint writes so no rank reads a file another is still writing."""
    if process_count() > 1:
        dist.barrier()


# ---------------------------------------------------------------- the mesh
def rank_coords(shape: Sequence[int], rank: int) -> Tuple[int, ...]:
    """Coordinates of `rank` in a mesh of `shape`: the position of device
    `rank` in the JAX package's row-major reshape of its device list."""
    return tuple(int(i) for i in np.unravel_index(rank, tuple(shape)))


def _axes(axes: Union[str, Sequence[str]]) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """Axis names and sizes, this rank's coordinates and device, and one
    process group per axis (or set of axes) of size > 1."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int],
                 device: torch.device, rank: int = 0, groups: Optional[Dict] = None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.device = device
        self.rank = rank
        self.coords = dict(zip(self.axis_names, rank_coords(shape, rank)))
        self._groups = groups or {}

    def __repr__(self):
        return f'Mesh({self.shape}, rank {self.rank} at {self.coords}, {self.device})'

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """Every axis but `model`: the batch shards over all of them."""
        return tuple(a for a in self.axis_names if a != MODEL_AXIS)

    def size(self, axes) -> int:
        return math.prod(self.shape[a] for a in _axes(axes))

    def index(self, axes) -> int:
        """This rank's row-major position over `axes`."""
        i = 0
        for a in _axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes):
        return self._groups.get(_axes(axes))

    @property
    def n_model(self) -> int:
        return self.shape.get(MODEL_AXIS, 1)

    @property
    def model_index(self) -> int:
        return self.coords.get(MODEL_AXIS, 0)

    @property
    def n_batch(self) -> int:
        return self.size(self.batch_axes)

    @property
    def batch_index(self) -> int:
        return self.index(self.batch_axes)

    def all_reduce(self, t: torch.Tensor, axes, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """In-place all-reduce of `t` over `axes` (nothing at size 1)."""
        if self.size(axes) > 1:
            dist.all_reduce(t, op=op, group=self.group(axes))
        return t


def _build(axis_names: Tuple[str, ...], shape: Tuple[int, ...], device) -> Mesh:
    n = math.prod(shape)
    world = process_count()
    if n != world:
        raise ValueError(f'a mesh of {dict(zip(axis_names, shape))} needs {n} processes, '
                         f'the world has {world} (launch with python -m torch.distributed.run '
                         f'--nproc-per-node {n} and call init_distributed first)')
    dev = resolve_device(device)
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', torch.cuda.current_device())
    rank = process_index()
    groups = {}
    if world > 1:
        batch = tuple(a for a in axis_names if a != MODEL_AXIS)
        sets = [(a,) for a in axis_names]
        if len(batch) > 1:
            sets.append(batch)
        coords = [rank_coords(shape, r) for r in range(world)]
        for axes in sets:
            pos = [axis_names.index(a) for a in axes]
            if math.prod(shape[p] for p in pos) == 1:
                continue
            # every rank creates every group, in one order (new_group is collective)
            members: Dict[Tuple, list] = {}
            for r, c in enumerate(coords):
                key = tuple(x for i, x in enumerate(c) if i not in pos)
                members.setdefault(key, []).append(r)
            for key in sorted(members):
                g = dist.new_group(members[key])
                if rank in members[key]:
                    groups[axes] = g
    return Mesh(axis_names, shape, dev, rank, groups)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """A (data, model) mesh over every process of the world (one process
    with no process group: the trivial (1, 1) mesh).  `device` is this rank's
    (CUDA unless 'cpu' is asked for; 'cuda' means the current device)."""
    world = process_count()
    if n_data is None:
        if world % n_model:
            raise ValueError(f'{world} processes not divisible by model={n_model}')
        n_data = world // n_model
    return _build((DATA_AXIS, MODEL_AXIS), (n_data, n_model), device)


def make_multislice_mesh(n_replica: int, n_data: Optional[int] = None, n_model: int = 1,
                         device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """(replica, data, model) mesh, `replica` outermost; the batch shards
    over (replica, data) jointly (`batch_specs(multislice=True)`)."""
    world = process_count()
    if n_data is None:
        if world % (n_replica * n_model):
            raise ValueError(f'{world} processes not divisible by {n_replica} x {n_model}')
        n_data = world // (n_replica * n_model)
    return _build((REPLICA_AXIS, DATA_AXIS, MODEL_AXIS), (n_replica, n_data, n_model), device)


def host_shard(mesh: Optional[Mesh] = None) -> Optional[Tuple[int, int]]:
    """(batch index, batch size) for `SongDataset.batches(shard=...)`: the
    rows of each global batch this rank loads, the same for every rank of
    one model group.  None when the batch is not split (a world of one).
    Without a mesh: (rank, world), every rank a data rank."""
    if mesh is None:
        n = process_count()
        return (process_index(), n) if n > 1 else None
    n = mesh.n_batch
    return (mesh.batch_index, n) if n > 1 else None


def make_global_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch (numpy) -> tensors on its device.
    The global batch is never assembled: each step's collectives combine
    the ranks' results."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(mesh.device, non_blocking=True)
            for k, v in batch.items()}


# ----------------------------------------------------------- the sharding rules
def _spec_for(names: Sequence[str], ndim: int, shard_vocab: bool = False) -> Spec:
    """Megatron-style rule for one leaf, keyed by its path (the JAX
    package's `_spec_for`): attention heads and FFN hidden columns shard over
    `model`; embeddings, norms and the head replicate, unless `shard_vocab`
    row-shards the tied [V, d] table and its bias.  Both model families."""
    last = names[-1] if names else ''
    parent = names[-2] if len(names) > 1 else ''
    if shard_vocab:
        if parent == 'embed' and last == 'weight':     # [V, d] row-sharded
            return (MODEL_AXIS, None)
        if last == 'out_bias':                         # [V]
            return (MODEL_AXIS,)
    if last == 'qkv':                                  # [d, 3, N, H]
        return (None, None, MODEL_AXIS, None)
    if last in ('r', 'qk') or (last in ('v', 'k') and parent == 'attn'):
        return (None, MODEL_AXIS, None)                # [d, N, H]
    if last == 'o':                                    # [N, H, d] row-parallel
        return (MODEL_AXIS, None, None)
    if last in ('r_w_bias', 'r_r_bias'):               # [N, H]
        return (MODEL_AXIS, None)
    if parent == 'w1':                                 # column-parallel FFN in
        return (None, MODEL_AXIS) if last == 'w' else (MODEL_AXIS,)
    if parent == 'w2':                                 # row-parallel FFN out
        return (MODEL_AXIS, None) if last == 'w' else (None,)
    return (None,) * ndim


def _walk(fn: Callable[[str, Any], Any], tree, prefix: str = ''):
    """fn(flat key, leaf) over a nested dict / list tree, the structure kept;
    keys are '/'-joined as `utils.checkpoint.flatten` joins them."""
    if isinstance(tree, dict):
        return {k: _walk(fn, v, f'{prefix}/{k}' if prefix else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(fn, v, f'{prefix}/{i}' if prefix else str(i)) for i, v in enumerate(tree)]
    return fn(prefix, tree)


def _leaves(tree) -> Dict[str, Any]:
    out = {}
    _walk(lambda k, v: out.__setitem__(k, v), tree)
    return out


def param_specs(params, shard_vocab: bool = False) -> Dict[str, Spec]:
    """{flat key: spec} for a parameter (or optimizer-state) tree: a tuple
    with one entry per dimension, an axis name or None (the JAX package's
    PartitionSpec entries).  List indices are not names, as in the JAX rule."""
    return {k: _spec_for([p for p in k.split('/') if not p.isdigit()], np.ndim(v),
                         shard_vocab=shard_vocab)
            for k, v in _leaves(params).items()}


def batch_specs(multislice: bool = False) -> Dict[str, Spec]:
    """Shardings of one training batch: rows over `data` (over (replica,
    data) jointly on a multislice mesh)."""
    axis = (REPLICA_AXIS, DATA_AXIS) if multislice else DATA_AXIS
    return dict(input_ids=(axis, None), labels=(axis, None), key_scores=(axis, None))


def replicated_specs(tree) -> Dict[str, Spec]:
    return {k: () for k in _leaves(tree)}


def _blocks(spec: Spec, mesh: Mesh):
    """(dim, axes) of each sharded dimension of a spec."""
    return [(d, _axes(e)) for d, e in enumerate(spec) if e is not None]


def shard_pytree(tree, specs: Dict[str, Spec], mesh: Mesh):
    """A full tree (numpy arrays or tensors) -> this rank's blocks, as
    tensors on its device (owning their memory: no view keeps the full
    array alive)."""
    def one(key, x):
        t = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
        for d, axes in _blocks(specs.get(key, ()), mesh):
            n = mesh.size(axes)
            if t.shape[d] % n:
                raise ValueError(f'{key}: dim {d} of {tuple(t.shape)} not divisible by {n}')
            w = t.shape[d] // n
            t = t.narrow(d, mesh.index(axes) * w, w)
        return t.to(mesh.device).clone(memory_format=torch.contiguous_format)
    return _walk(one, tree)


def gather_pytree(tree, specs: Dict[str, Spec], mesh: Mesh):
    """Inverse of `shard_pytree`: every rank's blocks -> the full tree on
    this rank's device, bit for bit.  Collective (every rank calls it).  A
    block goes into a zero tensor of the full shape and one all-reduce over
    its axes sums the blocks' bytes as uint8: a byte added to zeros stays
    itself, and all-reduce (unlike gloo's all-gather) takes CUDA tensors."""
    def one(key, t):
        t = t.detach()
        for d, axes in _blocks(specs.get(key, ()), mesh):
            n = mesh.size(axes)
            if n == 1:
                continue
            shape = list(t.shape)
            w = shape[d]
            shape[d] = w * n
            full = torch.zeros(shape, dtype=t.dtype, device=t.device)
            full.narrow(d, mesh.index(axes) * w, w).copy_(t)
            mesh.all_reduce(full.view(torch.uint8), axes)
            t = full
        return t
    return _walk(one, tree)


# ------------------------------------------------- collectives with gradients
class _AllReduce(torch.autograd.Function):
    """Forward: sum over `axes`; backward: identity (the summed result is
    replicated, so each rank's copy already carries the whole gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        y = x.contiguous().clone()
        return mesh.all_reduce(y, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyToModel(torch.autograd.Function):
    """Forward: identity; backward: sum over `model` (each rank's product
    read only its columns, so its input gradient is a partial sum)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        return ctx.mesh.all_reduce(g, MODEL_AXIS), None


def _tp(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.n_model > 1


def copy_to_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The input of a column-parallel product (identity at model size 1)."""
    return _CopyToModel.apply(x, mesh) if _tp(mesh) else x


def reduce_from_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of a row-parallel product's partial results over `model`."""
    return _AllReduce.apply(x, mesh, MODEL_AXIS) if _tp(mesh) else x


def sum_over_model(y: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """`reduce_from_model` summed in f32, cast back to y's dtype."""
    return reduce_from_model(y.float(), mesh).to(y.dtype) if _tp(mesh) else y


def model_shard(mesh: Optional[Mesh], dim: int) -> Optional[Tuple[int, int, int]]:
    """(dim, model index, model size) for `ops.layers.dropout` on an
    activation sharded over `model` along `dim`; None at model size 1."""
    return (dim, mesh.model_index, mesh.n_model) if _tp(mesh) else None


def batch_sum(x: torch.Tensor, mesh: Optional[Mesh], grad: bool = False) -> torch.Tensor:
    """x summed over the batch axes; with `grad`, differentiable (identity
    backward), else detached."""
    if mesh is None or mesh.n_batch == 1:
        return x if grad else x.detach()
    if grad:
        return _AllReduce.apply(x, mesh, mesh.batch_axes)
    return mesh.all_reduce(x.detach().contiguous().clone(), mesh.batch_axes)


def global_mean(mean: torch.Tensor, count: torch.Tensor, mesh: Optional[Mesh], *,
                total: Optional[torch.Tensor] = None, grad: bool = False) -> torch.Tensor:
    """The batch-global mean of per-rank means: `mean` over max(count, 1)
    items on each rank -> sum(mean * max(count, 1)) / max(sum(count), 1)."""
    if mesh is None or mesh.n_batch == 1:
        return mean
    if total is None:
        total = torch.clamp(batch_sum(count.float(), mesh), min=1.0)
    return batch_sum(mean * torch.clamp(count.float(), min=1.0), mesh, grad=grad) / total


def valid_count(labels: torch.Tensor) -> torch.Tensor:
    """The positions a CLM loss counts: shifted labels other than -100."""
    return (labels[:, 1:] != -100).sum().float()


def global_loss(loss: torch.Tensor, mets: Dict[str, torch.Tensor], labels: torch.Tensor,
                mesh: Optional[Mesh]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """A rank's CLM loss and metrics (means over its rows' valid labels) ->
    the global batch's, weighted by valid labels (unchanged without a mesh
    or with one data rank).  The loss keeps the gradient of this rank's share
    of the global mean; the Trainer sums the gradients over the batch axes."""
    if mesh is None or mesh.n_batch == 1:
        return loss, mets
    n_local = valid_count(labels)
    total = torch.clamp(batch_sum(n_local, mesh), min=1.0)
    return (global_mean(loss, n_local, mesh, total=total, grad=True),
            dict(mets, ntp_acc=global_mean(mets['ntp_acc'], n_local, mesh, total=total),
                 n_tok=total))


def sum_grads_over_batch(grads: Sequence[torch.Tensor], mesh: Optional[Mesh]) -> None:
    """Sum the gradients over the batch axes, in place, in one all-reduce
    per dtype (each rank's loss was scaled to its share of the global batch,
    so the sum is the global batch's gradient)."""
    if mesh is None or mesh.n_batch == 1:
        return
    by_dtype: Dict[torch.dtype, list] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for gs in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in gs])
        mesh.all_reduce(flat, mesh.batch_axes)
        off = 0
        for g in gs:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def global_norm(grads: Dict[str, torch.Tensor], mesh: Optional[Mesh] = None,
                shard_vocab: bool = False) -> torch.Tensor:
    """sqrt(sum of squares) of the logical gradient {flat key: grad}, in f32
    (optax.global_norm): over `mesh`'s model axis the leaves sharded over it
    (`param_specs`) are summed over it, each replicated leaf once."""
    def sq(ts):
        return sum((t.float() * t.float()).sum() for t in ts)
    if not _tp(mesh):
        return torch.sqrt(sq(grads.values()))
    specs = param_specs(grads, shard_vocab=shard_vocab)
    sharded = [g for k, g in grads.items() if MODEL_AXIS in _flat_axes(specs[k])]
    rep = [g for k, g in grads.items() if MODEL_AXIS not in _flat_axes(specs[k])]
    part = sq(sharded) if sharded else torch.zeros((), device=mesh.device)
    part = mesh.all_reduce(torch.as_tensor(part, dtype=torch.float32).clone(), MODEL_AXIS)
    return torch.sqrt(part + (sq(rep) if rep else 0.0))


def _flat_axes(spec: Spec) -> Tuple[str, ...]:
    return tuple(a for e in spec if e is not None for a in _axes(e))
