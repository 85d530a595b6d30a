"""Parameter checkpoints: flat .npz files with '/'-joined keys, the bridge
between the JAX package's parameters and the port's, and the Trainer's epoch
checkpoints (params + optimizer state + counters, appearing atomically).

Counterpart of `musicnlp_tpu/utils/checkpoint.py` (npz backend).  A file holds
one array per leaf under its tree path, e.g. `layers/0/attn/qkv`, so the two
packages read each other's checkpoints.  The port keeps the JAX layouts
(qkv [d_model, 3, N, H], r [d_model, N, H], o [N, H, d_model], dense w
[d_in, d_out]), so the bridge only changes containers: numpy arrays under flat
keys <-> nested dicts (lists for numbered levels) of torch tensors.

On a device mesh the Trainer's npz files hold the gathered (logical) arrays,
written by rank 0, so a single-device `load_trained` reads them unchanged.
The sharded backend (`backend='dcp'`, the counterpart of the JAX package's
orbax backend) writes each rank's own blocks with
`torch.distributed.checkpoint` into a directory and restores them into a
template of the same blocks; no rank ever holds the full arrays.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from musicnlp_tpu_torch import resolve_device

__all__ = ['flatten', 'params_from_jax', 'params_to_jax', 'save_pytree', 'load_flat',
           'restore_pytree', 'save_meta', 'load_meta', 'save_checkpoint', 'load_checkpoint']
# the sharded backend's directory marker
_DCP_META = '.metadata'


def flatten(tree, prefix: str = '') -> Dict[str, Any]:
    """Nested dicts / lists -> {'/'-joined path: leaf}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f'{prefix}/{k}' if prefix else str(k)))
    return out


def _unflatten(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for key, leaf in flat.items():
        node = root
        *parents, last = key.split('/')
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node
    return listify(root)


def params_from_jax(flat: Dict[str, Any],
                    device: Optional[Union[str, torch.device]] = None) -> Dict[str, Any]:
    """JAX parameters as numpy arrays, under flat '/'-joined keys (what the
    JAX package's npz checkpoints hold) or nested (what `utils/hf_import`
    returns) -> the port's nested dict of tensors on `device` (CUDA unless
    'cpu' is asked for)."""
    dev = resolve_device(device)
    return _unflatten({k: torch.from_numpy(np.array(v, copy=True)).to(dev)
                       for k, v in flatten(flat).items()})


def params_to_jax(params) -> Dict[str, np.ndarray]:
    """Inverse of `params_from_jax`: flat '/'-joined keys -> numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in flatten(params).items()}


def _block_keys(tree, specs, mesh) -> Dict[str, Any]:
    """{key: leaf} for the sharded backend: a leaf sharded over some axes is
    stored under its flat key and its block, e.g. `layers/0/attn/o@model:1/2`
    (one entry per rank holding it; replicas write once), any other under its
    flat key."""
    out = {}
    for key, leaf in flatten(tree).items():
        axes = [a for e in specs.get(key, ()) if e is not None
                for a in ((e,) if isinstance(e, str) else e)]
        blocks = ','.join(f'{a}:{mesh.coords[a]}/{mesh.shape[a]}' for a in axes
                          if mesh.shape[a] > 1)
        out[f'{key}@{blocks}' if blocks else key] = leaf
    return out


def save_pytree(path: str, params, backend: str = 'npz', *, mesh=None, specs=None) -> str:
    """Write the port's parameters as an npz (.npz appended), atomically; or,
    with backend='dcp', each rank's blocks (`params` this rank's tree,
    `specs` from `parallel.mesh.param_specs`) into the directory `path`
    (collective: every rank calls it)."""
    if backend == 'dcp':
        import torch.distributed.checkpoint as dcp
        path = os.path.abspath(path)
        dcp.save({k: v.detach() for k, v in _block_keys(params, specs, mesh).items()},
                 checkpoint_id=path)
        return path
    if backend != 'npz':
        raise ValueError(f'unknown checkpoint backend {backend!r}')
    if not path.endswith('.npz'):
        path = path + '.npz'
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        np.savez(f, **params_to_jax(params))
    os.replace(tmp, path)
    return path


def load_flat(path: str) -> Dict[str, np.ndarray]:
    if not path.endswith('.npz'):
        path = path + '.npz'
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def restore_pytree(path: str, device: Optional[Union[str, torch.device]] = None, *,
                   template=None, mesh=None, specs=None):
    """Read an npz written by either package into the port's parameters.  A
    directory is a sharded checkpoint: this rank's blocks are read into a
    copy of `template` (its tree of blocks, as `save_pytree` was given)."""
    if not os.path.isdir(path):
        return params_from_jax(load_flat(path), device)
    import torch.distributed.checkpoint as dcp
    if not os.path.exists(os.path.join(path, _DCP_META)):
        raise ValueError(f'{path} is a directory but no sharded checkpoint')
    state = {k: torch.empty_like(v) for k, v in _block_keys(template, specs, mesh).items()}
    dcp.load(state, checkpoint_id=os.path.abspath(path))
    by_key = dict(zip(flatten(template), state.values()))
    return _unflatten(by_key)


def save_meta(path: str, meta: Dict):
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    tmp = path + '.tmp'
    with open(tmp, 'w') as f:
        json.dump(meta, f, indent=2, default=str)
    os.replace(tmp, path)


def load_meta(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def save_checkpoint(ckpt_dir: str, epoch: int, params, opt_state) -> str:
    """An epoch checkpoint directory: `params.npz` (the layout both packages
    read), `opt_state.npz` (the port's own optimizer layout) and `state.json`
    ({'epoch': e}).  It is written as `<ckpt_dir>.tmp` and renamed when
    complete, so a kill mid-save never leaves a half-written checkpoint where
    resume, rotation or `load_trained` look."""
    tmp = ckpt_dir + '.tmp'
    shutil.rmtree(tmp, ignore_errors=True)
    save_pytree(os.path.join(tmp, 'params'), params)
    save_pytree(os.path.join(tmp, 'opt_state'), opt_state)
    save_meta(os.path.join(tmp, 'state.json'), dict(epoch=epoch))
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    os.rename(tmp, ckpt_dir)
    return ckpt_dir


def load_checkpoint(ckpt_dir: str, device: Optional[Union[str, torch.device]] = None):
    """(params, opt_state, epoch) of a `save_checkpoint` directory, tensors
    on `device`."""
    params = restore_pytree(os.path.join(ckpt_dir, 'params'), device)
    opt_state = restore_pytree(os.path.join(ckpt_dir, 'opt_state'), device)
    return params, opt_state, int(load_meta(os.path.join(ckpt_dir, 'state.json'))['epoch'])
