"""The port stands alone: it imports neither jax nor the JAX package, and its
entry points never fall back to the CPU on their own."""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import musicnlp_tpu_torch
from musicnlp_tpu_torch.models.reformer import Reformer, ReformerConfig
from musicnlp_tpu_torch.models.transformer_xl import TransfoXL, TransfoXLConfig
from musicnlp_tpu_torch.ops.chunked_attention_kernel import (
    chunked_window_attn, chunked_window_attn_bwd)
from musicnlp_tpu_torch.ops.flash_attention import flash_rel_attn_fwd
from musicnlp_tpu_torch.ops.roofline_kernels import mask_chain, muladd_chain
from musicnlp_tpu_torch.trainer.eval import MusicGenerator, load_trained
from musicnlp_tpu_torch.utils.checkpoint import params_from_jax, save_meta

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_no_jax_in_sys_modules():
    code = textwrap.dedent('''
        import importlib, pkgutil, sys
        import musicnlp_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split('.')[0] in ('jax', 'jaxlib', 'musicnlp_tpu'))
        print(len(names), bad)
        assert not bad, bad
        assert len(names) >= 30, names
        for sub in ('io.musicxml', 'preprocess.dataset', 'preprocess.music_export',
                    'tools.vpu_roofline', 'ops.roofline_kernels', 'cli', '__main__'):
            assert pkg.__name__ + '.' + sub in names, sub
    ''')
    # a PATH without nvcc: importing the kernel modules builds nothing
    env = dict(os.environ, PATH='/usr/bin:/bin', PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)


def test_entry_points_raise_without_cuda(no_cuda, tmp_path):
    cfg = TransfoXLConfig.from_size('debug', vocab_size=422)
    with pytest.raises(RuntimeError, match='CUDA'):
        musicnlp_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError, match='CUDA'):
        TransfoXL(cfg)
    with pytest.raises(RuntimeError, match='CUDA'):
        MusicGenerator(TransfoXL(cfg), None, None)
    with pytest.raises(RuntimeError, match='CUDA'):
        params_from_jax({'w': np.zeros(2, np.float32)})
    save_meta(str(tmp_path / 'meta.json'), dict(model_name='transf-xl', config=dict(
        vocab_size=422, d_model=32, n_head=2, d_head=16, d_inner=64, n_layer=1)))
    with pytest.raises(RuntimeError, match='CUDA'):
        load_trained(str(tmp_path))
    assert TransfoXL(cfg, device='cpu').device.type == 'cpu'

    rcfg = ReformerConfig.from_size('debug', vocab_size=422)
    with pytest.raises(RuntimeError, match='CUDA'):
        Reformer(rcfg)
    reformer_run = tmp_path / 'reformer'
    save_meta(str(reformer_run / 'meta.json'), dict(model_name='reformer', config=dict(
        vocab_size=422, d_model=32, n_head=2, d_head=16, d_ff=64, attn_layers=['local', 'lsh'],
        max_length=64, axial_pos_shape=[8, 8])))
    with pytest.raises(RuntimeError, match='CUDA'):
        load_trained(str(reformer_run))
    assert Reformer(rcfg, device='cpu').device.type == 'cpu'


def test_k1_wrapper_refuses_other_devices():
    """Only CPU tensors take the plain version: any other device launches the
    kernel (CUDA) or raises."""
    t = torch.empty(4, 8, 16, device='meta')
    g = torch.empty(2, 16, 16, device='meta')
    with pytest.raises(ValueError, match='CUDA'):
        flash_rel_attn_fwd(t, t, t, t, g, 0, M=0, scale=0.25)


def test_k3_k4_wrappers_refuse_other_devices():
    """As K1: CPU tensors take the plain versions, CUDA tensors launch K3 / K4,
    and any other device raises."""
    t = torch.empty(2, 64, 16, device='meta')
    pos = torch.empty(2, 64, dtype=torch.int32, device='meta')
    lse = torch.empty(2, 64, device='meta')
    with pytest.raises(ValueError, match='CUDA'):
        chunked_window_attn(t, t, t, pos, pos, chunk=32, scale=0.25)
    with pytest.raises(ValueError, match='CUDA'):
        chunked_window_attn_bwd(t, t, t, pos, pos, t, t, lse, lse, chunk=32, scale=0.25)


def test_k5_k6_wrappers_refuse_other_devices():
    """As K1: CPU tensors take the plain versions, CUDA tensors launch K5 / K6,
    and any other device raises."""
    s = torch.empty(2, 8, 64, 128, device='meta')
    kp = torch.empty(2, 8, 128, dtype=torch.int32, device='meta')
    qp = torch.empty(2, 8, 64, dtype=torch.int32, device='meta')
    with pytest.raises(ValueError, match='CUDA'):
        mask_chain(s, kp, qp, 4)
    with pytest.raises(ValueError, match='CUDA'):
        muladd_chain(s, 4)


@pytest.mark.parametrize('field,value', [('hf_compat', True), ('remat', True),
                                         ('decode_mode', 'bounded'), ('decode_scan_chunk', 32)])
def test_deferred_reformer_fields_raise(field, value):
    """Config fields whose code paths come with later slices refuse to run
    instead of computing something else."""
    cfg = dataclasses.replace(ReformerConfig.from_size('debug', vocab_size=422), **{field: value})
    with pytest.raises(NotImplementedError, match='slice'):
        Reformer(cfg, device='cpu').init_decode_state(1)
