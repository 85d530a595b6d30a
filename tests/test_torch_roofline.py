"""The roofline kernels' module (K5, K6) against the Pallas TPU kernels of
`scripts/vpu_roofline.py`, run in interpret mode on the CPU, and the port's
roofline tool on the CPU (where it must refuse to time anything)."""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from musicnlp_tpu_torch.ops import roofline_kernels as rk
from musicnlp_tpu_torch.tools import vpu_roofline as tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = 2                      # programs: the script's [8, 64, 128] blocks, two of them
M, C, W = 8, 64, 128


def _script():
    spec = importlib.util.spec_from_file_location(
        'vpu_roofline_script', os.path.join(REPO, 'scripts', 'vpu_roofline.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _chain_inputs(seed):
    s = np.random.default_rng(seed).standard_normal((GRID, M, C, W)).astype(np.float32)
    kp = np.tile((np.arange(W, dtype=np.int32) - C)[None, None, :], (GRID, M, 1))
    qp = np.tile(np.arange(C, dtype=np.int32)[None, None, :], (GRID, M, 1))
    return s, kp, qp


def _pallas_chain(K, s, kp, qp):
    call = pl.pallas_call(
        _script()._mask_chain_kernel(K), grid=(GRID,),
        in_specs=[pl.BlockSpec((1, M, C, W), lambda g: (g, 0, 0, 0)),
                  pl.BlockSpec((1, M, W), lambda g: (g, 0, 0)),
                  pl.BlockSpec((1, M, C), lambda g: (g, 0, 0))],
        out_specs=pl.BlockSpec((1, M, C, W), lambda g: (g, 0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((GRID, M, C, W), jnp.float32), interpret=True)
    return np.asarray(call(jnp.asarray(s), jnp.asarray(kp), jnp.asarray(qp)))


def _pallas_muladd(K, s):
    call = pl.pallas_call(
        _script()._muladd_kernel(K), grid=(GRID,),
        in_specs=[pl.BlockSpec((1, M, C, W), lambda g: (g, 0, 0, 0))],
        out_specs=pl.BlockSpec((1, M, C, W), lambda g: (g, 0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((GRID, M, C, W), jnp.float32), interpret=True)
    return np.asarray(call(jnp.asarray(s)))


@pytest.mark.parametrize('K', [1, 3, 8])
def test_mask_chain_plain_matches_pallas_interpret(K):
    """Each entry within one bf16 ulp (|d| <= 2^-7 |x|): the f32 sums run in
    other orders and a bf16 rounding may flip; the share of bit-equal entries
    is reported."""
    s, kp, qp = _chain_inputs(K)
    want = _pallas_chain(K, s, kp, qp)
    got = rk.mask_chain(torch.from_numpy(s), torch.from_numpy(kp), torch.from_numpy(qp),
                        K).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want)), \
        float(np.abs(got - want).max())
    equal = float(np.mean(got == want))
    print(f'K={K}: {equal:.4%} of entries bit-equal')
    # every row's window holds its self key (kp == qp), which the +1e4 bias
    # makes the row's softmax: the chain ends on a one-hot row
    assert np.allclose(want.sum(-1), 1.0) and float(want.max()) == 1.0


def test_mask_chain_plain_exercises_every_branch():
    """A row whose self key is out of its window: the masked, the valid and
    the self branches all shape the result (not a one-hot)."""
    s, kp, qp = _chain_inputs(5)
    qp = qp + 40                              # self keys move right: more valid keys
    kp = kp.copy()
    kp[:, :, ::3] = 10 ** 6                   # every third key masked
    want = _pallas_chain(3, s, kp, qp)
    got = rk.mask_chain(torch.from_numpy(s), torch.from_numpy(kp), torch.from_numpy(qp),
                        3).numpy()
    assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want))
    print(f'{float(np.mean(got == want)):.4%} of entries bit-equal')
    spread = np.mean((want > 0) & (want < 1))       # rows whose softmax is not one key
    assert spread > 0.05, spread


def _muladd_inputs(K):
    return np.random.default_rng(10 + K).standard_normal((GRID, M, C, W)).astype(np.float32)


def _muladd_rel_err(got, want):
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def _muladd_limit(K):
    """The chain's one multiply (x 1.0000001 = 1 + 2^-23) lifts the output by
    about K 2^-24 of its largest entry; rounding the product and the sum
    apart instead of once moves it by about K 2^-25.5 (1.5e-7 at K 8, 4.6e-6
    at K 256, measured against the interpret-mode kernel).  The limit
    K 2^-25 lies between, so a chain without the multiply fails from K 3."""
    return max(K, 4) * 2.0 ** -25


@pytest.mark.parametrize('K', [1, 3, 8, 256])
def test_muladd_chain_plain_matches_pallas_interpret(K):
    """Within K 2^-25 of the output's largest entry (`_muladd_limit`): the
    plain version rounds each pass once (a fused multiply-add), the
    interpret-mode kernel may round the product and the sum apart."""
    s = _muladd_inputs(K)
    want = _pallas_muladd(K, s)
    got = rk.muladd_chain(torch.from_numpy(s), K).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert _muladd_rel_err(got, want) <= _muladd_limit(K)
    print(f'K={K}: {float(np.mean(got == want)):.4%} of entries bit-equal')


@pytest.mark.parametrize('K', [8, 256])
def test_muladd_limit_catches_a_dropped_multiply(K):
    """A planted fault: the chain without its multiply (acc = acc + s, one
    rounding per pass) lies outside the limit the plain version is held to."""
    s = _muladd_inputs(K)
    want = _pallas_muladd(K, s)
    s64, acc = s.astype(np.float64), s
    for _ in range(K):
        acc = (acc.astype(np.float64) + s64).astype(np.float32)
    assert _muladd_rel_err(acc, want) > 2 * _muladd_limit(K)


def test_wrappers_check_shapes_and_devices():
    s = torch.zeros(1, 2, 4, W)
    kp, qp = torch.zeros(1, 2, W, dtype=torch.int32), torch.zeros(1, 2, 4, dtype=torch.int32)
    before = dict(rk.LAUNCHES)
    assert rk.mask_chain(s, kp, qp, 0).equal(s)           # CPU: the plain version
    assert rk.muladd_chain(s, 0).equal(s)
    assert rk.LAUNCHES == before                          # no kernel was launched
    with pytest.raises(ValueError, match='128'):
        rk.mask_chain(torch.zeros(1, 2, 4, 64), kp, qp, 1)
    with pytest.raises(ValueError, match='qp'):
        rk.mask_chain(s, kp, qp[:, :1], 1)
    with pytest.raises(ValueError, match='K'):
        rk.muladd_chain(s, -1)


def test_roofline_tool_needs_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        tool.main(['--out', str(tmp_path / 'r.json')])
    assert not (tmp_path / 'r.json').exists()
    assert tool.K3_PROGRAMS == 3072 and tool.OUT_DEFAULT.parent.name == 'build'


def test_roofline_bound_counts_the_card_rates():
    """The bound of a call from the card's rates: K6 is K FMAs per element on
    the FP32 pipes; K5's 12 FP32 operations per element outweigh its ex2."""
    rates = dict(fp32_per_s=128 * 132 * 1.98e9, sfu_per_s=16 * 132 * 1.98e9,
                 bytes_per_s=3.35e12)
    elems = tool.G * M * C * W
    b6 = tool.bound('muladd_chain', 1024, elems, rates)
    assert b6['bound_by'] == 'operations'
    assert b6['bound_ms'] == pytest.approx(1e3 * 1024 * elems / rates['fp32_per_s'])
    b5 = tool.bound('mask_chain', 1024, elems, rates)
    assert b5['bound_by'] == 'operations' and b5['fp32_ms'] > b5['sfu_ms'] > b5['bytes_ms']
    assert b5['bound_ms'] == pytest.approx(12 * b6['bound_ms'])
