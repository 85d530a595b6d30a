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
    """The bound of a call from the card's rates, by pipe: K6 is K FFMAs per
    element on the FMA pipe; K5 is 5 FMA-pipe, 5 ALU-pipe and 1 MUFU
    instruction per element-pass, and its 11 instructions at the SM's
    dispatch rate (128 lanes per clock) outweigh every single pipe."""
    rates = dict(bytes_per_s=3.35e12, **{f'{pipe}_per_s': lanes * 132 * 1.98e9
                                         for pipe, lanes in tool.LANES_PER_SM.items()})
    assert tool.LANES_PER_SM == dict(fma=128, alu=64, mufu=16, dispatch=128)
    elems = tool.G * M * C * W
    b6 = tool.bound('muladd_chain', 1024, elems, rates)
    assert b6['bound_by'] == 'operations' and b6['pipe'] == 'fma'
    assert b6['bound_ms'] == pytest.approx(1e3 * 1024 * elems / rates['fma_per_s'])
    b5 = tool.bound('mask_chain', 1024, elems, rates)
    assert b5['ops_per_elem_pass'] == dict(fma=5, alu=5, mufu=1)
    assert b5['bound_by'] == 'operations' and b5['pipe'] == 'dispatch'
    assert b5['dispatch_ms'] > b5['alu_ms'] > b5['mufu_ms'] > b5['fma_ms'] > b5['bytes_ms']
    assert b5['alu_ms'] == pytest.approx(5 * 2 * b6['bound_ms'])      # 64 lanes, not 128
    assert b5['mufu_ms'] == pytest.approx(8 * b6['bound_ms'])         # 16 lanes
    assert b5['bound_ms'] == pytest.approx(11 * b6['bound_ms'])
    assert b5['bound_ms'] == pytest.approx(1.4122, abs=1e-4)
    # a few passes move no more work than their bytes
    assert tool.bound('mask_chain', 1, elems, rates)['pipe'] == 'bytes'


SASS = """
        Function : _ZN12_GLOBAL__N_117mask_chain_kernelEPKfPKiS3_Pfiii
        /*0000*/                   LDC R1, c[0x0][0x28] ;                      /* 0x0 */
        /*0010*/                   LDG.E.128 R4, desc[UR4][R2.64] ;            /* 0x0 */
.L_x_0:
        /*0020*/                   FFMA R4, R4, 1.2499999e-07, R8 ;            /* 0x0 */
        /*0030*/                   ISETP.NE.AND P0, PT, R12, R16, PT ;         /* 0x0 */
        /*0040*/              @!P0 FADD R4, R4, 10000 ;                        /* 0x0 */
        /*0050*/                   MUFU.EX2 R5, R4 ;                           /* 0x0 */
        /*0060*/                   MUFU.RCP R6, R5 ;                           /* 0x0 */
        /*0070*/                   F2FP.BF16.F32.PACK_AB R4, R5, RZ ;          /* 0x0 */
        /*0080*/              @!P1 BRA `(.L_x_0) ;                             /* 0x0 */
        /*0090*/                   EXIT ;                                      /* 0x0 */
        Function : _ZN12_GLOBAL__N_117other_kernelEv
        /*0000*/                   EXIT ;                                      /* 0x0 */
"""


def test_sass_loop_counts_one_trip_per_pass_and_element(monkeypatch):
    monkeypatch.setattr(tool, '_sass', lambda name: SASS)
    loop = tool.sass_loop('mask_chain')
    assert loop['instructions_per_pass'] == 7 and loop['loop'] == ['0x20', '0x80']
    assert loop['instructions_per_element'] == 7 / 32
    assert loop['opcodes'] == dict(BRA=1, F2FP=1, FADD=1, FFMA=1, ISETP=1, MUFU=2)
