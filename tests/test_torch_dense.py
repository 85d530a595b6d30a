"""`ops.layers.dense` against the JAX `dense` and against autograd of the
unfused layer, on the CPU: one rounding of the f32 product plus the f32
bias in 16 bits (ROADMAP C.4), the `_Dense` Function's gradients (relu
inputs at exactly 0 included), the FFN's dropout draws, and `bias_act`'s
CPU path (its plain version, no launch) and refusals."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicnlp_tpu.ops import layers as jl
from musicnlp_tpu_torch.ops import layers as tl
from tests.torch_parity import np_of, randn


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in bf16 ulps: the distance of their bit patterns on the
    ordered line of bf16 values (+0 and -0 at one point)."""
    def order(t):
        bits = t.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7fff), bits)
    return (order(a) - order(b)).abs()


def _bf16(x: np.ndarray) -> np.ndarray:
    return np_of(torch.from_numpy(x).bfloat16())


def _c4_inputs(exact):
    """x [2, 256, 384] in bf16, w [384, 512] and b [512] in f32, w and b
    drawn N(0, 0.02), x N(0, 1).  With `exact`, x is quantized to eighths
    in [-1, 1] and w to multiples of 2^-11 (both bf16 values), so every
    product and partial sum is exact in f32 and any summation order gives
    the same f32 sum: only the roundings after it can differ."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 256, 384)).astype(np.float32)
    w = (rng.standard_normal((384, 512)) * 0.02).astype(np.float32)
    b = (rng.standard_normal(512) * 0.02).astype(np.float32)
    if exact:
        x = np.clip(np.round(x * 8), -8, 8).astype(np.float32) / 8
        w = np.clip(np.round(w * 2048), -255, 255).astype(np.float32) / 2048
    return _bf16(x), w, b


@pytest.mark.parametrize('exact', [True, False])
@pytest.mark.parametrize('act', [None, 'relu'])
def test_bf16_dense_rounds_once_as_jax(act, exact):
    """C.4: with a bias drawn N(0, 0.02), the bf16 `dense` against the JAX
    `dense` (f32 product, f32 bias, one rounding).  On exact sums every
    output is JAX's, bit for bit.  On N(0, 1) inputs the f32 sums differ
    by their summation order, which moves under 0.5% of outputs by one
    ulp; only outputs that cancel to within 2^-10 of the largest (whose
    f32 sums differ by more than their own ulp) lie further.  The form
    that rounds the product first and again after the bias differs from
    JAX's in more than 5% of outputs on both."""
    x, w, b = _c4_inputs(exact)
    want = jl.dense(dict(w=jnp.asarray(w), b=jnp.asarray(b)), jnp.asarray(x, jnp.bfloat16))
    if act == 'relu':
        want = jax.nn.relu(want)
    want = torch.from_numpy(np_of(want)).bfloat16()
    tx, tw, tb = torch.from_numpy(x).bfloat16(), torch.from_numpy(w), torch.from_numpy(b)
    launches = tl.LAUNCHES['bias_act']
    got = tl.dense(dict(w=tw, b=tb), tx, act=act)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 256, 512)
    assert tl.LAUNCHES['bias_act'] == launches              # the CPU takes the plain version
    d = _ulps(got, want)
    if exact:
        assert torch.equal(got, want)
    else:
        assert float((d >= 1).float().mean()) < 0.005
        far = want.float().abs() >= 2.0 ** -10 * float(want.float().abs().max())
        assert int(d[far].max()) <= 1
    twice = ((tx @ tw.bfloat16()).float() + tb).bfloat16()
    if act == 'relu':
        twice = torch.relu(twice)
    assert float((_ulps(twice, want) >= 1).float().mean()) > 0.05


def test_f32_dense_is_the_plain_product_plus_bias():
    """In f32 the product is already f32: dense equals x @ w + b bit for bit."""
    x, w, b = (torch.from_numpy(randn(s, *shape)) for s, shape in
               ((3, (4, 7, 24)), (4, (24, 40)), (5, (40,))))
    assert torch.equal(tl.dense(dict(w=w, b=b), x), x @ w + b)
    assert torch.equal(tl.dense(dict(w=w, b=b), x, act='relu'), torch.relu(x @ w + b))
    assert torch.equal(tl.dense(dict(w=w), x), x @ w)


def _exact_inputs(seed):
    """Small integers over powers of two (every product and sum exact in
    f32), and a bias that puts row 0's first 6 pre-activations at exactly 0."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-4, 5, (3, 5, 16)).astype(np.float32)
    w = rng.integers(-4, 5, (16, 12)).astype(np.float32) / 4
    b = rng.integers(-8, 9, 12).astype(np.float32) / 8
    b[:6] = -(x.reshape(-1, 16)[0] @ w)[:6]
    return [torch.from_numpy(t) for t in (x, w, b)]


@pytest.mark.parametrize('act,bias', [('relu', True), (None, True), ('relu', False)])
def test_dense_gradients_match_autograd_of_the_unfused_form(act, bias):
    """dx, dw and db of the `_Dense` Function against autograd through
    act(x @ w + b) in f32, on inputs whose relu sees exact zeros (gradient
    0 there, as torch.relu's)."""
    x, w, b = _exact_inputs(7)
    g = torch.from_numpy(randn(8, 3, 5, 12))
    leaves = [x, w] + ([b] if bias else [])
    pre = x.reshape(-1, 16) @ w + (b if bias else 0)
    if bias and act:
        assert int((pre[0, :6] == 0).sum()) == 6

    def run(fn):
        ins = [t.clone().requires_grad_(True) for t in leaves]
        out = fn(*ins)
        return out, torch.autograd.grad(out, ins, g)

    def unfused(x, w, b=None):
        y = x @ w + (b if b is not None else 0)
        return torch.relu(y) if act else y

    def fused(x, w, b=None):
        return tl.dense(dict(w=w, **({'b': b} if b is not None else {})), x, act=act)
    want, want_grads = run(unfused)
    got, got_grads = run(fused)
    assert torch.equal(got, want)
    for name, a, e in zip(('dx', 'dw', 'db'), got_grads, want_grads):
        assert a.dtype == e.dtype and a.shape == e.shape, name
        torch.testing.assert_close(a, e, rtol=1e-6, atol=1e-6, msg=name)
    if bias and act:      # a relu with gradient 1 at 0 would read another db
        kink_on = (g.reshape(-1, 12) * (pre >= 0)).sum(0)
        assert not torch.allclose(kink_on, got_grads[2])


def test_bf16_dense_gradients_keep_their_dtypes():
    """In bf16 the gradient stays bf16 up to the parameters: dx bf16, dw and
    db f32 (the masters' dtype), near autograd of the unfused bf16 layer."""
    x = torch.from_numpy(randn(9, 4, 32, 64)).bfloat16().requires_grad_(True)
    w = torch.from_numpy(randn(10, 64, 48, scale=0.05)).requires_grad_(True)
    b = torch.from_numpy(randn(11, 48, scale=0.05)).requires_grad_(True)
    g = torch.from_numpy(randn(12, 4, 32, 48)).bfloat16()
    got = torch.autograd.grad(tl.dense(dict(w=w, b=b), x, act='relu'), [x, w, b], g)
    unfused = torch.relu(((x @ w.bfloat16()).float() + b).bfloat16())
    want = torch.autograd.grad(unfused, [x, w, b], g)
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32, torch.float32]
    for a, e in zip(got, want):
        torch.testing.assert_close(a.float(), e.float(), rtol=2e-2, atol=2e-2)


def test_ffn_draws_its_dropout_as_before():
    """`ffn` with the fused relu draws the same masks, in the same order and
    shapes, from its generator as relu then dropout did."""
    p = {'w1': dict(w=torch.from_numpy(randn(13, 16, 32, scale=0.2)),
                    b=torch.from_numpy(randn(14, 32, scale=0.2))),
         'w2': dict(w=torch.from_numpy(randn(15, 32, 16, scale=0.2)),
                    b=torch.from_numpy(randn(16, 16, scale=0.2))),
         'ln': dict(scale=torch.ones(16), bias=torch.zeros(16))}
    x = torch.from_numpy(randn(17, 2, 9, 16))
    got = tl.ffn(p, x, dropout_rate=0.3, generator=torch.Generator().manual_seed(5),
                 deterministic=False)
    gen = torch.Generator().manual_seed(5)
    h = tl.dropout(torch.relu(x @ p['w1']['w'] + p['w1']['b']), 0.3, gen, False)
    h = tl.dropout(h @ p['w2']['w'] + p['w2']['b'], 0.3, gen, False)
    assert torch.equal(got, tl.layer_norm(p['ln'], x + h))


def test_bias_act_cpu_path_and_refusals():
    """On the CPU `bias_act` is its plain version (f32, bf16, f16 outputs,
    with or without a bias); it refuses an unknown act, an output dtype the
    kernel does not write and a non-f32 or mis-shaped input."""
    y, b = torch.from_numpy(randn(18, 3, 7, 10)), torch.from_numpy(randn(19, 10))
    launches = tl.LAUNCHES['bias_act']
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for bias in (b, None):
            for act in (None, 'relu'):
                want = y + (bias if bias is not None else 0)
                want = (torch.relu(want) if act else want).to(dtype)
                assert torch.equal(tl.bias_act(y, bias, act, dtype), want)
    assert tl.LAUNCHES['bias_act'] == launches
    with pytest.raises(ValueError, match='act'):
        tl.bias_act(y, b, 'gelu', torch.bfloat16)
    with pytest.raises(TypeError, match='writes'):
        tl.bias_act(y, b, None, torch.float64)
    with pytest.raises(ValueError, match='f32'):
        tl.bias_act(y.bfloat16(), b, None, torch.bfloat16)
    with pytest.raises(ValueError, match='f32'):
        tl.bias_act(y, b[:9], None, torch.bfloat16)
