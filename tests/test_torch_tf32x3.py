"""3xTF32, the f32 products of the slab kernels (`csrc/slab_mma.cuh`),
emulated in torch and held against the f64 plain versions of K1 and K2 at
the f32 limits the card holds them to (chip_smoke.py's TOL / TOL_K2,
unchanged): K1 ctx 1e-4 and lse 1e-3, each K2 output 1e-5 of its largest
entry.

The emulation rounds as the kernel does: `cvt.rna.tf32.f32` keeps the top 10
mantissa bits, rounding to nearest with ties away from zero on the low 13;
an operand x is split into hi = tf32(x) and lo = tf32(x - hi), and a product
is lo.hi + hi.lo + hi.hi summed in f32 (each TF32 product is exact in f32).
The card's tensor cores also truncate while they accumulate; the kernels
add each k-block's score products and each tile's output products into
their running sums with an f32 add, which this emulation's f32 sums stand
for.  Shapes: the 22-11 preset's head (T 1024, H 64, causal) and head dim
128, at two heads each; the checks hold each error to a tenth (K1) or a
quarter (K2) of its limit."""
import pytest
import torch

from musicnlp_tpu_torch.ops.flash_attention import _key_mask, distance_table

LIMIT_K1 = dict(ctx=1e-4, lse=1e-3)
LIMIT_K2 = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 as cvt.rna does: round to nearest, ties away, on the low
    13 mantissa bits (the bits are sign and magnitude, so adding half of
    2^13 rounds the magnitude away from zero)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x.float() - hi)


def mm3(a: torch.Tensor, b: torch.Tensor, products: int = 3) -> torch.Tensor:
    """a @ b in 3xTF32 (the small products first), f32 sums; `products` 2
    drops hi.lo (a weaker split, for the check that the test can fail)."""
    (ah, al), (bh, bl) = split(a), split(b)
    out = al @ bh
    if products == 3:
        out = out + ah @ bl
    return out + ah @ bh


def _inputs(H, T, seed, N=2):
    g = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g)
    Wr = mk(8 * H, N, H) * 0.05
    return (mk(N, T, H), mk(N, T, H), mk(N, T, H), mk(N, T, H),
            distance_table(Wr, T, T, 0, 1024, torch.float32), mk(N, T, H))


def _scores(rw, rr, k, g, mm, scale):
    """K1's masked scaled scores [BN, T, S] (causal, no memory) with the
    products `mm`, and the gather index u."""
    BN, T, _ = rw.shape
    u = T - 1 - torch.arange(T)[:, None] + torch.arange(T)[None, :]
    s1 = mm(rr, g.transpose(1, 2))                                   # [BN, T, 2T]
    s = (mm(rw, k.transpose(1, 2)) + torch.gather(s1, 2, u.expand(BN, T, T))) * scale
    ok = _key_mask(T, T, 0, 0, 0, 'cpu')
    return torch.where(ok, s, torch.full_like(s, -1e30)), u


def k1(rw, rr, k, v, g, mm, scale):
    s, _ = _scores(rw, rr, k, g, mm, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1)
    return mm(p, v) / l[..., None], m[..., 0] + torch.log(l)


def k2(rw, rr, k, v, g, out, d_out, lse, mm, scale):
    BN, T, H = rw.shape
    s, u = _scores(rw, rr, k, g, mm, scale)
    p = torch.exp(s - lse[..., None])
    delta = (d_out * out).sum(-1, keepdim=True)
    ds = p * (mm(d_out, v.transpose(1, 2)) - delta) * scale
    ds1 = torch.zeros(BN, T, 2 * T, dtype=ds.dtype)
    ds1.scatter_(2, u.expand(BN, T, T), ds)
    return (mm(ds, k), mm(ds1, g), mm(ds.transpose(1, 2), rw), mm(p.transpose(1, 2), d_out),
            mm(ds1.transpose(1, 2), rr))


def _f64(*xs):
    return [x.double() for x in xs]


@pytest.mark.parametrize('H', [64, 128])
def test_k1_in_3xtf32_holds_the_f32_limits(H):
    """ctx and lse of K1 with every product in 3xTF32 against the f64
    plain version at T 1024: within the card's f32 limits."""
    rw, rr, k, v, g, _ = _inputs(H, 1024, seed=H)
    scale = H ** -0.5
    ctx, lse = k1(rw, rr, k, v, g, mm3, scale)
    ref, ref_lse = k1(*_f64(rw, rr, k, v, g), torch.matmul, scale)
    assert float((ctx.double() - ref).abs().max()) <= LIMIT_K1['ctx'] / 10
    assert float((lse.double() - ref_lse).abs().max()) <= LIMIT_K1['lse'] / 10


@pytest.mark.parametrize('H', [64, 128])
def test_k2_in_3xtf32_holds_the_f32_limit(H):
    """Each of K2's outputs (drw, drr, dk, dv, dG summed over the heads'
    rows) with every product in 3xTF32 against the f64 plain version at T
    1024: within 1e-5 of its largest entry, and 3xTF32's error at least 4x
    below the limit."""
    rw, rr, k, v, g, d_out = _inputs(H, 1024, seed=10 + H)
    scale = H ** -0.5
    out, lse = k1(*_f64(rw, rr, k, v, g), torch.matmul, scale)
    got = k2(rw, rr, k, v, g, out.float(), d_out, lse.float(), mm3, scale)
    want = k2(*_f64(rw, rr, k, v, g), out, d_out.double(), lse, torch.matmul, scale)
    for name, a, b in zip(('drw', 'drr', 'dk', 'dv', 'dG'), got, want):
        err = float((a.double() - b).abs().max() / b.abs().max())
        assert err <= LIMIT_K2 / 4, (name, err)


def test_tf32_rounds_to_nearest_away_on_13_bits():
    """Ties round away from zero, others to nearest; 10 mantissa bits kept."""
    one = torch.tensor([1.0])
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4, 1 + 3 * ulp / 4, 3.0])
    assert torch.equal(tf32(x), torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + ulp, 3.0]))
    hi, lo = split(one / 3)
    assert float(hi + lo) != float(hi) and abs(float(hi + lo) - 1 / 3) < 2.0 ** -21
