"""3xTF32, the f32 products of the slab kernels (`csrc/slab_mma.cuh`),
emulated in torch and held against the f64 plain versions of K1, K2 and K4
at the f32 limits the card holds them to (chip_smoke.py's TOL / TOL_K2 /
TOL_K4, unchanged): K1 ctx 1e-4 and lse 1e-3, each K2 and K4 output 1e-5
of its largest entry.

The emulation rounds as the kernel does: `cvt.rna.tf32.f32`'s rounding
keeps the top 10 mantissa bits, rounding to nearest with ties away from
zero on the low 13 (the kernels do it on the bits); an operand x is split
into hi = tf32(x) and lo = tf32(x - hi), and a product is lo.hi + hi.lo +
hi.hi summed in f32 (each TF32 product is exact in f32).
The card's tensor cores also truncate while they accumulate; the kernels
add each k-block's score products and each tile's output products into
their running sums with an f32 add, which this emulation's f32 sums stand
for.  Shapes: the 22-11 preset's head (T 1024, H 64, causal) and head dim
128, at two heads each; K4 at the 22-04 LSH layer's shape cut to two rows
(T 1024, chunk 64, shared-QK with permuted positions, pad keys and the
self bias; each row's own key scored by the sequential f32 FMA chain, as
the kernels score it, against the lse the same scores give) at D 64 and
256; the checks hold each error to a tenth (K1) or a quarter (K2, K4) of
its limit."""
import numpy as np
import pytest
import torch

from musicnlp_tpu_torch.ops.chunked_attention_kernel import (
    NEG_INF, _pos_windows, _windows, chunked_window_attn_bwd_plain, chunked_window_attn_fwd_plain,
)
from musicnlp_tpu_torch.ops.flash_attention import _key_mask, distance_table

LIMIT_K1 = dict(ctx=1e-4, lse=1e-3)
LIMIT_K2 = LIMIT_K4 = 1e-5


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


def _chain(q, k):
    """q . k of rows [..., D] as the sequential f32 FMA chain over D (each
    step's product and sum exact in f64, rounded once to f32, as an FMA)."""
    acc = torch.zeros(q.shape[:-1], dtype=torch.float32)
    for d in range(q.shape[-1]):
        acc = (acc.double() + q[..., d].double() * k[..., d].double()).float()
    return acc


def k4_scores(q, k, qpos, kpos, chunk, scale, self_bias, mm, own):
    """K3 / K4's masked scores [G, n, c, 2c] with the products `mm`; own
    [G, T]: each row's own-key score (kpos == qpos), or None to take it
    from the products."""
    G, T, D = q.shape
    n = T // chunk
    s = mm(q.reshape(G, n, chunk, D), _windows(k, chunk).transpose(-1, -2)) * scale
    qp = qpos.reshape(G, n, chunk)[..., :, None]
    kp = _pos_windows(kpos, chunk)[..., None, :]
    s = torch.where(kp == qp, s + self_bias, s)
    if own is not None:
        s = torch.where(kp == qp, own.reshape(G, n, chunk, 1).to(s.dtype), s)
    return torch.where(kp <= qp, s, torch.full_like(s, NEG_INF))


def k4(q, k, v, qpos, kpos, out, d_out, lse, d_lse, chunk, scale, self_bias, mm, own):
    """K4's function (chunked_window_attn_bwd_plain's) with the products `mm`
    in the inputs' dtype -> (dq, dk, dv)."""
    G, T, D = q.shape
    n = T // chunk
    p = torch.exp(k4_scores(q, k, qpos, kpos, chunk, scale, self_bias, mm, own)
                  - lse.reshape(G, n, chunk, 1))
    do = d_out.reshape(G, n, chunk, D)
    delta = (do * out.reshape(G, n, chunk, D)).sum(-1, keepdim=True)
    ds = p * (mm(do, _windows(v, chunk).transpose(-1, -2)) - delta
              + d_lse.reshape(G, n, chunk, 1)) * scale
    dq = mm(ds, _windows(k, chunk)).reshape(G, T, D)
    dkw = mm(ds.transpose(-1, -2), q.reshape(G, n, chunk, D))
    dvw = mm(p.transpose(-1, -2), do)

    def fold(w):
        own_half = w[:, :, chunk:].clone()
        own_half[:, :-1] += w[:, 1:, :chunk]
        return own_half.reshape(G, T, D)
    return dq, fold(dkw), fold(dvw)


@pytest.mark.parametrize('D', [64, 256])
def test_k4_in_3xtf32_holds_the_f32_limit(D):
    """dq, dk, dv of K4 with every product in 3xTF32 (the own keys by the
    sequential f32 FMA chain, lse from the same scores) against the f64
    plain version at the 22-04 LSH shape cut to two rows: within 1e-5 of
    each output's largest entry, and 3xTF32's error at least 4x below the
    limit."""
    G, T, chunk, pads, scale, self_bias = 2, 1024, 64, 40, 1.0, -1e5
    g = torch.Generator().manual_seed(40 + D)
    q, v, d_out = (torch.randn(G, T, D, generator=g) for _ in range(3))
    k = q * torch.rsqrt((q * q).mean(-1, keepdim=True) + 1e-6) / D ** 0.5
    d_lse = torch.randn(G, T, generator=g)
    rng = np.random.default_rng(D)
    qpos = torch.from_numpy(np.stack([rng.permutation(T) for _ in range(G)]).astype(np.int64))
    kpos = torch.where(qpos >= T - pads, torch.full_like(qpos, T), qpos)
    own = (_chain(q, k) * scale).float() + self_bias           # kpos == qpos: the own row
    s = k4_scores(q, k, qpos, kpos, chunk, scale, self_bias, mm3, own)
    lse = (s.amax(-1) + torch.log(torch.exp(s - s.amax(-1, keepdim=True)).sum(-1))).reshape(G, T)
    s64 = k4_scores(*_f64(q, k), qpos, kpos, chunk, scale, self_bias, torch.matmul, None)
    lse64 = torch.logsumexp(s64, -1).reshape(G, T)
    out64 = (torch.exp(s64 - lse64.reshape(G, T // chunk, chunk, 1))
             @ _windows(v.double(), chunk)).reshape(G, T, D)
    got = k4(q, k, v, qpos, kpos, out64.float(), d_out, lse, d_lse, chunk, scale, self_bias,
             mm3, own)
    want = k4(*_f64(q, k, v), qpos, kpos, out64, *_f64(d_out, lse64, d_lse), chunk, scale,
              self_bias, torch.matmul, None)
    for name, a, b in zip(('dq', 'dk', 'dv'), got, want):
        err = float((a.double() - b).abs().max() / b.abs().max())
        assert err <= LIMIT_K4 / 4, (name, err)


def mm3_kblocks(a, b):
    """a @ b as the slab kernels' scores sum it: each 8-deep k-block's three
    TF32 products into a fresh fragment (each product exact, the fragment
    rounded to f32 after each), then added to the running sum in f32 ->
    [n k-blocks of the sum], the k-block sums in order."""
    (ah, al), (bh, bl) = split(a), split(b)
    out = []
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        t = (al[..., ks].double() @ bh[..., ks, :].double()).float()
        t = (t.double() + ah[..., ks].double() @ bl[..., ks, :].double()).float()
        out.append((t.double() + ah[..., ks].double() @ bh[..., ks, :].double()).float())
    return out


def two_sum(a, b):
    s = a + b
    bv = s - a
    return s, (a - (s - bv)) + (b - bv)


def k4_card(q, k, v, qpos, kpos, out, d_out, lse, d_lse, chunk, scale, self_bias, carry):
    """K4 in the f32 slab kernels' arithmetic -> (dq, dk, dv): S and dP by
    `mm3_kblocks`; with `carry` S's 64-wide slabs go into a pair hi + lo by
    two_sum (carry_slab) and a visible unbiased entry takes p =
    exp(fl(s scale - lse) + lo scale) (p_ds<true>), without it S is one f32
    running sum; own keys by the sequential chain; the outputs' products
    in 3xTF32."""
    G, T, D = q.shape
    n = T // chunk
    qc, kw, vw = q.reshape(G, n, chunk, D), _windows(k, chunk), _windows(v, chunk)
    do = d_out.reshape(G, n, chunk, D)
    def running(blocks):
        acc = blocks[0]
        for t in blocks[1:]:
            acc = acc + t
        return acc
    blocks = mm3_kblocks(qc, kw.transpose(-1, -2))
    s, lo = torch.zeros_like(blocks[0]), torch.zeros_like(blocks[0])
    for i in range(0, len(blocks), 8 if carry else len(blocks)):
        s, err = two_sum(s, running(blocks[i:i + 8] if carry else blocks))
        lo = lo + err
    dp = running(mm3_kblocks(do, vw.transpose(-1, -2)))
    qp = qpos.reshape(G, n, chunk)[..., :, None]
    kp = _pos_windows(kpos, chunk)[..., None, :]
    L = lse.reshape(G, n, chunk, 1)
    x = torch.where(kp == qp, s * scale + self_bias, s * scale)
    own = (_chain(q, k) * scale).float() + self_bias
    x = torch.where(kp == qp, own.reshape(G, n, chunk, 1), x)
    arg = torch.where(kp <= qp, x, torch.full_like(x, NEG_INF)) - L
    if carry:
        fused = (s.double() * scale - L.double()).float() + lo * scale
        arg = torch.where(kp < qp, fused, arg)
    p = torch.exp(arg)
    delta = (do * out.reshape(G, n, chunk, D)).sum(-1, keepdim=True)
    ds = p * (dp - delta + d_lse.reshape(G, n, chunk, 1)) * scale

    def fold(w):
        own_half = w[:, :, chunk:].clone()
        own_half[:, :-1] += w[:, 1:, :chunk]
        return own_half.reshape(G, T, D)
    return (mm3(ds, kw).reshape(G, T, D), fold(mm3(ds.transpose(-1, -2), qc)),
            fold(mm3(p.transpose(-1, -2), do)))


@pytest.mark.parametrize('G,T,D,chunk,pads', [(1, 640, 128, 128, 40), (2, 256, 256, 64, 9)])
def test_k4_carried_scores_are_closer_to_f64_than_plain(G, T, D, chunk, pads):
    """The f32 K4 cases of tests/test_torch_cuda.py::test_k3_k4_match_plain
    whose keys are not normalised (LSH-permuted, scale 1, self bias: scores
    up to ~50, where an f32 add rounds at ~4e-6): with the scores carried as
    a pair across slabs, dq, dk, dv of the slab kernels' arithmetic lie
    within half of the plain f32 backward's own error of the f64 backward
    (same inputs, out and lse), so that the card test's 1e-5 against the
    plain version measures the plain version; one f32 running sum does not."""
    g = torch.Generator().manual_seed(0)                  # the card test's inputs
    q, k, v = (torch.randn(G, T, D, generator=g) for _ in range(3))
    qpos = torch.stack([torch.randperm(T, generator=g) for _ in range(G)])
    kpos = torch.where(qpos >= T - pads, torch.full_like(qpos, T), qpos)
    kw = dict(chunk=chunk, scale=1.0, self_bias=-1e5)
    out, lse = chunked_window_attn_fwd_plain(q, k, v, qpos, kpos, **kw)
    d_out = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    d_lse = torch.randn(lse.shape, generator=torch.Generator().manual_seed(2))
    args = (q, k, v, qpos, kpos, out, d_out, lse, d_lse)
    plain = chunked_window_attn_bwd_plain(*args, **kw)
    # f64, but a row's own key keeps the f32 score that K3's lse holds
    own = ((q.double() * k.double()).sum(-1).float() - 1e5).double()
    want = k4(*_f64(q, k, v), qpos, kpos, *_f64(out, d_out, lse, d_lse), chunk, 1.0, -1e5,
              torch.matmul, own)
    got = k4_card(*args, chunk, 1.0, -1e5, carry=True)
    err = lambda a, b: float((a.double() - b).abs().max() / b.abs().max())
    for name, a, b, c in zip(('dq', 'dk', 'dv'), got, plain, want):
        assert err(a, c) <= err(b, c) / 2, (name, err(a, c), err(b, c))


def test_tf32_rounds_to_nearest_away_on_13_bits():
    """Ties round away from zero, others to nearest; 10 mantissa bits kept."""
    one = torch.tensor([1.0])
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4, 1 + 3 * ulp / 4, 3.0])
    assert torch.equal(tf32(x), torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + ulp, 3.0]))
    hi, lo = split(one / 3)
    assert float(hi + lo) != float(hi) and abs(float(hi + lo) - 1 / 3) < 2.0 ** -21
