"""K4's tiled tensor-core schedule (`csrc/chunked_window_attn_bwd.cu`,
k4_dq_tc / k4_dkdv_tc) emulated in plain torch and held against
`chunked_window_attn_bwd_plain`, and once against the Pallas kernel's VJP in
interpret mode.

The card kernels cannot run here; this pins their tile walk on the CPU:
the dq kernel takes 64 query rows and walks the 64-key tiles of the union
of its rows' windows, [(q0 / C - 1) C, (q_last / C + 1) C), keys outside
[0, T) staged as zeros with the position INT_MAX; the dk / dv kernel takes
64 key rows and walks the 64-row query tiles of chunks j and j + 1,
[(k0 / C) C, min((k_last / C + 2) C, T)), query rows past T giving p = 0.
Each tile's p is 0 outside a row's window and exp(x - lse) inside it, x
the scaled score with self_bias on kpos == qpos and the finite NEG_INF
where kpos > qpos; ds = p (dp - delta + dlse) scale; p and ds round to the
input dtype where they enter a product.  At D 128 a 16-row group is two
warps: warp c computes S and dP over keys [32c, 32c + 32) and owns
columns [64c, 64c + 64) of dq (from the tile's dS through shared memory),
dk and dv.  Chunks 8 / 16 / 48 / 128, LSH-permuted and padded positions,
ragged last tiles, f32 / bf16 / f16."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicnlp_tpu.ops.pallas.chunked_attention_kernel import (
    chunked_window_attn as pallas_chunked_window_attn)
from musicnlp_tpu_torch.ops.chunked_attention_kernel import (
    NEG_INF, chunked_window_attn_bwd_plain, chunked_window_attn_fwd_plain,
)
from tests.slab_configs import with_cfg
from tests.torch_parity import randn

B = 64                                   # rows per tile
NG = B // 16                             # 16-row groups per tile
INT_MIN, INT_MAX = -2 ** 31, 2 ** 31 - 1
# each output's largest error over its largest entry: f32 sums in another
# order; in 16 bits a p or ds within an ulp of a rounding boundary may round
# the other way (the card's K4 limits, chip_smoke.TOL_K4)
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 5e-3}
# against the Pallas VJP in interpret mode (tests/test_torch_chunked.py's
# K4_TOL: the TPU backward sums its overlapping windows in another order)
PALLAS_TOL = dict(rtol=2e-3, atol=2e-3)


# torch on one thread: the suite's xdist workers share the cores, and
# torch's intra-op threads on these many tiny ops slow each file many-fold
@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _split(D):
    """(warps per group, keys of a warp's S / dP, accumulator columns of a warp)."""
    sp = 2 if D > 64 else 1
    return sp, B // sp, D // sp


def _rows(x, r0, fill=0):
    """Rows [r0, r0 + B) of x [G, T, ...], `fill` outside [0, T)."""
    idx = torch.arange(r0, r0 + B)
    ok = (idx >= 0) & (idx < x.shape[1])
    out = torch.full((x.shape[0], B) + tuple(x.shape[2:]), fill, dtype=x.dtype)
    out[:, ok] = x[:, idx[ok]]
    return out


def _tile(qt, ot, kt, vt, r, w, qp, kp, lse, de, dl, C, scale, self_bias, dtype, live):
    """p and ds [G, 64, 64] of one (query tile, key tile), rounded to dtype:
    S and dP by warp (p, c) over its keys, the window, masks and self_bias
    on f32 scores; `live` [64, 64] zeroes pairs the kernel does not count."""
    sp, kw, _ = _split(qt.shape[-1])
    s = torch.empty(qt.shape[0], B, B)
    dp = torch.empty_like(s)
    for g in range(NG):
        rows = slice(16 * g, 16 * g + 16)
        for c in range(sp):
            keys = slice(kw * c, kw * c + kw)
            s[:, rows, keys] = qt[:, rows] @ kt[:, keys].transpose(1, 2)
            dp[:, rows, keys] = ot[:, rows] @ vt[:, keys].transpose(1, 2)
    lo = (torch.div(r, C, rounding_mode='floor') - 1) * C
    in_window = (w[None, :] >= lo[:, None]) & (w[None, :] < lo[:, None] + 2 * C) & live
    x = s * scale
    qpe, kpe = qp[:, :, None], kp[:, None, :]
    x = torch.where(kpe <= qpe, torch.where(kpe == qpe, x + self_bias, x),
                    torch.full_like(x, NEG_INF))
    p = torch.where(in_window, torch.exp(x - lse[..., None]), torch.zeros(()))
    ds = p * (dp - de[..., None] + dl[..., None]) * scale
    return p.to(dtype).float(), ds.to(dtype).float()


def k4_tiles(q, k, v, qpos, kpos, out, d_out, lse, d_lse, *, chunk, scale, self_bias=0.0):
    """The tiled K4 kernels' schedule in torch -> (dq in q's dtype, dk, dv f32)."""
    G, T, D = q.shape
    C, dtype = chunk, q.dtype
    sp, _, dw = _split(D)
    assert dw <= 64                      # a lane holds at most 64 f32 of dk and of dv
    qf, kf, vf, of = (x.float() for x in (q, k, v, d_out))
    delta = (of * out.float()).sum(-1)
    qpos, kpos = qpos.long(), kpos.long()

    def q_tile(q0):                      # what both kernels stage for query rows [q0, q0 + 64)
        return (_rows(qf, q0), _rows(of, q0), _rows(qpos, q0, INT_MIN), _rows(lse, q0),
                _rows(delta, q0), _rows(d_lse.float(), q0))

    dq = torch.zeros(G, T, D)
    for q0 in range(0, T, B):            # k4_dq_tc: one block per 64 query rows
        qt, ot, qp, l, de, dl = q_tile(q0)
        q_last = min(q0 + B, T) - 1
        w_lo, w_hi = (q0 // C - 1) * C, (q_last // C + 1) * C
        acc = torch.zeros(G, B, D)
        for k0 in range(w_lo, w_hi, B):
            kt, vt, kp = _rows(kf, k0), _rows(vf, k0), _rows(kpos, k0, INT_MAX)
            _, ds = _tile(qt, ot, kt, vt, torch.arange(q0, q0 + B), torch.arange(k0, k0 + B),
                          qp, kp, l, de, dl, C, scale, self_bias, dtype,
                          torch.ones(B, B, dtype=torch.bool))
            for c in range(sp):
                cols = slice(dw * c, dw * c + dw)
                acc[..., cols] += ds @ kt[..., cols]
        n = min(B, T - q0)
        dq[:, q0:q0 + n] = acc[:, :n]

    dk, dv = torch.zeros(G, T, D), torch.zeros(G, T, D)
    for k0 in range(0, T, B):            # k4_dkdv_tc: one block per 64 key rows
        kt, vt, kp = _rows(kf, k0), _rows(vf, k0), _rows(kpos, k0, INT_MAX)
        k_last = min(k0 + B, T) - 1
        r_lo, r_hi = (k0 // C) * C, min((k_last // C + 2) * C, T)
        acc_k, acc_v = torch.zeros(G, B, D), torch.zeros(G, B, D)
        w = torch.arange(k0, k0 + B)
        for q0 in range(r_lo, r_hi, B):
            qt, ot, qp, l, de, dl = q_tile(q0)
            r = torch.arange(q0, q0 + B)
            live = (r[:, None] < T) & (w[None, :] < T)
            p, ds = _tile(qt, ot, kt, vt, r, w, qp, kp, l, de, dl, C, scale, self_bias, dtype,
                          live)
            for g in range(NG):
                kr = slice(16 * g, 16 * g + 16)
                for c in range(sp):
                    cols = slice(dw * c, dw * c + dw)
                    acc_v[:, kr, cols] += p[:, :, kr].transpose(1, 2) @ ot[..., cols]
                    acc_k[:, kr, cols] += ds[:, :, kr].transpose(1, 2) @ qt[..., cols]
        n = min(B, T - k0)
        dk[:, k0:k0 + n], dv[:, k0:k0 + n] = acc_k[:, :n], acc_v[:, :n]
    return dq.to(dtype), dk, dv


def _inputs(G, T, D, seed, perm, pads):
    """q, k, v [G, T, D] f32 and int32 positions: a per-row permutation for
    LSH-like rows, the last `pads` slots as pad keys (kpos = T)."""
    q, k, v = (torch.from_numpy(randn(seed + i, G, T, D)) for i in range(3))
    rng = np.random.default_rng(seed + 3)
    if perm:
        qpos = np.stack([rng.permutation(T) for _ in range(G)]).astype(np.int32)
    else:
        qpos = np.broadcast_to(np.arange(T, dtype=np.int32), (G, T)).copy()
    kpos = qpos.copy()
    if pads:
        kpos[:, T - pads:] = T
    return q, k, v, torch.from_numpy(qpos), torch.from_numpy(kpos)


CASES = [   # G, T, D, chunk, perm, pads, scale, self_bias, dtype
    (2, 480, 32, 16, True, 9, 1.0, -1e5, torch.float32),       # ragged last tile
    (2, 480, 32, 16, True, 9, 1.0, -1e5, torch.float16),
    (2, 384, 64, 128, False, 0, 0.125, 0.0, torch.bfloat16),   # a tile inside one chunk
    (2, 384, 128, 128, True, 40, 1.0, -1e5, torch.float32),    # two warps per group
    (2, 256, 128, 128, True, 40, 1.0, -1e5, torch.bfloat16),
    (1, 320, 128, 64, False, 30, 0.09, 0.0, torch.float16),    # chunk 64 at D 128
    (2, 240, 16, 8, True, 0, 1.0, -1e5, torch.float16),        # chunk 8, 8 chunks per tile
    (2, 288, 64, 48, False, 17, 0.125, 0.0, torch.bfloat16),   # tiles across chunk edges
]


@pytest.mark.parametrize('G,T,D,chunk,perm,pads,scale,self_bias,dtype', CASES)
def test_tile_walk_matches_plain_backward(G, T, D, chunk, perm, pads, scale, self_bias, dtype):
    """dq, dk, dv of the emulated tile walk against the plain backward on
    the same inputs and cotangents (ctx and lse), each within `TOL`."""
    q, k, v, qpos, kpos = _inputs(G, T, D, G + T + D + chunk, perm, pads)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    kw = dict(chunk=chunk, scale=scale, self_bias=self_bias)
    out, lse = chunked_window_attn_fwd_plain(q, k, v, qpos, kpos, **kw)
    d_out = torch.from_numpy(randn(7, G, T, D)).to(dtype)
    d_lse = torch.from_numpy(randn(8, G, T))
    args = (q, k, v, qpos, kpos, out, d_out, lse, d_lse)
    got = k4_tiles(*args, **kw)
    want = chunked_window_attn_bwd_plain(*args, **kw)
    for name, a, b in zip(('dq', 'dk', 'dv'), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        err = float((a.float() - b.float()).abs().max() / b.float().abs().max())
        assert err <= TOL[dtype], (name, err)


@pytest.mark.parametrize('T,chunk', [(480, 16), (384, 128), (240, 8), (288, 48), (64, 64)])
def test_tile_walks_cover_each_window_once(T, chunk):
    """The dq walk visits every key of each row's window in exactly one key
    tile, and the dk / dv walk visits every query whose window holds a key
    in exactly one query tile: no pair is lost or counted twice."""
    C = chunk
    seen = torch.zeros(T, T + 2 * C, dtype=torch.int32)      # [query, key + C]
    for q0 in range(0, T, B):
        q_last = min(q0 + B, T) - 1
        for k0 in range((q0 // C - 1) * C, (q_last // C + 1) * C, B):
            for r in range(q0, q_last + 1):
                for w in range(max(k0, -C), min(k0 + B, T)):
                    seen[r, w + C] += 1
    seen_kv = torch.zeros(T, T, dtype=torch.int32)          # [query, key]
    for k0 in range(0, T, B):
        k_last = min(k0 + B, T) - 1
        for q0 in range((k0 // C) * C, min((k_last // C + 2) * C, T), B):
            seen_kv[q0:min(q0 + B, T), k0:k_last + 1] += 1
    for r in range(T):
        lo = (r // C - 1) * C
        assert bool((seen[r, lo + C:lo + 3 * C] == 1).all()), r
        keys = [w for w in range(max(lo, 0), lo + 2 * C)]
        assert bool((seen_kv[r, keys] == 1).all()), r


def test_tile_walk_matches_the_pallas_vjp():
    """At one small case (chunk 16, two 64-row tiles, LSH-permuted and
    padded positions, f32) the emulated walk gives the gradients of jax.grad
    through the Pallas kernel's custom VJP in interpret mode, for a loss on
    both outputs."""
    G, T, D, chunk, scale, self_bias = 2, 128, 16, 16, 1.0, -1e5
    q, k, v, qpos, kpos = _inputs(G, T, D, 5, True, 24)
    w_out, w_lse = randn(20, G, T, D), randn(21, G, T)

    def jloss(q, k, v):
        o, l = pallas_chunked_window_attn(q, k, v, jnp.asarray(qpos.numpy()),
                                          jnp.asarray(kpos.numpy()), chunk=chunk, scale=scale,
                                          self_bias=self_bias, interpret=True, form='windows')
        return jnp.sum(o * w_out) + jnp.sum(l * w_lse)
    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x.numpy()) for x in (q, k, v)))
    kw = dict(chunk=chunk, scale=scale, self_bias=self_bias)
    out, lse = chunked_window_attn_fwd_plain(q, k, v, qpos, kpos, **kw)
    got = k4_tiles(q, k, v, qpos, kpos, out, torch.from_numpy(w_out), lse,
                   torch.from_numpy(w_lse), **kw)
    for name, a, b in zip('qkv', got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **PALLAS_TOL, err_msg=name)


# ------------------------- every f32 call, and 16 bits above D 128: the slab split
SLAB = 64           # the widest slab of k4_dq_slab / k4_dkdv_slab
SP = 2              # warps per 16-row group
KW = B // SP        # keys of a warp's S / dP


def slab_config(D, dtype):
    """(slab width W, output slabs of a dq block ZQ, of a dk / dv block ZKV)
    of the slab kernels at head dim D, read from the C entry's `with_cfg`."""
    return with_cfg('chunked_window_attn_bwd', D, dtype == torch.float32)


def slab_items(ns, z0, nz):
    """A block's items per tile pair: ('score', i) for the ns slabs of the
    head dim in order, then ('out', z) for its output slabs [z0, z0 + nz)
    but the head dim's last, which the last score item's tiles serve in
    place (('score', ns - 1) also applies slab ns - 1 when the block has it)."""
    last_in = z0 + nz == ns
    return ([('score', i) for i in range(ns)]
            + [('out', z) for z in range(z0, z0 + nz) if not (last_in and z == ns - 1)])


def _chain(qr, kr):
    """q . k of rows qr, kr [n, D] as the sequential f32 FMA chain over all D."""
    acc = torch.zeros(qr.shape[0], dtype=torch.float32)
    for d in range(qr.shape[1]):
        acc = (acc.double() + qr[:, d].double() * kr[:, d].double()).float()
    return acc


def two_sum(a, b):
    """(fl(a + b), its exact error), as slab_mma.cuh's two_sum."""
    s = a + b
    bv = s - a
    return s, (a - (s - bv)) + (b - bv)


class ScorePass:
    """One tile pair's score pass, a slab at a time: S and dP by warp (each
    warp's rows over its KW keys), summed in f32 over the slabs in order;
    with `carry` (f32 instances that hold more than one output slab) each
    slab's S starts at 0 and goes into the pair (hi, lo) by two_sum
    (carry_slab)."""

    def __init__(self, G, carry):
        self.s, self.dp, self.carry = torch.zeros(G, B, B), torch.zeros(G, B, B), carry
        self.hi, self.lo = torch.zeros(G, B, B), torch.zeros(G, B, B)

    def add(self, qt, ot, kt, vt, cs):
        s = torch.zeros_like(self.s) if self.carry else self.s
        for c in range(SP):
            keys = slice(KW * c, KW * c + KW)
            s[..., keys] += qt[..., cs] @ kt[:, keys, cs].transpose(1, 2)
            self.dp[..., keys] += ot[..., cs] @ vt[:, keys, cs].transpose(1, 2)
        if self.carry:
            self.hi, err = two_sum(self.hi, s)
            self.lo = self.lo + err
            self.s = self.hi

    def p_ds(self, r, w, qp, kp, lse, de, dl, C, scale, self_bias, dtype, live, own):
        """p and ds of the pair, rounded to dtype: a row's own key (key index
        == row, kpos == qpos) in a layer with a self bias takes `own` [G, 64],
        its chained score, so p = exp(lse - lse) = 1 where a row sees only
        its own key, as K3 left lse; with `carry` a visible unbiased entry
        takes exp(fl(s scale - lse) + lo scale) (p_ds<true>)."""
        s, dp = self.s, self.dp
        lo = (torch.div(r, C, rounding_mode='floor') - 1) * C
        in_window = (w[None, :] >= lo[:, None]) & (w[None, :] < lo[:, None] + 2 * C) & live
        x = s * scale
        qpe, kpe = qp[:, :, None], kp[:, None, :]
        x = torch.where(kpe <= qpe, torch.where(kpe == qpe, x + self_bias, x),
                        torch.full_like(x, NEG_INF))
        if self_bias:
            diag = (w[None, :] == r[:, None]) & (kpe == qpe)
            x = torch.where(diag, own[:, :, None], x)
        arg = x - lse[..., None]
        if self.carry:      # fma(s, scale, -lse): one rounding of the exact s scale - lse
            fused = (s.double() * scale - lse[..., None].double()).float() + self.lo * scale
            arg = torch.where((kpe < qpe) | ((kpe == qpe) & (self_bias == 0)), fused, arg)
        p = torch.where(in_window, torch.exp(arg), torch.zeros(()))
        ds = p * (dp - de[..., None] + dl[..., None]) * scale
        return p.to(dtype).float(), ds.to(dtype).float()


def k4_slab_tiles(q, k, v, qpos, kpos, out, d_out, lse, d_lse, *, chunk, scale, self_bias=0.0):
    """The slab split's schedule in torch -> (dq, dk, dv): a block per (tile,
    group of ZQ / ZKV output slabs) walks its partner tiles, and per tile
    pair runs its `slab_items` in order: a score item adds its slab to the
    pair's one score pass (`ScorePass`; the own keys from the chain over
    all D), the last one turns it into p and ds and applies the last
    output slab when the block has it; an output item z adds dq += dS
    K[:, z] (k4_dq_slab) or dv += P^T dO[:, z], dk += dS^T Q[:, z]
    (k4_dkdv_slab), each pair's products summed apart, then added."""
    G, T, D = q.shape
    C, dtype = chunk, q.dtype
    W, ZQ, ZKV = slab_config(D, dtype)
    ns = D // W
    qf, kf, vf, of = (x.float() for x in (q, k, v, d_out))
    delta = (of * out.float()).sum(-1)
    qpos, kpos = qpos.long(), kpos.long()
    own = torch.zeros(G, T)
    if self_bias:                        # each row's own score: the chain, scaled, biased
        for g in range(G):
            own[g] = (_chain(qf[g], kf[g]) * scale).float() + self_bias
    cols = lambda z: slice(W * z, W * z + W)

    def walk(q0, k0, live, Z, z0, apply):
        """Tile pair (q0, k0) through the items of the block of output slabs
        [z0, z0 + Z)."""
        qt, ot, qp = _rows(qf, q0), _rows(of, q0), _rows(qpos, q0, INT_MIN)
        kt, vt, kp = _rows(kf, k0), _rows(vf, k0), _rows(kpos, k0, INT_MAX)
        nz = min(Z, ns - z0)
        sc = ScorePass(G, dtype == torch.float32 and Z > 1)
        p = ds = None
        for kind, i in slab_items(ns, z0, nz):
            if kind == 'out':
                apply(i, qt, ot, kt, p, ds)
                continue
            sc.add(qt, ot, kt, vt, cols(i))
            if i < ns - 1:
                continue
            p, ds = sc.p_ds(torch.arange(q0, q0 + B), torch.arange(k0, k0 + B), qp, kp,
                            _rows(lse, q0), _rows(delta, q0), _rows(d_lse.float(), q0), C,
                            scale, self_bias, dtype, live, _rows(own, q0))
            if z0 + nz == ns:
                apply(ns - 1, qt, ot, kt, p, ds)

    dq, dk, dv = torch.zeros(G, T, D), torch.zeros(G, T, D), torch.zeros(G, T, D)
    everywhere = torch.ones(B, B, dtype=torch.bool)
    for z0 in range(0, ns, ZQ):          # k4_dq_slab
        for q0 in range(0, T, B):
            q_last = min(q0 + B, T) - 1
            w_lo = (q0 // C - 1) * C
            w_lo += max(0, -w_lo) // B * B             # no key tile wholly before the sequence
            acc = torch.zeros(G, B, D)

            def apply_q(z, qt, ot, kt, p, ds):
                acc[..., cols(z)] += ds @ kt[..., cols(z)]
            for k0 in range(w_lo, (q_last // C + 1) * C, B):
                walk(q0, k0, everywhere, ZQ, z0, apply_q)
            n = min(B, T - q0)
            for z in range(z0, min(z0 + ZQ, ns)):
                dq[:, q0:q0 + n, cols(z)] = acc[:, :n, cols(z)]
    for z0 in range(0, ns, ZKV):         # k4_dkdv_slab
        for k0 in range(0, T, B):
            k_last = min(k0 + B, T) - 1
            w = torch.arange(k0, k0 + B)
            acc_k, acc_v = torch.zeros(G, B, D), torch.zeros(G, B, D)

            def apply_kv(z, qt, ot, kt, p, ds):
                acc_v[..., cols(z)] += p.transpose(1, 2) @ ot[..., cols(z)]
                acc_k[..., cols(z)] += ds.transpose(1, 2) @ qt[..., cols(z)]
            for q0 in range((k0 // C) * C, min((k_last // C + 2) * C, T), B):
                r = torch.arange(q0, q0 + B)
                walk(q0, k0, (r[:, None] < T) & (w[None, :] < T), ZKV, z0, apply_kv)
            n = min(B, T - k0)
            for z in range(z0, min(z0 + ZKV, ns)):
                dk[:, k0:k0 + n, cols(z)] = acc_k[:, :n, cols(z)]
                dv[:, k0:k0 + n, cols(z)] = acc_v[:, :n, cols(z)]
    return dq.to(dtype), dk, dv


SLAB_CASES = [   # G, T, D, chunk, perm, pads, scale, self_bias, dtype
    (1, 256, 256, 64, True, 9, 1.0, -1e5, torch.float32),
    (1, 288, 256, 48, False, 17, 0.0625, 0.0, torch.float32),    # tiles across chunk edges
    (1, 256, 384, 128, True, 0, 1.0, -1e5, torch.float32),       # two dk / dv slab groups
    (1, 192, 256, 32, True, 9, 1.0, -1e5, torch.bfloat16),
    (1, 192, 384, 64, True, 9, 1.0, -1e5, torch.float16),
    (2, 160, 64, 16, True, 9, 1.0, -1e5, torch.float32),         # one slab, ragged last tile
    (2, 96, 16, 32, True, 4, 1.0, -1e5, torch.float32),          # a slab of 16
    (1, 256, 128, 128, False, 0, 0.09, 0.0, torch.float32),      # two slabs in one block
]


@pytest.mark.parametrize('G,T,D,chunk,perm,pads,scale,self_bias,dtype', SLAB_CASES)
def test_slab_split_matches_plain_backward(G, T, D, chunk, perm, pads, scale, self_bias, dtype):
    """dq, dk, dv of the emulated slab split (one score pass per tile pair,
    P / dS applied per output slab, the own key from the chain) against
    the plain backward on the same inputs and cotangents, each within
    `TOL`; the forward's lse is K3's (own keys rescored by the chain)."""
    q, k, v, qpos, kpos = _inputs(G, T, D, G + T + D + chunk, perm, pads)
    if perm:        # shared-QK as the LSH layers: rows that see only their own key
        k = q * torch.rsqrt((q * q).mean(-1, keepdim=True) + 1e-6) / D ** 0.5
    q, k, v = (x.to(dtype) for x in (q, k, v))
    kw = dict(chunk=chunk, scale=scale, self_bias=self_bias)
    out, lse = chunked_window_attn_fwd_plain(q, k, v, qpos, kpos, **kw)
    d_out = torch.from_numpy(randn(7, G, T, D)).to(dtype)
    d_lse = torch.from_numpy(randn(8, G, T))
    args = (q, k, v, qpos, kpos, out, d_out, lse, d_lse)
    got = k4_slab_tiles(*args, **kw)
    want = chunked_window_attn_bwd_plain(*args, **kw)
    for name, a, b in zip(('dq', 'dk', 'dv'), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        err = float((a.float() - b.float()).abs().max() / b.float().abs().max())
        assert err <= TOL[dtype], (name, err)


def test_slab_split_matches_the_pallas_vjp():
    """At one small case (D 64 in one slab, chunk 16, LSH-permuted and
    padded positions, f32) the emulated slab split gives the gradients of
    jax.grad through the Pallas kernel's custom VJP in interpret mode."""
    G, T, D, chunk, scale, self_bias = 1, 128, 64, 16, 1.0, -1e5
    q, k, v, qpos, kpos = _inputs(G, T, D, 9, True, 24)
    w_out, w_lse = randn(22, G, T, D), randn(23, G, T)

    def jloss(q, k, v):
        o, l = pallas_chunked_window_attn(q, k, v, jnp.asarray(qpos.numpy()),
                                          jnp.asarray(kpos.numpy()), chunk=chunk, scale=scale,
                                          self_bias=self_bias, interpret=True, form='windows')
        return jnp.sum(o * w_out) + jnp.sum(l * w_lse)
    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x.numpy()) for x in (q, k, v)))
    kw = dict(chunk=chunk, scale=scale, self_bias=self_bias)
    out, lse = chunked_window_attn_fwd_plain(q, k, v, qpos, kpos, **kw)
    got = k4_slab_tiles(q, k, v, qpos, kpos, out, torch.from_numpy(w_out), lse,
                        torch.from_numpy(w_lse), **kw)
    for name, a, b in zip('qkv', got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **PALLAS_TOL, err_msg=name)


@pytest.mark.parametrize('D,dtype', [(16, torch.float32), (64, torch.float32),
                                     (128, torch.float32), (256, torch.float32),
                                     (384, torch.float32), (256, torch.bfloat16),
                                     (512, torch.float16)])
def test_slab_items_score_once_and_apply_each_output_slab_once(D, dtype):
    """Each block's items per tile pair: the head dim's slabs scored once,
    in order, and each of its output slabs applied once, the last one in
    place; the blocks of a tile together apply every output slab once, and
    up to D 256 (dk / dv) and 512 (dq) one block scores each tile pair."""
    W, ZQ, ZKV = slab_config(D, dtype)
    ns = D // W
    for Z in (ZQ, ZKV):
        applied = []
        for z0 in range(0, ns, Z):
            nz = min(Z, ns - z0)
            items = slab_items(ns, z0, nz)
            assert [i for kind, i in items if kind == 'score'] == list(range(ns))
            outs = [z for kind, z in items if kind == 'out']
            if z0 + nz == ns:
                outs.append(ns - 1)          # applied by the last score item
            assert sorted(outs) == list(range(z0, z0 + nz))
            applied += outs
        assert sorted(applied) == list(range(ns))
        assert (ns + Z - 1) // Z == (1 if D <= (512 if Z == ZQ else 256) else 2)


@pytest.mark.parametrize('T,chunk', [(480, 16), (2048, 64), (320, 128), (96, 32)])
def test_slab_walk_skips_key_tiles_before_the_sequence(T, chunk):
    """k4_dq_slab's walk starts at the first key tile that holds a key of the
    sequence (w_lo moved up by whole tiles past 0): no tile it visits lies
    wholly before the sequence, and it still visits every key of each row's
    window in exactly one key tile."""
    C = chunk
    for q0 in range(0, T, B):
        q_last = min(q0 + B, T) - 1
        w_lo = (q0 // C - 1) * C
        w_lo += max(0, -w_lo) // B * B
        tiles = list(range(w_lo, (q_last // C + 1) * C, B))
        assert all(k0 + B > 0 for k0 in tiles)
        seen = torch.zeros(T, dtype=torch.int32)
        for k0 in tiles:
            seen[max(k0, 0):min(k0 + B, T)] += 1
        for r in range(q0, q_last + 1):
            lo = (r // C - 1) * C
            assert bool((seen[max(lo, 0):lo + 2 * C] == 1).all()), (q0, r)
