"""The 16-bit forward kernels' tile schedules emulated in plain torch and held
against the plain versions: K1's `k1_tc` (`csrc/flash_rel_attn_fwd.cu`)
against `flash_rel_attn_fwd_plain`, K3's `k3_tc`
(`csrc/chunked_window_attn_fwd.cu`) against `chunked_window_attn_fwd_plain`.

The card kernels cannot run here; this pins their index arithmetic on the
CPU.  K1: each warp's 80 columns [48 - 16w, 128 - 16w) of X = Qr . Gwin^T
over the 128-row distance-table window from u_lo = T - q0 - 64 + k0, read at
column 15 - qr + ki; the window held in a ring of three 64-row slabs that
the next key tile's load refills while the current one computes; the online
softmax across key tiles (p = exp2((x - m) log2 e), p rounded to the input
dtype per tile); the interior test that skips the per-pair mask, against the
TPU kernel's `interior` and the full mask; the tile ranges with memory,
mem_valid < M and a window; ragged T and H 16.  K3: blocks over runs of
consecutive chunks (a last run shorter than the others, a run of one
chunk), the previous chunk's keys carried from chunk to chunk in three
slots and loaded once per run, each run's look-back, chunk 0's zero
look-back with position INT32_MAX, pad keys at position T, a fully masked
pad row (the window's uniform average), and the rows whose max is their own
biased key, whose score the kernel recomputes.  In f32 the emulations must
equal the plain versions to 1e-5.

At head dim 128 (`k1_tc`'s split) a 16-row group is two warps: warp c takes
keys [32c, 32c + 32) of the tile (BD from X's columns [48 - 16p + 32c, +48)),
the pair takes the row max over both halves, and warp c multiplies the
group's whole P into ctx columns [64c, 64c + 64); the row sums add at the
end.  K3's tiled walk on the tensor cores (`k3_union_tc`): a block of 64
query rows walks the 64-key tiles of the union of its rows' windows,
[(q0 / C - 1) C, (q_last / C + 1) C), keys outside a row's window score -inf
(no term), the online softmax starts from a finite running max, at D 128 the
same key / column split, and with a self bias each row's own key is
rescored as the sequential f32 FMA chain; chunks 8 / 16 / 48 / 128, D 128,
LSH-permuted and padded positions, ragged last tiles, once against the
Pallas forward in interpret mode.  p rounds to bf16 or f16 where it enters
PV.

The slab kernels (`k1_slab`, `k3_slab`: every f32 call and every call above
head dim 128) run one score pass per tile pair: a block per (q tile, group
of output slabs that `with_cfg` in the source sets, read by
tests/slab_configs.py) streams the head dim's slabs in order, each slab's
scores summed apart and then added, takes the online softmax once (two warps
per 16-row group, keys split in halves, the row max shared, the sums apart
until the end) and applies P to each of its output slabs; above the
table's slabs per block grid z splits them.  K3's own-key chain runs slab by
slab over the staged tiles, bit for bit the whole-row chain.  Each is held
against the plain forward and once against the Pallas forward in interpret
mode."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicnlp_tpu.ops.pallas.chunked_attention_kernel import (
    chunked_window_attn as pallas_chunked_window_attn)
from musicnlp_tpu.ops.pallas.flash_attention import _fwd_call as pallas_k1_fwd

from musicnlp_tpu_torch.ops.chunked_attention_kernel import (
    NEG_INF as NEG_INF_K3, chunked_window_attn_fwd_plain,
)
from musicnlp_tpu_torch.ops.flash_attention import (
    _key_mask, distance_table, flash_rel_attn_fwd_plain,
)
from tests.slab_configs import with_cfg

BQ = BK = 64        # K1: q rows / keys per tile
NW = 4              # K1: warps; warp w owns q rows 16w..16w+15
XW = 80             # K1: BD columns per warp
NEG_INF_K1 = -1e30
RUN = 16            # K3: consecutive chunks per block
INT32_MAX = torch.iinfo(torch.int32).max
INT32_MIN = torch.iinfo(torch.int32).min
K_NONE = -3e38      # K3's tiled walk: the running max before any key of the window
LOG2E = math.log2(math.e)


# torch on one thread: the suite's xdist workers share the cores, and
# torch's intra-op threads on these many tiny ops slow each file many-fold
@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(x, r0, n, fill=0):
    """Rows [r0, r0 + n) of x [..., L(, H)], `fill` outside [0, L)."""
    idx = torch.arange(r0, r0 + n)
    ok = (idx >= 0) & (idx < x.shape[1])
    out = torch.full((x.shape[0], n, *x.shape[2:]), fill, dtype=x.dtype)
    out[:, ok] = x[:, idx[ok]]
    return out


# ----------------------------------------------------------------------- K1
def tpu_interior(q0, k0, M, mv, window):
    """`interior` of the TPU kernel (musicnlp_tpu/ops/pallas/flash_attention.py:
    166-169) for 64 x 64 blocks."""
    ok = M + q0 - (k0 + BK - 1) >= 0 and k0 >= M - mv
    if window:
        ok = ok and M + q0 + BQ - 1 - k0 < window
    return ok


def k1_interior(q0, k0, S, M, mv, window):
    """The kernel's test (`interior` in flash_rel_attn_fwd.cu): the TPU's, and
    every key of the tile inside [0, S)."""
    return k0 + BK <= S and tpu_interior(q0, k0, M, mv, window)


def k1_key_tiles(q0, T, S, M, mv, window):
    """The key tiles block q0 visits (k_lo / k_hi of the kernel)."""
    q_last = min(q0 + BQ, T) - 1
    k_hi = min(S, M + q_last + 1)
    k_lo = max(0, M - mv)
    if window > 0:
        k_lo = max(k_lo, M + q0 - window + 1)
    return list(range(k_lo // BK, -(-k_hi // BK)))


def k1_slab(s, it):
    """Ring slot of window rows [64s, 64s + 64) at key step `it`."""
    return (it + s) % 3


def k1_split(H):
    """(warps per 16-row group, keys of a warp, ctx columns of a warp) of
    `k1_tc` at head dim H."""
    sp = 2 if H > 64 else 1
    return sp, BK // sp, H // sp


def k1_tiles(rw, rr, k, v, g, mem_valid, *, M, scale, window):
    """The schedule of `k1_tc` in torch -> (ctx, lse) as
    `flash_rel_attn_fwd_plain` returns them (p rounded to the inputs' dtype
    per key tile, where the kernel rounds it).  Group p's warp c scores keys
    [KW c, KW c + KW) from its XW = KW + 16 columns of X and owns ctx
    columns [HW c, HW c + HW); its partial row sums add at the end."""
    BN, T, H = rw.shape
    S, N = k.shape[1], g.shape[0]
    sp, kw, hw = k1_split(H)
    xw = kw + 16
    dtype = rw.dtype
    n_qt = -(-T // BQ)
    qw, qr = _rows(rw.float(), 0, n_qt * BQ), _rows(rr.float(), 0, n_qt * BQ)
    kf, vf = k.float(), v.float()
    gb = g.float()[torch.arange(BN) % N]                               # [BN, T+S, H]
    vis = torch.zeros(n_qt * BQ, -(-S // BK) * BK, dtype=torch.bool)  # padded: invisible
    vis[:T, :S] = _key_mask(T, S, M, mem_valid, window, 'cpu')
    ctx = torch.zeros(BN, n_qt * BQ, H)
    lse = torch.zeros(BN, n_qt * BQ)
    qr_ = torch.arange(16)[:, None]
    kl = torch.arange(kw)[None, :]
    for b in range(n_qt):
        q0 = (n_qt - 1 - b) * BQ                                       # longest rows first
        rows = slice(q0, q0 + BQ)
        m = torch.full((BN, BQ), NEG_INF_K1)
        l = torch.zeros(sp, BN, BQ)                                    # each warp's own keys
        o = torch.zeros(BN, BQ, H)
        tiles = k1_key_tiles(q0, T, S, M, mem_valid, window)
        ring = [None] * 3

        def load(kt, first):                       # the new slab(s) of key tile kt
            it, u_lo = kt - tiles[0], T - q0 - BQ + kt * BK
            if first:
                ring[k1_slab(0, it)] = _rows(gb, u_lo, 64)
            ring[k1_slab(1, it)] = _rows(gb, u_lo + 64, 64)

        if tiles:
            load(tiles[0], True)
        for it, kt in enumerate(tiles):
            k0, u_lo = kt * BK, T - q0 - BQ + kt * BK
            if kt + 1 <= tiles[-1]:
                load(kt + 1, False)                # in flight while this tile computes
            gwin = torch.cat([ring[k1_slab(0, it)], ring[k1_slab(1, it)]], dim=1)
            assert torch.equal(gwin, _rows(gb, u_lo, 128))
            kt_rows = _rows(kf, k0, BK)
            x = torch.empty(BN, BQ, BK)
            for p in range(NW):
                qs = slice(q0 + 16 * p, q0 + 16 * p + 16)
                for c in range(sp):
                    r0 = 48 - 16 * p + kw * c
                    xs = qr[:, qs] @ gwin[:, r0:r0 + xw].transpose(1, 2)   # the warp's staging
                    ac = qw[:, qs] @ kt_rows[:, kw * c:kw * c + kw].transpose(1, 2)
                    x[:, 16 * p:16 * p + 16, kw * c:kw * c + kw] = ac + xs[:, qr_, 15 - qr_ + kl]
            x = x * scale
            if not k1_interior(q0, k0, S, M, mem_valid, window):
                x = torch.where(vis[rows, k0:k0 + BK], x, torch.full_like(x, NEG_INF_K1))
            mx = m
            for c in range(sp):                    # each warp's max, then the pair's
                mx = torch.maximum(mx, x[..., kw * c:kw * c + kw].amax(-1))
            alpha = torch.exp2((m - mx) * LOG2E)
            p = torch.exp2((x - mx[..., None]) * LOG2E)
            P = p.to(dtype).float()
            vt = _rows(vf, k0, BK)
            for c in range(sp):
                l[c] = l[c] * alpha + p[..., kw * c:kw * c + kw].sum(-1)
                cols = slice(hw * c, hw * c + hw)
                o[..., cols] = o[..., cols] * alpha[..., None] + P @ vt[..., cols]
            m = mx
        lc = l.sum(0).clamp(min=1e-30)
        ctx[:, rows] = o * (1 / lc)[..., None]
        lse[:, rows] = m + torch.log(lc)
    return ctx[:, :T].to(dtype), lse[:, :T]


def _k1_inputs(H, T, M, clamp, seed, dtype=torch.float32, B=2, N=3):
    g = torch.Generator().manual_seed(seed)
    S = M + T
    mk = lambda *s: torch.randn(*s, generator=g)
    Wr = mk(8 * H, N, H) * 0.05
    return [x.to(dtype) for x in (mk(B * N, T, H), mk(B * N, T, H), mk(B * N, S, H),
                                  mk(B * N, S, H), distance_table(Wr, T, S, M, clamp,
                                                                  torch.float32))]


K1_CASES = [   # H, T, M, mem_valid, window, clamp
    (16, 77, 0, 0, 0, 1024), (32, 333, 0, 0, 0, 17), (64, 77, 30, 30, 0, 17),
    (16, 333, 64, 17, 40, 1024), (32, 200, 100, 37, 150, 17), (64, 333, 128, 50, 200, 1024),
    (64, 256, 128, 128, 0, 1024),
    # head dim 128: two warps per 16-row group
    (128, 77, 0, 0, 0, 1024), (128, 333, 64, 17, 40, 1024), (128, 200, 100, 37, 150, 17),
]


@pytest.mark.parametrize('H,T,M,mv,window,clamp', K1_CASES)
def test_k1_tile_schedule_matches_plain(H, T, M, mv, window, clamp):
    """ctx to 1e-5 of its largest entry and lse to 1e-5, f32: the same
    function with sums in another order and the softmax taken tile by tile."""
    rw, rr, k, v, g = _k1_inputs(H, T, M, clamp, seed=H + T + M)
    kw = dict(M=M, scale=H ** -0.5, window=window)
    ctx, lse = k1_tiles(rw, rr, k, v, g, mv, **kw)
    ref, ref_lse = flash_rel_attn_fwd_plain(rw, rr, k, v, g, mv, **kw)
    assert ctx.shape == ref.shape and lse.shape == ref_lse.shape
    assert float((ctx - ref).abs().max() / ref.abs().max()) <= 1e-5
    assert float((lse - ref_lse).abs().max()) <= 1e-5


@pytest.mark.parametrize('H,T,M,mv,window,clamp', [(16, 333, 64, 17, 40, 1024),
                                                   (64, 256, 128, 128, 0, 1024),
                                                   (128, 256, 128, 128, 0, 1024)])
def test_k1_tile_schedule_rounds_p_per_tile(H, T, M, mv, window, clamp):
    """bf16 inputs: p rounded to bf16 per key tile against the running max
    (the kernel) stays within the card's K1 tolerances of the plain version,
    which rounds p once against the row's global max: ctx 2e-2, lse 1e-3."""
    rw, rr, k, v, g = _k1_inputs(H, T, M, clamp, seed=7, dtype=torch.bfloat16)
    kw = dict(M=M, scale=H ** -0.5, window=window)
    ctx, lse = k1_tiles(rw, rr, k, v, g, mv, **kw)
    ref, ref_lse = flash_rel_attn_fwd_plain(rw, rr, k, v, g, mv, **kw)
    assert ctx.dtype == ref.dtype == torch.bfloat16
    assert float((ctx.float() - ref.float()).abs().max()) <= 2e-2
    assert float((lse - ref_lse).abs().max()) <= 1e-3


@pytest.mark.parametrize('H,T,M,mv,window,clamp', [(32, 333, 64, 17, 40, 1024),
                                                   (64, 256, 128, 128, 0, 1024),
                                                   (128, 200, 100, 37, 150, 17)])
def test_k1_tile_schedule_rounds_p_to_f16(H, T, M, mv, window, clamp):
    """f16 inputs (the kernel instantiated on __half): p rounded to f16 per
    key tile stays within the card's f16 K1 limits of the plain version:
    ctx 5e-3, lse 1e-3."""
    rw, rr, k, v, g = _k1_inputs(H, T, M, clamp, seed=8, dtype=torch.float16)
    kw = dict(M=M, scale=H ** -0.5, window=window)
    ctx, lse = k1_tiles(rw, rr, k, v, g, mv, **kw)
    ref, ref_lse = flash_rel_attn_fwd_plain(rw, rr, k, v, g, mv, **kw)
    assert ctx.dtype == ref.dtype == torch.float16
    assert float((ctx.float() - ref.float()).abs().max()) <= 5e-3
    assert float((lse - ref_lse).abs().max()) <= 1e-3


def test_k1_split_bd_windows_cover_every_pair():
    """At head dim 128 warp c of group p reads table window rows 63 - qi + ki
    for its keys ki in [32c, 32c + 32), all inside its 48 columns [48 - 16p
    + 32c, +48) at column 15 - qr + kl; the two warps' keys tile the 64 keys
    and their ctx columns the 128 columns, once each."""
    sp, kw, hw = k1_split(128)
    assert (sp, kw, hw) == (2, 32, 64)
    seen_k, seen_h = torch.zeros(BK, dtype=torch.int32), torch.zeros(128, dtype=torch.int32)
    for c in range(sp):
        seen_k[kw * c:kw * c + kw] += 1
        seen_h[hw * c:hw * c + hw] += 1
        kl = torch.arange(kw)[None, :]
        for p in range(NW):
            qr = torch.arange(16)[:, None]
            r = 63 - (16 * p + qr) + kw * c + kl
            r0 = 48 - 16 * p + kw * c
            assert int(r.min()) >= r0 and int(r.max()) < r0 + kw + 16
            assert torch.equal(r - r0, 15 - qr + kl)
            assert 0 <= r0 and r0 + kw + 16 <= 128
    assert bool((seen_k == 1).all()) and bool((seen_h == 1).all())


def test_k1_bd_window_covers_every_pair():
    """Warp w's q rows read table window rows 63 - qi + ki, all inside its 80
    columns [48 - 16w, 128 - 16w), at column 15 - qr + ki of its staging."""
    ki = torch.arange(BK)[None, :]
    for w in range(NW):
        qr = torch.arange(16)[:, None]
        r = 63 - (16 * w + qr) + ki
        assert int(r.min()) >= 48 - 16 * w and int(r.max()) < 128 - 16 * w
        assert torch.equal(r - (48 - 16 * w), 15 - qr + ki)
        # 16-row groups of the window never straddle two slabs
        assert all((48 - 16 * w + 16 * np) // 64 == (63 - 16 * w + 16 * np) // 64
                   for np in range(XW // 16))


@pytest.mark.parametrize('steps', [1, 2, 3, 7])
def test_k1_g_ring_refills_a_free_slab(steps):
    """The next key tile's slab goes into the one slot the current window
    does not use, and after the load the next window is whole."""
    ring = [None] * 3
    ring[k1_slab(0, 0)], ring[k1_slab(1, 0)] = 0, 64          # first window row of each slab
    for it in range(steps):
        u_lo = 64 * it
        assert ring[k1_slab(0, it)] == u_lo and ring[k1_slab(1, it)] == u_lo + 64
        new = k1_slab(1, it + 1)
        assert new not in (k1_slab(0, it), k1_slab(1, it))
        ring[new] = u_lo + 128


@pytest.mark.parametrize('T,M,mv,window,any_interior', [
    (1024, 0, 0, 0, True), (333, 64, 17, 40, False), (1024, 512, 300, 512, True),
    (2048, 1024, 1024, 0, True), (200, 100, 37, 150, False), (256, 128, 128, 0, True),
])
def test_k1_interior_tiles(T, M, mv, window, any_interior):
    """Over every tile pair a block visits: the kernel's interior test is the
    TPU kernel's (S = M + T keeps every interior key inside [0, S)); an
    interior pair has every (q < T, k) pair visible under the full mask; and
    every visible pair lies in a visited tile.  A window shorter than a tile
    pair's 127 distances leaves no pair interior."""
    S = M + T
    vis = _key_mask(T, S, M, mv, window, 'cpu')
    covered = torch.zeros_like(vis)
    n_interior = 0
    for q0 in range(0, T, BQ):
        for kt in k1_key_tiles(q0, T, S, M, mv, window):
            k0 = kt * BK
            inside = k1_interior(q0, k0, S, M, mv, window)
            assert inside == tpu_interior(q0, k0, M, mv, window)
            if inside:
                n_interior += 1
                assert bool(vis[q0:q0 + BQ, k0:k0 + BK].all())
            covered[q0:q0 + BQ, k0:k0 + BK] = True
    assert not bool((vis & ~covered).any())
    assert (n_interior > 0) == any_interior


# ----------------------------------------------------------------------- K3
def k3_runs(n, run=RUN):
    """The blocks' runs of consecutive chunks [j0, j1)."""
    return [(j0, min(j0 + run, n)) for j0 in range(0, n, run)]


def k3_tiles(q, k, v, qpos, kpos, *, chunk, scale, self_bias):
    """The schedule of `k3_tc` in torch -> (ctx, lse, loads, fixed): loads
    counts the key-chunk loads per (g, chunk) (chunk -1: the zeros before
    chunk 0), fixed the rows whose max is their own biased key (the kernel
    recomputes that score)."""
    G, T, D = q.shape
    C, n = chunk, T // chunk
    dtype = q.dtype
    qf, kf, vf = q.float(), k.float(), v.float()
    ctx = torch.zeros(G, T, D)
    lse = torch.zeros(G, T)
    loads, fixed = {}, []
    for g in range(G):
        for j0, j1 in k3_runs(n):
            kslots, qslots = [None] * 3, [None] * 2

            def load_kv(c):                       # key chunk c -> slot (c + 3) % 3
                loads[g, c] = loads.get((g, c), 0) + 1
                kslots[(c + 3) % 3] = (
                    c, _rows(kf[g:g + 1], c * C, C)[0], _rows(vf[g:g + 1], c * C, C)[0],
                    _rows(kpos[g:g + 1], c * C, C, fill=INT32_MAX)[0])

            def load_q(c):                        # query chunk c -> slot c % 2
                qslots[c % 2] = (c, qf[g, c * C:(c + 1) * C], qpos[g, c * C:(c + 1) * C])

            load_kv(j0 - 1)
            load_kv(j0)
            load_q(j0)
            for i in range(j0, j1):
                if i + 1 < j1:                    # in flight while chunk i computes
                    load_kv(i + 1)
                    load_q(i + 1)
                (cp, kp_, vp_, pp), (cc, kc, vc, pc) = kslots[(i + 2) % 3], kslots[i % 3]
                cq, qc, qp = qslots[i % 2]
                assert (cp, cc, cq) == (i - 1, i, i)
                kw, vw = torch.cat([kp_, kc]), torch.cat([vp_, vc])
                kp = torch.cat([pp, pc])[None, :]
                x = (qc @ kw.T) * scale
                own = kp == qp[:, None]
                if self_bias:
                    x = torch.where(own, x + self_bias, x)
                x = torch.where(kp > qp[:, None], torch.full_like(x, NEG_INF_K3), x)
                mx = x.amax(-1)
                if self_bias:            # rows at the window's least key position
                    fix = (qp == kp.min()) & (own & (x == mx[:, None])).any(-1)
                    fixed += [(g, i * C + int(r)) for r in torch.nonzero(fix)[:, 0]]
                p = torch.exp2((x - mx[:, None]) * LOG2E)
                l = p.sum(-1).clamp(min=1e-30)
                ctx[g, i * C:(i + 1) * C] = (p.to(dtype).float() @ vw) * (1 / l)[:, None]
                lse[g, i * C:(i + 1) * C] = mx + torch.log(l)
    return ctx.to(dtype), lse, loads, fixed


def _k3_inputs(G, T, D, perm, pads, seed):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(G, T, D, generator=g) for _ in range(3))
    if perm:        # shared-QK as the LSH layers: k = q rms-normalised, carrying 1/sqrt(D)
        k = q * torch.rsqrt((q * q).mean(-1, keepdim=True) + 1e-6) / D ** 0.5
        qpos = torch.stack([torch.randperm(T, generator=g) for _ in range(G)])
    else:
        qpos = torch.arange(T).expand(G, T)
    kpos = torch.where(qpos >= T - pads, torch.full_like(qpos, T), qpos) if pads else qpos
    return q, k, v, qpos.to(torch.int32).contiguous(), kpos.to(torch.int32).contiguous()


K3_CASES = [   # G, T, D, chunk, perm, pads, scale, self_bias
    (2, 17 * 64, 64, 64, True, 0, 1.0, -1e5),         # runs 16, 1
    (3, 33 * 32, 16, 32, True, 40, 1.0, -1e5),        # chunk 32 / D 16, padded; 16, 16, 1
    (2, 12 * 64, 32, 64, False, 200, 0.125, 0.0),     # local; fully masked pad rows
    (2, 3 * 32, 16, 32, False, 0, 0.25, 0.0),         # a single run of 3 chunks
]


def _lse_close(a, b):
    """f32 agreement of lse: 1e-5 of each value (rows with only their own key
    visible sit at ~self_bias = -1e5, where f32 steps are 2^-7)."""
    return bool(((a - b).abs() <= 1e-5 * b.abs().clamp(min=1.0)).all())


@pytest.mark.parametrize('G,T,D,chunk,perm,pads,scale,self_bias', K3_CASES)
def test_k3_run_schedule_matches_plain(G, T, D, chunk, perm, pads, scale, self_bias):
    """ctx to 1e-5 of its largest entry and lse to 1e-5, f32; every key chunk
    loaded once by its own run plus once as the look-back of the next run's
    first chunk, and chunk 0's look-back (zeros) once per row."""
    q, k, v, qpos, kpos = _k3_inputs(G, T, D, perm, pads, seed=G + T + D)
    kw = dict(chunk=chunk, scale=scale, self_bias=self_bias)
    ctx, lse, loads, _ = k3_tiles(q, k, v, qpos, kpos, **kw)
    ref, ref_lse = chunked_window_attn_fwd_plain(q, k, v, qpos, kpos, **kw)
    assert float((ctx - ref).abs().max() / ref.abs().max()) <= 1e-5
    assert _lse_close(lse, ref_lse)
    n = T // chunk
    firsts = {j0 for j0, _ in k3_runs(n)}
    for g in range(G):
        assert loads[g, -1] == 1
        for c in range(n):
            assert loads[g, c] == 1 + (c + 1 in firsts), (g, c)


def test_k3_runs():
    """17 chunks make runs of 16 and 1, 33 chunks 16, 16 and 1; 3 chunks one
    run; the runs tile every chunk once."""
    assert k3_runs(17) == [(0, 16), (16, 17)]
    assert k3_runs(33) == [(0, 16), (16, 32), (32, 33)]
    assert k3_runs(3) == [(0, 3)]
    for n in (1, 7, 8, 9, 32, 33):
        chunks = [c for j0, j1 in k3_runs(n) for c in range(j0, j1)]
        assert chunks == list(range(n))


def test_k3_fully_masked_pad_row_is_the_uniform_window_average():
    """A pad query whose whole window is pad keys (kpos = T) gets the mean of
    the window's 2C values, as the TPU kernel (-1e9 is finite, not -inf)."""
    G, T, D, C = 1, 6 * 32, 16, 32
    q, k, v, qpos, kpos = _k3_inputs(G, T, D, False, 2 * C + 5, seed=3)
    ctx, lse, _, _ = k3_tiles(q, k, v, qpos, kpos, chunk=C, scale=0.25, self_bias=0.0)
    ref, _ = chunked_window_attn_fwd_plain(q, k, v, qpos, kpos, chunk=C, scale=0.25)
    last = slice(T - C, T)                          # every key of chunks 4 and 5 is a pad
    want = v[0, T - 2 * C:].mean(0)
    assert torch.allclose(ctx[0, last], want.expand(C, D), atol=1e-6)
    assert torch.allclose(ref[0, last], want.expand(C, D), atol=1e-6)
    assert torch.allclose(lse[0, last], torch.full((C,), NEG_INF_K3 + math.log(2 * C)))


def test_k3_chunk0_lookback_is_invisible():
    """Chunk 0's look-back (zero keys, position INT32_MAX) takes no weight:
    with every own-chunk key visible, ctx of chunk 0 is attention over its
    own keys alone."""
    G, T, D, C = 2, 4 * 32, 16, 32
    q, k, v, qpos, kpos = _k3_inputs(G, T, D, False, 0, seed=5)
    ctx, _, _, _ = k3_tiles(q, k, v, qpos, kpos, chunk=C, scale=0.25, self_bias=0.0)
    s = (q[:, :C] @ k[:, :C].transpose(1, 2)) * 0.25
    s = s.masked_fill(torch.ones(C, C, dtype=torch.bool).triu(1), NEG_INF_K3)
    want = torch.softmax(s, -1) @ v[:, :C]
    assert torch.allclose(ctx[:, :C], want, atol=1e-5)


def test_k3_recomputed_rows_see_only_their_own_key():
    """With the LSH self bias, the rows whose max is their own biased key --
    the rows whose lse the kernel recomputes -- are exactly the rows with no
    other key visible, and every window has at most one such row."""
    G, T, D, C = 2, 17 * 64, 64, 64
    q, k, v, qpos, kpos = _k3_inputs(G, T, D, True, 0, seed=11)
    _, lse, _, fixed = k3_tiles(q, k, v, qpos, kpos, chunk=C, scale=1.0, self_bias=-1e5)
    qp = qpos.reshape(G, T // C, C)
    kw = torch.cat([torch.full_like(qp[:, :1], INT32_MAX), qp[:, :-1]], 1)
    window = torch.cat([kw, qp], -1)                                    # [G, n, 2C]
    only_self = ((window[..., None, :] <= qp[..., :, None]).sum(-1) == 1).reshape(G, T)
    assert sorted(fixed) == sorted(map(tuple, torch.nonzero(only_self).tolist()))
    assert fixed and bool((lse[only_self] < -5e4).all())
    per_window = only_self.reshape(G, T // C, C).sum(-1)
    assert int(per_window.max()) <= 1


# ------------------------------------------------------- K3's tiled walk, tensor cores
def k3_chain(qr, kr):
    """q . k of rows qr, kr [n, D] as the sequential f32 FMA chain over d
    (each product exact in f64, one rounding to f32 per step)."""
    acc = torch.zeros(qr.shape[0], dtype=torch.float32)
    for d in range(qr.shape[1]):
        acc = (acc.double() + qr[:, d].double() * kr[:, d].double()).float()
    return acc


def k3_union_key_tiles(q0, T, C):
    """First keys of the 64-key tiles the block of rows [q0, q0 + 64) walks:
    the union of its rows' windows, [(q0 / C - 1) C, (q_last / C + 1) C)."""
    q_last = min(q0 + BQ, T) - 1
    return list(range((q0 // C - 1) * C, (q_last // C + 1) * C, BK))


def k3_union_tiles(q, k, v, qpos, kpos, *, chunk, scale, self_bias):
    """The schedule of `k3_union_tc` in torch -> (ctx, lse, own): a block per
    64 query rows walks the 64-key tiles of the union of its rows' windows;
    at D 128 warp c of a 16-row group scores keys [32c, 32c + 32) and owns
    ctx columns [64c, 64c + 64).  `own` lists the (g, row) whose own key's
    score was recomputed as the f32 chain (with a self bias)."""
    G, T, D = q.shape
    C, dtype = chunk, q.dtype
    sp = 2 if D > 64 else 1
    kw, dw = BK // sp, D // sp
    qf, kf, vf = q.float(), k.float(), v.float()
    ctx, lse, own = torch.zeros(G, T, D), torch.zeros(G, T), []
    for q0 in range(0, T, BQ):
        qt, qp = _rows(qf, q0, BQ), _rows(qpos, q0, BQ, fill=INT32_MIN)
        r = torch.arange(q0, q0 + BQ)
        lo = (torch.div(r, C, rounding_mode='floor') - 1) * C          # first window key
        m = torch.full((G, BQ), K_NONE)
        l = torch.zeros(sp, G, BQ)
        o = torch.zeros(G, BQ, D)
        for k0 in k3_union_key_tiles(q0, T, C):
            kt, vt = _rows(kf, k0, BK), _rows(vf, k0, BK)
            kp = _rows(kpos, k0, BK, fill=INT32_MAX)[:, None, :]
            wk = torch.arange(k0, k0 + BK)
            s = torch.empty(G, BQ, BK)
            for c in range(sp):
                s[..., kw * c:kw * c + kw] = qt @ kt[:, kw * c:kw * c + kw].transpose(1, 2)
            x = s * scale
            mine = kp == qp[..., None]
            if self_bias:
                x = torch.where(mine, x + self_bias, x)
            x = torch.where(kp > qp[..., None], torch.full_like(x, NEG_INF_K3), x)
            inside = (wk[None, :] >= lo[:, None]) & (wk[None, :] < lo[:, None] + 2 * C)
            x = torch.where(inside, x, torch.full_like(x, -math.inf))
            if self_bias:            # the own key's score as the sequential f32 chain
                hit = torch.nonzero(mine & inside)
                gi, ri, ki = hit.unbind(1)
                x[gi, ri, ki] = ((k3_chain(qt[gi, ri], kt[gi, ki]) * scale).float()
                                 + self_bias).float()
                own += [(int(a), q0 + int(b)) for a, b in zip(gi, ri)]
            mx = m
            for c in range(sp):      # each warp's max, then the pair's
                mx = torch.maximum(mx, x[..., kw * c:kw * c + kw].amax(-1))
            alpha = torch.exp2((m - mx) * LOG2E)
            p = torch.exp2((x - mx[..., None]) * LOG2E)
            P = p.to(dtype).float()
            for c in range(sp):
                l[c] = l[c] * alpha + p[..., kw * c:kw * c + kw].sum(-1)
                cols = slice(dw * c, dw * c + dw)
                o[..., cols] = o[..., cols] * alpha[..., None] + P @ vt[..., cols]
            m = mx
        lc = l.sum(0).clamp(min=1e-30)
        n = min(BQ, T - q0)
        ctx[:, q0:q0 + n] = (o * (1 / lc)[..., None])[:, :n]
        lse[:, q0:q0 + n] = (m + torch.log(lc))[:, :n]
    return ctx.to(dtype), lse, own


def _lse16_close(a, b):
    """lse of a 16-bit call: 1e-3 (the card's K3 limit), or one f32 step of
    the value where that is coarser (rows at ~self_bias = -1e5, whose own
    score the CPU's f32 matmul sums in another order than the chain)."""
    return bool(((a - b).abs() <= torch.clamp(b.abs() * 2.0 ** -23, min=1e-3)).all())


K3_UNION_CASES = [   # G, T, D, chunk, perm, pads, scale, self_bias, dtype
    (2, 480, 32, 16, True, 9, 1.0, -1e5, torch.float32),        # ragged last tile
    (2, 480, 32, 16, True, 9, 1.0, -1e5, torch.float16),
    (2, 384, 64, 128, False, 0, 0.125, 0.0, torch.bfloat16),    # a tile inside one chunk
    (2, 384, 128, 128, True, 40, 1.0, -1e5, torch.float32),     # two warps per group
    (2, 256, 128, 128, True, 40, 1.0, -1e5, torch.bfloat16),
    (1, 320, 128, 64, False, 30, 0.09, 0.0, torch.float16),     # chunk 64 at D 128
    (2, 240, 16, 8, True, 0, 1.0, -1e5, torch.float16),         # chunk 8, 8 chunks per tile
    (2, 288, 64, 48, False, 17, 0.125, 0.0, torch.bfloat16),    # tiles across chunk edges
    (2, 288, 64, 48, True, 17, 1.0, -1e5, torch.float32),
]
K3_CTX_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 5e-3}


def _k3_union_inputs(G, T, D, perm, pads, seed, dtype):
    q, k, v, qpos, kpos = _k3_inputs(G, T, D, perm, pads, seed)
    return q.to(dtype), k.to(dtype), v.to(dtype), qpos, kpos


@pytest.mark.parametrize('G,T,D,chunk,perm,pads,scale,self_bias,dtype', K3_UNION_CASES)
def test_k3_union_walk_matches_plain(G, T, D, chunk, perm, pads, scale, self_bias, dtype):
    """ctx and lse of the emulated walk against the plain forward: f32 to
    1e-5 of ctx's largest entry and lse to 1e-5 of each value; bf16 / f16
    (p rounded per key tile against the running max) at the card's limits:
    ctx 2e-2 / 5e-3 (absolute, as chip_smoke's TOL_K3), lse 1e-3."""
    q, k, v, qpos, kpos = _k3_union_inputs(G, T, D, perm, pads, G + T + D + chunk, dtype)
    kw = dict(chunk=chunk, scale=scale, self_bias=self_bias)
    ctx, lse, _ = k3_union_tiles(q, k, v, qpos, kpos, **kw)
    ref, ref_lse = chunked_window_attn_fwd_plain(q, k, v, qpos, kpos, **kw)
    assert ctx.shape == ref.shape and ctx.dtype == ref.dtype and lse.shape == ref_lse.shape
    err = (ctx.float() - ref.float()).abs().max()
    if dtype == torch.float32:
        assert float(err / ref.abs().max()) <= K3_CTX_TOL[dtype]
        assert _lse_close(lse, ref_lse)
    else:
        assert float(err) <= K3_CTX_TOL[dtype]
        assert _lse16_close(lse, ref_lse)


@pytest.mark.parametrize('T,chunk', [(480, 16), (384, 128), (240, 8), (288, 48), (64, 64)])
def test_k3_union_walk_covers_each_window_once(T, chunk):
    """Each row's 2C window keys lie in exactly one of its block's key tiles,
    and no tile of the walk lies wholly outside every window of the block:
    a bound off by one tile either loses keys or walks a dead tile."""
    C = chunk
    for q0 in range(0, T, BQ):
        q_last = min(q0 + BQ, T) - 1
        tiles = k3_union_key_tiles(q0, T, C)
        lo = torch.div(torch.arange(q0, q_last + 1), C, rounding_mode='floor') * C - C
        for r, lo_r in zip(range(q0, q_last + 1), lo.tolist()):
            hits = torch.zeros(2 * C, dtype=torch.int32)
            for k0 in tiles:
                a, b = max(k0, lo_r), min(k0 + BK, lo_r + 2 * C)
                hits[a - lo_r:max(a, b) - lo_r] += 1
            assert bool((hits == 1).all()), (r, tiles)
        for k0 in tiles:
            assert bool(((lo < k0 + BK) & (lo + 2 * C > k0)).any()), (q0, k0)


@pytest.mark.parametrize('D,chunk,dtype', [(64, 16, torch.float32), (128, 128, torch.bfloat16),
                                           (32, 48, torch.float16)])
def test_k3_union_rescores_own_keys(D, chunk, dtype):
    """With the LSH self bias every row's own key (inside its window) is
    rescored once over the walk, and a row that sees only its own key keeps
    lse = fl(fl(chain(q, k) * scale) + self_bias) exactly: its other terms
    are exp(-1e9 - max) = 0, so l = 1 and lse is the rescored max."""
    G, T = 2, 6 * max(chunk, 64)
    q, k, v, qpos, kpos = _k3_union_inputs(G, T, D, True, 0, 19, dtype)
    _, lse, own = k3_union_tiles(q, k, v, qpos, kpos, chunk=chunk, scale=1.0, self_bias=-1e5)
    assert sorted(own) == [(g, r) for g in range(G) for r in range(T)]
    qp = qpos.reshape(G, T // chunk, chunk)
    kwin = torch.cat([torch.full_like(qp[:, :1], INT32_MAX), qp[:, :-1]], 1)
    window = torch.cat([kwin, qp], -1)
    only_self = ((window[..., None, :] <= qp[..., :, None]).sum(-1) == 1).reshape(G, T)
    g_i, r_i = torch.nonzero(only_self).unbind(1)
    assert len(g_i) > 0
    want = (k3_chain(q[g_i, r_i].float(), k[g_i, r_i].float()) + -1e5).float()
    assert torch.equal(lse[g_i, r_i], want)


def test_k3_union_walk_matches_the_pallas_forward():
    """At one small case (chunk 16, two 64-row tiles, LSH-permuted and
    padded positions, f32) the emulated walk gives the Pallas kernel's ctx
    and lse in interpret mode (the tolerance of tests/test_torch_chunked.py's
    K3 check: the TPU kernel sums in another order)."""
    G, T, D, chunk, scale, self_bias = 2, 128, 16, 16, 1.0, -1e5
    q, k, v, qpos, kpos = _k3_union_inputs(G, T, D, True, 24, 5, torch.float32)
    want, want_lse = pallas_chunked_window_attn(
        *(jnp.asarray(x.numpy()) for x in (q, k, v, qpos, kpos)), chunk=chunk, scale=scale,
        self_bias=self_bias, interpret=True, form='windows')
    got, got_lse, _ = k3_union_tiles(q, k, v, qpos, kpos, chunk=chunk, scale=scale,
                                     self_bias=self_bias)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), rtol=2e-4, atol=2e-4)


# ------------------------------- every f32 call, and head dims above 128: the slab kernels
SP = 2              # warps per 16-row group of k1_slab / k3_slab
KW = BK // SP       # keys of a warp's scores
SXW = KW + 16       # k1_slab: BD window columns a warp reads


def slab_config(name, H, dtype):
    """(slab width W, output slabs a block holds ZS) of the forward slab
    kernel of `csrc/<name>.cu` at head dim H, read from its `with_cfg`."""
    return with_cfg(name, H, dtype == torch.float32)


def fwd_slab_items(ns, nz, v_with_last_score):
    """A block's items per tile pair: ('score', i) for the ns slabs of the
    head dim in order, then ('out', z) for its output slabs 0 .. nz - 1 (the
    block's own numbering); with `v_with_last_score` (k3_slab) the last
    score item's stage also holds V's slab of the block's last output slab,
    which that item applies, so the items list the others."""
    return ([('score', i) for i in range(ns)]
            + [('out', z) for z in range(nz - 1 if v_with_last_score else nz)])


def chain_from(acc, qr, kr):
    """acc continued over the columns of rows qr, kr [n, W] as the sequential
    f32 FMA chain (k3_chain's steps): slab_mma.cuh's own_chain."""
    for d in range(qr.shape[1]):
        acc = (acc.double() + qr[:, d].double() * kr[:, d].double()).float()
    return acc


def k1_slab_tiles(rw, rr, k, v, g, mem_valid, *, M, scale, window):
    """The schedule of `k1_slab` in torch -> (ctx, lse, blocks): a block
    per (q tile, group of ZS output slabs) walks K1's key tiles and runs
    each tile pair's `fwd_slab_items`: a score item adds its slab's AC = Qw
    . K^T (summed apart, then added: slab 0 first) and each warp's X = Qr .
    Gwin[48 - 16p + 32c, + 48)^T (group p, warp c; BD read at column 15 - qr
    + ki of the warp's keys [32c, 32c + 32)); after the last, the online
    softmax (the row max over both warps' key halves, each warp's row sums
    apart until the end), every output slab's sums rescaled and P rounded
    to the inputs' dtype; an output item adds P . V[:, slab].  lse comes from
    the z0 = 0 blocks; every block's lse is the same.  `blocks` counts the
    blocks per q tile (grid z)."""
    BN, T, H = rw.shape
    S, N = k.shape[1], g.shape[0]
    dtype = rw.dtype
    W, ZS = slab_config('flash_rel_attn_fwd', H, dtype)
    ns = H // W
    n_qt = -(-T // BQ)
    qw, qr = _rows(rw.float(), 0, n_qt * BQ), _rows(rr.float(), 0, n_qt * BQ)
    kf, vf = k.float(), v.float()
    gb = g.float()[torch.arange(BN) % N]
    vis = torch.zeros(n_qt * BQ, -(-S // BK) * BK, dtype=torch.bool)
    vis[:T, :S] = _key_mask(T, S, M, mem_valid, window, 'cpu')
    ctx = torch.zeros(BN, n_qt * BQ, H)
    lses = []
    qr_ = torch.arange(16)[:, None]
    kl = torch.arange(KW)[None, :]
    for z0 in range(0, ns, ZS):                  # grid z
        nz = min(ZS, ns - z0)
        lse = torch.zeros(BN, n_qt * BQ)
        for q0 in range(0, n_qt * BQ, BQ):
            rows = slice(q0, q0 + BQ)
            m = torch.full((BN, BQ), NEG_INF_K1)
            l = torch.zeros(SP, BN, BQ)          # each warp's sums over its keys
            o = torch.zeros(BN, BQ, nz * W)
            for kt in k1_key_tiles(q0, T, S, M, mem_valid, window):
                k0, u_lo = kt * BK, T - q0 - BQ + kt * BK
                gwin, kt_rows, vt = _rows(gb, u_lo, 128), _rows(kf, k0, BK), _rows(vf, k0, BK)
                xs = torch.zeros(BN, NW, SP, 16, SXW)
                for kind, i in fwd_slab_items(ns, nz, False):
                    if kind == 'out':
                        zc = slice(W * (z0 + i), W * (z0 + i) + W)
                        o[..., W * i:W * i + W] += P @ vt[..., zc]
                        continue
                    c = slice(W * i, W * i + W)
                    sm = qw[:, rows, c] @ kt_rows[..., c].transpose(1, 2)
                    ac = sm if i == 0 else ac + sm
                    for p in range(NW):
                        for cw in range(SP):
                            r0 = 48 - 16 * p + KW * cw
                            xs[:, p, cw] += (qr[:, q0 + 16 * p:q0 + 16 * p + 16, c]
                                             @ gwin[:, r0:r0 + SXW, c].transpose(1, 2))
                    if i < ns - 1:
                        continue
                    bd = torch.cat([torch.cat([xs[:, p, cw][:, qr_, 15 - qr_ + kl]
                                               for cw in range(SP)], 2) for p in range(NW)], 1)
                    x = (ac + bd) * scale
                    if not k1_interior(q0, k0, S, M, mem_valid, window):
                        x = torch.where(vis[rows, k0:k0 + BK], x, torch.full_like(x, NEG_INF_K1))
                    mx = m
                    for cw in range(SP):         # each warp's max, then the pair's
                        mx = torch.maximum(mx, x[..., KW * cw:KW * cw + KW].amax(-1))
                    alpha = torch.exp2((m - mx) * LOG2E)
                    p_ = torch.exp2((x - mx[..., None]) * LOG2E)
                    for cw in range(SP):
                        l[cw] = l[cw] * alpha + p_[..., KW * cw:KW * cw + KW].sum(-1)
                    o = o * alpha[..., None]
                    P = p_.to(dtype).float()
                    m = mx
            lc = (l[0] + l[1]).clamp(min=1e-30)
            ctx[:, rows, W * z0:W * (z0 + nz)] = o * (1 / lc)[..., None]
            lse[:, rows] = m + torch.log(lc)
        lses.append(lse)
    assert all(torch.equal(x, lses[0]) for x in lses)
    return ctx[:, :T].to(dtype), lses[0][:, :T], len(lses)


K1_SLAB_CASES = [   # H, T, M, mem_valid, window, clamp, dtype
    (256, 77, 0, 0, 0, 1024, torch.float32),
    (256, 200, 100, 37, 150, 17, torch.float32),
    (384, 130, 64, 17, 40, 1024, torch.float32),
    (128, 140, 30, 30, 0, 17, torch.float32),       # f32 at 128: two slabs of 64
    (32, 100, 0, 0, 0, 1024, torch.float32),         # f32 below 64: one slab of H
    (256, 150, 64, 17, 40, 1024, torch.bfloat16),
    (384, 130, 64, 17, 40, 1024, torch.bfloat16),    # six output slabs in one block
    (640, 130, 64, 17, 40, 33, torch.float32),       # ten: grid z splits them
    (16, 77, 30, 30, 0, 17, torch.float32),          # a slab of 16: one warp of a pair idle
]


@pytest.mark.parametrize('H,T,M,mv,window,clamp,dtype', K1_SLAB_CASES)
def test_k1_slab_schedule_matches_plain(H, T, M, mv, window, clamp, dtype):
    """The slab schedule against the plain forward: f32 ctx to 1e-5 of its
    largest entry and lse to 1e-5; bf16 ctx at the card's limit 2e-2 and lse
    1e-3 (p rounded per tile against the running max)."""
    rw, rr, k, v, g = _k1_inputs(H, T, M, clamp, seed=H + T + M, dtype=dtype, N=2, B=1)
    kw = dict(M=M, scale=H ** -0.5, window=window)
    ctx, lse, _ = k1_slab_tiles(rw, rr, k, v, g, mv, **kw)
    ref, ref_lse = flash_rel_attn_fwd_plain(rw, rr, k, v, g, mv, **kw)
    assert ctx.shape == ref.shape and ctx.dtype == ref.dtype
    err = (ctx.float() - ref.float()).abs().max()
    if dtype == torch.float32:
        assert float(err / ref.abs().max()) <= 1e-5
        assert float((lse - ref_lse).abs().max()) <= 1e-5
    else:
        assert float(err) <= 2e-2 and float((lse - ref_lse).abs().max()) <= 1e-3


def test_k1_slab_schedule_matches_the_pallas_forward():
    """At one small case (f32, head dim 128 in two slabs, memory with
    mem_valid < M and a window) the emulated slab schedule gives the Pallas
    kernel's ctx and lse in interpret mode (the TPU kernel sums in another
    order: 2e-4, as tests/test_torch_attention.py's parity)."""
    H, T, M, mv, window = 128, 128, 64, 40, 100
    rw, rr, k, v, g = _k1_inputs(H, T, M, 33, seed=5, N=2, B=1)
    packed = pallas_k1_fwd(*(jnp.asarray(x.numpy()) for x in (rw, rr, k, v, g)), mv, M=M,
                           scale=H ** -0.5, window=window, bq=BQ, bk=BK, interpret=True)
    got, got_lse, _ = k1_slab_tiles(rw, rr, k, v, g, mv, M=M, scale=H ** -0.5, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(packed[..., :H]), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(packed[..., H]), rtol=2e-4,
                               atol=2e-4)


def k3_slab_tiles(q, k, v, qpos, kpos, *, chunk, scale, self_bias):
    """The schedule of `k3_slab` in torch -> (ctx, lse, own, blocks): a block
    per (64 query rows, group of ZS output slabs) walks the 64-key tiles of
    the union of its rows' windows (`k3_union_tc`'s walk) and runs each tile
    pair's `fwd_slab_items`: a score item adds its slab's Q . K^T (summed
    apart, then added: slab 0 first) and, with a self bias in a tile pair
    that holds own keys, continues each row's own-key chain over the slab's
    columns of the staged rows (the Q tile's row, the K tile's row of the
    same index, clamped into the tile); after the last, the masks, the own
    key's chained score where key index == row and kpos == qpos, the online
    softmax (max over both warps' key halves), every output slab's sums
    rescaled, P rounded, and the block's last output slab applied from the
    same stage; an output item adds P . V[:, slab].  `own` lists the (g,
    row) that took the chained score in the z0 = 0 blocks."""
    G, T, D = q.shape
    C, dtype = chunk, q.dtype
    W, ZS = slab_config('chunked_window_attn_fwd', D, dtype)
    ns = D // W
    qf, kf, vf = q.float(), k.float(), v.float()
    ctx, lses, own = torch.zeros(G, T, D), [], []
    for z0 in range(0, ns, ZS):                  # grid z
        nz = min(ZS, ns - z0)
        lse = torch.zeros(G, T)
        for q0 in range(0, T, BQ):
            qt, qp = _rows(qf, q0, BQ), _rows(qpos, q0, BQ, fill=INT32_MIN)
            r = torch.arange(q0, q0 + BQ)
            lo = (torch.div(r, C, rounding_mode='floor') - 1) * C
            m, l = torch.full((G, BQ), K_NONE), torch.zeros(SP, G, BQ)
            o = torch.zeros(G, BQ, nz * W)
            for k0 in k3_union_key_tiles(q0, T, C):
                kt, vt = _rows(kf, k0, BK), _rows(vf, k0, BK)
                kp = _rows(kpos, k0, BK, fill=INT32_MAX)[:, None, :]
                wk = torch.arange(k0, k0 + BK)
                chains = bool(self_bias) and k0 < q0 + BQ and q0 < k0 + BK
                kr = (r - k0).clamp(0, BK - 1)   # the K tile's row of each row's index
                acc = torch.zeros(G, BQ)
                items = fwd_slab_items(ns, nz, True)
                for kind, i in items:
                    if kind == 'out':
                        zc = slice(W * (z0 + i), W * (z0 + i) + W)
                        o[..., W * i:W * i + W] += P @ vt[..., zc]
                        continue
                    c = slice(W * i, W * i + W)
                    sm = qt[..., c] @ kt[..., c].transpose(1, 2)
                    s = sm if i == 0 else s + sm
                    if chains:
                        acc = torch.stack([chain_from(acc[b], qt[b][:, c], kt[b][kr][:, c])
                                           for b in range(G)])
                    if i < ns - 1:
                        continue
                    x = s * scale
                    mine = kp == qp[..., None]
                    if self_bias:
                        x = torch.where(mine, x + self_bias, x)
                    x = torch.where(kp > qp[..., None], torch.full_like(x, NEG_INF_K3), x)
                    if self_bias:
                        own_v = ((acc * scale).float() + self_bias).float()
                        diag = mine & (wk[None, None, :] == r[None, :, None])
                        x = torch.where(diag, own_v[..., None], x)
                        if z0 == 0:
                            own += [(int(a), q0 + int(b)) for a, b, _ in torch.nonzero(diag)]
                    inside = (wk[None, :] >= lo[:, None]) & (wk[None, :] < lo[:, None] + 2 * C)
                    x = torch.where(inside, x, torch.full_like(x, -math.inf))
                    mx = m
                    for cw in range(SP):         # each warp's max, then the pair's
                        mx = torch.maximum(mx, x[..., KW * cw:KW * cw + KW].amax(-1))
                    alpha = torch.exp2((m - mx) * LOG2E)
                    p_ = torch.exp2((x - mx[..., None]) * LOG2E)
                    for cw in range(SP):
                        l[cw] = l[cw] * alpha + p_[..., KW * cw:KW * cw + KW].sum(-1)
                    o = o * alpha[..., None]
                    P = p_.to(dtype).float()
                    m = mx
                    last = slice(W * (z0 + nz - 1), W * (z0 + nz))
                    o[..., W * (nz - 1):] += P @ vt[..., last]
            lc = (l[0] + l[1]).clamp(min=1e-30)
            n = min(BQ, T - q0)
            ctx[:, q0:q0 + n, W * z0:W * (z0 + nz)] = (o * (1 / lc)[..., None])[:, :n]
            lse[:, q0:q0 + n] = (m + torch.log(lc))[:, :n]
        lses.append(lse)
    assert all(torch.equal(x, lses[0]) for x in lses)
    return ctx.to(dtype), lses[0], own, len(lses)


K3_SLAB_CASES = [   # G, T, D, chunk, perm, pads, scale, self_bias, dtype
    (2, 256, 256, 64, True, 9, 1.0, -1e5, torch.float32),
    (1, 288, 256, 48, False, 17, 0.0625, 0.0, torch.float32),   # tiles across chunk edges
    (1, 256, 384, 128, True, 0, 1.0, -1e5, torch.float32),
    (2, 192, 256, 32, True, 9, 1.0, -1e5, torch.bfloat16),
    # f32 up to D 128: one slab of D, two of 64 at D 128, chunks 16 / 64 / 128
    (2, 480, 64, 16, True, 9, 1.0, -1e5, torch.float32),
    (2, 256, 64, 64, True, 9, 1.0, -1e5, torch.float32),
    (1, 384, 64, 128, False, 0, 0.125, 0.0, torch.float32),
    (1, 320, 128, 16, True, 9, 1.0, -1e5, torch.float32),
    (2, 256, 128, 64, False, 30, 0.088, 0.0, torch.float32),
    (1, 384, 128, 128, True, 40, 1.0, -1e5, torch.float32),
    (1, 192, 640, 64, True, 9, 0.04, -1e5, torch.float32),      # ten slabs: grid z splits
]


@pytest.mark.parametrize('G,T,D,chunk,perm,pads,scale,self_bias,dtype', K3_SLAB_CASES)
def test_k3_slab_walk_matches_plain(G, T, D, chunk, perm, pads, scale, self_bias, dtype):
    """The slab walk against the plain forward at the limits of the union
    walk's test: f32 ctx 1e-5 of its max and lse 1e-5 of each value, 16 bits
    at the card's."""
    q, k, v, qpos, kpos = _k3_union_inputs(G, T, D, perm, pads, G + T + D + chunk, dtype)
    kw = dict(chunk=chunk, scale=scale, self_bias=self_bias)
    ctx, lse, _, _ = k3_slab_tiles(q, k, v, qpos, kpos, **kw)
    ref, ref_lse = chunked_window_attn_fwd_plain(q, k, v, qpos, kpos, **kw)
    err = (ctx.float() - ref.float()).abs().max()
    if dtype == torch.float32:
        assert float(err / ref.abs().max()) <= 1e-5 and _lse_close(lse, ref_lse)
    else:
        assert float(err) <= K3_CTX_TOL[dtype] and _lse16_close(lse, ref_lse)


def test_k3_slab_rescores_own_keys_over_the_whole_head_dim():
    """LSH at D 256 (four slabs): every row's own key takes the chained
    score, and a row that sees only its own key keeps lse = fl(fl(chain(q,
    k) * scale) + self_bias) exactly, the chain running over all 256
    columns in order, a slab at a time from the staged tiles."""
    G, T, D, chunk = 2, 384, 256, 64
    q, k, v, qpos, kpos = _k3_union_inputs(G, T, D, True, 0, 23, torch.float32)
    _, lse, own, _ = k3_slab_tiles(q, k, v, qpos, kpos, chunk=chunk, scale=1.0, self_bias=-1e5)
    assert sorted(own) == [(g, r) for g in range(G) for r in range(T)]
    qp = qpos.reshape(G, T // chunk, chunk)
    kwin = torch.cat([torch.full_like(qp[:, :1], INT32_MAX), qp[:, :-1]], 1)
    window = torch.cat([kwin, qp], -1)
    only_self = ((window[..., None, :] <= qp[..., :, None]).sum(-1) == 1).reshape(G, T)
    g_i, r_i = torch.nonzero(only_self).unbind(1)
    assert len(g_i) > 0
    want = (k3_chain(q[g_i, r_i], k[g_i, r_i]) + -1e5).float()
    assert torch.equal(lse[g_i, r_i], want)


@pytest.mark.parametrize('D,dtype', [(64, torch.float32), (256, torch.float32),
                                     (128, torch.bfloat16)])
def test_k3_slab_own_chain_a_slab_at_a_time_is_the_whole_chain(D, dtype):
    """The own-key chain continued slab by slab over the staged tiles' rows
    (own_chain inside the product loop, the chain carried between slabs and
    restarted per tile pair only) is bit for bit the sequential chain over
    the whole head dim that lse of a row that sees only its own key holds."""
    W, _ = slab_config('chunked_window_attn_fwd', max(D, 256), dtype)
    q, k = (torch.randn(40, D, generator=torch.Generator().manual_seed(D + i)).to(dtype).float()
            for i in range(2))
    acc = torch.zeros(40)
    for c0 in range(0, D, W):
        acc = chain_from(acc, q[:, c0:c0 + W], k[:, c0:c0 + W])
    assert torch.equal(acc, k3_chain(q, k))


@pytest.mark.parametrize('name', ['flash_rel_attn_fwd', 'chunked_window_attn_fwd'])
@pytest.mark.parametrize('H,dtype', [(16, torch.float32), (64, torch.float32),
                                     (128, torch.float32), (256, torch.float32),
                                     (384, torch.float32), (640, torch.float32),
                                     (256, torch.bfloat16), (384, torch.float16),
                                     (512, torch.bfloat16)])
def test_fwd_slab_items_score_once_and_apply_each_output_slab_once(name, H, dtype):
    """Each block's items per tile pair: the head dim's slabs scored once,
    in order, then each of its output slabs applied once (k3_slab: the last
    from the last score slab's stage); the blocks of a tile together apply
    every output slab once; up to H 512 one block scores each tile pair
    (f32 at H 256: grid z 1), above it grid z splits the output slabs."""
    W, ZS = slab_config(name, H, dtype)
    ns = H // W
    applied = []
    for z0 in range(0, ns, ZS):
        nz = min(ZS, ns - z0)
        v_in = name == 'chunked_window_attn_fwd'
        items = fwd_slab_items(ns, nz, v_in)
        assert [i for kind, i in items if kind == 'score'] == list(range(ns))
        assert items[:ns] == [('score', i) for i in range(ns)]
        outs = [z for kind, z in items if kind == 'out']
        if v_in:
            outs.append(nz - 1)
        assert sorted(outs) == list(range(nz))
        applied += [z0 + z for z in outs]
    assert sorted(applied) == list(range(ns))
    assert (ns + ZS - 1) // ZS == (1 if H <= 512 else 2)


def test_k3_slab_walk_matches_the_pallas_forward():
    """At one small case (f32, D 128 in two slabs, chunk 16, LSH-permuted
    and padded positions) the emulated slab walk gives the Pallas kernel's
    ctx and lse in interpret mode (tests/test_torch_chunked.py's tolerance:
    the TPU kernel sums in another order)."""
    G, T, D, chunk, scale, self_bias = 1, 128, 128, 16, 1.0, -1e5
    q, k, v, qpos, kpos = _k3_union_inputs(G, T, D, True, 24, 6, torch.float32)
    want, want_lse = pallas_chunked_window_attn(
        *(jnp.asarray(x.numpy()) for x in (q, k, v, qpos, kpos)), chunk=chunk, scale=scale,
        self_bias=self_bias, interpret=True, form='windows')
    got, got_lse, _, _ = k3_slab_tiles(q, k, v, qpos, kpos, chunk=chunk, scale=scale,
                                       self_bias=self_bias)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), rtol=2e-4, atol=2e-4)
