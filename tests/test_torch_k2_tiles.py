"""K2's tensor-core tile schedule (`csrc/flash_rel_attn_bwd.cu`, k2_dkdv_tc /
k2_dq_tc) emulated in plain torch and held against `flash_rel_attn_bwd_plain`.

The card kernels cannot run here; this pins their index arithmetic on the
CPU: the 128-row distance-table window Gwin from u_lo = T - q0 - 64 + k0,
each warp's columns of X = Qr . Gwin^T read at column 15 - qr + kl, the
dSskew scatter dSskew[qi][63 - qi + ki] = ds, drr = dSskew . Gwin over each
16-row group's band, the dG window dSskew^T . Qr kept as two 64-row halves
that swap roles after each key tile (the finished half flushed, the other
carried), the full-tile test that skips the per-pair mask, the three-slab
ring that holds Gwin, and K1's tile ranges with memory, mem_valid and a
window.  At head dim 128 a 16-row group is two warps (`SP` = 2): warp c
computes S and dP over keys [32c, 32c + 32) from X's columns [48 - 16p +
32c, +48) and owns columns [64c, 64c + 64) of dk, dv, drw, drr and the dG
window, with drw from the group's dS rows shared through its scratch.  In
f32 the emulation must equal the plain backward to rounding; in bf16 and
f16 p and ds round to the input dtype where they enter a product, as the
kernels and the plain version round them."""
import pytest
import torch

from musicnlp_tpu_torch.ops.flash_attention import (
    _key_mask, distance_table, flash_rel_attn_bwd_plain, flash_rel_attn_fwd_plain,
)
from tests.slab_configs import with_cfg

BQ = BK = 64        # q rows / keys per tile
GW = 128            # distance-table rows staged per tile pair
NG = 4              # 16-row groups per tile: group p owns q rows (or keys) 16p..16p+15


# torch on one thread: the suite's xdist workers share the cores, and
# torch's intra-op threads on these many tiny ops slow each file many-fold
@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _split(H):
    """(warps per group, keys of a warp's S / dP, accumulator columns of a
    warp) of the kernels at head dim H."""
    sp = 2 if H > 64 else 1
    return sp, BK // sp, H // sp


def _rows(x, r0, n):
    """Rows [r0, r0 + n) of x [..., L, H], zero outside [0, L)."""
    idx = torch.arange(r0, r0 + n)
    ok = (idx >= 0) & (idx < x.shape[-2])
    out = x.new_zeros(*x.shape[:-2], n, x.shape[-1])
    out[..., ok, :] = x[..., idx[ok], :]
    return out


def _pad(x, n):
    """x [..., L, H] zero-padded to n rows."""
    return _rows(x, 0, n)


def _tile(qw, qr, do, kt, vt, gwin, lse, dl, vis, scale, dtype):
    """p and ds [BN, 64, 64] of one tile pair, rounded to dtype as the
    kernels round them; S, dP and BD by warp (p, c) over its KW keys, BD
    from the warp's XW = KW + 16 columns of X."""
    sp, kw, _ = _split(qw.shape[-1])
    xw = kw + 16
    s = torch.empty(qw.shape[0], BQ, BK)
    dp, bd = torch.empty_like(s), torch.empty_like(s)
    qr_ = torch.arange(16)[:, None]
    kl = torch.arange(kw)[None, :]
    for g in range(NG):
        rows = slice(16 * g, 16 * g + 16)
        for c in range(sp):
            keys = slice(kw * c, kw * c + kw)
            r0 = 48 - 16 * g + kw * c
            assert 0 <= r0 and r0 + xw <= GW and r0 % 16 == 0
            s[:, rows, keys] = qw[:, rows] @ kt[:, keys].transpose(1, 2)
            dp[:, rows, keys] = do[:, rows] @ vt[:, keys].transpose(1, 2)
            x = qr[:, rows] @ gwin[:, r0:r0 + xw].transpose(1, 2)
            assert int((15 - qr_ + kl).max()) < xw
            bd[:, rows, keys] = x[:, qr_, 15 - qr_ + kl]
    p = torch.where(vis, torch.exp((s + bd) * scale - lse[..., None]), torch.zeros(()))
    ds = p * (dp - dl[..., None]) * scale
    return p.to(dtype).float(), ds.to(dtype).float()


def k2_tiles(rw, rr, k, v, g, out, d_out, lse, mem_valid, *, M, scale, window):
    """The schedule of the bf16 K2 kernels in torch -> (drw, drr, dk, dv, dG)
    as `flash_rel_attn_bwd_plain` returns them."""
    BN, T, H = rw.shape
    S, N = k.shape[1], g.shape[0]
    dtype = rw.dtype
    Tp, Sp = -(-T // BQ) * BQ, -(-S // BK) * BK
    f = lambda x, n: _pad(x.float(), n)
    qw, qr, do = f(rw, Tp), f(rr, Tp), f(d_out, Tp)
    kk, vv = f(k, Sp), f(v, Sp)
    gb = g.float()[torch.arange(BN) % N]                               # [BN, T+S, H]
    lse_p = torch.zeros(BN, Tp)
    lse_p[:, :T] = lse
    dl_p = torch.zeros(BN, Tp)
    dl_p[:, :T] = (d_out.float() * out.float()).sum(-1)
    vis = torch.zeros(Tp, Sp, dtype=torch.bool)
    vis[:T, :S] = _key_mask(T, S, M, mem_valid, window, 'cpu')

    def pair(q0, k0):
        gwin = _rows(gb, T - q0 - BQ + k0, GW)
        qs, ks = slice(q0, q0 + BQ), slice(k0, k0 + BK)
        # the kernels' test for a tile pair with every (q, k) visible
        full = (q0 + BQ <= T and k0 + BK <= S and M + q0 - (k0 + BK - 1) >= 0
                and k0 >= M - mem_valid and (window <= 0 or M + q0 + BQ - 1 - k0 < window))
        assert not full or bool(vis[qs, ks].all())
        p, ds = _tile(qw[:, qs], qr[:, qs], do[:, qs], kk[:, ks], vv[:, ks], gwin,
                      lse_p[:, qs], dl_p[:, qs], vis[qs, ks], scale, dtype)
        return gwin, qs, ks, p, ds

    sp, _, hw = _split(H)
    assert hw <= 64                  # a lane holds at most 64 f32 of one accumulator

    # dkdv: one block per key tile over the q tiles that see it; warp (p, c)
    # accumulates key rows 16p.. and columns [hw c, hw c + hw)
    dk, dv = torch.zeros(BN, Sp, H), torch.zeros(BN, Sp, H)
    for k0 in range(0, S, BK):
        k_last = min(k0 + BK, S) - 1
        q_lo, q_hi = max(0, k0 - M), T
        if window > 0:
            q_hi = min(q_hi, window + k_last - M)
        if not (k_last >= M - mem_valid and q_lo < q_hi):
            continue
        for q0 in range(q_lo // BQ * BQ, q_hi, BQ):
            _, qs, ks, p, ds = pair(q0, k0)
            for g in range(NG):
                kr = slice(k0 + 16 * g, k0 + 16 * g + 16)
                for c in range(sp):
                    cols = slice(hw * c, hw * c + hw)
                    pt = p[:, :, 16 * g:16 * g + 16].transpose(1, 2)
                    dst = ds[:, :, 16 * g:16 * g + 16].transpose(1, 2)
                    dv[:, kr, cols] += pt @ do[:, qs, cols]
                    dk[:, kr, cols] += dst @ qw[:, qs, cols]

    # dq: one block per q tile over K1's key tiles, dG in two swapping halves
    drw, drr = torch.zeros(BN, Tp, H), torch.zeros(BN, Tp, H)
    dg = torch.zeros(BN, T + S, H)

    def flush(acc, u0):
        u = torch.arange(u0, u0 + 64)
        ok = (u >= 0) & (u < T + S)
        dg[:, u[ok]] += acc[:, ok]

    qi = torch.arange(BQ)[:, None]
    ki = torch.arange(BK)[None, :]
    for q0 in range(0, T, BQ):
        q_last = min(q0 + BQ, T) - 1
        k_hi = min(S, M + q_last + 1)
        k_lo = max(0, M - mem_valid)
        if window > 0:
            k_lo = max(k_lo, M + q0 - window + 1)
        acc = [torch.zeros(BN, 64, H), torch.zeros(BN, 64, H)]   # group pairs 0-1, 2-3
        tiles = list(range(k_lo // BK, -(-k_hi // BK)))
        for it, kt in enumerate(tiles):
            k0 = kt * BK
            u_lo = T - q0 - BQ + k0
            gwin, qs, ks, _, ds = pair(q0, k0)
            dsk = torch.zeros(BN, BQ, GW)
            dsk[:, qi, 63 - qi + ki] = ds
            assert not dsk[:, :, 127].any()
            for g in range(NG):
                band = slice(48 - 16 * g, 128 - 16 * g)
                rows = slice(16 * g, 16 * g + 16)
                out_rows = slice(q0 + 16 * g, q0 + 16 * g + 16)
                assert not dsk[:, rows][:, :, _outside(band)].any()   # the group's band
                for c in range(sp):
                    cols = slice(hw * c, hw * c + hw)
                    # drw from the group's dS rows (all 64 keys), drr over its band
                    drw[:, out_rows, cols] += ds[:, rows] @ kk[:, ks, cols]
                    drr[:, out_rows, cols] += dsk[:, rows, band] @ gwin[:, band, cols]
            for c in range(sp):
                cols = slice(hw * c, hw * c + hw)
                window_dg = dsk.transpose(1, 2) @ qr[:, qs, cols]     # [BN, 128, hw]
                for pr in range(2):
                    half = (pr ^ it) & 1
                    acc[pr][..., cols] += window_dg[:, 64 * half:64 * half + 64]
            for pr in range(2):
                if (pr ^ it) & 1 == 0:
                    flush(acc[pr], u_lo)
                    acc[pr] = torch.zeros(BN, 64, H)
        if tiles:
            it = len(tiles) - 1
            u_lo = T - q0 - BQ + tiles[-1] * BK
            for pr in range(2):
                if (pr ^ it) & 1:
                    flush(acc[pr], u_lo + 64)
    dg = dg.reshape(BN // N, N, T + S, H).sum(0)
    return drw[:, :T].to(dtype), drr[:, :T].to(dtype), dk[:, :S], dv[:, :S], dg


def _outside(band):
    return torch.cat([torch.arange(0, band.start), torch.arange(band.stop, GW)])


def _inputs(H, T, M, clamp, seed, B=2, N=3):
    g = torch.Generator().manual_seed(seed)
    S = M + T
    mk = lambda *s: torch.randn(*s, generator=g)
    Wr = mk(8 * H, N, H) * 0.05
    return (mk(B * N, T, H), mk(B * N, T, H), mk(B * N, S, H), mk(B * N, S, H),
            distance_table(Wr, T, S, M, clamp, torch.float32), mk(B * N, T, H))


@pytest.mark.parametrize('H,T,M,mv,window,clamp', [
    (16, 77, 0, 0, 0, 1024), (32, 333, 0, 0, 0, 17), (64, 77, 30, 30, 0, 17),
    (16, 333, 64, 17, 40, 1024), (32, 200, 100, 37, 150, 17), (64, 333, 128, 50, 200, 1024),
])
def test_tile_schedule_matches_plain_backward(H, T, M, mv, window, clamp):
    """Every output of the emulated schedule equals the plain backward, f32,
    to 1e-5 of the output's largest entry (sums in another order)."""
    rw, rr, k, v, g, d_out = _inputs(H, T, M, clamp, seed=H + T + M)
    scale = H ** -0.5
    out, lse = flash_rel_attn_fwd_plain(rw, rr, k, v, g, mv, M=M, scale=scale, window=window)
    args = (rw, rr, k, v, g, out, d_out, lse, mv)
    got = k2_tiles(*args, M=M, scale=scale, window=window)
    want = flash_rel_attn_bwd_plain(*args, M=M, scale=scale, window=window)
    for name, a, b in zip(('drw', 'drr', 'dk', 'dv', 'dG'), got, want):
        assert a.shape == b.shape, name
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= 1e-5, (name, err)


# the largest error over each output's largest entry: f32 sums in another
# order; in 16 bits a p or ds that lies within an ulp of a rounding boundary
# may round the other way (one ulp of one term: 2^-8 bf16, 2^-11 f16)
TOL_TILES = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 5e-3}


@pytest.mark.parametrize('H,T,M,mv,window,clamp,dtype', [
    (128, 77, 0, 0, 0, 1024, torch.float32), (128, 333, 64, 17, 40, 1024, torch.float32),
    (128, 200, 100, 37, 150, 17, torch.float32), (128, 150, 0, 0, 0, 1024, torch.bfloat16),
    (128, 200, 100, 37, 150, 17, torch.float16), (64, 333, 128, 50, 200, 1024, torch.float16),
    (16, 77, 30, 30, 0, 17, torch.float16), (32, 333, 0, 0, 0, 17, torch.bfloat16),
])
def test_tile_schedule_at_h128_and_in_16_bits_matches_plain_backward(H, T, M, mv, window, clamp,
                                                                    dtype):
    """The two-warp groups of head dim 128 and the rounding of p and ds to
    bf16 / f16: every output of the emulated schedule against the plain
    backward on the same inputs (`TOL_TILES`)."""
    ins = [x.to(dtype) for x in _inputs(H, T, M, clamp, seed=2 * H + T + M)]
    rw, rr, k, v, g, d_out = ins
    scale = H ** -0.5
    out, lse = flash_rel_attn_fwd_plain(rw, rr, k, v, g, mv, M=M, scale=scale, window=window)
    args = (rw, rr, k, v, g, out, d_out, lse, mv)
    got = k2_tiles(*args, M=M, scale=scale, window=window)
    want = flash_rel_attn_bwd_plain(*args, M=M, scale=scale, window=window)
    for name, a, b in zip(('drw', 'drr', 'dk', 'dv', 'dG'), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        err = float((a.float() - b.float()).abs().max() / b.float().abs().max())
        assert err <= TOL_TILES[dtype], (name, err)


@pytest.mark.parametrize('T,M,mv,window', [(77, 0, 0, 0), (333, 64, 17, 40), (1024, 512, 300, 512)])
def test_dg_halves_flush_every_window_row_once(T, M, mv, window):
    """Over one q tile's key tiles, the flushed 64-row halves of the sliding
    dG windows are disjoint and cover every row of every window."""
    S = M + T
    for q0 in range(0, T, BQ):
        q_last = min(q0 + BQ, T) - 1
        k_hi = min(S, M + q_last + 1)
        k_lo = max(0, M - mv)
        if window > 0:
            k_lo = max(k_lo, M + q0 - window + 1)
        tiles = list(range(k_lo // BK, -(-k_hi // BK)))
        flushed, seen = [], set()
        for it, kt in enumerate(tiles):
            u_lo = T - q0 - BQ + kt * BK
            seen.update(range(u_lo, u_lo + GW))
            flushed.extend(range(u_lo, u_lo + 64))          # the half that is final
        u_last = T - q0 - BQ + tiles[-1] * BK
        flushed.extend(range(u_last + 64, u_last + GW))     # the carried half, at the end
        assert len(flushed) == len(set(flushed)) and set(flushed) == seen


@pytest.mark.parametrize('kernel', ['dq', 'dkdv'])
@pytest.mark.parametrize('steps', [1, 2, 3, 7])
def test_g_ring_holds_each_window(kernel, steps):
    """The three 64-row slabs of the distance-table ring: at each step the
    two slabs of the window hold its rows, and the slab the next step loads
    into is neither of them (the dq kernel's windows slide up 64 rows per key
    tile, the dkdv kernel's down 64 per q tile)."""
    up = kernel == 'dq'
    slab = (lambda s, it: (it + s) % 3) if up else (lambda s, it: ((s - it) % 3 + 3) % 3)
    ring = [None] * 3                                   # first window row each slot holds
    u0 = 1000
    for it in range(steps):
        u_lo = u0 + 64 * it if up else u0 - 64 * it
        if it == 0:                                     # the first load fills both slabs
            ring[slab(0, 0)], ring[slab(1, 0)] = u_lo, u_lo + 64
        assert ring[slab(0, it)] == u_lo and ring[slab(1, it)] == u_lo + 64
        nxt = 1 if up else 0                            # the slab the next step loads
        new = slab(nxt, it + 1)
        assert new not in (slab(0, it), slab(1, it))
        ring[new] = (u_lo + 64) + 64 * nxt if up else u_lo - 64


# ----------------------------- head dims above 128 and every f32 call: the slab kernels
SP = 2              # warps per 16-row group of the slab kernels
KW = BK // SP       # keys of a warp's S / dP
XW = KW + 16        # BD window columns a warp reads


def slab_config(H, dtype):
    """(slab width W, output slabs per block ZS) of k2_dkdv_slab / k2_dq_slab
    at head dim H, read from the C entry's `with_cfg`."""
    return with_cfg('flash_rel_attn_bwd', H, dtype == torch.float32)


def slab_items(ns, z0, nz):
    """A block's items per tile pair: ('score', i) for the ns slabs in order,
    then ('out', z) for its output slabs [z0, z0 + nz) but the head dim's
    last, which the last score item's tiles serve in place."""
    last_in = z0 + nz == ns
    return ([('score', i) for i in range(ns)]
            + [('out', z) for z in range(z0, z0 + nz) if not (last_in and z == ns - 1)])


def _slab_tile(qw, qr, do, kt, vt, gwin, lse, dl, vis, scale, dtype, W, items):
    """p and ds [BN, 64, 64] of one tile pair from one score pass, the score
    items of `items` (a block's `slab_items`) in order: S, dP and each
    warp's X = Qr[16p..] . Gwin[48 - 16p + 32c, + 48)^T summed over the
    W-wide slabs (X's first slab stored, the rest added, in the warp's f32
    staging), BD read from X at column 15 - qr + kl."""
    BN, H = qw.shape[0], qw.shape[-1]
    s, dp, bd = torch.zeros(BN, BQ, BK), torch.zeros(BN, BQ, BK), torch.zeros(BN, BQ, BK)
    xs = torch.zeros(BN, NG, SP, 16, XW)
    for hs in (i for kind, i in items if kind == 'score'):
        cs = slice(W * hs, W * hs + W)
        for g in range(NG):
            rows = slice(16 * g, 16 * g + 16)
            for c in range(SP):
                keys, r0 = slice(KW * c, KW * c + KW), 48 - 16 * g + KW * c
                s[:, rows, keys] += qw[:, rows, cs] @ kt[:, keys, cs].transpose(1, 2)
                dp[:, rows, keys] += do[:, rows, cs] @ vt[:, keys, cs].transpose(1, 2)
                xs[:, g, c] += qr[:, rows, cs] @ gwin[:, r0:r0 + XW, cs].transpose(1, 2)
    qr_, kl = torch.arange(16)[:, None], torch.arange(KW)[None, :]
    for g in range(NG):
        for c in range(SP):
            bd[:, 16 * g:16 * g + 16, KW * c:KW * c + KW] = xs[:, g, c][:, qr_, 15 - qr_ + kl]
    p = torch.where(vis, torch.exp((s + bd) * scale - lse[..., None]), torch.zeros(()))
    ds = p * (dp - dl[..., None]) * scale
    return p.to(dtype).float(), ds.to(dtype).float()


def k2_slab_tiles(rw, rr, k, v, g, out, d_out, lse, mem_valid, *, M, scale, window):
    """The schedule of `k2_dkdv_slab` / `k2_dq_slab` in torch -> (drw, drr,
    dk, dv, dG).  A block owns a group of ZS output slabs; per tile pair it
    runs its `slab_items`: the score items make one score pass
    (`_slab_tile`), then the last score item's slab (when the block has it)
    and each output item's slab z take dv += P^T dO[:, z], dk += dS^T Qw[:,
    z] (dkdv), or drw += dS K[:, z], drr += dSskew Gwin[:, z] over each
    group's band and, by the window's 16-row blocks (one per warp),
    dSskew^T Qr[:, z] over the q blocks of its diagonal band into dG's rows
    u_lo + r (dq)."""
    BN, T, H = rw.shape
    S, N = k.shape[1], g.shape[0]
    dtype = rw.dtype
    W, ZS = slab_config(H, dtype)
    ns = H // W
    K8 = 8 if dtype == torch.float32 else 16          # the product's k-block depth
    Tp, Sp = -(-T // BQ) * BQ, -(-S // BK) * BK
    f = lambda x, n: _pad(x.float(), n)
    qw, qr, do = f(rw, Tp), f(rr, Tp), f(d_out, Tp)
    kk, vv = f(k, Sp), f(v, Sp)
    gb = g.float()[torch.arange(BN) % N]
    lse_p, dl_p = torch.zeros(BN, Tp), torch.zeros(BN, Tp)
    lse_p[:, :T] = lse
    dl_p[:, :T] = (d_out.float() * out.float()).sum(-1)
    vis = torch.zeros(Tp, Sp, dtype=torch.bool)
    vis[:T, :S] = _key_mask(T, S, M, mem_valid, window, 'cpu')

    def pair(q0, k0, items):
        gwin = _rows(gb, T - q0 - BQ + k0, GW)
        qs, ks = slice(q0, q0 + BQ), slice(k0, k0 + BK)
        p, ds = _slab_tile(qw[:, qs], qr[:, qs], do[:, qs], kk[:, ks], vv[:, ks], gwin,
                           lse_p[:, qs], dl_p[:, qs], vis[qs, ks], scale, dtype, W, items)
        return gwin, qs, ks, p, ds

    def applied(items, nz):
        """The output slabs a block's items apply, in order: the last score
        item's (when the block has it), then each output item's."""
        outs = [i for kind, i in items if kind == 'out']
        last = [ns - 1] if len(outs) < nz else []
        return [slice(W * z, W * z + W) for z in last + outs]

    dk, dv = torch.zeros(BN, Sp, H), torch.zeros(BN, Sp, H)
    drw, drr = torch.zeros(BN, Tp, H), torch.zeros(BN, Tp, H)
    dg = torch.zeros(BN, T + S, H)
    qi, ki = torch.arange(BQ)[:, None], torch.arange(BK)[None, :]
    for z0 in range(0, ns, ZS):
        nz = min(ZS, ns - z0)
        items = slab_items(ns, z0, nz)
        zs = applied(items, nz)
        for k0 in range(0, S, BK):                  # dkdv
            k_last = min(k0 + BK, S) - 1
            q_lo, q_hi = max(0, k0 - M), T
            if window > 0:
                q_hi = min(q_hi, window + k_last - M)
            if not (k_last >= M - mem_valid and q_lo < q_hi):
                continue
            for q0 in range(q_lo // BQ * BQ, q_hi, BQ):
                _, qs, ks, p, ds = pair(q0, k0, items)
                pt, dst = p.transpose(1, 2), ds.transpose(1, 2)    # staged transposed
                for zc in zs:
                    dv[:, ks, zc] += pt @ do[:, qs, zc]
                    dk[:, ks, zc] += dst @ qw[:, qs, zc]
        for q0 in range(0, T, BQ):                  # dq
            q_last = min(q0 + BQ, T) - 1
            k_hi, k_lo = min(S, M + q_last + 1), max(0, M - mem_valid)
            if window > 0:
                k_lo = max(k_lo, M + q0 - window + 1)
            for kt in range(k_lo // BK, -(-k_hi // BK)):
                k0, u_lo = kt * BK, T - q0 - BQ + kt * BK
                gwin, qs, ks, _, ds = pair(q0, k0, items)
                dsk = torch.zeros(BN, BQ, GW)
                dsk[:, qi, 63 - qi + ki] = ds
                for zc in zs:
                    drw[:, qs, zc] += ds @ kk[:, ks, zc]
                    for gr in range(NG):
                        band = slice(48 - 16 * gr, 128 - 16 * gr)
                        rows = slice(16 * gr, 16 * gr + 16)
                        assert not dsk[:, rows][:, :, _outside(band)].any()
                        drr[:, q0 + 16 * gr:q0 + 16 * gr + 16, zc] += \
                            dsk[:, rows, band] @ gwin[:, band, zc]
                    for r0 in range(0, GW, 16):     # warp r0 / 16's window rows
                        blk = torch.zeros(BN, 16, W)
                        for kq in range(BQ // K8):  # the q blocks of the diagonal band
                            if K8 * kq > 126 - r0 or K8 * kq + K8 - 1 < 48 - r0:
                                assert not dsk[:, K8 * kq:K8 * kq + K8, r0:r0 + 16].any()
                                continue
                            qb = slice(K8 * kq, K8 * kq + K8)
                            blk += dsk[:, qb, r0:r0 + 16].transpose(1, 2) @ \
                                qr[:, q0 + K8 * kq:q0 + K8 * kq + K8, zc]
                        u = torch.arange(u_lo + r0, u_lo + r0 + 16)
                        ok = (u >= 0) & (u < T + S)
                        dg[:, u[ok], zc] += blk[:, ok]
    dg = dg.reshape(BN // N, N, T + S, H).sum(0)
    return drw[:, :T].to(dtype), drr[:, :T].to(dtype), dk[:, :S], dv[:, :S], dg


@pytest.mark.parametrize('H,T,M,mv,window,clamp,dtype', [
    (256, 77, 0, 0, 0, 1024, torch.float32), (256, 200, 100, 37, 150, 17, torch.float32),
    (384, 130, 64, 17, 40, 1024, torch.float32), (128, 140, 30, 30, 0, 17, torch.float32),
    (32, 100, 64, 17, 40, 1024, torch.float32), (256, 150, 64, 17, 40, 1024, torch.bfloat16),
    (64, 150, 64, 17, 40, 96, torch.float32), (16, 90, 0, 0, 0, 1024, torch.float32),
    (384, 100, 0, 0, 0, 1024, torch.float16),
])
def test_slab_schedule_matches_plain_backward(H, T, M, mv, window, clamp, dtype):
    """The slab kernels' schedule (every f32 head dim, and 16 bits above 128):
    one score pass per tile pair, its P / dS (or dS / dSskew) applied to
    each output slab; every output against the plain backward at
    `TOL_TILES`."""
    ins = [x.to(dtype) for x in _inputs(H, T, M, clamp, seed=3 * H + T + M, B=1, N=2)]
    rw, rr, k, v, g, d_out = ins
    scale = H ** -0.5
    out, lse = flash_rel_attn_fwd_plain(rw, rr, k, v, g, mv, M=M, scale=scale, window=window)
    args = (rw, rr, k, v, g, out, d_out, lse, mv)
    got = k2_slab_tiles(*args, M=M, scale=scale, window=window)
    want = flash_rel_attn_bwd_plain(*args, M=M, scale=scale, window=window)
    for name, a, b in zip(('drw', 'drr', 'dk', 'dv', 'dG'), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        err = float((a.float() - b.float()).abs().max() / b.float().abs().max())
        assert err <= TOL_TILES[dtype], (name, err)


@pytest.mark.parametrize('H,dtype', [(16, torch.float32), (64, torch.float32),
                                     (128, torch.float32), (256, torch.float32),
                                     (384, torch.float32), (256, torch.bfloat16),
                                     (384, torch.bfloat16)])
def test_slab_items_score_once_and_apply_each_output_slab_once(H, dtype):
    """Each block's items per tile pair: the head dim's slabs scored once,
    in order, and each of its output slabs applied once, the last in place;
    the blocks of a tile together apply every output slab once, and up to
    256 columns one block scores each tile pair."""
    W, ZS = slab_config(H, dtype)
    ns = H // W
    applied = []
    for z0 in range(0, ns, ZS):
        nz = min(ZS, ns - z0)
        items = slab_items(ns, z0, nz)
        assert [i for kind, i in items if kind == 'score'] == list(range(ns))
        outs = [z for kind, z in items if kind == 'out']
        if z0 + nz == ns:
            outs.append(ns - 1)
        assert sorted(outs) == list(range(z0, z0 + nz))
        applied += outs
    assert sorted(applied) == list(range(ns))
    assert (ns + ZS - 1) // ZS == (1 if H <= 256 else 2)
