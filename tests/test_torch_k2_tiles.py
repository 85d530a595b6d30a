"""K2's bf16 tile schedule (`csrc/flash_rel_attn_bwd.cu`, k2_dkdv_tc /
k2_dq_tc) emulated in plain torch and held against `flash_rel_attn_bwd_plain`.

The card kernels cannot run here; this pins their index arithmetic on the
CPU: the 128-row distance-table window Gwin from u_lo = T - q0 - 64 + k0,
each warp's 80 columns [48 - 16w, 128 - 16w) of X = Qr . Gwin^T read at
column 15 - qr + ki, the dSskew scatter dSskew[qi][63 - qi + ki] = ds,
drr = dSskew . Gwin over each warp's band, the dG window dSskew^T . Qr kept
as two 64-row halves that swap roles after each key tile (the finished half
flushed, the other carried), the full-tile test that skips the per-pair
mask, the three-slab ring that holds Gwin, and K1's tile ranges with
memory, mem_valid and a window.  In f32 the emulation must equal the plain
backward to rounding."""
import pytest
import torch

from musicnlp_tpu_torch.ops.flash_attention import (
    _key_mask, distance_table, flash_rel_attn_bwd_plain, flash_rel_attn_fwd_plain,
)

BQ = BK = 64        # q rows / keys per tile
GW = 128            # distance-table rows staged per tile pair
NW = 4              # warps; warp w owns q rows 16w..16w+15


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
    kernels round them; BD from each warp's X columns."""
    s = qw @ kt.transpose(1, 2)
    dp = do @ vt.transpose(1, 2)
    bd = torch.empty_like(s)
    qr_ = torch.arange(16)[:, None]
    ki = torch.arange(BK)[None, :]
    for w in range(NW):
        x = qr[:, 16 * w:16 * w + 16] @ gwin[:, 48 - 16 * w:128 - 16 * w].transpose(1, 2)
        assert x.shape[-1] == 80 and int((15 - qr_ + ki).max()) < 80
        bd[:, 16 * w:16 * w + 16] = x[:, qr_, 15 - qr_ + ki]
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

    # dkdv: one block per key tile over the q tiles that see it
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
            dv[:, ks] += p.transpose(1, 2) @ do[:, qs]
            dk[:, ks] += ds.transpose(1, 2) @ qw[:, qs]

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
        acc = [torch.zeros(BN, 64, H), torch.zeros(BN, 64, H)]   # warp pairs 0-1, 2-3
        tiles = list(range(k_lo // BK, -(-k_hi // BK)))
        for it, kt in enumerate(tiles):
            k0 = kt * BK
            u_lo = T - q0 - BQ + k0
            gwin, qs, ks, _, ds = pair(q0, k0)
            drw[:, qs] += ds @ kk[:, ks]
            dsk = torch.zeros(BN, BQ, GW)
            dsk[:, qi, 63 - qi + ki] = ds
            assert not dsk[:, :, 127].any()
            for w in range(NW):
                band = slice(48 - 16 * w, 128 - 16 * w)
                rows = slice(16 * w, 16 * w + 16)
                assert not dsk[:, rows][:, :, _outside(band)].any()   # the warp's band
                drr[:, q0 + 16 * w:q0 + 16 * w + 16] += dsk[:, rows, band] @ gwin[:, band]
            window_dg = dsk.transpose(1, 2) @ qr[:, qs]                # [BN, 128, H]
            for pr in range(2):
                half = (pr ^ it) & 1
                acc[pr] += window_dg[:, 64 * half:64 * half + 64]
                if half == 0:
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
