"""K5's schedule (`csrc/mask_chain.cu`) emulated in plain torch and held
against the plain version `mask_chain_plain` and, once, the Pallas TPU kernel
in interpret mode.

The card kernel cannot run here; this pins its arithmetic on the CPU.  A
quad of lanes owns a row of 128: lane t holds columns 16j + 4t + i (j < 8,
i < 4).  Per pass and element: x = fma(acc, 1e-6 / 8, s0 / 8), the self add
and the mask select; each lane's max and sum as a pairwise tree over its 32
values, then the quad's by two butterfly shuffles (xor 1, then xor 2);
p = exp2((x - max) log2 e), the difference taken before the scale; one
reciprocal of l = max(sum, 1e-30) per row, then p * r; the bf16 round trip
with round-to-nearest-even.  Every entry must lie within one bf16 ulp of the
plain version (|d| <= 2^-7 |want|, so an exact zero stays exact), with the
tool's positions, mixed positions (rows without a self key), and all-masked
rows, which read 1/128 exactly.  The chain that the roofline bound counts,
log2 e folded into the pre-scaled constants, is held to the same check; a
last case shows what the single-FMA exp argument x log2 e - max log2 e does
to the all-masked and the self rows."""
import math

import numpy as np
import pytest
import torch

from musicnlp_tpu_torch.ops.roofline_kernels import W, mask_chain_plain
from tests.test_torch_roofline import C, GRID, M, _chain_inputs, _pallas_chain

QUAD, PER = 4, 32                  # lanes per row, values per lane
FOLD = np.float32(1e-6) * np.float32(0.125)        # exact: 1/8 is a power of two
LOG2E = torch.tensor(math.log2(math.e), dtype=torch.float32)
MASKED = 10 ** 6                   # a key position past every query


# torch on one thread: the suite's xdist workers share the cores, and
# torch's intra-op threads on these many tiny ops slow each file many-fold
@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lane_columns() -> torch.Tensor:
    """[4, 32]: the column of lane t's e-th value (float4 j = e // 4 at
    index 4j + t of the row)."""
    e = torch.arange(PER)
    return 16 * (e // 4)[None] + 4 * torch.arange(QUAD)[:, None] + (e % 4)[None]


def tree(v: torch.Tensor, op) -> torch.Tensor:
    """op over the last dim (32) as the kernel's pairwise tree:
    (v0 op v1), (v2 op v3), ..., then pairs of those."""
    while v.shape[-1] > 1:
        v = op(v[..., 0::2], v[..., 1::2])
    return v[..., 0]


def quad(v: torch.Tensor, op) -> torch.Tensor:
    """[..., 4] lane values -> [...]: the xor-1 then xor-2 butterfly; every
    lane ends with the same bits (op is commutative), lane 0's is returned."""
    v = op(v, v[..., [1, 0, 3, 2]])
    return op(v, v[..., [2, 3, 0, 1]])[..., 0]


def emulate(s, kp, qp, K, single_fma_exp=False, fold_log2e=False):
    """The kernel's K passes -> (acc [G, M, C, 128], the last pass's p before
    normalising, its row max), all in the row's own column order.
    `fold_log2e`: the chain that the bound counts instead, log2 e folded into
    the pre-scaled constants (s0 / 8, the fold constant, 1e4, -1e9), so x is
    in log2 units and p = exp2(x - max) with no multiply."""
    cols = lane_columns()
    lanes = lambda t: t[..., cols]                          # [..., 4, 32]
    scale = LOG2E if fold_log2e else torch.tensor(1.0)
    s0 = lanes(s) * 0.125 * scale
    fold = float(torch.tensor(float(FOLD)) * scale)
    self_add, masked = (torch.tensor(1e4) * scale, torch.tensor(-1e9) * scale)
    kpl = lanes(kp)[:, :, None]                             # [G, M, 1, 4, 32]
    q = qp[..., None, None]
    acc = lanes(s)
    p = mx = None
    for _ in range(K):
        # one FFMA: the f64 product is exact, its sum with s0 is rounded
        # once to f64 and then to f32 (rarely one f32 ulp from the FMA)
        x = (acc.double() * fold + s0.double()).float()
        x = torch.where(kpl == q, x + self_add, x)
        x = torch.where(kpl > q, masked, x)
        mx = quad(tree(x, torch.maximum), torch.maximum)[..., None, None]
        if fold_log2e:            # already in log2 units
            arg = x - mx
        elif single_fma_exp:      # fma(x, log2 e, -(max log2 e)), rounded once
            arg = (x.double() * float(LOG2E) - (mx * LOG2E).double()).float()
        else:                     # (x - max) first, then the scale
            arg = (x - mx) * LOG2E
        p = torch.exp2(arg)
        l = quad(tree(p, torch.add), torch.add).clamp(min=1e-30)
        r = 1.0 / l                                         # one reciprocal per row
        acc = (p * r[..., None, None]).to(torch.bfloat16).float()
    out = torch.empty_like(s)
    out[..., cols] = acc
    p_rows = torch.empty_like(s)
    if p is not None:
        p_rows[..., cols] = p
    return out, p_rows, mx


def _positions(kind, seed):
    s, kp, qp = (torch.from_numpy(a) for a in _chain_inputs(seed))
    if kind in ('mixed', 'masked'):
        kp = (torch.arange(W, dtype=torch.int32) - 40).expand(GRID, M, W).clone()
        kp[:, :, ::5] = MASKED                 # masked keys beside the valid and self ones
    if kind == 'masked':
        kp[:, ::2] = MASKED                    # every key of each even m
    return s, kp, qp


def _within_one_bf16_ulp(got, want):
    return bool(((got - want).abs() <= 2.0 ** -7 * want.abs()).all())


def test_lane_columns_cover_each_column_once():
    cols = lane_columns()
    assert sorted(cols.flatten().tolist()) == list(range(W))
    # lane t's e-th value is element e % 4 of the float4 at index 4 (e // 4) + t
    e = torch.arange(PER)
    assert torch.equal(cols, 4 * (4 * (e // 4)[None] + torch.arange(QUAD)[:, None]) + e % 4)


@pytest.mark.parametrize('kind', ['tool', 'mixed', 'masked'])
@pytest.mark.parametrize('K', [1, 4, 32])
def test_schedule_matches_plain(K, kind):
    s, kp, qp = _positions(kind, seed=K)
    want = mask_chain_plain(s, kp, qp, K)
    got, _, _ = emulate(s, kp, qp, K)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _within_one_bf16_ulp(got, want), float((got - want).abs().max())
    assert torch.equal(got == 0, want == 0)                # zeros stay exact
    print(f'K={K} {kind}: {float((got == want).float().mean()):.4%} of entries bit-equal')
    if kind == 'tool':
        # every row's window holds its self key: the chain ends one-hot
        assert torch.equal(got, want) and float(got.max()) == 1.0


@pytest.mark.parametrize('K', [1, 32])
def test_all_masked_rows_read_one_in_128(K):
    s, kp, qp = _positions('masked', seed=7)
    got, p, mx = emulate(s, kp, qp, K)
    want = mask_chain_plain(s, kp, qp, K)
    assert bool((got[:, ::2] == 1 / W).all()) and bool((want[:, ::2] == 1 / W).all())
    # x - max is 0 for every key: p = exp2(0) = 1, l = 128, r = 2^-7, all exact
    assert bool((p[:, ::2] == 1).all()) and bool((mx[:, ::2] == -1e9).all())


def test_rows_without_a_self_key_spread():
    """The mixed positions mask the self key of every fifth row: those rows
    keep a real softmax over their valid keys, where a bf16 rounding can
    flip; the tolerance holds them."""
    K = 4
    s, kp, qp = _positions('mixed', seed=11)
    no_self = ~(kp[:, :, None, :] == qp[..., None]).any(-1)       # [G, M, C]
    assert 0 < int(no_self.sum()) < no_self.numel()
    want = mask_chain_plain(s, kp, qp, K)
    got, _, _ = emulate(s, kp, qp, K)
    rows_got, rows_want = got[no_self], want[no_self]
    assert _within_one_bf16_ulp(rows_got, rows_want)
    # row c sees the keys j <= c + 40 that are not a multiple of 5: 32 or more
    spread = ((rows_want > 0) & (rows_want < 1)).sum(-1)
    assert int(spread.min()) >= 32, spread
    assert torch.allclose(rows_want.sum(-1), torch.ones(rows_want.shape[0]), atol=0.05)


def test_schedule_matches_pallas_interpret():
    """The emulation against the TPU kernel itself (interpret mode) at K 4,
    with the tool's positions and with mixed ones."""
    for kind in ('tool', 'mixed'):
        s, kp, qp = _positions(kind, seed=4)
        want = torch.from_numpy(_pallas_chain(4, s.numpy(), kp.numpy(), qp.numpy()).copy())
        got, _, _ = emulate(s, kp, qp, 4)
        assert _within_one_bf16_ulp(got, want), kind


@pytest.mark.parametrize('kind', ['tool', 'mixed', 'masked'])
@pytest.mark.parametrize('K', [4, 32])
def test_log2e_folded_into_the_constants_matches_plain(K, kind):
    """The chain that `tools/vpu_roofline.OPS` counts (5 FMA-pipe
    instructions per element-pass, not the kernel's 6): with log2 e folded
    into the pre-scaled constants, the difference x - max is still taken
    before any scaling and the chain stays within one bf16 ulp of the plain
    version, all-masked rows at 1/128 exactly.  So one FMUL per element is
    no part of the least work."""
    s, kp, qp = _positions(kind, seed=20 + K)
    want = mask_chain_plain(s, kp, qp, K)
    got, p, _ = emulate(s, kp, qp, K, fold_log2e=True)
    assert _within_one_bf16_ulp(got, want), float((got - want).abs().max())
    assert torch.equal(got == 0, want == 0)
    if kind == 'masked':
        assert bool((got[:, ::2] == 1 / W).all()) and bool((p[:, ::2] == 1).all())


def test_single_fma_exp_argument_breaks_p_in_masked_and_self_rows():
    """x log2 e - (max log2 e) as one FMA is not 0 at x = max when |max| is
    large: in an all-masked row max = -1e9, and the rounding of -1e9 log2 e
    (f32 steps of 128 there) leaves p = 2^e != 1 for every key; a self row
    (max ~ 1e4, steps of 2^-10) is off by up to 2^-11 in the exponent.  The
    kernel's order (the difference first, then the scale) gives p = 1 there.
    acc = p / l does not show the fault: the error is the same for every key
    of the row and cancels (and a log-sum-exp near -1e9 has f32 steps of 64),
    so this test on p, and not the card's check on acc, guards the order."""
    s, kp, qp = _positions('masked', seed=3)
    acc, p, _ = emulate(s, kp, qp, 1)
    acc_fma, p_fma, _ = emulate(s, kp, qp, 1, single_fma_exp=True)
    e = float(np.float64(np.float32(-1e9)) * float(LOG2E)
              - np.float64(np.float32(-1e9) * np.float32(LOG2E)))
    assert 1 <= abs(e) <= 64
    assert bool((p_fma[:, ::2] == torch.exp2(torch.tensor(e, dtype=torch.float32))).all())
    assert bool((p[:, ::2] == 1).all())
    self_rows = (kp[:, 1::2, None, :] == qp[:, 1::2, :, None]).any(-1)
    p_self, p_self_fma = p[:, 1::2].amax(-1)[self_rows], p_fma[:, 1::2].amax(-1)[self_rows]
    assert bool((p_self == 1).all()) and bool((p_self_fma != 1).any())
    assert float((p_self_fma.log2()).abs().max()) <= 2.0 ** -11
    assert torch.equal(acc_fma[:, ::2], acc[:, ::2])                 # cancels in acc
