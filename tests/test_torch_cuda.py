"""K1 on the card against its plain version (needs an NVIDIA GPU and nvcc).

Run on a GPU machine with `python -m pytest -m cuda tests/test_torch_cuda.py`;
elsewhere these tests skip.  `chip_smoke.py` holds K1 against the plain
version at the model's real shapes."""
import pytest
import torch

from musicnlp_tpu_torch.models.transformer_xl import TransfoXL, TransfoXLConfig
from musicnlp_tpu_torch.ops.flash_attention import (
    LAUNCHES, distance_table, flash_rel_attn_fwd, flash_rel_attn_fwd_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (K1 is a CUDA kernel with no CPU mode)')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _inputs(dev, dtype, BN, N, T, M, H, clamp, seed=0):
    g = torch.Generator(device='cpu').manual_seed(seed)
    S = M + T
    mk = lambda *s: torch.randn(*s, generator=g).to(dev, dtype)
    Wr = torch.randn(8 * H, N, H, generator=g).to(dev) * 0.05
    return (mk(BN, T, H), mk(BN, T, H), mk(BN, S, H), mk(BN, S, H),
            distance_table(Wr, T, S, M, clamp, dtype))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('H,T,M,mv,window,clamp', [
    (64, 128, 0, 0, 0, 1024), (32, 96, 64, 17, 40, 33), (16, 77, 30, 30, 0, 17),
])
def test_k1_matches_plain(dev, dtype, H, T, M, mv, window, clamp):
    rw, rr, k, v, g = _inputs(dev, dtype, 6, 3, T, M, H, clamp)
    mvt = torch.tensor(mv, dtype=torch.int32, device=dev)
    ctx, lse = flash_rel_attn_fwd(rw, rr, k, v, g, mvt, M=M, scale=H ** -0.5, window=window)
    ref, ref_lse = flash_rel_attn_fwd_plain(rw, rr, k, v, g, mv, M=M, scale=H ** -0.5,
                                            window=window)
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == torch.float32 else 2e-2      # bf16 output rounding
    torch.testing.assert_close(ctx.float(), ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)


def test_k1_refuses_gradients(dev):
    rw, rr, k, v, g = _inputs(dev, torch.float32, 2, 2, 16, 0, 16, 64)
    rw.requires_grad_(True)
    with pytest.raises(NotImplementedError):
        flash_rel_attn_fwd(rw, rr, k, v, g, 0, M=0, scale=0.25)


def test_forward_launches_k1_once_per_layer(dev):
    cfg = TransfoXLConfig.from_size('debug', vocab_size=422, dtype='float32')
    model = TransfoXL(cfg)
    params = model.init(seed=0)
    ids = torch.randint(0, 422, (2, 64), device=dev)
    LAUNCHES['flash_rel_attn_fwd'] = 0
    with torch.no_grad():
        model.forward(params, ids)
    assert LAUNCHES['flash_rel_attn_fwd'] == cfg.n_layer
