"""The Reformer's other LSH decode estimators on the CPU at a small width
(four layers, T 128, chunks of 32, eight buckets, two hash rounds):
'bounded' (per-bucket recency rings) against the JAX package's 'bounded'
step by step and in greedy tokens over two chunks, and against 'scan' where
its rings lose nothing; the streamed 'scan' (`decode_scan_chunk` = L/4)
against the JAX package's streamed scan and against the port's one-pass
scan, with compute-dtype and int8 caches; and beam and contrastive search
over 'bounded' states (expand / select carry the rings and counts) against
the JAX package's tokens."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicnlp_tpu.models.reformer import Reformer as JModel, ReformerConfig as JConfig
from musicnlp_tpu.ops import sampling as jsamp
from musicnlp_tpu.vocab import MusicTokenizer as JTok
from musicnlp_tpu_torch.models.reformer import Reformer, ReformerConfig
from musicnlp_tpu_torch.ops import sampling as tsamp
from tests.test_torch_reformer import CFG, margins  # noqa: F401 (fixture)
from tests.torch_parity import perturb, to_torch

V = JTok(pitch_kind='midi').vocab_size
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)            # f32, other summation orders
# int8: a row scale that rounds a hair differently moves one code; bf16: the
# packages round products to bf16 at other points (test_torch_reformer's)
TOL = {(None, 'float32'): LOGIT_TOL, ('int8', 'float32'): dict(rtol=1e-3, atol=1e-3),
       (None, 'bfloat16'): dict(rtol=0, atol=3e-2), ('int8', 'bfloat16'): dict(rtol=0, atol=3e-2)}
N_STEPS = 80              # two and a half chunks of 32: buckets and streaming both count
WINDOW = 4                # bounded rings of 4: 4 x 8 buckets < 128, so rings drop positions


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny decode steps run faster on one thread, and several test workers
    on one machine would otherwise oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def params():
    jm = JModel(JConfig(vocab_size=V, **CFG))
    jp = perturb(jm.init(jax.random.PRNGKey(0)), 1)
    return jp, to_torch(jp)


def _models(**kw):
    return (JModel(JConfig(vocab_size=V, **dict(CFG, **kw))),
            Reformer(ReformerConfig(vocab_size=V, **dict(CFG, **kw)), device='cpu'))


def _ids(seed, B, n):
    return np.random.default_rng(seed).integers(0, V, (B, n)).astype(np.int32)


def _port_logits(tm, tp, ids):
    st, out = tm.init_decode_state(ids.shape[0]), []
    with torch.no_grad():
        for t in range(ids.shape[1]):
            lg, st = tm.decode_step(tp, torch.from_numpy(ids[:, t]), st)
            out.append(lg.numpy())
    return np.stack(out, 1), st


def _jax_logits(jm, jp, ids):
    st, out, step = jm.init_decode_state(ids.shape[0]), [], jax.jit(jm.decode_step)
    for t in range(ids.shape[1]):
        lg, st = step(jp, jnp.asarray(ids[:, t]), st)
        out.append(np.asarray(lg))
    return np.stack(out, 1), st


def test_bounded_matches_jax(params, margins):  # noqa: F811
    """Teacher-forced logits step by step, and the rings and counts after
    them, == the JAX package's 'bounded' decode."""
    jp, tp = params
    jm, tm = _models(decode_mode='bounded', decode_window=WINDOW)
    ids = _ids(1, 2, N_STEPS)
    got, ts = _port_logits(tm, tp, ids)
    want, js = _jax_logits(jm, jp, ids)
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    assert ts.lsh_ring.shape == (2, 2, CFG['n_head'], 2, 8 * WINDOW)
    np.testing.assert_array_equal(ts.lsh_ring.numpy(), np.asarray(js.lsh_ring))
    np.testing.assert_array_equal(ts.lsh_cnt.numpy(), np.asarray(js.lsh_cnt))
    assert int(ts.lsh_cnt.sum()) == 2 * 2 * CFG['n_head'] * 2 * N_STEPS
    assert margins.smallest() > 0


def test_bounded_greedy_tokens_match_jax(params, margins):  # noqa: F811
    """Greedy generation over two chunks: the same tokens."""
    jp, tp = params
    jm, tm = _models(decode_mode='bounded', decode_window=WINDOW)
    ids, plen = _ids(2, 2, 5), np.array([5, 3])
    kw = dict(max_length=72, eos_id=3, pad_id=0)
    want, wl = jsamp.generate_scan(
        lambda t, s: jm.decode_step(jp, t, s), jm.init_decode_state(2), jnp.asarray(ids),
        jnp.asarray(plen),
        sample_cfg=jsamp.SampleConfig(strategy='greedy'), vocab_size=V,
        rng=jax.random.PRNGKey(0), **kw)
    with torch.no_grad():
        got, gl = tsamp.generate_scan(
            lambda t, s: tm.decode_step(tp, t, s), tm.init_decode_state(2),
            torch.from_numpy(ids).long(), torch.from_numpy(plen).long(),
            sample_cfg=tsamp.SampleConfig(strategy='greedy'), vocab_size=V,
            generator=torch.Generator().manual_seed(0), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    assert margins.smallest() > 0


def largest_bucket(state) -> int:
    """The most positions any (layer, row, head, round) bucket holds in a
    'scan' state's bucket cache."""
    sb = state.lsh_buckets.long()
    nb = int(sb.max()) + 1
    return max(int((sb == b).sum(-1).max()) for b in range(nb))


def test_bounded_equals_scan_when_rings_hold_everything(params):
    """With decode_window at least the largest bucket's occupancy, every
    earlier same-bucket position is still in its ring, so 'bounded' attends
    what 'scan' does."""
    _, tp = params
    _, scan = _models()
    ids = _ids(3, 2, 100)
    a, st = _port_logits(scan, tp, ids)
    window = largest_bucket(st)
    assert window > 100 // 8                   # some bucket holds more than its share
    _, bounded = _models(decode_mode='bounded', decode_window=window)
    b, _ = _port_logits(bounded, tp, ids)
    np.testing.assert_allclose(b, a, **LOGIT_TOL)


@pytest.mark.parametrize('quant,dtype', list(TOL))
def test_streamed_scan(params, margins, quant, dtype):  # noqa: F811
    """decode_scan_chunk = L/4: the port's streamed scan == its one-pass scan
    over two and a half chunks, and == the JAX package's streamed scan (in
    f32 over the same steps; in bf16 over the first LSH chunk, where every
    earlier position is attended whatever its bucket)."""
    jp, tp = params
    kw = dict(decode_cache_quant=quant, dtype=dtype)
    jm, tm = _models(decode_scan_chunk=CFG['max_length'] // 4, **kw)
    _, one_pass = _models(**kw)
    ids = _ids(4, 2, N_STEPS)
    got, st = _port_logits(tm, tp, ids)
    ref, _ = _port_logits(one_pass, tp, ids)
    np.testing.assert_allclose(got, ref, **(LOGIT_TOL if dtype == 'float32' else TOL[quant, dtype]))
    n = N_STEPS if dtype == 'float32' else CFG['lsh_chunk']
    want, _ = _jax_logits(jm, jp, ids[:, :n])
    np.testing.assert_allclose(got[:, :n], want, **TOL[quant, dtype])
    assert (st.lsh_k.dtype == torch.int8) == (quant == 'int8')
    assert dtype != 'float32' or margins.smallest() > 0


@pytest.mark.parametrize('name', ['beam', 'contrastive'])
def test_search_over_bounded_states_matches_jax(params, margins, name):  # noqa: F811
    """Beam search reorders, contrastive search expands and selects the
    decode state: with 'bounded' rings both pick the JAX package's tokens,
    which they cannot unless the rings and counts travel with their rows."""
    jp, tp = params
    jm, tm = _models(decode_mode='bounded', decode_window=WINDOW)
    ids, plen = _ids(5, 2, 5), np.array([5, 3])
    kw = dict(max_length=48, eos_id=3, pad_id=0)
    if name == 'beam':
        want, wl = jsamp.beam_generate(
            lambda t, s: jm.decode_step(jp, t, s), jm.init_decode_state, jnp.asarray(ids),
            jnp.asarray(plen), num_beams=4, reorder_state=jm.reorder_decode_state, **kw)
        with torch.no_grad():
            got, gl = tsamp.beam_generate(
                lambda t, s: tm.decode_step(tp, t, s), tm.init_decode_state,
                torch.from_numpy(ids).long(), torch.from_numpy(plen).long(), num_beams=4,
                reorder_state=tm.reorder_decode_state, **kw)
    else:
        ckw = dict(kw, top_k=4, penalty_alpha=0.6, d_model=tm.hidden_dim)
        want, wl = jsamp.contrastive_generate(
            lambda t, s: jm.decode_step_with_hidden(jp, t, s), jm.init_decode_state(2),
            jnp.asarray(ids), jnp.asarray(plen), expand_state=jm.expand_decode_state,
            select_state=jm.select_decode_state, **ckw)
        with torch.no_grad():
            got, gl = tsamp.contrastive_generate(
                lambda t, s: tm.decode_step_with_hidden(tp, t, s), tm.init_decode_state(2),
                torch.from_numpy(ids).long(), torch.from_numpy(plen).long(),
                expand_state=tm.expand_decode_state, hidden_dtype=tm.cfg.compute_dtype, **ckw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    assert margins.smallest() > 0

    _, st = _port_logits(tm, tp, _ids(6, 3, 40))
    ex = tm.expand_decode_state(st, 2)
    back = tm.select_decode_state(ex, torch.tensor([1, 2, 5]))
    for f in ('lsh_ring', 'lsh_cnt'):
        assert torch.equal(getattr(ex, f), getattr(st, f).repeat_interleave(2, dim=1)), f
        assert torch.equal(getattr(back, f), getattr(st, f)), f
