"""Beam, diverse-beam and contrastive search, port vs JAX at a small width
(f32 on the CPU), for TF-XL and the Reformer: identical tokens on a batch of
two prompts of different lengths, the beams' log-probs, early exit, bf16
and int8 caches, and the decode-state protocol the searches rely on (every
per-row field of both models' states is gathered)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicnlp_tpu.models.reformer import Reformer as JReformer, ReformerConfig as JReformerConfig
from musicnlp_tpu.models.transformer_xl import TransfoXL as JTransfoXL, TransfoXLConfig as JTCfg
from musicnlp_tpu.ops import sampling as jsamp
from musicnlp_tpu.vocab import MusicTokenizer as JTok
from musicnlp_tpu_torch.models.reformer import Reformer, ReformerConfig
from musicnlp_tpu_torch.models.transformer_xl import TransfoXL, TransfoXLConfig
from musicnlp_tpu_torch.ops import sampling as tsamp
from musicnlp_tpu_torch.trainer.eval import MusicGenerator
from musicnlp_tpu_torch.vocab import MusicTokenizer
from tests.test_torch_model import CFG as TFXL_CFG
from tests.test_torch_reformer import CFG as REFORMER_CFG, margins  # noqa: F401 (fixture)
from tests.torch_parity import perturb, to_torch

V = JTok(pitch_kind='midi').vocab_size
MAX_LEN, EOS, PAD = 40, 3, 0
# a sequence's summed f32 log-probs in the two packages (~40 terms of
# log-softmax over 422 tokens, each summed in another order)
LOGP_TOL = dict(rtol=1e-5, atol=1e-5)
STRATEGIES = ['beam', 'diverse', 'contrastive']


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny decode steps run faster on one thread, and several test workers
    on one machine would otherwise oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module', params=['transf-xl', 'reformer'])
def family(request):
    """(name, JAX model, JAX params, port model, port compute params, the
    JAX decode step jitted once)."""
    if request.param == 'transf-xl':
        cfg = dict(TFXL_CFG, dropout=0.0)
        jm, tm = JTransfoXL(JTCfg(vocab_size=V, **cfg)), \
            TransfoXL(TransfoXLConfig(vocab_size=V, **cfg), device='cpu')
    else:
        jm, tm = JReformer(JReformerConfig(vocab_size=V, **REFORMER_CFG)), \
            Reformer(ReformerConfig(vocab_size=V, **REFORMER_CFG), device='cpu')
    jp = perturb(jm.init(jax.random.PRNGKey(0)), 1)
    return request.param, jm, jp, tm, tm.compute_params(to_torch(jp)), jax.jit(jm.decode_step)


def _prompts():
    """Two prompts longer than one token, of different lengths: while the
    shorter one is teacher-forced, its dead beams tie at NEG_INF."""
    ids = np.random.default_rng(3).integers(5, V, (2, 5)).astype(np.int32)
    return ids, np.array([5, 3], np.int32)


def _jax_search(name, jm, jp, ids, plen, **kw):
    kw = dict(max_length=MAX_LEN, eos_id=EOS, pad_id=PAD, **kw)
    ids, plen = jnp.asarray(ids), jnp.asarray(plen)
    if name == 'contrastive':
        return jsamp.contrastive_generate(
            lambda t, s: jm.decode_step_with_hidden(jp, t, s), jm.init_decode_state(2), ids,
            plen, top_k=4, penalty_alpha=0.6, d_model=jm.cfg.d_model,
            expand_state=jm.expand_decode_state, select_state=jm.select_decode_state, **kw)
    step = lambda t, s: jm.decode_step(jp, t, s)
    if name == 'diverse':
        return jsamp.diverse_beam_generate(step, jm.init_decode_state, ids, plen, num_beams=4,
                                           num_beam_groups=2, diversity_penalty=1.0,
                                           reorder_state=jm.reorder_decode_state, **kw)
    return jsamp.beam_generate(step, jm.init_decode_state, ids, plen, num_beams=4,
                               reorder_state=jm.reorder_decode_state, **kw)


def _port_search(name, tm, tp, ids, plen, **kw):
    kw = dict(max_length=MAX_LEN, eos_id=EOS, pad_id=PAD, **kw)
    ids, plen = torch.as_tensor(ids).long(), torch.as_tensor(plen).long()
    if name == 'contrastive':
        return tsamp.contrastive_generate(
            lambda t, s: tm.decode_step_with_hidden(tp, t, s), tm.init_decode_state(2), ids,
            plen, top_k=4, penalty_alpha=0.6, d_model=tm.cfg.d_model,
            expand_state=tm.expand_decode_state, hidden_dtype=tm.cfg.compute_dtype, **kw)
    step = lambda t, s: tm.decode_step(tp, t, s)
    if name == 'diverse':
        return tsamp.diverse_beam_generate(step, tm.init_decode_state, ids, plen, num_beams=4,
                                           num_beam_groups=2, diversity_penalty=1.0,
                                           reorder_state=tm.reorder_decode_state, **kw)
    return tsamp.beam_generate(step, tm.init_decode_state, ids, plen, num_beams=4,
                               reorder_state=tm.reorder_decode_state, **kw)


def _jax_logp(jm, jp, step, ids, plen, out_len):
    """Summed log-probs of each row's generated tokens under the JAX decode."""
    st, tot = jm.init_decode_state(ids.shape[0]), np.zeros(ids.shape[0])
    for t in range(int(out_len.max()) - 1):
        lg, st = step(jp, jnp.asarray(ids[:, t]), st)
        lp = np.asarray(jax.nn.log_softmax(lg, axis=-1))
        for b in range(ids.shape[0]):
            if plen[b] <= t + 1 < out_len[b]:
                tot[b] += lp[b, ids[b, t + 1]]
    return tot


def _port_logp(tm, tp, ids, plen, out_len):
    st, tot = tm.init_decode_state(ids.shape[0]), np.zeros(ids.shape[0])
    for t in range(int(out_len.max()) - 1):
        lg, st = tm.decode_step(tp, torch.as_tensor(ids[:, t]).long(), st)
        lp = torch.log_softmax(lg, dim=-1).numpy()
        for b in range(ids.shape[0]):
            if plen[b] <= t + 1 < out_len[b]:
                tot[b] += lp[b, ids[b, t + 1]]
    return tot


@pytest.mark.parametrize('name', STRATEGIES)
def test_search_tokens_identical_to_jax(family, name, margins):  # noqa: F811
    """Tokens and lengths identical (the port with early exit on, JAX off);
    the chosen beams' log-probs (their scores before the length penalty)
    agree in both packages."""
    fam, jm, jp, tm, tp, jstep = family
    ids, plen = _prompts()
    want, wl = (np.asarray(x) for x in _jax_search(name, jm, jp, ids, plen))
    got, gl = (x.numpy() for x in _port_search(name, tm, tp, ids, plen, early_exit_chunk=8))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gl, wl)
    assert (got[:, :5] == np.where(np.arange(5) < plen[:, None], ids, got[:, :5])).all()
    if name != 'contrastive':
        np.testing.assert_allclose(_port_logp(tm, tp, got, plen, gl),
                                   _jax_logp(jm, jp, jstep, want, plen, wl), **LOGP_TOL)
    # the LSH hashes the port computed were far from a near-tie
    assert fam != 'reformer' or margins.smallest() > 0


@pytest.mark.parametrize('quant,dtype', [(None, 'bfloat16'), ('int8', 'bfloat16')])
@pytest.mark.parametrize('name', STRATEGIES)
def test_search_with_bf16_and_int8_caches_is_deterministic(family, name, quant, dtype):
    """Two port calls with the same arguments give the same tokens, with
    compute-dtype and int8 decode caches."""
    tm = family[3]
    cfg = dataclasses.replace(tm.cfg, dtype=dtype, decode_cache_quant=quant)
    tm = type(tm)(cfg, device='cpu')
    tp = tm.compute_params(tm.init(seed=2))
    ids, plen = _prompts()
    a, al = _port_search(name, tm, tp, ids, plen, early_exit_chunk=8)
    b, bl = _port_search(name, tm, tp, ids, plen)
    assert torch.equal(a, b) and torch.equal(al, bl)
    assert (a[:, :3].numpy() == ids[:, :3]).all() and (al >= 3).all()


def _eos_step(calls):
    """A model that always prefers eos (with a unique runner-up per row)."""
    def step(tok, state):
        calls.append(1)
        lg = torch.arange(tok.shape[0] * V, dtype=torch.float32).reshape(-1, V) % 7 * 0.01
        lg[:, EOS] = 5.0
        return lg, state
    return step


@pytest.mark.parametrize('name', STRATEGIES)
def test_early_exit_stops_and_changes_nothing(name):
    """Every beam freezes on eos: with early exit the loop stops in the
    first chunk after that, and the output equals the full run's."""
    ids, plen = torch.tensor([[7, 8, 9], [9, 10, 0]]), torch.tensor([3, 2])
    outs, n_calls = [], []
    for chunk in (None, 4):
        calls = []
        step = _eos_step(calls)
        kw = dict(max_length=MAX_LEN, eos_id=EOS, pad_id=PAD, early_exit_chunk=chunk)
        if name == 'contrastive':
            out = tsamp.contrastive_generate(
                lambda t, s: (*step(t, s)[:1], torch.ones(t.shape[0], 4), s), None, ids, plen,
                top_k=2, penalty_alpha=0.6, d_model=4, expand_state=lambda s, k: s, **kw)
        elif name == 'diverse':
            out = tsamp.diverse_beam_generate(step, lambda n: None, ids, plen, num_beams=4,
                                              num_beam_groups=2, **kw)
        else:
            out = tsamp.beam_generate(step, lambda n: None, ids, plen, num_beams=4, **kw)
        outs.append(out)
        n_calls.append(len(calls))
    assert n_calls[0] == (MAX_LEN - 1) * (2 if name == 'contrastive' else 1)
    assert n_calls[1] < n_calls[0] // 4
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert outs[0][1].tolist() == [4, 3]


@pytest.mark.parametrize('fam', ['transf-xl', 'reformer'])
def test_contrastive_top1_alpha0_is_greedy(fam):
    """Contrastive search with one candidate and no penalty is greedy, in
    the generator of both families (the JAX package's contract)."""
    tok = MusicTokenizer(pitch_kind='midi', model_max_length=MAX_LEN)
    if fam == 'transf-xl':
        model = TransfoXL(TransfoXLConfig(vocab_size=V, **dict(TFXL_CFG, dropout=0.0)),
                          device='cpu')
    else:
        model = Reformer(ReformerConfig(vocab_size=V, **REFORMER_CFG), device='cpu')
    gen = MusicGenerator(model, tok, model.init(seed=4))
    prompts = [gen.unconditional_prompt(), gen.unconditional_prompt(time_sig=(3, 4), tempo=90)]
    c = gen.generate(prompts, strategy='contrastive', max_length=MAX_LEN, top_k=1,
                     penalty_alpha=0.0)
    assert c == gen.generate(prompts, strategy='greedy', max_length=MAX_LEN)


def _states(tm, tp, B, n):
    """A decode state after n steps of distinct tokens per row."""
    st = tm.init_decode_state(B)
    ids = torch.from_numpy(np.random.default_rng(5).integers(5, V, (B, n)))
    for t in range(n):
        _, st = tm.decode_step(tp, ids[:, t], st)
    return st


# fields that hold no batch axis: what every row shares
SHARED = {'transf-xl': {'cache_pos', 'step', 'pos_tables'}, 'reformer': {'step'}}


@pytest.mark.parametrize('quant', [None, 'int8'])
def test_reorder_gathers_every_per_row_field(family, quant):
    """Reorder, select and expand touch every field with a batch axis (axis
    1) and leave the shared ones as they are; select(expand(s, K), b*K + j)
    is s, which contrastive search relies on; the default reorder of the
    JAX package's searches gathers what the model's own does."""
    fam, _, _, tm, tp, _ = family
    tm = type(tm)(dataclasses.replace(tm.cfg, decode_cache_quant=quant), device='cpu')
    B, idx = 3, torch.tensor([2, 0, 2])
    st = _states(tm, tp, B, 6)
    per_row = [f for f in st._fields if f not in SHARED[fam]]
    assert all(getattr(st, f).shape[1] == B for f in per_row if getattr(st, f) is not None)
    assert {f for f in per_row if getattr(st, f) is None} == (
        set() if quant else ({'k_scale', 'v_scale'} if fam == 'transf-xl'
                             else {'lsh_k_scale', 'lsh_v_scale'}))
    re = tm.reorder_decode_state(st, idx)
    de = tsamp._default_reorder(st, idx, B)
    ex = tm.expand_decode_state(st, 4)
    back = tm.select_decode_state(ex, torch.arange(B) * 4 + torch.tensor([3, 1, 0]))
    for f in st._fields:
        x = getattr(st, f)
        if f in per_row and x is not None:
            assert torch.equal(getattr(re, f), x[:, idx]), f
            assert torch.equal(getattr(de, f), x[:, idx]), f
            assert torch.equal(getattr(ex, f), x.repeat_interleave(4, dim=1)), f
            assert torch.equal(getattr(back, f), x), f
            assert getattr(re, f).data_ptr() != x.data_ptr(), f
        elif isinstance(x, torch.Tensor):
            for other in (re, ex, back):
                assert torch.equal(getattr(other, f), x), f
        else:
            for other in (re, de, ex, back):
                assert getattr(other, f) is x or getattr(other, f) == x, f
    # a step on the reordered state leaves the original untouched
    before = {f: getattr(st, f).clone() for f in per_row if getattr(st, f) is not None}
    tm.decode_step(tp, torch.tensor([7, 8, 9]), re)
    tm.decode_step(tp, torch.arange(12) + 5, ex)
    for f, x in before.items():
        assert torch.equal(getattr(st, f), x), f
