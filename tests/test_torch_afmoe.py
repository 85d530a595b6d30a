"""Trinity's sparse-expert block (`models/afmoe.py`, `ops/moe.py`, the
grouped-query form of K1 / K2) against the plain reference that the
benchmark also uses (`benchmark/reference/afmoe.py`), on the CPU at a tiny
size: d 64, 4 query / 2 key heads of 16, 16 experts of which 4 are held,
top-2, window 8 at T 32.  No JAX: the family has no JAX counterpart."""
import dataclasses

import pytest
import torch

from benchmark.harness.weights import flatten, make_flat, nest
from benchmark.reference import afmoe as ref
from musicnlp_tpu_torch.models.afmoe import AfmoeConfig, AfmoeLM
from musicnlp_tpu_torch.ops import flash_attention as fa
from musicnlp_tpu_torch.ops import moe as moe_ops
from musicnlp_tpu_torch.trainer.eval import score_batch
from musicnlp_tpu_torch.trainer.metrics import IkrMetric
from musicnlp_tpu_torch.trainer.train import TrainArgs, Trainer
from musicnlp_tpu_torch.utils import profiling
from musicnlp_tpu_torch.vocab import MusicTokenizer

LAYERS = ('sliding_attention',) * 3 + ('full_attention',)
TINY = dict(vocab_size=1190, hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
            head_dim=16, intermediate_size=128, moe_intermediate_size=32, num_hidden_layers=4,
            num_dense_layers=1, num_experts=16, n_experts_held=4, expert_offset=4,
            num_experts_per_tok=2, sliding_window=8, max_length=32, layer_types=LAYERS)
B, T = 2, 32


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(dtype='float32', seed=3, **kw):
    cfg = AfmoeConfig(**dict(TINY, dtype=dtype, **kw))
    m = dataclasses.asdict(cfg)
    flat = make_flat('afmoe', m, seed, 'cpu')
    ids = torch.from_numpy(
        __import__('numpy').random.default_rng(seed).integers(4, 1190, (B, T))).long()
    return m, AfmoeLM(cfg, device='cpu'), flat, ids


def _grads(fn, flat):
    leaves = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
    out = fn(leaves)
    return out, torch.autograd.grad(out, list(leaves.values()))


def _loss_of_logits(lg, ids):
    lbl = ids[:, 1:]
    return torch.nn.functional.cross_entropy(lg[:, :-1].reshape(-1, lg.shape[-1]).float(),
                                             lbl.reshape(-1))


def test_logits_loss_and_every_gradient_equal_the_reference_in_f32():
    m, model, flat, ids = _setup()
    with torch.no_grad():
        ours = model.forward(nest(flat), ids)
        theirs = ref.logits(flat, ids, m)
    assert float((ours - theirs).abs().max()) <= 1e-5 * float(theirs.abs().max())
    lo, go = _grads(lambda fl: _loss_of_logits(model.forward(nest(fl), ids), ids), flat)
    lr, gr = _grads(lambda fl: _loss_of_logits(ref.logits(fl, ids, m), ids), flat)
    assert abs(float(lo.detach()) - float(lr.detach())) <= 1e-6 * abs(float(lr.detach()))
    for k, a, b in zip(flat, go, gr):        # f32 round-off, summed in other orders
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()) + 1e-12, k


def test_bf16_stays_within_its_rounding_of_the_f32_reference():
    """bf16 keeps 8 bits of mantissa (2^-9 a rounding); over 4 layers of
    rounded activations a position's logits lie about 1% from the f32
    reference's (1.3% here): the median over positions within 3%, the loss
    within 0.1% (3e-5 here).  A token whose top-k scores lie within a
    rounding of each other may route to another expert, which moves its
    logits by a whole expert's part (up to 37% on some seeds), so no single
    position is bounded.  Gradient norms: the median leaf within 2% (0.4%
    here), the worst within 10% (1.8% here; a flipped token's rows feed
    another expert)."""
    m, model, flat, ids = _setup('bfloat16')
    with torch.no_grad():
        ours = model.forward(nest(flat), ids)
        theirs = ref.logits(flat, ids, m)
    per_position = (ours - theirs).norm(dim=-1) / theirs.norm(dim=-1)
    assert float(per_position.median()) <= 3e-2
    lo, go = _grads(lambda fl: _loss_of_logits(model.forward(nest(fl), ids), ids), flat)
    lr, gr = _grads(lambda fl: _loss_of_logits(ref.logits(fl, ids, m), ids), flat)
    assert abs(float(lo.detach()) - float(lr.detach())) <= 1e-3 * abs(float(lr.detach()))
    gaps = sorted(abs(float(a.norm()) - float(b.norm())) / float(b.norm()) for a, b in zip(go, gr))
    assert gaps[len(gaps) // 2] <= 2e-2 and gaps[-1] <= 0.1, gaps


@pytest.mark.parametrize('window', [8, 0])
def test_gqa_plain_path_is_explicit_masked_attention(window):
    """The grouped-query form's plain path (the CPU side of K1 / K2's GQA
    kernels) against softmax over explicitly repeated key heads, forward
    and backward; dk / dv come out summed over each key head's group."""
    G, H = 4, 16
    g = torch.Generator().manual_seed(window)
    q = torch.randn(2 * 8, T, H, generator=g)
    k, v = (torch.randn(2 * 8 // G, T, H, generator=g) for _ in range(2))
    d = torch.randn(2 * 8, T, H, generator=g)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.GqaAttn.apply(*ins, G, H ** -0.5, window)
    got = torch.autograd.grad(out, ins, d)
    ex = [t.double().requires_grad_(True) for t in (q, k, v)]
    i = torch.arange(T)
    dist = i[:, None] - i[None, :]
    ok = (dist >= 0) & ((dist < window) if window else True)
    s = ex[0] @ ex[1].repeat_interleave(G, 0).transpose(1, 2) * H ** -0.5
    want_out = torch.softmax(s.masked_fill(~ok, float('-inf')), -1) @ ex[2].repeat_interleave(G, 0)
    want = torch.autograd.grad(want_out, ex, d.double())
    assert torch.allclose(out.double(), want_out, atol=1e-5)      # f32 against f64
    for a, b in zip(got, want):
        assert torch.allclose(a.double(), b, atol=1e-5)
    assert got[1].shape == k.shape


def test_routing_chooses_by_biased_scores_and_weighs_without_the_bias():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(5, 8, generator=g)
    w = torch.randn(8, 6, generator=g)
    s = torch.sigmoid(x @ w)
    idx, wt = moe_ops.route(x, w, torch.zeros(6), top_k=2, route_scale=2.5)
    assert torch.equal(idx, s.topk(2, dim=-1).indices)
    chosen = s.gather(-1, idx)
    assert torch.allclose(wt, chosen / (chosen.sum(-1, keepdim=True) + 1e-20) * 2.5)
    bias = torch.zeros(6)
    bias[5] = 10.0                                     # planted: expert 5 always chosen
    idx_b, wt_b = moe_ops.route(x, w, bias, top_k=2, route_scale=2.5)
    assert (idx_b == 5).any(-1).all() and not torch.equal(idx_b, idx)
    chosen_b = s.gather(-1, idx_b)                     # the scores, not score + bias
    assert torch.allclose(wt_b, chosen_b / (chosen_b.sum(-1, keepdim=True) + 1e-20) * 2.5)


def test_the_shares_of_every_chip_add_up_to_the_uncut_layer():
    """Four chips holding 4 experts each: their routed parts, with the
    shared expert (which every chip computes alike) counted once, add up
    to the uncut reference's expert layer over all 16."""
    m = dataclasses.asdict(AfmoeConfig(**dict(TINY, n_experts_held=16, expert_offset=0)))
    flat = make_flat('afmoe', m, 5, 'cpu')
    p = {k[len('layers/1/moe/'):]: v for k, v in flat.items() if k.startswith('layers/1/moe/')}
    x = torch.randn(1, T, m['hidden_size'], generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        whole = ref._moe(p, x, m, 'f32')[0]
        shared = ref._swiglu(p['shared/gate'], p['shared/up'], p['shared/down'], x[0], 'f32')
        total = shared.clone()
        for off in range(0, 16, 4):
            share = {'router': p['router'], 'shared': {k: p[f'shared/{k}'] for k in
                                                       ('gate', 'up', 'down')},
                     'experts': {k: p[f'experts/{k}'][off:off + 4] for k in ('gate', 'up', 'down')}}
            part = moe_ops.moe(share, x[0], torch.zeros(16), top_k=2,
                               route_scale=m['route_scale'], n_held=4, offset=off)
            total += part - shared
    assert float((total - whole).abs().max()) <= 1e-5 * float(whole.abs().max())


def test_expert_rows_in_chunks_give_the_same_layer_and_gradients(monkeypatch):
    """The held experts run CHUNK rows at a time and recompute each chunk
    in the backward: chunks of 7 rows against one chunk, in f32."""
    cfg = AfmoeConfig(**TINY)
    flat = make_flat('afmoe', dataclasses.asdict(cfg), 7, 'cpu')
    pre = 'layers/2/moe/'
    x = torch.randn(B * T, 64, generator=torch.Generator().manual_seed(2))

    def run(chunk):
        monkeypatch.setattr(moe_ops, 'CHUNK', chunk)
        leaves = {k: v.clone().requires_grad_(True) for k, v in flat.items() if k.startswith(pre)}
        xx = x.clone().requires_grad_(True)
        out = moe_ops.moe(nest({k[len(pre):]: v for k, v in leaves.items()}), xx,
                          torch.zeros(16), top_k=2, route_scale=2.826, n_held=4, offset=4)
        grads = torch.autograd.grad((out * out).sum(), [xx, *leaves.values()])
        return out, grads
    out7, g7 = run(7)
    out1, g1 = run(10 ** 9)
    assert torch.allclose(out7, out1, rtol=1e-6, atol=1e-7)
    for a, b in zip(g7, g1):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-7)


def _trainer(model, tmp_path):
    tok = MusicTokenizer(pitch_kind='degree')
    tok.model_max_length = T

    class Rows:
        def __len__(self):
            return 64
    args = TrainArgs(seed=1, batch_size=B, learning_rate=3e-4, weight_decay=0.1,
                     num_train_epochs=2, warmup_ratio=0.1)
    return Trainer(model, tok, Rows(), None, args=args, out_dir=str(tmp_path),
                   ikr_mode='ins-key'), tok


def _batch(ids):
    return dict(input_ids=ids.int(), labels=ids.int(), key_scores=torch.ones(B, 24))


def test_one_train_step_and_one_scored_batch_on_the_cpu(tmp_path):
    m, model, flat, ids = _setup('bfloat16')
    trainer, tok = _trainer(model, tmp_path)
    params = nest({k: v.clone().requires_grad_(True) for k, v in flat.items()})
    state = trainer.opt.init(params)
    state['count'] = torch.tensor(8)                   # past the warmup: a rate above 0
    mets = trainer.train_step(params, state, _batch(ids))
    assert all(torch.isfinite(torch.as_tensor(v)).all() for v in mets.values())
    moved = flatten(params)
    assert all(not torch.equal(moved[k], flat[k]) for k in flat)      # every leaf trained
    scored = score_batch(model, params, ids, ids, IkrMetric(tok, mode='ins-key'),
                         torch.ones(B, 24))
    assert set(scored) >= {'loss', 'ntp_acc', 'ikr'} and torch.isfinite(scored['loss'])


def test_expert_bias_is_state_that_no_step_moves(tmp_path):
    m, model, flat, ids = _setup()
    assert model.expert_bias.shape == (3, 16) and not model.expert_bias.requires_grad
    assert not any('bias' in k for k in flat)          # no trained leaf holds it
    trainer, _ = _trainer(model, tmp_path)
    params = nest({k: v.clone().requires_grad_(True) for k, v in flat.items()})
    state = trainer.opt.init(params)
    state['count'] = torch.tensor(8)
    trainer.train_step(params, state, _batch(ids))
    assert torch.equal(model.expert_bias, torch.zeros(3, 16))
    assert not any(v is model.expert_bias for v in flatten(state).values())


def test_expert_layers_log_their_spans_and_rows_under_the_profiler():
    m, model, flat, ids = _setup()
    profiling.clear_span_log()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad():
            model.forward(nest(flat), ids)
    log = profiling.span_log()
    names = [s['name'] for s in log]
    assert names.count('model.moe') == names.count('model.route') == 3
    assert names.count('model.ffn') == 1 and names.count('model.attn') == 4
    rows = [s for s in log if s['name'] == 'moe_rows']
    moe_ids = {s['id'] for s in log if s['name'] == 'model.moe'}
    assert len(rows) == 3 and all(s['parent'] in moe_ids for s in rows)
    assert all(len(s['value']) == 4 and sum(s['value']) <= B * T * 2 for s in rows)
    profiling.clear_span_log()
    model.forward(nest(flat), ids)                    # no recording: nothing logged
    assert profiling.span_log() == []


def test_config_refuses_what_the_block_does_not_have():
    for bad in (dict(layer_types=LAYERS[:3]), dict(num_key_value_heads=3),
                dict(expert_offset=13), dict(dropout=0.1)):
        with pytest.raises(ValueError):
            AfmoeConfig(**dict(TINY, **bad))
    assert dataclasses.asdict(AfmoeConfig())['num_experts'] == 128
