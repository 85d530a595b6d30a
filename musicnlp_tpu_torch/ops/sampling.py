"""Autoregressive decoding: logits warpers, the generate loop, and beam,
diverse-beam and contrastive search.

Counterpart of `musicnlp_tpu/ops/sampling.py`.  The JAX package runs each
decode as one `lax.scan`; here each loop is Python over a fixed-shape token
buffer, and the "every sequence (or beam) finished" check -- the only host
sync -- runs once per `early_exit_chunk` steps, so early exit gives the same
output as running every step.  Draws come from an explicit
`torch.Generator`.  Top-k selections over search scores take the entries
that `jax.lax.top_k` takes: the largest first and, among equal values, the
lower index first (`_top_k`); frozen and dead beams tie at NEG_INF.

Decode states are updated in place by the step that takes them (the port's
models): a search gathers a state (`reorder_state`) into fresh tensors, and
contrastive search runs its candidates on an expanded copy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

__all__ = ['SampleConfig', 'process_logits', 'generate_scan', 'beam_generate',
           'diverse_beam_generate', 'contrastive_generate']

NEG_INF = -1e30


def _default_reorder(state, idx: torch.Tensor, n: int):
    """Gather a decode state's beam axis by `idx` when no reorder_state was
    given: for each tensor field (a NamedTuple's, or the state itself), gather
    axis 0 if its dim0 == n, else axis 1 if its dim1 == n (TF-XL caches carry
    batch on axis 1, [L, B*W, M, N, H]); other fields pass through unchanged."""
    def go(x):
        if not isinstance(x, torch.Tensor) or x.ndim == 0:
            return x
        if x.shape[0] == n:
            return x[idx]
        if x.ndim > 1 and x.shape[1] == n:
            return x[:, idx]
        return x
    if isinstance(state, tuple) and hasattr(state, '_fields'):
        return type(state)(*(go(x) for x in state))
    return go(state)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of each row, in the order
    `jax.lax.top_k` gives them: descending, equal values by lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _steps(n_steps: int, chunk: Optional[int], all_done: Callable[[], bool]):
    """t = 0 .. n_steps-1, stopping early when `all_done()` holds, asked once
    per `chunk` steps (HF generate's all-sequences-finished rule).  Every
    loop body is a no-op on its token buffer once everything is finished, so
    the output equals the full run."""
    for t in range(n_steps):
        if chunk and t and t % chunk == 0 and all_done():
            return
        yield t


def _finalize(buf: torch.Tensor, plen: torch.Tensor, eos_id: int, pad_id: int,
              max_length: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's length (through its first eos at or after the prompt's
    end, else max_length) and the buffer with pad_id past it."""
    idx = torch.arange(max_length, device=buf.device)[None, :]
    is_eos = (buf == eos_id) & (idx >= (plen[:, None] - 1))
    first_eos = is_eos.int().argmax(dim=1)
    out_len = torch.where(is_eos.any(dim=1), first_eos + 1,
                          torch.full_like(first_eos, max_length))
    return torch.where(idx < out_len[:, None], buf, torch.full_like(buf, pad_id)), out_len


@dataclass(frozen=True)
class SampleConfig:
    strategy: str = 'sample'            # greedy | sample
    temperature: float = 1.0
    top_k: int = 0                      # 0 = off
    top_p: float = 1.0                  # 1 = off
    typical_p: float = 0.0              # 0 = off
    repetition_penalty: float = 1.0     # 1 = off


def _masked(logits: torch.Tensor, drop: torch.Tensor) -> torch.Tensor:
    return torch.where(drop, torch.full_like(logits, NEG_INF), logits)


def _apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return _masked(logits, logits < kth)


def _apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus: keep the smallest set with cumulative mass > p (HF semantics)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < p
    thresh = torch.where(keep_sorted, sorted_logits,
                         torch.full_like(sorted_logits, float('inf'))
                         ).amin(dim=-1, keepdim=True)
    return _masked(logits, logits < thresh)


def _apply_typical(logits: torch.Tensor, mass: float) -> torch.Tensor:
    """Typical decoding: keep tokens whose -log p is closest to the entropy
    until `mass` probability is covered."""
    logp = torch.log_softmax(logits, dim=-1)
    p = torch.exp(logp)
    ent = -(p * torch.where(p > 0, logp, torch.zeros_like(logp))).sum(-1, keepdim=True)
    shift = (-logp - ent).abs()
    order = torch.argsort(shift, dim=-1, stable=True)
    p_sorted = torch.gather(p, -1, order)
    keep_sorted = (torch.cumsum(p_sorted, dim=-1) - p_sorted) < mass
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    return _masked(logits, ~keep)


def process_logits(logits: torch.Tensor, cfg: SampleConfig,
                   token_counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """HF warper order: repetition penalty -> temperature -> top-k -> top-p ->
    typical.  logits f32 [B, V]; token_counts int [B, V] emitted-token counts."""
    if cfg.repetition_penalty != 1.0 and token_counts is not None:
        pen = cfg.repetition_penalty
        penalized = torch.where(logits > 0, logits / pen, logits * pen)
        logits = torch.where(token_counts > 0, penalized, logits)
    if cfg.temperature != 1.0:
        logits = logits / cfg.temperature
    if cfg.top_k:
        logits = _apply_top_k(logits, cfg.top_k)
    if cfg.top_p < 1.0:
        logits = _apply_top_p(logits, cfg.top_p)
    if cfg.typical_p:
        logits = _apply_typical(logits, cfg.typical_p)
    return logits


def _categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(logits), by the Gumbel-max trick."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return (logits + gumbel).argmax(dim=-1)


def generate_scan(
        decode_step: Callable, init_state, prompt_ids: torch.Tensor,
        prompt_len: torch.Tensor, *, max_length: int, eos_id: int, pad_id: int,
        sample_cfg: SampleConfig, vocab_size: int,
        generator: Optional[torch.Generator] = None,
        early_exit_chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the decode loop.

    decode_step: (token_ids [B], state) -> (logits f32 [B, V], state).
    prompt_ids [B, P] left-aligned, padded with pad_id; prompt_len [B] >= 1.
    Returns (ids [B, max_length] incl. prompt, out_len [B]); positions past a
    sequence's end are pad_id.  early_exit_chunk: stop, checking once per
    chunk, when every sequence has emitted eos (bit-identical output)."""
    B, P = prompt_ids.shape
    if P > max_length:
        raise ValueError(f'prompt length {P} > max_length {max_length}')
    dev = prompt_ids.device
    prompt_len = prompt_len.to(dev)
    if sample_cfg.strategy != 'greedy' and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    buf = torch.full((B, max_length), pad_id, dtype=torch.int64, device=dev)
    buf[:, :P] = prompt_ids
    track_counts = sample_cfg.repetition_penalty != 1.0
    counts = torch.zeros(B, vocab_size, dtype=torch.int32, device=dev) if track_counts else None
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    rows = torch.arange(B, device=dev)

    state = init_state
    for t in _steps(max_length - 1, early_exit_chunk, lambda: bool(finished.all())):
        cur = buf[:, t]
        if track_counts:
            counts.index_put_((rows, cur), (~finished).to(torch.int32), accumulate=True)
        logits, state = decode_step(cur, state)
        warped = process_logits(logits, sample_cfg, counts)
        if sample_cfg.strategy == 'greedy':
            nxt = warped.argmax(dim=-1)
        else:
            nxt = _categorical(warped, generator)
        in_prompt = (t + 1) < prompt_len
        nxt_tok = torch.where(in_prompt, buf[:, t + 1], nxt)
        finished = finished | ((cur == eos_id) & ~in_prompt)
        buf[:, t + 1] = torch.where(finished, torch.full_like(nxt_tok, pad_id), nxt_tok)

    buf, out_len = _finalize(buf, prompt_len, eos_id, pad_id, max_length)
    return buf.to(torch.int32), out_len.to(torch.int32)


def _frozen_rows(scores: torch.Tensor, forced: torch.Tensor, V: int) -> torch.Tensor:
    """Candidate scores of a frozen (finished or teacher-forced) beam: its
    forced token at its own score, NEG_INF elsewhere -- by the arithmetic of
    the JAX package (`-inf` would give NaN there)."""
    onehot = torch.nn.functional.one_hot(forced, V).float()
    return scores[..., None] * onehot + NEG_INF * (1 - onehot)


def beam_generate(
        decode_step: Callable, init_state_fn: Callable, prompt_ids: torch.Tensor,
        prompt_len: torch.Tensor, *, max_length: int, eos_id: int, pad_id: int,
        num_beams: int, length_penalty: float = 1.0, reorder_state: Callable = None,
        early_exit_chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search (HF semantics: log-prob beams, eos freezes a beam, length
    penalty at final selection).

    decode_step: (token_ids [B*W], state) -> (logits [B*W, V], state).
    init_state_fn: (batch_size) -> a fresh decode state for that batch size.
    reorder_state: (state, idx [B*W]) -> the state with its batch axis
    gathered by idx; defaults to `_default_reorder`.
    early_exit_chunk: stop, checking once per chunk, when every beam is frozen.
    Returns (ids [B, max_length] of the best beam per batch row, out_len [B])."""
    B, P = prompt_ids.shape
    W = num_beams
    dev = prompt_ids.device
    buf = torch.full((B * W, max_length), pad_id, dtype=torch.int64, device=dev)
    buf[:, :P] = prompt_ids.repeat_interleave(W, dim=0)
    plen = prompt_len.to(dev).repeat_interleave(W, dim=0)
    state = init_state_fn(B * W)
    reorder = reorder_state or (lambda st, idx: _default_reorder(st, idx, B * W))
    # beam 0 active, the others NEG_INF: the first expansion draws W distinct
    # continuations from beam 0
    scores = torch.tensor([0.0] + [NEG_INF] * (W - 1), device=dev).repeat(B)
    finished = torch.zeros(B * W, dtype=torch.bool, device=dev)
    base = torch.arange(B, device=dev)[:, None] * W

    for t in _steps(max_length - 1, early_exit_chunk, lambda: bool(finished.all())):
        logits, state = decode_step(buf[:, t], state)                     # [B*W, V]
        logp = torch.log_softmax(logits.float(), dim=-1)
        V = logp.shape[-1]
        in_prompt = (t + 1) < plen
        # finished or teacher-forced beams contribute one continuation at
        # their unchanged score
        forced = torch.where(finished, torch.full_like(buf[:, t + 1], pad_id), buf[:, t + 1])
        cand = torch.where((finished | in_prompt)[:, None], _frozen_rows(scores, forced, V),
                           scores[:, None] + logp)
        top_scores, top_idx = _top_k(cand.reshape(B, W * V), W)          # [B, W]
        src = (base + top_idx // V).reshape(B * W)
        nxt = (top_idx % V).reshape(B * W)
        buf = buf[src]
        state = reorder(state, src)
        was_finished = finished[src]
        scores = top_scores.reshape(B * W)
        finished = was_finished | ((nxt == eos_id) & ~in_prompt[src])
        buf[:, t + 1] = torch.where(was_finished, torch.full_like(nxt, pad_id), nxt)
    return _best_beam(buf, scores, plen, B, W, eos_id, pad_id, max_length, length_penalty)


def _best_beam(buf, scores, plen, B, W, eos_id, pad_id, max_length, length_penalty):
    """Final selection: the beam with the best length-penalized score per row."""
    buf, out_len = _finalize(buf, plen, eos_id, pad_id, max_length)
    norm = scores / (out_len.float() ** length_penalty)
    sel = torch.arange(B, device=buf.device) * W + norm.reshape(B, W).argmax(dim=1)
    return buf[sel].to(torch.int32), out_len[sel].to(torch.int32)


def diverse_beam_generate(
        decode_step: Callable, init_state_fn: Callable, prompt_ids: torch.Tensor,
        prompt_len: torch.Tensor, *, max_length: int, eos_id: int, pad_id: int,
        num_beams: int, num_beam_groups: int, diversity_penalty: float = 1.0,
        length_penalty: float = 1.0, reorder_state: Callable = None,
        early_exit_chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Diverse (group) beam search (Vijayakumar et al.; HF `num_beam_groups` /
    `diversity_penalty`).  The beams split into G groups expanded one after
    another within each step; group g's candidate log-probs are penalized by
    `diversity_penalty` times the number of earlier groups' beams that chose
    each token this step.  Returns the best beam over all groups per row."""
    B, P = prompt_ids.shape
    W, G = num_beams, num_beam_groups
    if W % G:
        raise ValueError(f'num_beams {W} must divide into num_beam_groups {G}')
    Wg = W // G
    dev = prompt_ids.device
    buf = torch.full((B * W, max_length), pad_id, dtype=torch.int64, device=dev)
    buf[:, :P] = prompt_ids.repeat_interleave(W, dim=0)
    plen = prompt_len.to(dev).repeat_interleave(W, dim=0)
    state = init_state_fn(B * W)
    reorder = reorder_state or (lambda st, idx: _default_reorder(st, idx, B * W))
    # per group: beam 0 active, the rest NEG_INF
    scores = torch.tensor([0.0] + [NEG_INF] * (Wg - 1), device=dev).repeat(G * B)
    finished = torch.zeros(B * W, dtype=torch.bool, device=dev)
    base = torch.arange(B, device=dev)[:, None] * W

    for t in _steps(max_length - 1, early_exit_chunk, lambda: bool(finished.all())):
        logits, state = decode_step(buf[:, t], state)                     # [B*W, V]
        V = logits.shape[-1]
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, G, Wg, V)
        in_prompt = (t + 1) < plen
        forced = torch.where(finished, torch.full_like(buf[:, t + 1], pad_id),
                             buf[:, t + 1]).reshape(B, G, Wg)
        frozen = (finished | in_prompt).reshape(B, G, Wg)
        sc = scores.reshape(B, G, Wg)
        used = torch.zeros(B, V, device=dev)           # earlier groups' picks this step
        new_scores, new_toks, new_src = [], [], []
        for g in range(G):
            cand = sc[:, g, :, None] + logp[:, g] - diversity_penalty * used[:, None, :]
            cand = torch.where(frozen[:, g][:, :, None], _frozen_rows(sc[:, g], forced[:, g], V),
                               cand)
            top_s, top_i = _top_k(cand.reshape(B, Wg * V), Wg)           # [B, Wg]
            src = top_i // V
            tok = top_i % V
            # the diversity penalty biases the selection only: the stored
            # score stays the sequence's log-prob
            frozen_sel = torch.gather(frozen[:, g], 1, src)
            top_s = torch.where(frozen_sel, top_s,
                                top_s + diversity_penalty * torch.gather(used, 1, tok))
            used = used + (torch.nn.functional.one_hot(tok, V).float()
                           * (~frozen_sel)[:, :, None].float()).sum(dim=1)
            new_scores.append(top_s)
            new_toks.append(tok)
            new_src.append(src + g * Wg)
        scores = torch.stack(new_scores, 1).reshape(B * W)
        nxt = torch.stack(new_toks, 1).reshape(B * W)
        src = (base + torch.stack(new_src, 1).reshape(B, W)).reshape(B * W)
        buf = buf[src]
        state = reorder(state, src)
        was_finished = finished[src]
        finished = was_finished | ((nxt == eos_id) & ~in_prompt[src])
        buf[:, t + 1] = torch.where(was_finished, torch.full_like(nxt, pad_id), nxt)
    return _best_beam(buf, scores, plen, B, W, eos_id, pad_id, max_length, length_penalty)


def contrastive_generate(
        step_h: Callable, init_state, prompt_ids: torch.Tensor, prompt_len: torch.Tensor, *,
        max_length: int, eos_id: int, pad_id: int, top_k: int = 4, penalty_alpha: float = 0.6,
        d_model: int, expand_state: Callable, hidden_dtype: torch.dtype = torch.float32,
        early_exit_chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Contrastive search (HF `penalty_alpha` decoding): at each step the
    top-k candidates are re-scored by (1 - a) p(cand) - a max_l cos(h_cand,
    h_l) over the context's hidden states h_l, and the best is kept.

    step_h: (tokens [n], state) -> (logits [n, V], hidden [n, d], state).
    expand_state: (state, k) -> a copy of the state with each batch row
    repeated k times.  The candidates run one step on that copy (which the
    step writes into) and only their hidden states are used.  The JAX
    package then selects row b*K + best of the expanded state as it was
    before the candidate step: each such row is row b of `state`, which no
    candidate step touched, so `state` itself is the selection.
    Returns (ids [B, max_length], out_len [B])."""
    B, P = prompt_ids.shape
    K = top_k
    dev = prompt_ids.device
    prompt_len = prompt_len.to(dev)
    buf = torch.full((B, max_length), pad_id, dtype=torch.int64, device=dev)
    buf[:, :P] = prompt_ids
    ctx_h = torch.zeros(B, max_length, d_model, dtype=hidden_dtype, device=dev)
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    pos = torch.arange(max_length, device=dev)
    state = init_state

    def unit(x):
        return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-6)

    for t in _steps(max_length - 1, early_exit_chunk, lambda: bool(finished.all())):
        cur = buf[:, t]
        logits, h_cur, state = step_h(cur, state)
        ctx_h[:, t] = h_cur.to(hidden_dtype)
        top_p, top_tok = _top_k(torch.softmax(logits.float(), dim=-1), K)       # [B, K]
        _, h_cand, _ = step_h(top_tok.reshape(B * K), expand_state(state, K))
        sim = torch.einsum('bkd,bld->bkl', unit(h_cand.reshape(B, K, -1).float()),
                           unit(ctx_h.float()))
        pen = torch.where(pos <= t, sim, torch.full_like(sim, -1.0)).amax(dim=-1)   # [B, K]
        score = (1 - penalty_alpha) * top_p - penalty_alpha * pen
        nxt = torch.gather(top_tok, 1, score.argmax(dim=-1, keepdim=True))[:, 0]
        in_prompt = (t + 1) < prompt_len
        nxt_tok = torch.where(in_prompt, buf[:, t + 1], nxt)
        finished = finished | ((cur == eos_id) & ~in_prompt)
        buf[:, t + 1] = torch.where(finished, torch.full_like(nxt_tok, pad_id), nxt_tok)

    buf, out_len = _finalize(buf, prompt_len, eos_id, pad_id, max_length)
    return buf.to(torch.int32), out_len.to(torch.int32)
