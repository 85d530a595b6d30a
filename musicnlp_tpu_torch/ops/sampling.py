"""Autoregressive decoding: logits warpers and the generate loop.

Counterpart of `musicnlp_tpu/ops/sampling.py` (greedy and sampling; beam,
diverse beam and contrastive search come with a later slice).  The JAX
package runs one `lax.scan`; here the loop is Python over a fixed-shape token
buffer, and the "every sequence finished" check -- the only host sync --
runs once per `early_exit_chunk` steps, so early exit is bit-identical to
running every step.  Draws come from an explicit `torch.Generator`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

__all__ = ['SampleConfig', 'process_logits', 'generate_scan']

NEG_INF = -1e30


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
    n_steps = max_length - 1
    for t in range(n_steps):
        if early_exit_chunk and t and t % early_exit_chunk == 0 and bool(finished.all()):
            break
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

    idx = torch.arange(max_length, device=dev)[None, :]
    is_eos = (buf == eos_id) & (idx >= (prompt_len[:, None] - 1))
    any_eos = is_eos.any(dim=1)
    first_eos = is_eos.int().argmax(dim=1)
    out_len = torch.where(any_eos, first_eos + 1, torch.full_like(first_eos, max_length))
    buf = torch.where(idx < out_len[:, None], buf, torch.full_like(buf, pad_id))
    return buf.to(torch.int32), out_len.to(torch.int32)
