"""Transformer-XL music LM in PyTorch.

Counterpart of `musicnlp_tpu/models/transformer_xl.py`: the same size presets,
a tied embedding with a dense softmax head (or the HF-compatible adaptive
head, `adaptive_cutoffs`), relative-position attention with a fixed-shape
right-aligned memory, a loss with NTP accuracy (over dense logits, tiled over
the vocab with `head_chunk`, or segment by segment with carried memory), and
an exact KV ring-cache decode step (bf16 or int8 caches).

Parameters are a nested dict of float32 tensors in the JAX package's layouts
(`utils/checkpoint.params_from_jax` carries JAX parameters in).  An
attention layer of `forward` runs through kernels K1 (forward) and K2
(backward) of `ops/flash_attention.py` (on CPU tensors, their plain
versions).  Like the TPU kernels, they have no key-padding mask and no
attention-probability dropout, so a forward with `attn_mask` or with
`dropatt > 0` runs every layer through the plain `ops/attention.rel_attn`,
as the JAX model does.  Every other forward launches K1 / K2, in f32, bf16
or f16, at any head dim up to 128 (`fused_rel_attn` zero-pads one outside
16 / 32 / 64 / 128; a wider head raises on the card).  With `remat_attn`
each layer's fused attention is recomputed in the backward
(`ops/layers.remat`).  Dropout draws come from an explicit
`torch.Generator`.  HF `TransfoXLLMHeadModel` checkpoints come in
through `utils/hf_import.from_hf_transfo_xl` (the adaptive head, HF's
`same_length` window as `attn_window`).

Training on a device mesh (`parallel/mesh.py`, `TransfoXL(cfg, mesh=...)`
or the mesh a `Trainer` attaches): each rank computes with its own heads and
FFN columns (Megatron tensor parallelism over `model`, the parameters'
blocks from `mesh.shard_pytree`), on its own rows of the batch, and `loss`
returns the global batch's loss and metrics.  `shard_vocab` row-shards the
tied table and its bias over `model` (`ops/sharded_head.py`).  Decode and
generation are mesh-free, as in the JAX package.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from musicnlp_tpu_torch import resolve_device
from musicnlp_tpu_torch.ops.attention import (
    decode_pos_table, quantize_kv_rows, rel_attn, rel_attn_decode_step,
)
from musicnlp_tpu_torch.ops.flash_attention import fused_rel_attn
from musicnlp_tpu_torch.ops.layers import Params, dropout, ffn, remat
from musicnlp_tpu_torch.ops.losses import (
    PT_LOSS_PAD, chunked_shifted_ce_loss, ntp_accuracy, shifted_ce_loss,
)
from musicnlp_tpu_torch.ops.sharded_head import vocab_sharded_ce_loss, vocab_sharded_embed
from musicnlp_tpu_torch.parallel.mesh import Mesh, global_loss, global_mean, valid_count
from musicnlp_tpu_torch.utils.checkpoint import params_from_jax
from musicnlp_tpu_torch.utils.profiling import span

__all__ = ['TransfoXLConfig', 'TransfoXL', 'DecodeState']

_DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32, 'float16': torch.float16}


@dataclass(frozen=True)
class TransfoXLConfig:
    """The JAX package's config less the knobs of its TPU execution (flash
    block sizes and use), which change how a result is computed there but
    not the result; `load_trained` drops them.

    shard_vocab: row-shard the tied [V, d] embedding / head and its bias
    over the mesh's `model` axis (`ops/sharded_head.py`), for the 262k
    tier; training only (n_seg 1), and needs a mesh (`TransfoXL(cfg,
    mesh=...)` or the Trainer's).  Not with `adaptive_cutoffs`.

    remat_attn: recompute each layer's fused attention (K1 and the layer's
    projections) in the backward instead of keeping its activations: one
    more K1 launch per layer and step, for less memory; the result is the
    same (`ops/layers.remat` replays the dropout draws).  head_chunk: train through the tiled CE over the tied head in tiles of
    this many vocab rows (`ops/losses.chunked_shifted_ce_loss`), so no
    [B, T, V] logits exist; None = dense logits.  adaptive_cutoffs: the
    HF-compatible adaptive softmax head (cluster factorization), whose
    "logits" are log-probs, for checkpoints trained with it."""
    vocab_size: int = 1190
    model_size: str = 'base'
    d_model: int = 768
    n_head: int = 12
    d_head: int = 64
    d_inner: int = 3072
    n_layer: int = 12
    mem_len: int = 256
    clamp_len: int = 1024
    max_length: int = 2048
    dropout: float = 0.1
    dropatt: float = 0.0
    pre_lnorm: bool = False
    init_std: float = 0.02
    dtype: str = 'bfloat16'
    head_chunk: Optional[int] = None
    adaptive_cutoffs: Optional[Tuple[int, ...]] = None
    decode_cache_quant: Optional[str] = None    # None | 'int8'
    attn_window: Optional[int] = None
    remat_attn: bool = False
    shard_vocab: bool = False

    presets = {
        'debug': dict(d_model=128, n_head=8, n_layer=4),
        'debug-large': dict(d_model=128, n_head=8, n_layer=4),
        'tiny': dict(d_model=256, n_head=8, n_layer=6),
        'small': dict(d_model=512, n_head=8, n_layer=12),
        'base': dict(d_model=768, n_head=12, n_layer=12),
        'large': dict(d_model=1024, n_head=16, n_layer=18),
    }
    size2max_length = {'debug': 64, 'debug-large': 128, 'tiny': 512,
                       'small': 1024, 'base': 2048, 'large': 2048}

    @classmethod
    def from_size(cls, model_size: str, vocab_size: int, max_length: int = None,
                  **kwargs) -> 'TransfoXLConfig':
        p = dict(cls.presets[model_size])
        max_len = max_length or cls.size2max_length[model_size]
        if 'debug' in model_size:
            m_len, c_len = 64, 64
        else:
            m_len = max(128, cls.size2max_length[model_size] // 8)
            c_len = max(1024, cls.size2max_length[model_size] // 2)
        d = p['d_model']
        cfg = dict(
            vocab_size=vocab_size, model_size=model_size, d_model=d,
            n_head=p['n_head'], d_head=d // p['n_head'], d_inner=d * 4,
            n_layer=p['n_layer'], mem_len=m_len, clamp_len=c_len, max_length=max_len,
        )
        cfg.update(kwargs)
        return cls(**cfg)

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


class DecodeState(NamedTuple):
    """Autoregressive decode state.  The caches are updated IN PLACE by
    `decode_step` (one slot per step), so a state is consumed by the step
    that takes it."""
    cache_k: torch.Tensor    # [L, B, M, N, H] compute dtype, or int8
    cache_v: torch.Tensor
    cache_pos: torch.Tensor  # int32 [M] absolute position per slot, -1 empty
    step: int
    k_scale: Optional[torch.Tensor] = None   # [L, B, M, N] f32 for int8 caches
    v_scale: Optional[torch.Tensor] = None
    # per-layer distance tables R_head [C+1, N, H] (params only), built by the
    # first decode step and reused by the later ones
    pos_tables: Optional[Tuple[torch.Tensor, ...]] = None


class TransfoXL:
    """Model namespace over explicit parameters, as in the JAX package."""

    def __init__(self, config: TransfoXLConfig,
                 device: Optional[Union[str, torch.device]] = None, mesh: Optional[Mesh] = None):
        self.cfg = config
        self.device = resolve_device(device)
        # consulted by training only (tensor parallelism, shard_vocab); a
        # Trainer attaches its own when this is None
        self.mesh = mesh

    def _require_mesh(self) -> Mesh:
        if self.mesh is None:
            raise ValueError('shard_vocab=True needs a mesh: pass TransfoXL(cfg, mesh=mesh) or '
                             'set model.mesh before the first forward (a Trainer does this)')
        return self.mesh

    def unread_leaves(self) -> frozenset:
        """Flat keys of the leaves the loss never reads: none."""
        return frozenset()

    # ------------------------------------------------------------------ init
    def init_flat(self, seed: int = 0) -> Dict[str, np.ndarray]:
        """Random parameters made with numpy from `seed`, in the JAX layout
        under flat '/'-joined keys (normal(0, init_std) matrices, zero biases,
        unit layer-norm scales) -- what `params_from_jax` carries in."""
        cfg = self.cfg
        rng = np.random.default_rng(seed)
        D, N, H, F = cfg.d_model, cfg.n_head, cfg.d_head, cfg.d_inner

        def normal(*shape):
            return (rng.standard_normal(shape, dtype=np.float32) * cfg.init_std)

        flat = {'embed/weight': normal(cfg.vocab_size, D),
                'out_bias': np.zeros(cfg.vocab_size, np.float32)}
        if cfg.adaptive_cutoffs:
            n_cl = len(cfg.adaptive_cutoffs)
            flat.update({'adaptive/cluster_w': np.zeros((n_cl, D), np.float32),
                         'adaptive/cluster_b': np.zeros(n_cl, np.float32)})
        for li in range(cfg.n_layer):
            a, f = f'layers/{li}/attn', f'layers/{li}/ffn'
            flat.update({
                f'{a}/qkv': normal(D, 3, N, H), f'{a}/r': normal(D, N, H),
                f'{a}/o': normal(N, H, D),
                f'{a}/r_w_bias': np.zeros((N, H), np.float32),
                f'{a}/r_r_bias': np.zeros((N, H), np.float32),
                f'{a}/ln/scale': np.ones(D, np.float32), f'{a}/ln/bias': np.zeros(D, np.float32),
                f'{f}/w1/w': normal(D, F), f'{f}/w1/b': np.zeros(F, np.float32),
                f'{f}/w2/w': normal(F, D), f'{f}/w2/b': np.zeros(D, np.float32),
                f'{f}/ln/scale': np.ones(D, np.float32), f'{f}/ln/bias': np.zeros(D, np.float32),
            })
        return flat

    def init(self, seed: int = 0) -> Params:
        return params_from_jax(self.init_flat(seed), self.device)

    def compute_params(self, params: Params) -> Params:
        """A view of `params` with the matmul weights cast once to the compute
        dtype (biases and layer norms stay f32).  Every function casts its
        weights itself, so this changes no result -- it saves the per-call
        casts in a decode loop."""
        dt = self.cfg.compute_dtype

        def attn(p):
            return {**p, **{k: p[k].to(dt) for k in ('qkv', 'r', 'o')}}

        def ffn_p(p):
            return {**p, 'w1': {**p['w1'], 'w': p['w1']['w'].to(dt)},
                    'w2': {**p['w2'], 'w': p['w2']['w'].to(dt)}}
        return {**params, 'embed': {'weight': params['embed']['weight'].to(dt)},
                'layers': [dict(attn=attn(l['attn']), ffn=ffn_p(l['ffn']))
                           for l in params['layers']]}

    def init_mems(self, batch_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        mems = torch.zeros(cfg.n_layer, batch_size, cfg.mem_len, cfg.d_model,
                           dtype=cfg.compute_dtype, device=self.device)
        return mems, torch.zeros((), dtype=torch.int32, device=self.device)

    # --------------------------------------------------------------- forward
    def forward(self, params: Params, input_ids: torch.Tensor,
                mems: Optional[torch.Tensor] = None, mem_valid=0,
                attn_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, deterministic: bool = True):
        """input_ids [B, Q] -> (logits f32 [B, Q, V], new_mems, new_valid)."""
        h, new_mems, new_valid = self.forward_hidden(
            params, input_ids, mems=mems, mem_valid=mem_valid, attn_mask=attn_mask,
            generator=generator, deterministic=deterministic)
        with span('model.head'):
            logits = self._lm_head(params, h)
        return logits, new_mems, new_valid

    def forward_hidden(self, params: Params, input_ids: torch.Tensor,
                       mems: Optional[torch.Tensor] = None, mem_valid=0,
                       attn_mask: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None,
                       deterministic: bool = True):
        """Trunk only: final hidden states [B, Q, d], new memory, new valid count.
        mems [L, B, M, d] right-aligned memory or None; attn_mask [B, Q] bool
        (True = real token) masks padded keys."""
        cfg = self.cfg
        # K1 / K2 have neither a key mask nor attention dropout
        plain = attn_mask is not None or cfg.dropatt > 0
        dtype = cfg.compute_dtype
        B, Q = input_ids.shape
        if cfg.shard_vocab:
            h = vocab_sharded_embed(input_ids, params['embed']['weight'],
                                    mesh=self._require_mesh(), dtype=dtype)
        else:
            h = params['embed']['weight'].to(dtype)[input_ids.long()]
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=dtype, device=h.device)
        h = dropout(h, cfg.dropout, generator, deterministic)

        new_mems = [] if mems is not None else None
        if isinstance(mem_valid, torch.Tensor):
            mem_valid = mem_valid.to(device=h.device, dtype=torch.int32)
        for li, layer in enumerate(params['layers']):
            layer_mems = None
            if mems is not None:
                # memory stores this layer's INPUT hiddens (TF-XL semantics)
                new_mems.append(torch.cat([mems[li], h], dim=1)[:, -cfg.mem_len:].detach())
                layer_mems = mems[li]
            with span('model.attn'):
                if plain:
                    h = rel_attn(
                        layer['attn'], h, layer_mems, mem_valid, clamp_len=cfg.clamp_len,
                        pre_lnorm=cfg.pre_lnorm, dropout_rate=cfg.dropout,
                        dropatt_rate=cfg.dropatt, generator=generator,
                        deterministic=deterministic, attn_mask=attn_mask,
                        window=cfg.attn_window, mesh=self.mesh)
                else:
                    attn = functools.partial(
                        fused_rel_attn, clamp_len=cfg.clamp_len, pre_lnorm=cfg.pre_lnorm,
                        dropout_rate=cfg.dropout, generator=generator,
                        deterministic=deterministic, window=cfg.attn_window, mesh=self.mesh)
                    if cfg.remat_attn:
                        h = remat(attn, layer['attn'], h, layer_mems, mem_valid,
                                  generator=generator)
                    else:
                        h = attn(layer['attn'], h, layer_mems, mem_valid)
            with span('model.ffn'):
                h = ffn(layer['ffn'], h, pre_lnorm=cfg.pre_lnorm, dropout_rate=cfg.dropout,
                        generator=generator, deterministic=deterministic, mesh=self.mesh)

        if mems is not None:
            new_valid = torch.clamp(torch.as_tensor(mem_valid, device=h.device) + Q,
                                    max=cfg.mem_len).to(torch.int32)
            return h, torch.stack(new_mems), new_valid
        return h, None, torch.zeros((), dtype=torch.int32, device=h.device)

    def _lm_head(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        """Tied dense head: f32 logits from compute-dtype operands.  With
        `adaptive_cutoffs`, the adaptive head's log-probs instead (HF
        ProjectedAdaptiveLogSoftmax with div_val 1 and no projection): a
        head softmax over the first cutoff's tokens and one logit per tail
        cluster, plus each cluster's own softmax over its tokens."""
        if self.cfg.shard_vocab and self.mesh is not None and self.mesh.n_model > 1:
            raise ValueError('the vocab-sharded head trains through loss(); score or decode '
                             'with the gathered parameters (load_trained)')
        w = params['embed']['weight'].to(h.dtype).float()
        bias = params['out_bias'].float()
        hf = h.float()
        if not self.cfg.adaptive_cutoffs:
            return hf @ w.T + bias
        cuts = (0, *self.cfg.adaptive_cutoffs, self.cfg.vocab_size)
        c0 = cuts[1]
        ad = params['adaptive']
        head_w = torch.cat([w[:c0], ad['cluster_w'].to(h.dtype).float()])
        head_b = torch.cat([bias[:c0], ad['cluster_b'].float()])
        head_lp = torch.log_softmax(hf @ head_w.T + head_b, dim=-1)
        parts = [head_lp[..., :c0]]
        for i in range(len(cuts) - 2):
            lo, hi = cuts[i + 1], cuts[i + 2]
            tail_lp = torch.log_softmax(hf @ w[lo:hi].T + bias[lo:hi], dim=-1)
            parts.append(head_lp[..., c0 + i:c0 + i + 1] + tail_lp)
        return torch.cat(parts, dim=-1)

    # ------------------------------------------------------------------ loss
    def loss(self, params: Params, input_ids: torch.Tensor, labels: torch.Tensor,
             generator: Optional[torch.Generator] = None, deterministic: bool = True,
             n_seg: int = 1) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """CLM loss + aux metrics: over dense logits, or with `head_chunk`
        through the tiled CE (no [B, T, V] logits).  n_seg > 1 trains segment
        by segment with the memory carried across segments (`_loss_segments`)."""
        cfg = self.cfg
        if (cfg.head_chunk or cfg.shard_vocab) and cfg.adaptive_cutoffs:
            raise ValueError('head_chunk / shard_vocab train over the dense tied head while '
                             'forward and decode score through the adaptive clusters: training '
                             'and scoring would disagree for an adaptive checkpoint')
        if n_seg > 1:
            if cfg.head_chunk or cfg.shard_vocab:
                raise ValueError('head_chunk / shard_vocab (the tiled large-vocab CE) requires '
                                 'n_seg == 1; segment training materializes per-segment logits')
            return global_loss(*self._loss_segments(
                params, input_ids, labels, n_seg=n_seg, generator=generator,
                deterministic=deterministic), labels, self.mesh)
        h, _, _ = self.forward_hidden(params, input_ids, generator=generator,
                                      deterministic=deterministic)
        with span('model.head'):
            if cfg.shard_vocab:
                loss, n_tok, preds = vocab_sharded_ce_loss(
                    h, labels, params['embed']['weight'], params['out_bias'],
                    mesh=self._require_mesh(), chunk=cfg.head_chunk)
                acc = global_mean(ntp_accuracy(preds, labels), valid_count(labels), self.mesh,
                                  total=n_tok)
                return loss, dict(ntp_acc=acc, n_tok=n_tok, preds=preds)
            if cfg.head_chunk:
                loss, n_tok, preds = chunked_shifted_ce_loss(
                    h, labels, params['embed']['weight'].to(h.dtype), params['out_bias'],
                    chunk=cfg.head_chunk)
            else:
                logits = self._lm_head(params, h)
                loss, n_tok = shifted_ce_loss(logits, labels)
                preds = logits.argmax(dim=-1)
            return global_loss(loss, dict(ntp_acc=ntp_accuracy(preds, labels), n_tok=n_tok,
                                           preds=preds), labels, self.mesh)

    def _segments(self, x: torch.Tensor, n_seg: int) -> Tuple[torch.Tensor, ...]:
        B, T = x.shape
        if T % n_seg:
            raise ValueError(f'seq len {T} not divisible by n_seg {n_seg}')
        return x.split(T // n_seg, dim=1)

    def _loss_segments(self, params: Params, input_ids: torch.Tensor, labels: torch.Tensor,
                       *, n_seg: int, generator: Optional[torch.Generator] = None,
                       deterministic: bool = True
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Segment-loop training loss: equal to `shifted_ce_loss` over the
        full-sequence logits.  The memory is detached between segments (TF-XL
        stop-gradient), the cross-boundary prediction (last logits of segment
        s for the first label of segment s+1) is carried, and the sums
        accumulate inside the loop, so no [B, T, V] logits are stacked."""
        B = input_ids.shape[0]
        mems, valid = self.init_mems(B)
        nll = torch.zeros((), device=self.device)
        n = torch.zeros((), device=self.device)
        correct = torch.zeros((), device=self.device)
        prev_last, preds = None, []
        for ids_s, lb_s in zip(self._segments(input_ids, n_seg), self._segments(labels, n_seg)):
            logits, mems, valid = self.forward(params, ids_s, mems=mems, mem_valid=valid,
                                               generator=generator,
                                               deterministic=deterministic)
            lg = logits[:, :-1].float()
            nxt = lb_s[:, 1:]
            if prev_last is not None:        # the boundary prediction
                lg = torch.cat([prev_last[:, None], lg], dim=1)
                nxt = lb_s
            ok = nxt != PT_LOSS_PAD
            safe = torch.where(ok, nxt, torch.zeros_like(nxt)).long()
            tok = torch.gather(lg, -1, safe[..., None])[..., 0]
            nll = nll + torch.where(ok, torch.logsumexp(lg, dim=-1) - tok,
                                    torch.zeros_like(tok)).sum()
            n = n + ok.sum()
            correct = correct + ((lg.argmax(dim=-1) == nxt) & ok).sum()
            prev_last = logits[:, -1].float()
            preds.append(logits.argmax(dim=-1))
        n = torch.clamp(n, min=1.0)
        return nll / n, dict(ntp_acc=correct / n, n_tok=n, preds=torch.cat(preds, dim=1))

    def forward_segments(self, params: Params, input_ids: torch.Tensor, *, n_seg: int,
                         generator: Optional[torch.Generator] = None,
                         deterministic: bool = True) -> torch.Tensor:
        """Segment-level recurrence: run the segments in order with the
        detached memory carried across them; input_ids [B, T], T % n_seg == 0
        -> logits [B, T, V]."""
        mems, valid = self.init_mems(input_ids.shape[0])
        out = []
        for ids_s in self._segments(input_ids, n_seg):
            logits, mems, valid = self.forward(params, ids_s, mems=mems, mem_valid=valid,
                                               generator=generator,
                                               deterministic=deterministic)
            out.append(logits)
        return torch.cat(out, dim=1)

    # ---------------------------------------------------------------- decode
    def init_decode_state(self, batch_size: int) -> DecodeState:
        cfg = self.cfg
        shape = (cfg.n_layer, batch_size, cfg.mem_len, cfg.n_head, cfg.d_head)
        quant = cfg.decode_cache_quant == 'int8'
        cache_dt = torch.int8 if quant else cfg.compute_dtype
        dev = self.device

        def scales():
            return torch.zeros(shape[:-1], dtype=torch.float32, device=dev) if quant else None
        return DecodeState(
            cache_k=torch.zeros(shape, dtype=cache_dt, device=dev),
            cache_v=torch.zeros(shape, dtype=cache_dt, device=dev),
            cache_pos=torch.full((cfg.mem_len,), -1, dtype=torch.int32, device=dev),
            step=0, k_scale=scales(), v_scale=scales())

    def decode_step(self, params: Params, token_ids: torch.Tensor, state: DecodeState):
        logits, _, state = self.decode_step_with_hidden(params, token_ids, state)
        return logits, state

    def decode_step_with_hidden(self, params: Params, token_ids: torch.Tensor,
                                state: DecodeState):
        """token_ids [B] -> (logits f32 [B, V], final hidden [B, d], next state).
        Exactly forward() on the full prefix with mem_len-window attention."""
        cfg = self.cfg
        dtype = cfg.compute_dtype
        slot = state.step % cfg.mem_len
        h = params['embed']['weight'].to(dtype)[token_ids.long()][:, None, :]
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=dtype, device=h.device)

        tables = state.pos_tables
        if tables is None:
            C = cfg.clamp_len if cfg.clamp_len > 0 else cfg.mem_len
            tables = tuple(decode_pos_table(l['attn'], C, cfg.d_model, dtype, h.device)
                           for l in params['layers'])
        ck, cv, ks, vs = state.cache_k, state.cache_v, state.k_scale, state.v_scale
        quant = ks is not None
        for li, layer in enumerate(params['layers']):
            h, k_cur, v_cur = rel_attn_decode_step(
                layer['attn'], h, ck[li], cv[li], state.cache_pos, state.step,
                clamp_len=cfg.clamp_len, pre_lnorm=cfg.pre_lnorm, window=cfg.attn_window,
                cache_k_scale=ks[li] if quant else None,
                cache_v_scale=vs[li] if quant else None, r_head_all=tables[li])
            if quant:
                k_cur, k_sc = quantize_kv_rows(k_cur)
                v_cur, v_sc = quantize_kv_rows(v_cur)
                ks[li, :, slot] = k_sc[:, 0]
                vs[li, :, slot] = v_sc[:, 0]
            ck[li, :, slot] = k_cur[:, 0]
            cv[li, :, slot] = v_cur[:, 0]
            h = ffn(layer['ffn'], h, pre_lnorm=cfg.pre_lnorm)

        logits = self._lm_head(params, h)[:, 0]
        state.cache_pos[slot] = state.step
        return logits, h[:, 0], state._replace(step=state.step + 1, pos_tables=tables)

    @staticmethod
    def expand_decode_state(state: DecodeState, k: int) -> DecodeState:
        def rep(x):
            return None if x is None else torch.repeat_interleave(x, k, dim=1)
        return state._replace(cache_k=rep(state.cache_k), cache_v=rep(state.cache_v),
                              cache_pos=state.cache_pos.clone(),
                              k_scale=rep(state.k_scale), v_scale=rep(state.v_scale))

    @staticmethod
    def select_decode_state(state: DecodeState, idx: torch.Tensor) -> DecodeState:
        def sel(x):
            return None if x is None else x[:, idx.long()]
        return state._replace(cache_k=sel(state.cache_k), cache_v=sel(state.cache_v),
                              cache_pos=state.cache_pos.clone(),
                              k_scale=sel(state.k_scale), v_scale=sel(state.v_scale))

    # the generic name beam search looks up on any model
    reorder_decode_state = select_decode_state
