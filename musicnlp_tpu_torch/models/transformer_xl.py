"""Transformer-XL music LM in PyTorch.

Counterpart of `musicnlp_tpu/models/transformer_xl.py`: the same size presets,
tied embedding / dense softmax head, relative-position attention with a
fixed-shape right-aligned memory, a dense-head loss with NTP accuracy (over
one segment, or segment by segment with carried memory), and an exact KV
ring-cache decode step (bf16 or int8 caches).

Parameters are a nested dict of float32 tensors in the JAX package's layouts
(`utils/checkpoint.params_from_jax` carries JAX parameters in).  Every
attention layer of `forward` runs through kernels K1 (forward) and K2
(backward) of `ops/flash_attention.py` (on CPU tensors, their plain
versions).  Like the TPU kernels, they have no key-padding mask and no
attention-probability dropout: the JAX model sends a forward with
`attn_mask` or with `dropatt > 0` to its plain `rel_attn`.  That dispatch
is not ported yet, so `forward` takes no `attn_mask` and raises when
`dropatt` would apply (every preset has dropatt = 0).  Dropout draws come
from an explicit `torch.Generator`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from musicnlp_tpu_torch import resolve_device
from musicnlp_tpu_torch.ops.attention import (
    decode_pos_table, quantize_kv_rows, rel_attn_decode_step,
)
from musicnlp_tpu_torch.ops.flash_attention import fused_rel_attn
from musicnlp_tpu_torch.ops.layers import Params, dropout, ffn
from musicnlp_tpu_torch.ops.losses import PT_LOSS_PAD, ntp_accuracy, shifted_ce_loss
from musicnlp_tpu_torch.utils.checkpoint import params_from_jax

__all__ = ['TransfoXLConfig', 'TransfoXL', 'DecodeState']

_DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32, 'float16': torch.float16}


@dataclass(frozen=True)
class TransfoXLConfig:
    """The JAX package's config less its TPU execution knobs (flash block
    sizes, remat, vocab tiling / sharding), which change how a result is
    computed there but not the result; `load_trained` drops them."""
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
    decode_cache_quant: Optional[str] = None    # None | 'int8'
    attn_window: Optional[int] = None

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
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg = config
        self.device = resolve_device(device)

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
                generator: Optional[torch.Generator] = None, deterministic: bool = True):
        """input_ids [B, Q] -> (logits f32 [B, Q, V], new_mems, new_valid)."""
        h, new_mems, new_valid = self.forward_hidden(
            params, input_ids, mems=mems, mem_valid=mem_valid,
            generator=generator, deterministic=deterministic)
        return self._lm_head(params, h), new_mems, new_valid

    def forward_hidden(self, params: Params, input_ids: torch.Tensor,
                       mems: Optional[torch.Tensor] = None, mem_valid=0,
                       generator: Optional[torch.Generator] = None,
                       deterministic: bool = True):
        """Trunk only: final hidden states [B, Q, d], new memory, new valid count.
        mems [L, B, M, d] right-aligned memory or None."""
        cfg = self.cfg
        if cfg.dropatt > 0 and not deterministic:
            raise NotImplementedError('attention-probability dropout (dropatt > 0) runs on the '
                                      'plain rel_attn path, whose dispatch is not ported yet; '
                                      'K1/K2, like the TPU kernels, have none: set dropatt=0')
        dtype = cfg.compute_dtype
        B, Q = input_ids.shape
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
            h = fused_rel_attn(
                layer['attn'], h, layer_mems, mem_valid, clamp_len=cfg.clamp_len,
                pre_lnorm=cfg.pre_lnorm, dropout_rate=cfg.dropout, generator=generator,
                deterministic=deterministic, window=cfg.attn_window)
            h = ffn(layer['ffn'], h, pre_lnorm=cfg.pre_lnorm, dropout_rate=cfg.dropout,
                    generator=generator, deterministic=deterministic)

        if mems is not None:
            new_valid = torch.clamp(torch.as_tensor(mem_valid, device=h.device) + Q,
                                    max=cfg.mem_len).to(torch.int32)
            return h, torch.stack(new_mems), new_valid
        return h, None, torch.zeros((), dtype=torch.int32, device=h.device)

    def _lm_head(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        """Tied dense head; f32 logits from compute-dtype operands."""
        w = params['embed']['weight'].to(h.dtype)
        return h.float() @ w.float().T + params['out_bias'].float()

    # ------------------------------------------------------------------ loss
    def loss(self, params: Params, input_ids: torch.Tensor, labels: torch.Tensor,
             generator: Optional[torch.Generator] = None, deterministic: bool = True,
             n_seg: int = 1) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """CLM loss + aux metrics (dense head).  n_seg > 1 trains segment by
        segment with the memory carried across segments (`_loss_segments`)."""
        if n_seg > 1:
            return self._loss_segments(params, input_ids, labels, n_seg=n_seg,
                                       generator=generator, deterministic=deterministic)
        logits, _, _ = self.forward(params, input_ids, generator=generator,
                                    deterministic=deterministic)
        loss, n_tok = shifted_ce_loss(logits, labels)
        preds = logits.argmax(dim=-1)
        return loss, dict(ntp_acc=ntp_accuracy(preds, labels), n_tok=n_tok, preds=preds)

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
