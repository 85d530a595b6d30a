"""Reformer music LM in PyTorch.

Counterpart of `musicnlp_tpu/models/reformer.py`: the same size presets
(alternating local / LSH attention layers, axial position embeddings, a
separate key projection in local layers, shared-QK LSH layers with
`n_hashes` rounds, feed-forward 4x, untied LM head), a pre-norm residual
stack, the CLM loss with NTP accuracy, and the incremental 'scan' decode
step (a lossless 2*chunk ring in local layers; in LSH layers a masked scan of
the whole cache by bucket id, bf16 or int8).

Parameters are a nested dict of float32 tensors in the JAX package's layouts
(`utils/checkpoint.params_from_jax` carries JAX parameters in).  Every
attention layer of `forward` runs through kernels K3 (forward) and K4
(backward) of `ops/chunked_attention_kernel.py` (on CPU tensors, their plain
versions); decode was never a kernel and is plain torch.  The LSH rotations
are the JAX model's own draws (`ops/chunked_attention.lsh_rotations`).

Not ported yet (each raises `NotImplementedError`): `hf_compat` (the
reversible two-stream layout of HF checkpoints), `remat`, the 'bounded'
decode estimator and a streamed `decode_scan_chunk`.  Dropout draws come
from an explicit `torch.Generator`, not JAX's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from musicnlp_tpu_torch import resolve_device
from musicnlp_tpu_torch.ops.attention import quantize_kv_rows
from musicnlp_tpu_torch.ops.chunked_attention import (
    NEG_INF, SELF_BIAS, local_attention, lsh_attention, lsh_buckets, lsh_rotations,
)
from musicnlp_tpu_torch.ops.layers import Params, dense, dropout, layer_norm
from musicnlp_tpu_torch.ops.losses import ntp_accuracy, shifted_ce_loss
from musicnlp_tpu_torch.utils.checkpoint import params_from_jax

__all__ = ['ReformerConfig', 'Reformer', 'ReformerDecodeState', 'ReformerExactDecodeState']

_DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32, 'float16': torch.float16}


def _auto_buckets(T: int, chunk: int) -> int:
    """HF heuristic: ~2 * T / chunk, rounded up to an even power of 2."""
    target = max(2, 2 * T // chunk)
    n = 2
    while n < target:
        n *= 2
    return n


@dataclass(frozen=True)
class ReformerConfig:
    """The JAX package's config, field for field (its `meta.json` loads here)."""
    vocab_size: int = 1190
    model_size: str = 'base'
    d_model: int = 768
    n_head: int = 12
    d_head: int = 64
    d_ff: int = 3072
    attn_layers: Tuple[str, ...] = ('local', 'lsh') * 6
    max_length: int = 2048
    axial_pos_shape: Tuple[int, int] = (32, 64)
    local_chunk: int = 64
    lsh_chunk: int = 64
    n_hashes: int = 1
    n_buckets: Optional[int] = None
    dropout: float = 0.05
    lsh_seed: int = 77
    remat: bool = False
    init_std: float = 0.02
    dtype: str = 'bfloat16'
    ln_eps: float = 1e-5
    decode_mode: str = 'scan'
    decode_window: int = 32
    decode_cache_quant: Optional[str] = None    # None | 'int8'
    decode_scan_chunk: Optional[int] = None
    hf_compat: bool = False

    presets = {
        'debug': dict(max_length=64, axial_pos_shape=(8, 8), d_model=128,
                      n_head=8, n_pairs=3),
        'debug-large': dict(max_length=512, axial_pos_shape=(16, 32), d_model=128,
                            n_head=8, n_pairs=3),
        'tiny': dict(max_length=1024, axial_pos_shape=(32, 32), d_model=256,
                     n_head=8, n_pairs=3),
        'small': dict(max_length=2048, axial_pos_shape=(32, 64), d_model=512,
                      n_head=8, n_pairs=3),
        'base': dict(max_length=2048, axial_pos_shape=(32, 64), d_model=768,
                     n_head=12, n_pairs=6, n_hashes=2),
        'large': dict(max_length=2048, axial_pos_shape=(32, 64), d_model=1024,
                      n_head=16, n_pairs=12, n_hashes=2),
    }

    @classmethod
    def from_size(cls, model_size: str, vocab_size: int, max_length: int = None,
                  **kwargs) -> 'ReformerConfig':
        p = dict(cls.presets[model_size])
        n_pairs = p.pop('n_pairs')
        d = p['d_model']
        cfg = dict(vocab_size=vocab_size, model_size=model_size, d_head=d // p['n_head'],
                   d_ff=d * 4, attn_layers=('local', 'lsh') * n_pairs, **p)
        if max_length and max_length != cfg['max_length']:
            cfg['max_length'] = max_length
            if 'axial_pos_shape' not in kwargs:
                a = 1                       # near-square factorization
                while a * a < max_length:
                    a *= 2
                if max_length % a:
                    raise ValueError(f'max_length {max_length} must be a power-of-two-ish '
                                     f'product')
                cfg['axial_pos_shape'] = (max_length // a, a)
        cfg.update(kwargs)
        c = cls(**cfg)
        n1, n2 = c.axial_pos_shape
        if n1 * n2 != c.max_length:
            raise ValueError(f'axial_pos_shape {c.axial_pos_shape} must multiply to '
                             f'{c.max_length}')
        if c.max_length % c.local_chunk or c.max_length % c.lsh_chunk:
            raise ValueError('max_length must be a multiple of both chunk sizes')
        return c

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def axial_dims(self) -> Tuple[int, int]:
        return self.d_model // 4, 3 * self.d_model // 4

    def lsh_buckets_at(self, T: int) -> int:
        return self.n_buckets or _auto_buckets(T, self.lsh_chunk)


class ReformerDecodeState(NamedTuple):
    """Incremental ('scan') decode state, updated IN PLACE by `decode_step`
    (one slot per step), so a state is consumed by the step that takes it.
    Every cache keeps batch on axis 1; the time axis comes before the head
    dim (the port's layout, not the TPU's lane-minor one)."""
    local_k: torch.Tensor       # [n_local, B, N, 2c, H] ring of projected keys
    local_v: torch.Tensor       # [n_local, B, N, 2c, H]
    lsh_k: torch.Tensor         # [n_lsh, B, N, L, H] normalized keys (or int8)
    lsh_v: torch.Tensor         # [n_lsh, B, N, L, H]
    lsh_buckets: torch.Tensor   # [n_lsh, B, N, R, L] int16, -1 = unwritten
    step: int
    lsh_k_scale: Optional[torch.Tensor] = None   # [n_lsh, B, N, L] f32 for int8 caches
    lsh_v_scale: Optional[torch.Tensor] = None


class ReformerExactDecodeState(NamedTuple):
    """Oracle decode state: the token buffer; each step re-forwards the prefix."""
    buf: torch.Tensor    # int64 [B, L]
    step: int


class Reformer:
    """Model namespace over explicit parameters, as in the JAX package."""

    def __init__(self, config: ReformerConfig,
                 device: Optional[Union[str, torch.device]] = None):
        if config.hf_compat:
            raise NotImplementedError('hf_compat (the reversible two-stream layout of HF '
                                      'checkpoints) comes with the HF-interop slice')
        if config.remat:
            raise NotImplementedError('remat (activation recomputation) comes with a later '
                                      'slice; training at 22-04 fits without it')
        self.cfg = config
        self.device = resolve_device(device)

    # ------------------------------------------------------------------ init
    def init_flat(self, seed: int = 0) -> Dict[str, np.ndarray]:
        """Random parameters made with numpy from `seed`, in the JAX layout
        under flat '/'-joined keys (normal(0, init_std) matrices and axial
        embeddings, zero biases, unit layer-norm scales)."""
        cfg = self.cfg
        rng = np.random.default_rng(seed)
        D, N, H, F, V = cfg.d_model, cfg.n_head, cfg.d_head, cfg.d_ff, cfg.vocab_size
        n1, n2 = cfg.axial_pos_shape
        d1, d2 = cfg.axial_dims

        def normal(*shape):
            return rng.standard_normal(shape, dtype=np.float32) * np.float32(cfg.init_std)

        def ln(prefix):
            return {f'{prefix}/scale': np.ones(D, np.float32),
                    f'{prefix}/bias': np.zeros(D, np.float32)}

        flat = {'embed/weight': normal(V, D), 'axial1': normal(n1, 1, d1),
                'axial2': normal(1, n2, d2), 'lm_head/w': normal(D, V),
                'lm_head/b': np.zeros(V, np.float32), **ln('ln_f')}
        for li, kind in enumerate(cfg.attn_layers):
            a, f = f'layers/{li}/attn', f'layers/{li}/ffn'
            flat.update({f'{a}/qk': normal(D, N, H), f'{a}/v': normal(D, N, H),
                         f'{a}/o': normal(N, H, D), **ln(f'{a}/ln'),
                         f'{f}/w1/w': normal(D, F), f'{f}/w1/b': np.zeros(F, np.float32),
                         f'{f}/w2/w': normal(F, D), f'{f}/w2/b': np.zeros(D, np.float32),
                         **ln(f'{f}/ln')})
            if kind == 'local':
                flat[f'{a}/k'] = normal(D, N, H)
        return flat

    def init(self, seed: int = 0) -> Params:
        return params_from_jax(self.init_flat(seed), self.device)

    def compute_params(self, params: Params) -> Params:
        """A view of `params` with the matmul weights cast once to the compute
        dtype (biases, layer norms and axial embeddings stay f32).  Every
        function casts its weights itself, so this changes no result."""
        dt = self.cfg.compute_dtype

        def attn(p):
            return {**p, **{k: p[k].to(dt) for k in ('qk', 'k', 'v', 'o') if k in p}}

        def ffn_p(p):
            return {**p, 'w1': {**p['w1'], 'w': p['w1']['w'].to(dt)},
                    'w2': {**p['w2'], 'w': p['w2']['w'].to(dt)}}
        return {**params, 'embed': {'weight': params['embed']['weight'].to(dt)},
                'lm_head': {**params['lm_head'], 'w': params['lm_head']['w'].to(dt)},
                'layers': [dict(attn=attn(l['attn']), ffn=ffn_p(l['ffn']))
                           for l in params['layers']]}

    def _pos_emb(self, params: Params, T: int, dtype) -> torch.Tensor:
        cfg = self.cfg
        n1, n2 = cfg.axial_pos_shape
        a1 = params['axial1'].expand(n1, n2, cfg.axial_dims[0])
        a2 = params['axial2'].expand(n1, n2, cfg.axial_dims[1])
        return torch.cat([a1, a2], dim=-1).reshape(n1 * n2, cfg.d_model)[:T].to(dtype)

    # --------------------------------------------------------------- forward
    def forward(self, params: Params, input_ids: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                deterministic: bool = True) -> torch.Tensor:
        """input_ids [B, T] (T a multiple of the chunk sizes; pad with
        pad_mask False beyond the real length) -> logits f32 [B, T, V]."""
        cfg = self.cfg
        dtype = cfg.compute_dtype
        B, T = input_ids.shape
        if T % cfg.local_chunk or T % cfg.lsh_chunk:
            raise ValueError(f'T={T} must be a multiple of the chunk sizes')
        h = params['embed']['weight'].to(dtype)[input_ids.long()]
        h = h + self._pos_emb(params, T, dtype)[None]
        for li, layer in enumerate(params['layers']):
            a = self._attn_block(layer['attn'], cfg.attn_layers[li], li, h, pad_mask)
            h = h + dropout(a, cfg.dropout, generator, deterministic)
            f = self._ffn_block(layer['ffn'], h)
            h = h + dropout(f, cfg.dropout, generator, deterministic)
        return self._lm_head(params, layer_norm(params['ln_f'], h, eps=cfg.ln_eps))

    def _lm_head(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        """Untied dense head; f32 logits from compute-dtype operands."""
        w = params['lm_head']['w'].to(h.dtype)
        return h.float() @ w.float() + params['lm_head']['b'].float()

    @staticmethod
    def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x [B, T, d] @ w [d, N, H] -> [B, N, T, H] in x's dtype."""
        d, N, H = w.shape
        y = x @ w.to(x.dtype).reshape(d, N * H)
        return y.reshape(*x.shape[:-1], N, H).transpose(1, 2)

    def _attn_block(self, p: Params, kind: str, layer_idx: int, h: torch.Tensor,
                    pad_mask: Optional[torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        x = layer_norm(p['ln'], h, eps=cfg.ln_eps)
        qk = self._proj(x, p['qk'])
        v = self._proj(x, p['v'])
        if kind == 'local':
            ctx = local_attention(qk, self._proj(x, p['k']), v, chunk=cfg.local_chunk,
                                  pad_mask=pad_mask)
        else:
            T = h.shape[1]
            nb = cfg.lsh_buckets_at(T)
            rots = lsh_rotations(cfg.lsh_seed, layer_idx, cfg.n_hashes, cfg.d_head, nb,
                                 h.device)
            ctx = lsh_attention(qk, v, chunk=cfg.lsh_chunk, n_hashes=cfg.n_hashes,
                                n_buckets=nb, rots=rots, pad_mask=pad_mask)
        B, N, T, H = ctx.shape
        o = p['o'].to(h.dtype).reshape(N * H, -1)
        return ctx.transpose(1, 2).reshape(B, T, N * H) @ o

    def _ffn_block(self, p: Params, h: torch.Tensor) -> torch.Tensor:
        x = layer_norm(p['ln'], h, eps=self.cfg.ln_eps)
        return dense(p['w2'], torch.relu(dense(p['w1'], x)))

    # ------------------------------------------------------------------ loss
    def loss(self, params: Params, input_ids: torch.Tensor, labels: torch.Tensor,
             generator: Optional[torch.Generator] = None, deterministic: bool = True,
             n_seg: int = 1, pad_id: Optional[int] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """CLM loss + aux metrics.  n_seg is the Trainer's TF-XL knob and is
        ignored here, as in the JAX model; pad_id masks pad keys."""
        pad_mask = (input_ids != pad_id) if pad_id is not None else None
        logits = self.forward(params, input_ids, pad_mask=pad_mask, generator=generator,
                              deterministic=deterministic)
        loss, n_tok = shifted_ce_loss(logits, labels)
        preds = logits.argmax(dim=-1)
        return loss, dict(ntp_acc=ntp_accuracy(preds, labels), n_tok=n_tok, preds=preds)

    # ---------------------------------------------------------------- decode
    def _n_kind(self) -> Tuple[int, int]:
        kinds = self.cfg.attn_layers
        return kinds.count('local'), kinds.count('lsh')

    def init_decode_state(self, batch_size: int) -> ReformerDecodeState:
        cfg = self.cfg
        if cfg.decode_mode != 'scan':
            raise NotImplementedError(f"decode_mode={cfg.decode_mode!r} (per-bucket recency "
                                      f"rings) comes with a later slice; use 'scan'")
        if cfg.decode_scan_chunk not in (None, cfg.max_length):
            raise NotImplementedError('a streamed decode_scan_chunk comes with a later slice; '
                                      'the scan reads the whole cache in one pass')
        quant = cfg.decode_cache_quant == 'int8'
        n_local, n_lsh = self._n_kind()
        B, N, H, L, R = batch_size, cfg.n_head, cfg.d_head, cfg.max_length, cfg.n_hashes
        dt, dev = cfg.compute_dtype, self.device
        nb = cfg.lsh_buckets_at(L)
        if nb >= 32767:
            raise ValueError(f'{nb} buckets do not fit the int16 bucket cache')
        lsh_dt = torch.int8 if quant else dt

        def scales():
            return torch.zeros(n_lsh, B, N, L, dtype=torch.float32, device=dev) if quant else None
        return ReformerDecodeState(
            local_k=torch.zeros(n_local, B, N, 2 * cfg.local_chunk, H, dtype=dt, device=dev),
            local_v=torch.zeros(n_local, B, N, 2 * cfg.local_chunk, H, dtype=dt, device=dev),
            lsh_k=torch.zeros(n_lsh, B, N, L, H, dtype=lsh_dt, device=dev),
            lsh_v=torch.zeros(n_lsh, B, N, L, H, dtype=lsh_dt, device=dev),
            lsh_buckets=torch.full((n_lsh, B, N, R, L), -1, dtype=torch.int16, device=dev),
            step=0, lsh_k_scale=scales(), lsh_v_scale=scales())

    def _pos_emb_row(self, params: Params, t: int, dtype) -> torch.Tensor:
        n2 = self.cfg.axial_pos_shape[1]
        return torch.cat([params['axial1'][t // n2, 0], params['axial2'][0, t % n2]]).to(dtype)

    def decode_step(self, params: Params, token_ids: torch.Tensor,
                    state: ReformerDecodeState):
        logits, _, state = self.decode_step_with_hidden(params, token_ids, state)
        return logits, state

    def decode_step_with_hidden(self, params: Params, token_ids: torch.Tensor,
                                state: ReformerDecodeState):
        """token_ids [B] -> (logits f32 [B, V], final hidden [B, d], next state).
        Exact against `forward` while the position is in the first chunk."""
        cfg = self.cfg
        dtype = cfg.compute_dtype
        t, L = state.step, cfg.max_length
        if t >= L:
            raise ValueError(f'decode step {t} is past max_length {L}')
        scale = 1.0 / (cfg.d_head ** 0.5)
        h = params['embed']['weight'].to(dtype)[token_ids.long()]
        h = h + self._pos_emb_row(params, t, dtype)[None]
        B, dev = h.shape[0], h.device
        lk, lv, sk, sv, sb = (state.local_k, state.local_v, state.lsh_k, state.lsh_v,
                              state.lsh_buckets)
        sks, svs = state.lsh_k_scale, state.lsh_v_scale
        quant = sks is not None
        N, H = cfg.n_head, cfg.d_head
        il = ish = 0
        for li, layer in enumerate(params['layers']):
            p = layer['attn']
            x = layer_norm(p['ln'], h, eps=cfg.ln_eps)                      # [B, d]

            def proj(w):
                return (x @ w.to(dtype).reshape(cfg.d_model, N * H)).reshape(B, N, H)
            q, v = proj(p['qk']), proj(p['v'])
            if cfg.attn_layers[li] == 'local':
                c = cfg.local_chunk
                W = 2 * c
                lk[il, :, :, t % W] = proj(p['k'])
                lv[il, :, :, t % W] = v
                slots = torch.arange(W, device=dev)
                pos_slot = t - ((t - slots) % W)                            # position per slot
                valid = (pos_slot >= (t // c - 1) * c) & (pos_slot >= 0)
                score = torch.einsum('bnh,bnwh->bnw', q.float(), lk[il].float()) * scale
                score = torch.where(valid, score, torch.full_like(score, NEG_INF))
                probs = torch.softmax(score, dim=-1)
                ctx = torch.einsum('bnw,bnwh->bnh', probs.to(dtype).float(),
                                   lv[il].float()).to(dtype)
                il += 1
            else:
                qf = q.float()
                # HF _len_and_dim_norm: rms-normalized keys carrying 1/sqrt(H)
                kn = (qf * torch.rsqrt((qf * qf).mean(dim=-1, keepdim=True) + 1e-6)
                      * (1.0 / (H ** 0.5))).to(dtype)
                if quant:
                    kn_w, k_sc = quantize_kv_rows(kn)
                    v_w, v_sc = quantize_kv_rows(v)
                    sks[ish, :, :, t] = k_sc
                    svs[ish, :, :, t] = v_sc
                else:
                    kn_w, v_w = kn, v
                sk[ish, :, :, t] = kn_w
                sv[ish, :, :, t] = v_w
                nb = cfg.lsh_buckets_at(L)
                rots = lsh_rotations(cfg.lsh_seed, li, cfg.n_hashes, H, nb, dev)
                bt = lsh_buckets(qf, rots).permute(1, 2, 0)                 # [B, N, R]
                sb[ish, :, :, :, t] = bt.to(sb.dtype)
                c = cfg.lsh_chunk
                chunk_start = (t // c) * c
                pos = torch.arange(L, device=dev)
                # the scores read the cache as stored; int8 row scales fold back in
                sc0 = torch.einsum('bnh,bnlh->bnl', q.float(), sk[ish].to(dtype).float())
                if quant:
                    sc0 = sc0 * sks[ish]
                sc0 = torch.where(pos == t, sc0 + SELF_BIAS, sc0)
                mask = (pos <= t) & ((sb[ish] == bt[..., None].to(sb.dtype))
                                     | (pos >= chunk_start))                # [B, N, R, L]
                sc = torch.where(mask, sc0[:, :, None], torch.full_like(sc0[:, :, None],
                                                                          NEG_INF))
                lse = torch.logsumexp(sc, dim=-1)                           # [B, N, R]
                pr = torch.exp(sc - lse[..., None])
                if cfg.n_hashes > 1:
                    pr = pr * torch.softmax(lse, dim=-1)[..., None]
                prc = pr.sum(dim=2)                                         # [B, N, L]
                if quant:
                    prc = prc * svs[ish]
                ctx = torch.einsum('bnl,bnlh->bnh', prc.to(dtype).float(),
                                   sv[ish].to(dtype).float()).to(dtype)
                ish += 1
            a = ctx.reshape(B, N * H) @ p['o'].to(dtype).reshape(N * H, cfg.d_model)
            h = h + a
            fp = layer['ffn']
            xf = layer_norm(fp['ln'], h, eps=cfg.ln_eps)
            h = h + dense(fp['w2'], torch.relu(dense(fp['w1'], xf)))
        h = layer_norm(params['ln_f'], h, eps=cfg.ln_eps)
        return self._lm_head(params, h), h, state._replace(step=t + 1)

    @property
    def hidden_dim(self) -> int:
        """Width of decode_step_with_hidden's hidden output."""
        return self.cfg.d_model

    @staticmethod
    def expand_decode_state(state: ReformerDecodeState, k: int) -> ReformerDecodeState:
        """Repeat the batch axis (axis 1 of every cache) k times."""
        def rep(x):
            return None if x is None else torch.repeat_interleave(x, k, dim=1)
        return state._replace(**{f: rep(getattr(state, f)) for f in _CACHES})

    @staticmethod
    def select_decode_state(state: ReformerDecodeState, idx: torch.Tensor
                            ) -> ReformerDecodeState:
        """Gather the batch axis (axis 1 of every cache)."""
        def sel(x):
            return None if x is None else x[:, idx.long()]
        return state._replace(**{f: sel(getattr(state, f)) for f in _CACHES})

    reorder_decode_state = select_decode_state

    # ------------------------------------------------------ exact decode oracle
    def init_decode_state_exact(self, batch_size: int) -> ReformerExactDecodeState:
        return ReformerExactDecodeState(
            buf=torch.zeros(batch_size, self.cfg.max_length, dtype=torch.int64,
                            device=self.device), step=0)

    def decode_step_exact(self, params: Params, token_ids: torch.Tensor,
                          state: ReformerExactDecodeState):
        """Full-prefix re-forward per step: the exactness oracle."""
        buf = state.buf.clone()
        buf[:, state.step] = token_ids
        pad_mask = (torch.arange(self.cfg.max_length, device=buf.device) <= state.step)
        logits = self.forward(params, buf, pad_mask=pad_mask.expand(buf.shape))
        return logits[:, state.step], ReformerExactDecodeState(buf=buf, step=state.step + 1)


_CACHES = ('local_k', 'local_v', 'lsh_k', 'lsh_v', 'lsh_buckets', 'lsh_k_scale', 'lsh_v_scale')
