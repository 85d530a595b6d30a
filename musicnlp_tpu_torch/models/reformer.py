"""Reformer music LM in PyTorch.

Counterpart of `musicnlp_tpu/models/reformer.py`: the same size presets
(alternating local / LSH attention layers, axial position embeddings, a
separate key projection in local layers, shared-QK LSH layers with
`n_hashes` rounds, feed-forward 4x, untied LM head), a pre-norm residual
stack, the CLM loss with NTP accuracy, and the incremental decode step (a
lossless 2*chunk ring in local layers; in LSH layers either a masked scan of
the cache by bucket id, in one pass or streamed in `decode_scan_chunk`-wide
chunks, bf16 or int8 -- 'scan' -- or per-bucket recency rings --
'bounded').  `hf_compat` is the layout of HF `ReformerModelWithLMHead`
checkpoints (`utils/hf_import.from_hf_reformer`): reversible two-stream
residuals, a separate query in local layers, and the final norm and head
over both streams.  `remat` recomputes each attention and feed-forward block
in the backward (`ops/layers.remat`).

Parameters are a nested dict of float32 tensors in the JAX package's layouts
(`utils/checkpoint.params_from_jax` carries JAX parameters in).  Every
attention layer of `forward` runs through kernels K3 (forward) and K4
(backward) of `ops/chunked_attention_kernel.py` (on CPU tensors, their plain
versions); decode was never a kernel and is plain torch.  The LSH rotations
are the JAX model's own draws (`ops/chunked_attention.lsh_rotations`), so
a recomputed block buckets as its forward did.  Dropout draws come from an
explicit `torch.Generator`, not JAX's.

Training on a device mesh (`parallel/mesh.py`, `Reformer(cfg, mesh=...)` or
the mesh a `Trainer` attaches): each rank runs K3 / K4 on its own heads and
the feed-forward on its own columns (Megatron tensor parallelism over
`model`), on its own rows of the batch; `loss` returns the global batch's
loss and metrics.  Decode is mesh-free, as in the JAX package.
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
from musicnlp_tpu_torch.ops.layers import Params, dense, dropout, layer_norm, remat
from musicnlp_tpu_torch.ops.losses import ntp_accuracy, shifted_ce_loss
from musicnlp_tpu_torch.parallel.mesh import Mesh, copy_to_model, global_loss, sum_over_model
from musicnlp_tpu_torch.utils.checkpoint import params_from_jax
from musicnlp_tpu_torch.utils.profiling import span

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
    """The JAX package's config, field for field (its `meta.json` loads here).

    decode_mode: 'scan' or 'bounded' (`ReformerDecodeState`).
    decode_scan_chunk: 'scan' reads the live prefix of the LSH cache in
    chunks of this many positions with an online softmax; None reads the
    whole cache in one pass.  It must divide max_length.
    hf_compat: the HF `ReformerModelWithLMHead` layout (module docstring)."""
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
    """Incremental decode state, updated IN PLACE by `decode_step` (one slot
    per step), so a state is consumed by the step that takes it.  Every cache
    keeps batch on axis 1; the time axis comes before the head dim (the
    port's layout, not the TPU's lane-minor one).

    LSH layers cache normalized keys and values; a query attends causally
    over the earlier positions of its own bucket plus the whole current
    chunk.  'scan' masks the cache by the bucket id of every position
    (`lsh_buckets`); 'bounded' keeps, per (head, round, bucket), a ring of
    the `decode_window` latest positions of that bucket (`lsh_ring`, with
    each bucket's write count in `lsh_cnt`) and attends to those and the
    current chunk only.  Where decode_window is at least the most positions
    any bucket receives, the rings lose nothing and the two agree
    (decode_window * n_buckets >= max_length alone does not ensure it: a
    bucket may receive more than its share).  The fields of the other mode
    are allocated [n_lsh, B, 1, 1, 1] and left alone."""
    local_k: torch.Tensor       # [n_local, B, N, 2c, H] ring of projected keys
    local_v: torch.Tensor       # [n_local, B, N, 2c, H]
    lsh_k: torch.Tensor         # [n_lsh, B, N, L, H] normalized keys (or int8)
    lsh_v: torch.Tensor         # [n_lsh, B, N, L, H]
    lsh_buckets: torch.Tensor   # [n_lsh, B, N, R, L] int16, -1 = unwritten ('scan')
    lsh_ring: torch.Tensor      # [n_lsh, B, N, R, nb * W] int32 positions, -1 ('bounded')
    lsh_cnt: torch.Tensor       # [n_lsh, B, N, R, nb] int32 writes per bucket ('bounded')
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
                 device: Optional[Union[str, torch.device]] = None, mesh: Optional[Mesh] = None):
        self.cfg = config
        self.device = resolve_device(device)
        self.mesh = mesh         # training only; a Trainer attaches its own when None

    # ------------------------------------------------------------------ init
    def init_flat(self, seed: int = 0) -> Dict[str, np.ndarray]:
        """Random parameters made with numpy from `seed`, in the JAX layout
        under flat '/'-joined keys (normal(0, init_std) matrices and axial
        embeddings, zero biases, unit layer-norm scales); with `hf_compat`, a
        query per local layer and the final norm and head over [2 d]."""
        cfg = self.cfg
        rng = np.random.default_rng(seed)
        D, N, H, F, V = cfg.d_model, cfg.n_head, cfg.d_head, cfg.d_ff, cfg.vocab_size
        n1, n2 = cfg.axial_pos_shape
        d1, d2 = cfg.axial_dims

        def normal(*shape):
            return rng.standard_normal(shape, dtype=np.float32) * np.float32(cfg.init_std)

        def ln(prefix, width=D):
            return {f'{prefix}/scale': np.ones(width, np.float32),
                    f'{prefix}/bias': np.zeros(width, np.float32)}

        d_out = 2 * D if cfg.hf_compat else D
        flat = {'embed/weight': normal(V, D), 'axial1': normal(n1, 1, d1),
                'axial2': normal(1, n2, d2), 'lm_head/w': normal(d_out, V),
                'lm_head/b': np.zeros(V, np.float32), **ln('ln_f', d_out)}
        for li, kind in enumerate(cfg.attn_layers):
            a, f = f'layers/{li}/attn', f'layers/{li}/ffn'
            flat.update({f'{a}/qk': normal(D, N, H), f'{a}/v': normal(D, N, H),
                         f'{a}/o': normal(N, H, D), **ln(f'{a}/ln'),
                         f'{f}/w1/w': normal(D, F), f'{f}/w1/b': np.zeros(F, np.float32),
                         f'{f}/w2/w': normal(F, D), f'{f}/w2/b': np.zeros(D, np.float32),
                         **ln(f'{f}/ln')})
            if kind == 'local':
                flat[f'{a}/k'] = normal(D, N, H)
                if cfg.hf_compat:
                    flat[f'{a}/q'] = normal(D, N, H)
        return flat

    def init(self, seed: int = 0) -> Params:
        return params_from_jax(self.init_flat(seed), self.device)

    def unread_leaves(self) -> frozenset:
        """Flat keys of the leaves the loss never reads: under `hf_compat` a
        local layer attends through its own 'q' and keeps 'qk' only for the
        JAX layout."""
        if not self.cfg.hf_compat:
            return frozenset()
        return frozenset(f'layers/{li}/attn/qk' for li, kind in enumerate(self.cfg.attn_layers)
                         if kind == 'local')

    def compute_params(self, params: Params) -> Params:
        """A view of `params` with the matmul weights cast once to the compute
        dtype (biases, layer norms and axial embeddings stay f32).  Every
        function casts its weights itself, so this changes no result."""
        dt = self.cfg.compute_dtype

        def attn(p):
            return {**p, **{k: p[k].to(dt) for k in ('q', 'qk', 'k', 'v', 'o') if k in p}}

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
        h = self._trunk(params, input_ids, pad_mask, generator, deterministic)
        with span('model.head'):
            return self._lm_head(params, layer_norm(params['ln_f'], h, eps=self.cfg.ln_eps))

    def _trunk(self, params: Params, input_ids: torch.Tensor, pad_mask: Optional[torch.Tensor],
               generator: Optional[torch.Generator], deterministic: bool) -> torch.Tensor:
        """The embedding and the layers: hidden states [B, T, d] (both
        streams, [B, T, 2d], with `hf_compat`) before the final norm."""
        cfg = self.cfg
        dtype = cfg.compute_dtype
        B, T = input_ids.shape
        if T % cfg.local_chunk or T % cfg.lsh_chunk:
            raise ValueError(f'T={T} must be a multiple of the chunk sizes')
        h = params['embed']['weight'].to(dtype)[input_ids.long()]
        h = h + self._pos_emb(params, T, dtype)[None]

        def block(fn, *args):
            return remat(fn, *args) if cfg.remat else fn(*args)
        if cfg.hf_compat:
            # reversible two-stream residuals (HF's layout), both streams
            # starting from the embedding: Y1 = X1 + attn(LN X2), Y2 = X2 +
            # ff(LN Y1); autograd runs through them, as in the JAX model
            x1 = x2 = h
            for li, layer in enumerate(params['layers']):
                with span('model.attn'):
                    a = block(self._attn_block, layer['attn'], cfg.attn_layers[li], li, x2,
                              pad_mask)
                    x1 = x1 + dropout(a, cfg.dropout, generator, deterministic)
                with span('model.ffn'):
                    f = block(self._ffn_block, layer['ffn'], x1)
                    x2 = x2 + dropout(f, cfg.dropout, generator, deterministic)
            return torch.cat([x1, x2], dim=-1)
        for li, layer in enumerate(params['layers']):
            with span('model.attn'):
                a = block(self._attn_block, layer['attn'], cfg.attn_layers[li], li, h, pad_mask)
                h = h + dropout(a, cfg.dropout, generator, deterministic)
            with span('model.ffn'):
                f = block(self._ffn_block, layer['ffn'], h)
                h = h + dropout(f, cfg.dropout, generator, deterministic)
        return h

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
        x = copy_to_model(layer_norm(p['ln'], h, eps=cfg.ln_eps), self.mesh)
        v = self._proj(x, p['v'])
        if kind == 'local':
            # HF's local layers have their own query; native ones share 'qk'
            ctx = local_attention(self._proj(x, p.get('q', p['qk'])), self._proj(x, p['k']), v,
                                  chunk=cfg.local_chunk, pad_mask=pad_mask)
        else:
            qk = self._proj(x, p['qk'])
            T = h.shape[1]
            nb = cfg.lsh_buckets_at(T)
            rots = lsh_rotations(cfg.lsh_seed, layer_idx, cfg.n_hashes, cfg.d_head, nb,
                                 h.device)
            ctx = lsh_attention(qk, v, chunk=cfg.lsh_chunk, n_hashes=cfg.n_hashes,
                                n_buckets=nb, rots=rots, pad_mask=pad_mask)
        B, N, T, H = ctx.shape
        o = p['o'].to(h.dtype).reshape(N * H, -1)
        return sum_over_model(ctx.transpose(1, 2).reshape(B, T, N * H) @ o, self.mesh)

    def _ffn_block(self, p: Params, h: torch.Tensor) -> torch.Tensor:
        x = copy_to_model(layer_norm(p['ln'], h, eps=self.cfg.ln_eps), self.mesh)
        return dense(p['w2'], dense(p['w1'], x, act='relu'), self.mesh)

    # ------------------------------------------------------------------ loss
    def loss(self, params: Params, input_ids: torch.Tensor, labels: torch.Tensor,
             generator: Optional[torch.Generator] = None, deterministic: bool = True,
             n_seg: int = 1, pad_id: Optional[int] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """CLM loss + aux metrics.  n_seg is the Trainer's TF-XL knob and is
        ignored here, as in the JAX model; pad_id masks pad keys."""
        pad_mask = (input_ids != pad_id) if pad_id is not None else None
        h = self._trunk(params, input_ids, pad_mask, generator, deterministic)
        with span('model.head'):
            logits = self._lm_head(params, layer_norm(params['ln_f'], h, eps=self.cfg.ln_eps))
            loss, n_tok = shifted_ce_loss(logits, labels)
            preds = logits.argmax(dim=-1)
            return global_loss(loss, dict(ntp_acc=ntp_accuracy(preds, labels), n_tok=n_tok,
                                          preds=preds), labels, self.mesh)

    # ---------------------------------------------------------------- decode
    def _n_kind(self) -> Tuple[int, int]:
        kinds = self.cfg.attn_layers
        return kinds.count('local'), kinds.count('lsh')

    def init_decode_state(self, batch_size: int) -> ReformerDecodeState:
        cfg = self.cfg
        if cfg.decode_mode not in ('scan', 'bounded'):
            raise ValueError(f"decode_mode is 'scan' or 'bounded': {cfg.decode_mode!r}")
        quant = cfg.decode_cache_quant == 'int8'
        bounded = cfg.decode_mode == 'bounded'
        if quant and bounded:
            raise ValueError("decode_cache_quant='int8' supports only decode_mode='scan' "
                             "(the bounded decode gathers single rows, not streams)")
        if cfg.max_length % (cfg.decode_scan_chunk or cfg.max_length):
            raise ValueError(f'decode_scan_chunk {cfg.decode_scan_chunk} does not divide '
                             f'max_length {cfg.max_length}')
        n_local, n_lsh = self._n_kind()
        B, N, H, L, R = batch_size, cfg.n_head, cfg.d_head, cfg.max_length, cfg.n_hashes
        dt, dev = cfg.compute_dtype, self.device
        nb = cfg.lsh_buckets_at(L)
        if nb >= 32767:
            raise ValueError(f'{nb} buckets do not fit the int16 bucket cache')
        lsh_dt = torch.int8 if quant else dt

        def scales():
            return torch.zeros(n_lsh, B, N, L, dtype=torch.float32, device=dev) if quant else None

        def unused(dtype):
            return torch.zeros(n_lsh, B, 1, 1, 1, dtype=dtype, device=dev)
        return ReformerDecodeState(
            local_k=torch.zeros(n_local, B, N, 2 * cfg.local_chunk, H, dtype=dt, device=dev),
            local_v=torch.zeros(n_local, B, N, 2 * cfg.local_chunk, H, dtype=dt, device=dev),
            lsh_k=torch.zeros(n_lsh, B, N, L, H, dtype=lsh_dt, device=dev),
            lsh_v=torch.zeros(n_lsh, B, N, L, H, dtype=lsh_dt, device=dev),
            lsh_buckets=(unused(torch.int16) if bounded else
                         torch.full((n_lsh, B, N, R, L), -1, dtype=torch.int16, device=dev)),
            lsh_ring=(torch.full((n_lsh, B, N, R, nb * cfg.decode_window), -1,
                                 dtype=torch.int32, device=dev)
                      if bounded else unused(torch.int32)),
            lsh_cnt=(torch.zeros(n_lsh, B, N, R, nb, dtype=torch.int32, device=dev)
                     if bounded else unused(torch.int32)),
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
        """token_ids [B] -> (logits f32 [B, V], the final norm's output
        [B, hidden_dim], next state).  Exact against `forward` while the
        position is in the first chunk."""
        cfg = self.cfg
        dtype = cfg.compute_dtype
        t, L = state.step, cfg.max_length
        if t >= L:
            raise ValueError(f'decode step {t} is past max_length {L}')
        scale = 1.0 / (cfg.d_head ** 0.5)
        h = params['embed']['weight'].to(dtype)[token_ids.long()]
        h = h + self._pos_emb_row(params, t, dtype)[None]
        x1 = h                      # hf_compat: the first stream; h carries the second
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
            v = proj(p['v'])
            if cfg.attn_layers[li] == 'local':
                q = proj(p.get('q', p['qk']))
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
                q = proj(p['qk'])
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
                chunk_start = (t // cfg.lsh_chunk) * cfg.lsh_chunk
                if cfg.decode_mode == 'bounded':
                    ctx = self._lsh_attend_bounded(q, sk[ish], sv[ish], state.lsh_ring[ish],
                                                   state.lsh_cnt[ish], bt, t, chunk_start, nb)
                else:
                    sb[ish, :, :, :, t] = bt.to(sb.dtype)
                    ctx = self._lsh_attend_scan(
                        q, sk[ish], sv[ish], sb[ish], bt.to(sb.dtype), t, chunk_start,
                        sks[ish] if quant else None, svs[ish] if quant else None)
                ish += 1
            a = ctx.reshape(B, N * H) @ p['o'].to(dtype).reshape(N * H, cfg.d_model)
            fp = layer['ffn']
            if cfg.hf_compat:
                # Y1 = X1 + attn(LN X2); Y2 = X2 + ff(LN Y1)
                x1 = x1 + a
                xf = layer_norm(fp['ln'], x1, eps=cfg.ln_eps)
            else:
                h = h + a
                xf = layer_norm(fp['ln'], h, eps=cfg.ln_eps)
            h = h + dense(fp['w2'], dense(fp['w1'], xf, act='relu'))
        if cfg.hf_compat:
            h = torch.cat([x1, h], dim=-1)
        h = layer_norm(params['ln_f'], h, eps=cfg.ln_eps)
        return self._lm_head(params, h), h, state._replace(step=t + 1)

    def _lsh_scores(self, q, sk, sb, bt, t: int, chunk_start: int, k_scale, lo: int,
                    hi: int):
        """Scores of q [B, N, H] against the cache's positions [lo, hi) per
        hash round, -> (sc [B, N, R, hi - lo] f32 with NEG_INF where masked,
        mask).  A key is visible up to t when it shares the query's bucket
        or lies in the current chunk; the self key carries SELF_BIAS.  The
        scores read the cache as stored; int8 row scales fold back in."""
        sl = slice(lo, hi)
        pos = torch.arange(lo, hi, device=q.device)
        sc0 = torch.einsum('bnh,bnlh->bnl', q.float(),
                           sk[:, :, sl].to(self.cfg.compute_dtype).float())
        if k_scale is not None:
            sc0 = sc0 * k_scale[..., sl]
        sc0 = torch.where(pos == t, sc0 + SELF_BIAS, sc0)
        mask = (pos <= t) & ((sb[..., sl] == bt[..., None]) | (pos >= chunk_start))
        sc = torch.where(mask, sc0[:, :, None], torch.full_like(sc0[:, :, None], NEG_INF))
        return sc, mask

    def _lsh_attend_scan(self, q, sk, sv, sb, bt, t: int, chunk_start: int, k_scale, v_scale):
        """'scan' LSH attention of one step over the cache: q [B, N, H];
        sk, sv [B, N, L, H]; sb [B, N, R, L] bucket ids; bt [B, N, R] this
        step's buckets; k_scale, v_scale [B, N, L] for int8 caches, else
        None.  Keys of the query's bucket up to t and the whole current chunk
        are attended; each hash round normalizes on its own, and the rounds
        combine by the softmax of their logsumexps.  Returns ctx [B, N, H]."""
        cfg = self.cfg
        dtype = cfg.compute_dtype
        L = cfg.max_length
        CH = cfg.decode_scan_chunk or L
        if CH == L:
            # one pass over the whole cache; the rounds fold into the
            # probabilities before the V product, so V is read once
            sc, _ = self._lsh_scores(q, sk, sb, bt, t, chunk_start, k_scale, 0, L)
            lse = torch.logsumexp(sc, dim=-1)                               # [B, N, R]
            pr = torch.exp(sc - lse[..., None])
            if cfg.n_hashes > 1:
                pr = pr * torch.softmax(lse, dim=-1)[..., None]
            prc = pr.sum(dim=2)                                             # [B, N, L]
            if v_scale is not None:
                prc = prc * v_scale
            return torch.einsum('bnl,bnlh->bnh', prc.to(dtype).float(),
                                sv.to(dtype).float()).to(dtype)
        # streamed: only the live prefix, CH positions at a time, with a
        # running max / sum / accumulator per round (f32)
        B, N, R, H = q.shape[0], q.shape[1], cfg.n_hashes, q.shape[2]
        dev = q.device
        m_run = torch.full((B, N, R), NEG_INF, dtype=torch.float32, device=dev)
        l_run = torch.zeros(B, N, R, dtype=torch.float32, device=dev)
        acc = torch.zeros(B, N, R, H, dtype=torch.float32, device=dev)
        for off in range(0, (t // CH + 1) * CH, CH):
            sl = slice(off, off + CH)
            sc, mask = self._lsh_scores(q, sk, sb, bt, t, chunk_start, k_scale, off, off + CH)
            m_new = torch.maximum(m_run, sc.amax(dim=-1))
            # the mask on p itself: a chunk with no visible key would
            # otherwise weigh exp(NEG_INF - NEG_INF) = 1 per entry while no
            # earlier chunk has raised the running max above the mask value
            pv = torch.where(mask, torch.exp(sc - m_new[..., None]), torch.zeros_like(sc))
            alpha = torch.exp(m_run - m_new)
            l_run = l_run * alpha + pv.sum(dim=-1)
            if v_scale is not None:
                pv = pv * v_scale[..., sl][:, :, None]
            acc = acc * alpha[..., None] + torch.einsum(
                'bnrl,bnlh->bnrh', pv.to(dtype).float(), sv[:, :, sl].to(dtype).float())
            m_run = m_new
        lse = m_run + torch.log(l_run.clamp(min=1e-30))
        ctx_r = acc / l_run.clamp(min=1e-30)[..., None]
        if R > 1:
            return (torch.softmax(lse, dim=-1)[..., None] * ctx_r).sum(dim=2).to(dtype)
        return ctx_r[:, :, 0].to(dtype)

    def _lsh_attend_bounded(self, q, sk, sv, ring, cnt, bt, t: int, chunk_start: int,
                            nb: int) -> torch.Tensor:
        """'bounded' LSH attention of one step: q [B, N, H]; sk, sv
        [B, N, L, H]; ring [B, N, R, nb * W] and cnt [B, N, R, nb] (this
        layer's, updated in place); bt [B, N, R].  Each round attends its own
        bucket's latest W positions before the current chunk, plus the chunk;
        the rounds combine by the softmax of their logsumexps.  Then t joins
        its bucket's ring.  Returns ctx [B, N, H]."""
        cfg = self.cfg
        dtype = cfg.compute_dtype
        R, W, c = cfg.n_hashes, cfg.decode_window, cfg.lsh_chunk
        B, N, H = q.shape
        dev = q.device
        slot_idx = bt[..., None] * W + torch.arange(W, device=dev)          # [B, N, R, W]
        cand = torch.gather(ring, -1, slot_idx).long()                      # [B, N, R, W]
        cand_ok = (cand >= 0) & (cand < chunk_start)       # the chunk covers the rest
        ccpos = chunk_start + torch.arange(c, device=dev)
        chunk_ok = (ccpos <= t).expand(B, N, c)
        posS = torch.cat([cand.reshape(B, N, R * W), ccpos.expand(B, N, c)], dim=-1)
        idx = posS.clamp(min=0).long()[..., None].expand(B, N, R * W + c, H)
        k_sel = torch.gather(sk, 2, idx)                                    # [B, N, S, H]
        v_sel = torch.gather(sv, 2, idx)
        s = torch.einsum('bnh,bnsh->bns', q.float(), k_sel.float())         # keys carry scale
        s = torch.where(posS == t, s + SELF_BIAS, s)
        none = torch.zeros(B, N, W, dtype=torch.bool, device=dev)
        lses, prs = [], []
        for r in range(R):
            m = torch.cat([cand_ok[:, :, r] if rr == r else none for rr in range(R)]
                          + [chunk_ok], dim=-1)
            sc = torch.where(m, s, torch.full_like(s, NEG_INF))
            lse = torch.logsumexp(sc, dim=-1)                               # [B, N]
            lses.append(lse)
            prs.append(torch.exp(sc - lse[..., None]))
        if R == 1:
            pr = prs[0]
        else:
            w = torch.softmax(torch.stack(lses, dim=-1), dim=-1)            # [B, N, R]
            pr = sum(w[..., r:r + 1] * prs[r] for r in range(R))
        ctx = torch.einsum('bns,bnsh->bnh', pr.to(dtype).float(), v_sel.float()).to(dtype)

        # t joins its bucket's ring: a one-hot select, as in the JAX model
        cnt_b = torch.gather(cnt, -1, bt[..., None])[..., 0]                # [B, N, R]
        j = bt * W + cnt_b % W
        ring.copy_(torch.where(torch.arange(nb * W, device=dev) == j[..., None],
                               torch.full_like(ring, t), ring))
        cnt.copy_(torch.where(torch.arange(nb, device=dev) == bt[..., None],
                              cnt_b[..., None] + 1, cnt))
        return ctx

    @property
    def hidden_dim(self) -> int:
        """Width of decode_step_with_hidden's hidden output: both streams
        under hf_compat."""
        return (2 if self.cfg.hf_compat else 1) * self.cfg.d_model

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


_CACHES = ('local_k', 'local_v', 'lsh_k', 'lsh_v', 'lsh_buckets', 'lsh_ring', 'lsh_cnt',
           'lsh_k_scale', 'lsh_v_scale')
