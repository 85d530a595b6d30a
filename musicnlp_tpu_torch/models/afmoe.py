"""The Trinity sparse-expert language model (`model_type` 'afmoe') in PyTorch.

Arcee's Trinity-Mini / Trinity-Large block, as the public `afmoe` model
code writes it, over the port's music vocabularies:

  h = embed[ids] * sqrt(d)                          (muP embedding scale)
  per layer, sandwich norms:
    h = h + norm_post_attn(Attn(norm_in(h)))
    h = h + norm_post_mlp(MLP(norm_pre_mlp(h)))
  logits = norm_final(h) @ W_head                   (an untied head)

Attn: bias-free projections to `num_attention_heads` query heads and
`num_key_value_heads` key / value heads of `head_dim`, an RMSNorm over the
head dim on q and on k, rotary positions (`rope_theta`) on q and k in
'sliding_attention' layers only (the 'full_attention' layers use none),
causal softmax at 1 / sqrt(head_dim) with query head h reading key head h //
(heads per key head), the sliding layers' keys within `sliding_window`;
the context times sigmoid(x W_gate), then the output projection.  The
attention core runs through the grouped-query form of K1 / K2
(`ops/flash_attention.GqaAttn`).  MLP: the bias-free SwiGLU of width
`intermediate_size` in the first `num_dense_layers` layers, then the expert
layer (`ops/moe.py`): sigmoid routing over `num_experts`, the top
`num_experts_per_tok` by score plus `expert_bias`, the chosen scores
normalised and times `route_scale`, plus `num_shared_experts` shared
experts of width `moe_intermediate_size` each.

Expert parallelism is the chip's share: this model holds `n_experts_held`
experts of each expert layer from `expert_offset`, routes over all
`num_experts`, and passes on what its experts and the shared expert give.
`expert_bias` (one row of `num_experts` per expert layer, zeros) is model
state outside the trained parameters: the forward reads it, no gradient or
rule moves it.  Computation is in `dtype` over f32 parameters, with
float32 norms, rotary positions, router scores and logits.  No dropout.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from musicnlp_tpu_torch import resolve_device
from musicnlp_tpu_torch.ops.flash_attention import GqaAttn
from musicnlp_tpu_torch.ops.layers import Params, f32_matmul, mlp, rms_norm, rope, rope_tables
from musicnlp_tpu_torch.ops.losses import ntp_accuracy, shifted_ce_loss
from musicnlp_tpu_torch.ops.moe import moe
from musicnlp_tpu_torch.parallel.mesh import Mesh, global_loss
from musicnlp_tpu_torch.utils.checkpoint import params_from_jax
from musicnlp_tpu_torch.utils.profiling import span

__all__ = ['AfmoeConfig', 'AfmoeLM']

_DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32, 'float16': torch.float16}
SLIDING, FULL = 'sliding_attention', 'full_attention'


@dataclass(frozen=True)
class AfmoeConfig:
    """The published `afmoe` keys this block reads (Trinity-Mini's values
    by default, its first eight layers), the expert share this model holds
    (`n_experts_held` from `expert_offset`), and the port's own: `max_length`,
    `init_std`, `dtype`, `dropout` (0: the family has none)."""
    vocab_size: int = 1190
    hidden_size: int = 2048
    num_hidden_layers: int = 8
    num_attention_heads: int = 32
    num_key_value_heads: int = 4
    head_dim: int = 128
    intermediate_size: int = 6144
    moe_intermediate_size: int = 1024
    num_dense_layers: int = 2
    num_experts: int = 128
    num_experts_per_tok: int = 8
    num_shared_experts: int = 1
    route_scale: float = 2.826
    route_norm: bool = True
    score_func: str = 'sigmoid'
    layer_types: Tuple[str, ...] = (SLIDING,) * 3 + (FULL,) + (SLIDING,) * 3 + (FULL,)
    sliding_window: int = 2048
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    mup_enabled: bool = True
    tie_word_embeddings: bool = False
    n_experts_held: int = 16
    expert_offset: int = 0
    max_length: int = 8192
    init_std: float = 0.02
    dtype: str = 'bfloat16'
    dropout: float = 0.0

    def __post_init__(self):
        if len(self.layer_types) != self.num_hidden_layers or not set(self.layer_types) <= {
                SLIDING, FULL}:
            raise ValueError(f'layer_types {self.layer_types} is not {self.num_hidden_layers} of '
                             f'{SLIDING!r} / {FULL!r}')
        if self.num_attention_heads % self.num_key_value_heads:
            raise ValueError('num_key_value_heads must divide num_attention_heads')
        if not 0 <= self.expert_offset <= self.num_experts - self.n_experts_held:
            raise ValueError(f'experts [{self.expert_offset}, +{self.n_experts_held}) are not '
                             f'among the {self.num_experts}')
        if (self.score_func != 'sigmoid' or not self.route_norm or self.tie_word_embeddings
                or self.dropout):
            raise ValueError('the afmoe block here scores by sigmoid, normalises the chosen '
                             'weights, unties its head and has no dropout')

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def n_moe_layers(self) -> int:
        return max(self.num_hidden_layers - self.num_dense_layers, 0)


class AfmoeLM:
    """Model namespace over explicit parameters, as the port's other models."""

    def __init__(self, config: AfmoeConfig, device: Optional[Union[str, torch.device]] = None,
                 mesh: Optional[Mesh] = None):
        self.cfg = config
        self.device = resolve_device(device)
        self.mesh = mesh
        # the routing bias of each expert layer: state, not a trained leaf
        self.expert_bias = torch.zeros(config.n_moe_layers, config.num_experts,
                                       device=self.device)

    def unread_leaves(self) -> frozenset:
        """Flat keys of the leaves the loss never reads: none."""
        return frozenset()

    # ------------------------------------------------------------------ init
    def init_flat(self, seed: int = 0) -> Dict[str, np.ndarray]:
        """Random parameters made with numpy from `seed` under flat keys:
        normal(0, init_std) matrices, unit norm scales."""
        c = self.cfg
        rng = np.random.default_rng(seed)
        D, N, NK, H = c.hidden_size, c.num_attention_heads, c.num_key_value_heads, c.head_dim

        def normal(*shape):
            return rng.standard_normal(shape, dtype=np.float32) * c.init_std

        def ones(n):
            return np.ones(n, np.float32)

        def swiglu(prefix, F, lead=()):
            return {f'{prefix}/gate': normal(*lead, D, F), f'{prefix}/up': normal(*lead, D, F),
                    f'{prefix}/down': normal(*lead, F, D)}

        flat = {'embed/weight': normal(c.vocab_size, D), 'lm_head/w': normal(D, c.vocab_size),
                'norm': ones(D)}
        for li in range(c.num_hidden_layers):
            pre = f'layers/{li}'
            flat.update({f'{pre}/attn/q': normal(D, N * H), f'{pre}/attn/k': normal(D, NK * H),
                         f'{pre}/attn/v': normal(D, NK * H), f'{pre}/attn/gate': normal(D, N * H),
                         f'{pre}/attn/o': normal(N * H, D), f'{pre}/attn/q_norm': ones(H),
                         f'{pre}/attn/k_norm': ones(H)})
            for k in ('input_norm', 'post_attn_norm', 'pre_mlp_norm', 'post_mlp_norm'):
                flat[f'{pre}/{k}'] = ones(D)
            if li < c.num_dense_layers:
                flat.update(swiglu(f'{pre}/mlp', c.intermediate_size))
            else:
                flat[f'{pre}/moe/router'] = normal(D, c.num_experts)
                flat.update(swiglu(f'{pre}/moe/experts', c.moe_intermediate_size,
                                   (c.n_experts_held,)))
                flat.update(swiglu(f'{pre}/moe/shared',
                                   c.moe_intermediate_size * c.num_shared_experts))
        return flat

    def init(self, seed: int = 0) -> Params:
        return params_from_jax(self.init_flat(seed), self.device)

    # --------------------------------------------------------------- forward
    def _attention(self, p: Params, x: torch.Tensor, sliding: bool, rot) -> torch.Tensor:
        """Attn(x) [B, T, d] of one layer (no norms, no residual)."""
        c = self.cfg
        B, T, D = x.shape
        N, NK, H, dt = c.num_attention_heads, c.num_key_value_heads, c.head_dim, x.dtype
        q = (x @ p['q'].to(dt)).view(B, T, N, H)
        k = (x @ p['k'].to(dt)).view(B, T, NK, H)
        v = (x @ p['v'].to(dt)).view(B, T, NK, H)
        gate = x @ p['gate'].to(dt)
        q = rms_norm(q, p['q_norm'], eps=c.rms_norm_eps)
        k = rms_norm(k, p['k_norm'], eps=c.rms_norm_eps)
        if sliding:
            q, k = rope(q, *rot), rope(k, *rot)
        # reshape alone may return a strided view; the kernels take dense rows
        q3 = q.transpose(1, 2).reshape(B * N, T, H).contiguous()
        k3 = k.transpose(1, 2).reshape(B * NK, T, H).contiguous()
        v3 = v.transpose(1, 2).reshape(B * NK, T, H).contiguous()
        ctx = GqaAttn.apply(q3, k3, v3, N // NK, H ** -0.5, c.sliding_window if sliding else 0)
        ctx = ctx.view(B, N, T, H).transpose(1, 2).reshape(B, T, N * H)
        return (ctx * torch.sigmoid(gate)) @ p['o'].to(dt)

    def forward_hidden(self, params: Params, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids [B, T] -> the final norm's output [B, T, d]."""
        c = self.cfg
        eps, dt = c.rms_norm_eps, c.compute_dtype
        B, T = input_ids.shape
        # gathered from the f32 table: its gradient rows sum in f32
        h = params['embed']['weight'][input_ids.long()]
        h = (h * c.hidden_size ** 0.5 if c.mup_enabled else h).to(dt)
        rot = rope_tables(T, c.head_dim, c.rope_theta, h.device)
        for li, p in enumerate(params['layers']):
            with span('model.attn'):
                a = self._attention(p['attn'], rms_norm(h, p['input_norm'], eps=eps),
                                    c.layer_types[li] == SLIDING, rot)
                h = h + rms_norm(a, p['post_attn_norm'], eps=eps)
            if li < c.num_dense_layers:
                with span('model.ffn'):
                    f = mlp(p['mlp'], rms_norm(h, p['pre_mlp_norm'], eps=eps))
                    h = h + rms_norm(f, p['post_mlp_norm'], eps=eps)
            else:
                with span('model.moe'):
                    x = rms_norm(h, p['pre_mlp_norm'], eps=eps).reshape(B * T, -1)
                    f = moe(p['moe'], x, self.expert_bias[li - c.num_dense_layers],
                            top_k=c.num_experts_per_tok, route_scale=c.route_scale,
                            n_held=c.n_experts_held, offset=c.expert_offset)
                    h = h + rms_norm(f.view(B, T, -1), p['post_mlp_norm'], eps=eps)
        return rms_norm(h, params['norm'], eps=eps)

    def _lm_head(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        """The untied head: f32 logits [B, T, V] from compute-dtype operands
        with f32 accumulation."""
        B, T, D = h.shape
        return f32_matmul(h.reshape(B * T, D), params['lm_head']['w']).view(B, T, -1)

    def forward(self, params: Params, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids [B, T] -> f32 logits [B, T, V]."""
        h = self.forward_hidden(params, input_ids)
        with span('model.head'):
            return self._lm_head(params, h)

    # ------------------------------------------------------------------ loss
    def loss(self, params: Params, input_ids: torch.Tensor, labels: torch.Tensor,
             generator: Optional[torch.Generator] = None, deterministic: bool = True,
             n_seg: int = 1) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """CLM loss and NTP accuracy over dense logits; the family has no
        dropout (`generator` draws nothing) and trains whole rows (n_seg 1)."""
        if n_seg != 1:
            raise ValueError('the afmoe model trains whole rows: n_seg must be 1')
        if self.mesh is not None and self.mesh.n_model > 1:
            raise ValueError('the afmoe model has no tensor-parallel form: model axis 1 only')
        h = self.forward_hidden(params, input_ids)
        with span('model.head'):
            logits = self._lm_head(params, h)
            loss, n_tok = shifted_ce_loss(logits, labels)
            preds = logits.argmax(dim=-1)
            return global_loss(loss, dict(ntp_acc=ntp_accuracy(preds, labels), n_tok=n_tok,
                                          preds=preds), labels, self.mesh)
