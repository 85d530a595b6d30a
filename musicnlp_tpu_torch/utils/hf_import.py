"""HF checkpoint import / export for both model families.

Counterpart of `musicnlp_tpu/utils/hf_import.py`.  A user of the reference
stack (HF `TransfoXLLMHeadModel` and `ReformerModelWithLMHead`) brings a
trained torch checkpoint into the port, and takes one back out, weight for
weight:

  * TF-XL: the trunk (embedding, per-layer qkv / r / o projections, the
    r_w / r_r biases, layer norms, FFN) maps by transpose and reshape only;
    the adaptive-softmax head (the reference sets cutoffs=[1000] for vocab
    >= 1000) maps onto `TransfoXLConfig.adaptive_cutoffs` and the `adaptive`
    parameter group, and HF's default `same_length=True` onto `attn_window`
    = mem_len.  Only div_val == 1 with d_proj == d_embed and a tied output
    embedding (the reference's layout) is supported; anything else raises.
  * Reformer: `ReformerConfig(hf_compat=True)`, the reversible two-stream
    layout with a [2 d] final norm and untied head and a separate query in
    local layers.  HF draws its LSH rotations from unseeded torch RNG; the
    port uses the JAX model's fixed (seed, layer) draws, so outputs agree
    exactly where bucketing cannot matter (a sequence within one LSH chunk)
    and are the same estimator elsewhere.

The import functions take a model or a state dict (torch tensors or numpy
arrays) with a config object that has HF's attribute names, and return the
JAX package's nested numpy parameters leaf for leaf; `params_from_jax`
places them on a device.  `transformers` is imported only by the export
functions, inside them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from musicnlp_tpu_torch.models.reformer import ReformerConfig
from musicnlp_tpu_torch.models.transformer_xl import TransfoXLConfig

__all__ = ['from_hf_transfo_xl', 'to_hf_transfo_xl', 'from_hf_reformer', 'to_hf_reformer']


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def _state_dict(model_or_state) -> Dict[str, np.ndarray]:
    sd = (model_or_state.state_dict() if hasattr(model_or_state, 'state_dict')
          else model_or_state)
    return {k: _np(v) for k, v in sd.items()}


def _hf_config(model_or_state, hf_config):
    if hf_config is None:
        hf_config = getattr(model_or_state, 'config', None)
        if hf_config is None:
            raise ValueError('pass hf_config when importing a bare state dict')
    return hf_config


def _torch(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))    # a copy: read-only views warn


def from_hf_transfo_xl(model_or_state, *, hf_config=None, max_length: Optional[int] = None,
                       **config_overrides) -> Tuple[TransfoXLConfig, Dict[str, Any]]:
    """HF TransfoXLLMHeadModel (or its state dict and `hf_config`) ->
    (config, nested numpy parameters)."""
    hc = _hf_config(model_or_state, hf_config)
    sd = _state_dict(model_or_state)
    if getattr(hc, 'div_val', 1) != 1:
        raise NotImplementedError('div_val != 1 is not a reference layout')
    if hc.d_embed != hc.d_model:
        raise NotImplementedError('d_proj != d_embed is not a reference layout')
    N, H, d = hc.n_head, hc.d_head, hc.d_model
    cutoffs = tuple(int(c) for c in (hc.cutoffs or []) if c < hc.vocab_size)

    embed = sd['transformer.word_emb.emb_layers.0.weight']       # [V, d]
    out_w = sd.get('crit.out_layers.0.weight')
    if out_w is not None and not np.allclose(out_w, embed, atol=1e-6):
        raise NotImplementedError('an untied output embedding (tie_weight=False) is not '
                                  'supported by the tied head')

    layers = []
    for i in range(hc.n_layer):
        p = f'transformer.layers.{i}.'
        if getattr(hc, 'untie_r', True):
            rw, rr = sd[p + 'dec_attn.r_w_bias'], sd[p + 'dec_attn.r_r_bias']
        else:
            rw, rr = sd['transformer.r_w_bias'], sd['transformer.r_r_bias']
        layers.append(dict(
            attn=dict(
                qkv=sd[p + 'dec_attn.qkv_net.weight'].T.reshape(d, 3, N, H),
                r=sd[p + 'dec_attn.r_net.weight'].T.reshape(d, N, H),
                o=sd[p + 'dec_attn.o_net.weight'].T.reshape(N, H, d),
                r_w_bias=rw.reshape(N, H),
                r_r_bias=rr.reshape(N, H),
                ln=dict(scale=sd[p + 'dec_attn.layer_norm.weight'],
                        bias=sd[p + 'dec_attn.layer_norm.bias']),
            ),
            ffn=dict(
                w1=dict(w=sd[p + 'pos_ff.CoreNet.0.weight'].T,
                        b=sd[p + 'pos_ff.CoreNet.0.bias']),
                w2=dict(w=sd[p + 'pos_ff.CoreNet.3.weight'].T,
                        b=sd[p + 'pos_ff.CoreNet.3.bias']),
                ln=dict(scale=sd[p + 'pos_ff.layer_norm.weight'],
                        bias=sd[p + 'pos_ff.layer_norm.bias']),
            ),
        ))
    params: Dict[str, Any] = dict(embed=dict(weight=embed), layers=layers,
                                  out_bias=sd['crit.out_layers.0.bias'])
    if cutoffs:
        params['adaptive'] = dict(cluster_w=sd['crit.cluster_weight'],
                                  cluster_b=sd['crit.cluster_bias'])

    # HF's same_length=True default (which the reference never overrides)
    # makes its models attend a fixed mem_len-wide window, not full causal
    # context: attn_window reproduces it
    window = max(1, hc.mem_len) if getattr(hc, 'same_length', True) else None
    cfg = TransfoXLConfig(
        vocab_size=hc.vocab_size, model_size='hf-import', d_model=d, n_head=N, d_head=H,
        d_inner=hc.d_inner, n_layer=hc.n_layer, mem_len=max(1, hc.mem_len),
        clamp_len=hc.clamp_len, max_length=max_length or max(hc.mem_len, 1) * 8,
        dropout=hc.dropout, pre_lnorm=bool(getattr(hc, 'pre_lnorm', False)),
        adaptive_cutoffs=cutoffs or None, attn_window=window, **config_overrides)
    return cfg, params


def to_hf_transfo_xl(cfg: TransfoXLConfig, params: Dict[str, Any]):
    """(config, parameters: numpy arrays or tensors) -> HF TransfoXLLMHeadModel
    with the same weights.  The dense tied head exports as a single-cluster
    (cutoffs=[]) HF model; adaptive parameters keep their cutoffs."""
    if cfg.attn_window is not None and cfg.attn_window != cfg.mem_len:
        raise NotImplementedError('HF same_length can only express attn_window == mem_len')
    from transformers import TransfoXLConfig as HFConfig
    from transformers import TransfoXLLMHeadModel

    cuts = list(cfg.adaptive_cutoffs or [])
    hc = HFConfig(
        vocab_size=cfg.vocab_size, d_model=cfg.d_model, d_embed=cfg.d_model,
        n_head=cfg.n_head, d_head=cfg.d_head, d_inner=cfg.d_inner, n_layer=cfg.n_layer,
        mem_len=cfg.mem_len, clamp_len=cfg.clamp_len, cutoffs=cuts, div_val=1, untie_r=True,
        dropout=cfg.dropout, dropatt=cfg.dropatt, pre_lnorm=cfg.pre_lnorm,
        same_length=cfg.attn_window is not None)
    model = TransfoXLLMHeadModel(hc)
    N, H, d = cfg.n_head, cfg.d_head, cfg.d_model
    embed = _np(params['embed']['weight'])
    new = {'transformer.word_emb.emb_layers.0.weight': _torch(embed),
           'crit.out_layers.0.weight': _torch(embed),
           'crit.out_layers.0.bias': _torch(_np(params['out_bias']))}
    if cuts:
        new['crit.cluster_weight'] = _torch(_np(params['adaptive']['cluster_w']))
        new['crit.cluster_bias'] = _torch(_np(params['adaptive']['cluster_b']))
    for i, layer in enumerate(params['layers']):
        p = f'transformer.layers.{i}.'
        a, f = layer['attn'], layer['ffn']
        new.update({
            p + 'dec_attn.qkv_net.weight': _torch(_np(a['qkv']).reshape(d, 3 * N * H).T),
            p + 'dec_attn.r_net.weight': _torch(_np(a['r']).reshape(d, N * H).T),
            p + 'dec_attn.o_net.weight': _torch(_np(a['o']).reshape(N * H, d).T),
            p + 'dec_attn.r_w_bias': _torch(_np(a['r_w_bias'])),
            p + 'dec_attn.r_r_bias': _torch(_np(a['r_r_bias'])),
            p + 'dec_attn.layer_norm.weight': _torch(_np(a['ln']['scale'])),
            p + 'dec_attn.layer_norm.bias': _torch(_np(a['ln']['bias'])),
            p + 'pos_ff.CoreNet.0.weight': _torch(_np(f['w1']['w']).T),
            p + 'pos_ff.CoreNet.0.bias': _torch(_np(f['w1']['b'])),
            p + 'pos_ff.CoreNet.3.weight': _torch(_np(f['w2']['w']).T),
            p + 'pos_ff.CoreNet.3.bias': _torch(_np(f['w2']['b'])),
            p + 'pos_ff.layer_norm.weight': _torch(_np(f['ln']['scale'])),
            p + 'pos_ff.layer_norm.bias': _torch(_np(f['ln']['bias'])),
        })
    sd = model.state_dict()
    sd.update(new)
    model.load_state_dict(sd)
    return model


# --------------------------------------------------------------- Reformer
def from_hf_reformer(model_or_state, *, hf_config=None,
                     **config_overrides) -> Tuple[ReformerConfig, Dict[str, Any]]:
    """HF ReformerModelWithLMHead (or its state dict and `hf_config`) ->
    (ReformerConfig(hf_compat=True), nested numpy parameters).  Imported
    models score, train (autograd through the reversible stack) and decode
    through the same entry points as native ones."""
    hc = _hf_config(model_or_state, hf_config)
    sd = _state_dict(model_or_state)
    if hc.hidden_act not in ('relu',):
        raise NotImplementedError(f'hidden_act {hc.hidden_act!r}: the port implements the '
                                  f"reference's relu")
    if isinstance(hc.num_buckets, (list, tuple)):
        raise NotImplementedError('factorized num_buckets is not supported')
    if hc.local_num_chunks_before != 1 or hc.local_num_chunks_after != 0 \
            or hc.lsh_num_chunks_before != 1 or hc.lsh_num_chunks_after != 0:
        raise NotImplementedError('only the causal one-look-back chunk layout')
    N, H, d = hc.num_attention_heads, hc.attention_head_size, hc.hidden_size
    if tuple(hc.axial_pos_embds_dim) != (d // 4, 3 * d // 4):
        # ReformerConfig.axial_dims fixes the (d/4, 3d/4) split
        raise NotImplementedError(f'axial_pos_embds_dim {tuple(hc.axial_pos_embds_dim)} != '
                                  f'({d // 4}, {3 * d // 4}): unsupported axial split')

    layers = []
    for i, kind in enumerate(hc.attn_layers):
        p = f'reformer.encoder.layers.{i}.'
        sa = p + 'attention.self_attention.'
        attn = dict(
            v=sd[sa + 'value.weight'].T.reshape(d, N, H),
            o=sd[p + 'attention.output.dense.weight'].T.reshape(N, H, d),
            ln=dict(scale=sd[p + 'attention.layer_norm.weight'],
                    bias=sd[p + 'attention.layer_norm.bias']),
        )
        if kind == 'local':
            attn['q'] = sd[sa + 'query.weight'].T.reshape(d, N, H)
            attn['k'] = sd[sa + 'key.weight'].T.reshape(d, N, H)
            attn['qk'] = attn['q']          # the JAX layout's leaf; local layers read 'q'
        else:
            attn['qk'] = sd[sa + 'query_key.weight'].T.reshape(d, N, H)
        layers.append(dict(
            attn=attn,
            ffn=dict(
                w1=dict(w=sd[p + 'feed_forward.dense.dense.weight'].T,
                        b=sd[p + 'feed_forward.dense.dense.bias']),
                w2=dict(w=sd[p + 'feed_forward.output.dense.weight'].T,
                        b=sd[p + 'feed_forward.output.dense.bias']),
                ln=dict(scale=sd[p + 'feed_forward.layer_norm.weight'],
                        bias=sd[p + 'feed_forward.layer_norm.bias']),
            )))
    params: Dict[str, Any] = dict(
        embed=dict(weight=sd['reformer.embeddings.word_embeddings.weight']),
        axial1=sd['reformer.embeddings.position_embeddings.weights.0'],
        axial2=sd['reformer.embeddings.position_embeddings.weights.1'],
        ln_f=dict(scale=sd['reformer.encoder.layer_norm.weight'],
                  bias=sd['reformer.encoder.layer_norm.bias']),
        lm_head=dict(w=sd['lm_head.decoder.weight'].T, b=sd['lm_head.decoder.bias']),
        layers=layers,
    )
    n1, n2 = hc.axial_pos_shape
    cfg = ReformerConfig(
        vocab_size=hc.vocab_size, model_size='hf-import', d_model=d, n_head=N, d_head=H,
        d_ff=hc.feed_forward_size, attn_layers=tuple(hc.attn_layers),
        max_length=hc.max_position_embeddings, axial_pos_shape=(int(n1), int(n2)),
        local_chunk=hc.local_attn_chunk_length, lsh_chunk=hc.lsh_attn_chunk_length,
        n_hashes=hc.num_hashes, n_buckets=hc.num_buckets, dropout=hc.hidden_dropout_prob,
        ln_eps=hc.layer_norm_eps, hf_compat=True, **config_overrides)
    return cfg, params


def to_hf_reformer(cfg: ReformerConfig, params: Dict[str, Any]):
    """(ReformerConfig(hf_compat=True), parameters) -> HF ReformerModelWithLMHead."""
    if not cfg.hf_compat:
        raise NotImplementedError('only hf_compat (reversible, 2d-head) models are '
                                  'HF-expressible; the native stack uses standard residuals')
    from transformers import ReformerConfig as HFConfig
    from transformers import ReformerModelWithLMHead

    hc = HFConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.d_model, num_attention_heads=cfg.n_head,
        attention_head_size=cfg.d_head, feed_forward_size=cfg.d_ff,
        attn_layers=list(cfg.attn_layers), axial_pos_shape=list(cfg.axial_pos_shape),
        axial_pos_embds_dim=[cfg.d_model // 4, 3 * cfg.d_model // 4],
        max_position_embeddings=cfg.max_length, local_attn_chunk_length=cfg.local_chunk,
        lsh_attn_chunk_length=cfg.lsh_chunk, num_hashes=cfg.n_hashes,
        num_buckets=cfg.n_buckets, is_decoder=True, hidden_dropout_prob=cfg.dropout,
        hidden_act='relu', layer_norm_eps=cfg.ln_eps)
    model = ReformerModelWithLMHead(hc)
    N, H, d = cfg.n_head, cfg.d_head, cfg.d_model
    head_b = _torch(_np(params['lm_head']['b']))
    new = {
        'reformer.embeddings.word_embeddings.weight': _torch(_np(params['embed']['weight'])),
        'reformer.embeddings.position_embeddings.weights.0': _torch(_np(params['axial1'])),
        'reformer.embeddings.position_embeddings.weights.1': _torch(_np(params['axial2'])),
        'reformer.encoder.layer_norm.weight': _torch(_np(params['ln_f']['scale'])),
        'reformer.encoder.layer_norm.bias': _torch(_np(params['ln_f']['bias'])),
        'lm_head.decoder.weight': _torch(_np(params['lm_head']['w']).T),
        'lm_head.decoder.bias': head_b,
        'lm_head.bias': head_b,
    }
    for i, kind in enumerate(cfg.attn_layers):
        p = f'reformer.encoder.layers.{i}.'
        sa = p + 'attention.self_attention.'
        a, f = params['layers'][i]['attn'], params['layers'][i]['ffn']
        if kind == 'local':
            new[sa + 'query.weight'] = _torch(_np(a['q']).reshape(d, N * H).T)
            new[sa + 'key.weight'] = _torch(_np(a['k']).reshape(d, N * H).T)
        else:
            new[sa + 'query_key.weight'] = _torch(_np(a['qk']).reshape(d, N * H).T)
        new.update({
            sa + 'value.weight': _torch(_np(a['v']).reshape(d, N * H).T),
            p + 'attention.output.dense.weight': _torch(_np(a['o']).reshape(N * H, d).T),
            p + 'attention.layer_norm.weight': _torch(_np(a['ln']['scale'])),
            p + 'attention.layer_norm.bias': _torch(_np(a['ln']['bias'])),
            p + 'feed_forward.dense.dense.weight': _torch(_np(f['w1']['w']).T),
            p + 'feed_forward.dense.dense.bias': _torch(_np(f['w1']['b'])),
            p + 'feed_forward.output.dense.weight': _torch(_np(f['w2']['w']).T),
            p + 'feed_forward.output.dense.bias': _torch(_np(f['w2']['b'])),
            p + 'feed_forward.layer_norm.weight': _torch(_np(f['ln']['scale'])),
            p + 'feed_forward.layer_norm.bias': _torch(_np(f['ln']['bias'])),
        })
    sd = model.state_dict()
    sd.update(new)
    model.load_state_dict(sd)
    return model
