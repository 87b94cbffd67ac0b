"""Whisper-style encoder–decoder (arXiv:2212.04356), in PyTorch. The
mel-spectrogram + conv frontend is a stub, as in the JAX package: inputs
are precomputed frame embeddings (B, n_frames, d_model). The backbone is a
bidirectional encoder (sinusoidal positions) and a causal decoder (learned
positions, cross-attention), all on the reference attention.

Cache:
  {"k","v": (L,B,C,H,D) decoder self-attention,
   "ck","cv": (L,B,F,H,D) cross-attention (computed once at prefill),
   "pos_map": (B,C)}

Where the JAX package returned a new cache, ``decode_step`` writes the new
self-attention K/V and position into the given cache tensors **in place**
(as :func:`repro_torch.models.dense.decode_step`) and returns the same
dict.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models import dense
from repro_torch.weights import layers


def _no_mask(device):
    return torch.zeros((1, 1, 1, 1, 1), dtype=torch.float32, device=device)


def encode(cfg: ModelConfig, params, audio_embeds, remat: bool = False):
    """audio_embeds (B, F, d), the stub frontend's output -> (B, F, d)."""
    F_ = audio_embeds.shape[1]
    pos = cm.sinusoidal_positions(F_, cfg.d_model, device=audio_embeds.device)
    x = cm.constrain_batch(
        cfg, audio_embeds + pos.to(audio_embeds.dtype)[None])
    zero = _no_mask(x.device)

    def body(x, lp):
        h = cm.apply_norm(cfg, lp, "ln1", x)
        q, k, v = cm.attention_qkv(cfg, lp, h, None, None, 0)
        x = x + cm.settled(cm.sdpa(q, k, v, zero) @ lp["attn/wo"])
        return x + cm.mlp(cfg, lp, cm.apply_norm(cfg, lp, "ln2", x))

    for lp in layers(params, "enc_layers/"):
        x = cm.run_layer(remat, body, x, lp)
    return cm.apply_norm(cfg, params, "enc_norm", x)


def _dec_block(cfg, lp, x, mask, ck, cv, self_kv=None, slot=None):
    """One decoder layer: self-attention (over its own K/V, or over the
    cache ``self_kv`` after writing this step's K/V at ``slot``), cross-
    attention over the encoder's K/V ``ck``/``cv``, MLP. Returns (x, k, v)
    with k, v this layer's self-attention K/V (the cache slabs when
    decoding)."""
    h = cm.apply_norm(cfg, lp, "ln1", x)
    q, k, v = cm.attention_qkv(cfg, lp, h, None, None, 0, prefix="self_attn")
    if self_kv is not None:
        kc, vc = self_kv
        bidx = torch.arange(x.shape[0], device=x.device)
        cm.write_slots(kc, k[:, 0], slot, bidx)
        cm.write_slots(vc, v[:, 0], slot, bidx)
        k, v = kc, vc
    x = x + cm.settled(cm.sdpa(q, k, v, mask) @ lp["self_attn/wo"])
    h = cm.apply_norm(cfg, lp, "ln_x", x)
    B, S, _ = h.shape
    qx = cm.split_heads(h @ lp["cross_attn/wq"], cfg.n_heads, cfg.head_dim_)
    x = x + cm.settled(
        cm.sdpa(qx, ck, cv, _no_mask(x.device)) @ lp["cross_attn/wo"])
    x = x + cm.mlp(cfg, lp, cm.apply_norm(cfg, lp, "ln2", x))
    return x, k, v


def cross_kv_all(cfg: ModelConfig, params, enc_out):
    """Cross-attention K/V of every decoder layer: (L,B,F,Hk,D) each."""
    B, F_, _ = enc_out.shape
    hd = cfg.head_dim_
    ks, vs = [], []
    for lp in layers(params, "dec_layers/"):
        ks.append((enc_out @ lp["cross_attn/wk"])
                  .reshape(B, F_, cfg.n_kv_heads, hd))
        vs.append((enc_out @ lp["cross_attn/wv"])
                  .reshape(B, F_, cfg.n_kv_heads, hd))
    return torch.stack(ks), torch.stack(vs)


def forward_seq(cfg: ModelConfig, params, tokens, audio_embeds, *,
                cache_capacity: Optional[int] = None, remat: bool = False,
                enc_out=None):
    """Teacher-forced decoder pass (train/prefill) over tokens (B,S).
    Returns (logits, cache | None); the cache is new and must hold the
    whole prefix (capacity >= S)."""
    if enc_out is None:
        enc_out = encode(cfg, params, audio_embeds, remat=remat)
    B, S = tokens.shape
    x = cm.embed(cfg, params, tokens) + params["pos"][:S][None]
    x = cm.constrain_batch(cfg, x)
    mask = cm.causal_mask(S, S, device=x.device)
    ck, cv = cross_kv_all(cfg, params, enc_out)

    def body(x, lp, ckl, cvl):
        return _dec_block(cfg, lp, x, mask, ckl, cvl)

    ks, vs = [], []
    for i, lp in enumerate(layers(params, "dec_layers/")):
        x, k, v = cm.run_layer(remat, body, x, lp, ck[i], cv[i])
        ks.append(k)
        vs.append(v)
    logits = dense._final(cfg, params, x)
    cache = None
    if cache_capacity is not None:
        if cache_capacity < S:
            raise ValueError(f"the decoder cache must hold the whole "
                             f"prefix: capacity {cache_capacity} < {S}")
        cache = dense.seq_cache(torch.stack(ks), torch.stack(vs),
                                cache_capacity)
        cache.update(ck=ck, cv=cv)
    return logits, cache


def decode_step(cfg: ModelConfig, params, cache, token, pos):
    """token (B,1) int; pos (B,) absolute positions. Writes each row's
    self-attention K/V at slot ``pos % C`` and its position into
    ``pos_map`` in place; returns (logits (B,1,V), cache)."""
    B = token.shape[0]
    kc, vc, pos_map = cache["k"], cache["v"], cache["pos_map"]
    pos = pos.long()
    slot = pos % kc.shape[2]
    cm.write_slots(pos_map, pos.to(torch.int32), slot,
                   torch.arange(B, device=pos.device))
    mask = cm.decode_mask(pos_map, pos)
    x = cm.embed(cfg, params, token) \
        + params["pos"][torch.clamp_max(pos, cfg.max_seq_len - 1)][:, None]
    x = cm.constrain_batch(cfg, x)
    for i, lp in enumerate(layers(params, "dec_layers/")):
        x, _, _ = _dec_block(cfg, lp, x, mask, cache["ck"][i], cache["cv"][i],
                             self_kv=(kc[i], vc[i]), slot=slot)
    return dense._final(cfg, params, x), cache
