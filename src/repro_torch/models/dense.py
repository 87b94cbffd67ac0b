"""Dense decoder-only transformer, in PyTorch.

Cache layout (per model):
  {"k","v": (L, B, C, Hk, D), "pos_map": (B, C) int32 abs position per slot (-1 empty)}

``C`` (capacity) may be >= seq (full cache) or a sliding window (ring buffer,
slot = pos % C) — the pos_map-driven mask makes both behave identically.

Where the JAX package returned updated cache arrays from donated buffers,
``decode_step`` and ``prefill_chunk`` write the new K/V and positions into
the given cache tensors **in place** and return the same dict. Callers that
need the old cache pass a clone.

``cfg.attn_impl == "hopper"`` routes attention through the hand-written
kernels (``repro_torch.kernels``): flash prefill for ``forward_seq`` and
``prefill_chunk``, paged decode for ``decode_step``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.weights import layer


def _use_kernels(cfg: ModelConfig) -> bool:
    """The serving engine's kernel switch. Softcapped logits (gemma) have no
    kernel variant yet — fail loudly rather than silently diverging from
    the reference numerics."""
    if cfg.attn_impl == "reference":
        return False
    if cfg.attn_impl != "hopper":
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    if cfg.logit_softcap:
        raise NotImplementedError(
            "attn_impl='hopper' does not support logit_softcap")
    return True


def _mlp_residual(cfg, lp, x):
    return x + cm.mlp(cfg, lp, cm.apply_norm(cfg, lp, "ln2", x))


def _final(cfg, params, x):
    x = cm.apply_norm(cfg, params, "final_norm", x)
    return cm.unembed(cfg, params, x)


def forward_seq(cfg: ModelConfig, params, x, positions, *,
                window: Optional[int] = None,
                cache_capacity: Optional[int] = None):
    """Full-sequence forward. x (B,S,d) embeddings, positions (S,).
    Returns (logits (B,S,V_padded), cache | None); the cache is new."""
    B, S, _ = x.shape
    cos, sin, rope_dim = cm.rope_for(cfg, positions)
    use_k = _use_kernels(cfg)
    mask = None if use_k else cm.causal_mask(S, S, window=window,
                                             device=x.device)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = layer(params, i)
        h = cm.apply_norm(cfg, lp, "ln1", x)
        q, k, v = cm.attention_qkv(cfg, lp, h, cos, sin, rope_dim)
        if use_k:
            from repro_torch.kernels.flash_prefill import flash_seq_op
            o = flash_seq_op(q, k, v, window=window).reshape(B, S, -1)
        else:
            o = cm.sdpa(q, k, v, mask, cfg.logit_softcap)
        x = _mlp_residual(cfg, lp, x + o @ lp["attn/wo"])
        ks.append(k)
        vs.append(v)
    logits = _final(cfg, params, x)

    cache = None
    if cache_capacity is not None:
        ks, vs = torch.stack(ks), torch.stack(vs)        # (L,B,S,Hk,D)
        C = cache_capacity
        dev = x.device
        if C >= S:
            shape = ks.shape[:2] + (C,) + ks.shape[3:]
            kc = torch.zeros(shape, dtype=ks.dtype, device=dev)
            vc = torch.zeros_like(kc)
            kc[:, :, :S] = ks
            vc[:, :, :S] = vs
            idx = torch.arange(C, device=dev)
            pos_map = torch.where(idx < S, idx, -1)
        else:
            # keep the last C positions, placed at their ring slots
            keep_pos = torch.arange(S - C, S, device=dev)
            slots = keep_pos % C
            kc = torch.zeros_like(ks[:, :, S - C:])
            vc = torch.zeros_like(kc)
            kc[:, :, slots] = ks[:, :, S - C:]
            vc[:, :, slots] = vs[:, :, S - C:]
            pos_map = torch.zeros((C,), dtype=torch.long, device=dev)
            pos_map[slots] = keep_pos
        pos_map = pos_map.to(torch.int32)[None].expand(B, C).contiguous()
        cache = {"k": kc, "v": vc, "pos_map": pos_map}
    return logits, cache


def decode_step(cfg: ModelConfig, params, cache, x, pos, *,
                window: Optional[int] = None):
    """x (B,1,d) new-token embeddings; pos (B,) absolute positions (a
    device tensor). Writes each row's K/V at slot ``pos % C`` and its
    position into ``pos_map`` in place; returns (logits (B,1,V), cache).

    With ``cfg.attn_impl == "hopper"`` attention runs the paged decode
    kernel over the slot cache viewed as contiguous pages; that path
    assumes a non-ring cache whose positions [0, pos] are valid (the
    serving engine's contract) and masks by context length instead of the
    pos_map."""
    B = x.shape[0]
    kc, vc, pos_map = cache["k"], cache["v"], cache["pos_map"]
    C = kc.shape[2]
    pos = pos.long()
    slot = pos % C
    bidx = torch.arange(B, device=x.device)
    pos_map[bidx, slot] = pos.to(torch.int32)
    cos, sin, rope_dim = cm.rope_for(cfg, pos[:, None])
    use_k = _use_kernels(cfg)
    if use_k:
        if window is not None:
            raise NotImplementedError(
                "attn_impl='hopper' decode has no sliding-window variant")
        from repro_torch.kernels.flash_prefill.ops import _block_size
        from repro_torch.kernels.paged_attention import paged_attention_op
        page = _block_size(C)             # pages tile the slot's capacity
        MP = C // page
        page_table = (bidx[:, None] * MP + torch.arange(
            MP, device=x.device)[None, :]).to(torch.int32)
        lengths = (pos + 1).to(torch.int32)
    else:
        mask = cm.decode_mask(pos_map, pos, window=window)
    for i in range(cfg.n_layers):
        lp = layer(params, i)
        h = cm.apply_norm(cfg, lp, "ln1", x)
        q, k, v = cm.attention_qkv(cfg, lp, h, cos, sin, rope_dim)
        ck, cv = kc[i], vc[i]                          # (B,C,Hk,D) views
        ck[bidx, slot] = k[:, 0]
        cv[bidx, slot] = v[:, 0]
        if use_k:
            Hk, D = ck.shape[2], ck.shape[3]
            o = paged_attention_op(q[:, 0], ck.view(B * MP, page, Hk, D),
                                   cv.view(B * MP, page, Hk, D), page_table,
                                   lengths).reshape(B, 1, -1)
        else:
            o = cm.sdpa(q, ck, cv, mask, cfg.logit_softcap)
        x = _mlp_residual(cfg, lp, x + o @ lp["attn/wo"])
    return _final(cfg, params, x), cache


def prefill_chunk(cfg: ModelConfig, params, cache, x, offset: int, *,
                  window: Optional[int] = None):
    """Chunked prefill: run a chunk x (B,Sq,d) whose tokens sit at absolute
    positions [offset, offset+Sq) against an existing cache (same layout as
    decode; non-ring, offset + Sq <= C). ``offset`` is a host int shared by
    the batch rows. Writes the chunk's K/V and positions in place; returns
    (logits (B,Sq,V), cache).

    With ``cfg.attn_impl == "hopper"`` attention runs the flash kernel
    against the whole cache with positional causal masking; positions
    [0, offset) must be contiguously valid (the engine's KV prefix
    contract)."""
    B, Sq, _ = x.shape
    kc, vc, pos_map = cache["k"], cache["v"], cache["pos_map"]
    offset = int(offset)
    if offset + Sq > kc.shape[2]:
        raise ValueError(f"chunk [{offset}, {offset + Sq}) overruns the "
                         f"cache capacity {kc.shape[2]}")
    positions = offset + torch.arange(Sq, device=x.device)
    pos_map[:, offset:offset + Sq] = positions.to(torch.int32)
    cos, sin, rope_dim = cm.rope_for(cfg, positions)
    use_k = _use_kernels(cfg)
    mask = None if use_k else cm.chunk_mask(pos_map, positions, window=window)
    for i in range(cfg.n_layers):
        lp = layer(params, i)
        h = cm.apply_norm(cfg, lp, "ln1", x)
        q, k, v = cm.attention_qkv(cfg, lp, h, cos, sin, rope_dim)
        ck, cv = kc[i], vc[i]
        ck[:, offset:offset + Sq] = k
        cv[:, offset:offset + Sq] = v
        if use_k:
            from repro_torch.kernels.flash_prefill import flash_chunk_op
            o = flash_chunk_op(q, ck, cv, offset,
                               window=window).reshape(B, Sq, -1)
        else:
            o = cm.sdpa(q, ck, cv, mask, cfg.logit_softcap)
        x = _mlp_residual(cfg, lp, x + o @ lp["attn/wo"])
    return _final(cfg, params, x), cache


def embed_tokens(cfg: ModelConfig, params, tokens):
    return cm.embed(cfg, params, tokens)
