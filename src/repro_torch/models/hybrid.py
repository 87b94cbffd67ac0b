"""RecurrentGemma / Griffin hybrid (arXiv:2402.19427), in PyTorch: repeating
(RG-LRU, RG-LRU, local-attention) blocks, GeGLU MLPs, MQA local attention.

Layer pattern: ``len(pattern)`` layers per group; a trailing partial group
(n_layers % len(pattern) leading entries of the pattern) is a separate
"tail" stack (38 = 12x3 + 2 for recurrentgemma-9b). Parameters live under
``groups/sub{i}_{kind}/...`` and ``tail/sub0_{kind}/...`` with the group
(or tail) index as leading axis.

Cache:
  groups: {"conv{i}": (G,B,W-1,lw), "h{i}": (G,B,lw) float32 per rglru
           slot, "k{i}","v{i}": (G,B,C,Hk,D)} with C = local attention
           window (ring)
  tail:   {"conv0", "h0"}
  pos_map: (B, C) int32

``cfg.attn_impl == "hopper"`` routes the serving path's recurrence
(``prefill_chunk``) through the hand-written ``rglru_scan`` kernel (its
plain version on CPU tensors). The local attention stays on the reference
``sdpa`` in both modes, as in the JAX package.

Where the JAX package returned new cache arrays, ``prefill_chunk`` and
``decode_step`` write into the given cache tensors **in place** and return
the same dict; ``decode_step``'s optional ``active`` row index limits every
write (rings, pos_map, recurrences) to those rows.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
from repro_torch.models import common as cm
from repro_torch.models import dense
from repro_torch.weights import layers

_RGLRU_C = 8.0


def _use_kernels(cfg: ModelConfig) -> bool:
    """The serving path's kernel switch (mirrors dense)."""
    if cfg.attn_impl == "reference":
        return False
    if cfg.attn_impl != "hopper":
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    return True


def _pattern(cfg: ModelConfig):
    pat = cfg.hybrid.pattern
    return pat, cfg.n_layers // len(pat), cfg.n_layers % len(pat)


def _lru_width(cfg):
    return cfg.hybrid.lru_width or cfg.d_model


def _window(cfg):
    return cfg.sliding_window or cfg.hybrid.local_window


def _subs(cfg, params):
    """(group or tail index, pattern slot, kind, that sub-block's leaves)
    in layer order, as (section, g, i, kind, p)."""
    pat, n_groups, tail = _pattern(cfg)
    subs = [layers(params, f"groups/sub{i}_{kind}/")
            for i, kind in enumerate(pat)]
    for g in range(n_groups):
        for i, kind in enumerate(pat):
            yield "groups", g, i, kind, subs[i][g]
    if tail:
        for t, p in enumerate(layers(params, f"tail/sub0_{pat[0]}/")):
            yield "tail", t, 0, pat[0], p


# -------------------------------------------------------------------- rglru


def _rglru_gates(p, u, x_in):
    """u: conv output (B,S,lw); x_in: pre-conv branch input for gates (B,S,lw).
    Returns log_a (f32), gated input (f32)."""
    r = torch.sigmoid((x_in @ p["rglru/w_a"]).float() + p["rglru/b_a"])
    i = torch.sigmoid((x_in @ p["rglru/w_i"]).float() + p["rglru/b_i"])
    log_a = -_RGLRU_C * cm.softplus(p["rglru/lam"]) * r
    a2 = torch.exp(2.0 * log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12)) * i * u.float()
    return log_a, gated


def _rglru_scan(log_a, gated, h0=None):
    """Associative scan of h_t = a_t h_{t-1} + b_t along axis 1."""
    return rglru_scan_ref(log_a, gated, h0)[0]


def _rglru_seq(cfg, p, x, conv_state=None, h0=None):
    """Full recurrent mixer block. x (B,S,d) normed input."""
    S = x.shape[1]
    y = cm._gelu(x @ p["rglru/w_y"])
    u = x @ p["rglru/w_x"]
    cw = cfg.hybrid.conv_width
    if conv_state is None:
        conv_state = u.new_zeros((x.shape[0], cw - 1, u.shape[-1]))
    full = torch.cat([conv_state, u], dim=1)
    conv = cm.causal_conv(full, p["rglru/conv_w"], p["rglru/conv_b"], S)
    new_conv = full[:, full.shape[1] - (cw - 1):]
    log_a, gated = _rglru_gates(p, conv, u)
    h = _rglru_scan(log_a, gated, h0)
    out = cm.settled((y.float() * h).to(x.dtype) @ p["rglru/w_o"])
    return out, new_conv, h[:, -1]


def _rglru_chunk(cfg, p, x, conv_state, h0, valid_len: int, use_kernels):
    """Valid-length-masked recurrent mixer for one prefill chunk.

    Pad positions (index >= valid_len) get log_a = 0 (a = 1) and gated = 0, so
    the hidden state passes through them unchanged: h[:, -1] equals the state
    after the last *valid* token regardless of padding, and the conv tail is
    sliced at ``valid_len`` rather than at the padded end.
    """
    S = x.shape[1]
    y = cm._gelu(x @ p["rglru/w_y"])
    u = x @ p["rglru/w_x"]
    cw = cfg.hybrid.conv_width
    full = torch.cat([conv_state, u], dim=1)
    conv = cm.causal_conv(full, p["rglru/conv_w"], p["rglru/conv_b"], S)
    new_conv = full[:, valid_len:valid_len + cw - 1]
    log_a, gated = _rglru_gates(p, conv, u)
    valid = (torch.arange(S, device=x.device) < valid_len)[None, :, None]
    log_a = torch.where(valid, log_a, 0.0)
    gated = gated * valid
    if use_kernels:
        from repro_torch.kernels.rglru_scan import rglru_scan_op
        h, h_last = rglru_scan_op(log_a, gated, h0)
    else:
        h = _rglru_scan(log_a, gated, h0)
        h_last = h[:, -1]
    out = cm.settled((y.float() * h).to(x.dtype) @ p["rglru/w_o"])
    return out, new_conv, h_last


def _rglru_step(cfg, p, x, conv_state, h):
    """Single token. x (B,1,d); h (B,lw) f32. Returns new tensors."""
    y = cm._gelu(x @ p["rglru/w_y"])
    u = x @ p["rglru/w_x"]
    full = torch.cat([conv_state, u], dim=1)                   # (B,cw,lw)
    conv = torch.einsum("bwc,wc->bc", full, p["rglru/conv_w"]) \
        + p["rglru/conv_b"]
    log_a, gated = _rglru_gates(p, conv[:, None], u)
    h = torch.exp(log_a[:, 0]) * h + gated[:, 0]
    out = cm.settled((y[:, 0].float() * h).to(x.dtype) @ p["rglru/w_o"])
    return out[:, None], full[:, 1:], h


# ------------------------------------------------------------------- blocks


def _mlp_residual(cfg, p, x):
    return x + cm.mlp(cfg, p, cm.apply_norm(cfg, p, "ln2", x))


def _sub_seq(cfg, kind, p, x, cos, sin, rope_dim, mask):
    h_in = cm.apply_norm(cfg, p, "ln1", x)
    if kind == "attn":
        q, k, v = cm.attention_qkv(cfg, p, h_in, cos, sin, rope_dim)
        o = cm.sdpa(q, k, v, mask, cfg.logit_softcap)
        x = x + cm.settled(o @ p["attn/wo"])
        extra = (k, v)
    else:
        o, new_conv, h_last = _rglru_seq(cfg, p, h_in)
        x = x + o
        extra = (new_conv, h_last)
    return _mlp_residual(cfg, p, x), extra


def _final(cfg, params, x):
    x = cm.apply_norm(cfg, params, "final_norm", x)
    return cm.unembed(cfg, params, x)


# ------------------------------------------------------------------ forward


def forward_seq(cfg: ModelConfig, params, x, positions, *, window=None,
                cache_capacity: Optional[int] = None, remat: bool = False):
    """x (B,S,d), positions (S,). Returns (logits, cache|None); the cache
    is new, its rings holding the last min(C, S) positions. ``remat``
    recomputes each sub-layer's activations in the backward pass."""
    del window
    S = x.shape[1]
    x = cm.constrain_batch(cfg, x)
    pat, n_groups, tail = _pattern(cfg)
    W = _window(cfg)
    cos, sin, rope_dim = cm.rope_for(cfg, positions)
    mask = cm.causal_mask(S, S, window=W, device=x.device)
    extras = {}
    for sec, g, i, kind, p in _subs(cfg, params):
        x, extra = cm.run_layer(
            remat, lambda x, p, kind=kind: _sub_seq(cfg, kind, p, x, cos, sin,
                                                    rope_dim, mask), x, p)
        if sec == "groups" and i == len(pat) - 1:
            x = cm.constrain_batch(cfg, x)
        extras.setdefault((sec, i), []).append(extra)
    logits = _final(cfg, params, x)
    if cache_capacity is None:
        return logits, None

    C = min(cache_capacity, W)
    g = {}
    cache_pos = None
    for i, kind in enumerate(pat):
        a, b = (torch.stack(t) for t in zip(*extras[("groups", i)]))
        if kind == "attn":
            ring = dense.seq_cache(a, b, C)             # a, b (G,B,S,Hk,D)
            g[f"k{i}"], g[f"v{i}"] = ring["k"], ring["v"]
            cache_pos = ring["pos_map"]
        else:
            g[f"conv{i}"], g[f"h{i}"] = a, b
    cache = {"groups": g, "pos_map": cache_pos}
    if tail:
        conv, h_last = (torch.stack(t) for t in zip(*extras[("tail", 0)]))
        cache["tail"] = {"conv0": conv, "h0": h_last}
    return logits, cache


def _states(cache, sec, g, i):
    """(conv, h) views of one recurrent layer's state."""
    st = cache[sec]
    return st[f"conv{i}"][g], st[f"h{i}"][g]


def decode_step(cfg: ModelConfig, params, cache, x, pos, *, window=None,
                active=None):
    """x (B,1,d) new-token embeddings; pos (B,) absolute positions (a
    device tensor). Writes each row's K/V at ring slot ``pos % C``, its
    position into ``pos_map`` and its recurrences in place — only rows
    ``active`` (a long index tensor) when given. Returns (logits, cache)."""
    del window
    B = x.shape[0]
    x = cm.constrain_batch(cfg, x)
    pat, _, _ = _pattern(cfg)
    W = _window(cfg)
    attn_idx = [i for i, k in enumerate(pat) if k == "attn"]
    C = cache["groups"][f"k{attn_idx[0]}"].shape[2]
    pos = pos.long()
    slot = pos % C
    bidx = torch.arange(B, device=x.device)
    pos_map = cache["pos_map"].clone()
    cm.write_slots(pos_map, pos.to(torch.int32), slot, bidx)
    mask = cm.decode_mask(pos_map, pos, window=W)
    cm.write_rows(cache["pos_map"], pos_map, active)
    rows = bidx if active is None else active
    cos, sin, rope_dim = cm.rope_for(cfg, pos[:, None])
    for sec, g, i, kind, p in _subs(cfg, params):
        h_in = cm.apply_norm(cfg, p, "ln1", x)
        if kind == "attn":
            q, k, v = cm.attention_qkv(cfg, p, h_in, cos, sin, rope_dim)
            ck = cache["groups"][f"k{i}"][g]                 # (B,C,Hk,D)
            cv = cache["groups"][f"v{i}"][g]
            if active is None:
                cm.write_slots(ck, k[:, 0], slot, bidx)
                cm.write_slots(cv, v[:, 0], slot, bidx)
            else:
                ck[rows, slot[rows]] = k[rows, 0]
                cv[rows, slot[rows]] = v[rows, 0]
            o = cm.sdpa(q, ck, cv, mask, cfg.logit_softcap)
            x = x + cm.settled(o @ p["attn/wo"])
        else:
            conv, h = _states(cache, sec, g, i)
            o, new_conv, new_h = _rglru_step(cfg, p, h_in, conv, h)
            cm.write_rows(conv, new_conv, active)
            cm.write_rows(h, new_h, active)
            x = x + o
        x = _mlp_residual(cfg, p, x)
    return _final(cfg, params, x), cache


def init_cache(cfg: ModelConfig, batch: int, capacity: int, device="cuda"):
    """Empty decode cache for ``batch`` fresh streams: zero k/v rings with
    pos_map -1 (no valid slots) and zero recurrent (conv, h) state."""
    from repro_torch.weights import torch_dtype
    dtype = torch_dtype(cfg.dtype)
    pat, n_groups, tail = _pattern(cfg)
    C = min(capacity, _window(cfg))
    lw = _lru_width(cfg)
    cw = cfg.hybrid.conv_width
    hd = cfg.head_dim_

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    g = {}
    for i, kind in enumerate(pat):
        if kind == "attn":
            g[f"k{i}"] = zeros((n_groups, batch, C, cfg.n_kv_heads, hd))
            g[f"v{i}"] = zeros((n_groups, batch, C, cfg.n_kv_heads, hd))
        else:
            g[f"conv{i}"] = zeros((n_groups, batch, cw - 1, lw))
            g[f"h{i}"] = zeros((n_groups, batch, lw), torch.float32)
    cache = {"groups": g,
             "pos_map": torch.full((batch, C), -1, dtype=torch.int32,
                                   device=device)}
    if tail:
        cache["tail"] = {"conv0": zeros((tail, batch, cw - 1, lw)),
                         "h0": zeros((tail, batch, lw), torch.float32)}
    return cache


def prefill_chunk(cfg: ModelConfig, params, cache, x, offset: int, *,
                  valid_len: int, window=None):
    """One chunk of incremental prefill against a live decode cache.

    x (B,Sq,d): embedded chunk covering absolute positions
    offset..offset+Sq-1, of which the first ``valid_len`` are real tokens and
    the rest padding. Attention layers attend over the concatenation
    [ring cache | chunk] under a combined validity/causal/sliding-window mask,
    then commit the last min(valid_len, C) valid keys into the ring (write
    *after* attend, so in-chunk attention never sees overwritten slots).
    Recurrent layers run the valid-length-masked scan (``_rglru_chunk``),
    with the Hopper kernel on the path when ``attn_impl == "hopper"``. The
    cache is advanced in place; returns (logits, cache), from which decoding
    resumes exactly as from a whole-sequence prefill.
    """
    del window
    B, Sq, _ = x.shape
    x = cm.constrain_batch(cfg, x)
    offset, valid_len = int(offset), int(valid_len)
    pat, _, _ = _pattern(cfg)
    use_k = _use_kernels(cfg)
    W = _window(cfg)
    dev = x.device
    attn_idx = [i for i, k in enumerate(pat) if k == "attn"]
    C = cache["groups"][f"k{attn_idx[0]}"].shape[2] if attn_idx else 0

    positions = offset + torch.arange(Sq, device=dev)
    cos, sin, rope_dim = cm.rope_for(cfg, positions)

    # Additive mask over concat([ring (C) | chunk (Sq)]) keys. Ring entries
    # hold absolute positions < offset, chunk keys sit at offset + j.
    idx = torch.arange(Sq, device=dev)
    ok = (idx[None, :] <= idx[:, None]) & (idx[None, :] < valid_len)
    ok = ok & (idx[None, :] > idx[:, None] - W)
    chunk_m = torch.where(ok, 0.0, cm.NEG_INF).float()[None, None, None]
    chunk_m = chunk_m.expand(B, 1, 1, Sq, Sq)
    if attn_idx:
        ring_m = cm.chunk_mask(cache["pos_map"], positions, window=W)
        mask = torch.cat([ring_m, chunk_m], dim=-1)
        # Ring commit plan, shared by every attention layer: slot c takes the
        # last valid chunk index congruent to it mod C (handles Sq > C wrap).
        cidx = torch.arange(C, device=dev)
        r = (cidx - offset) % C
        has = torch.nonzero(r < valid_len).flatten()
        last_rel = torch.clamp(
            r + C * torch.div(valid_len - 1 - r, C, rounding_mode="floor"),
            0, Sq - 1)[has]
        new_pos = (offset + last_rel).to(torch.int32)
    else:
        mask = chunk_m

    for sec, g, i, kind, p in _subs(cfg, params):
        h_in = cm.apply_norm(cfg, p, "ln1", x)
        if kind == "attn":
            q, k, v = cm.attention_qkv(cfg, p, h_in, cos, sin, rope_dim)
            ck = cache["groups"][f"k{i}"][g]                 # (B,C,Hk,D)
            cv = cache["groups"][f"v{i}"][g]
            keys = torch.cat([ck, k], dim=1)
            vals = torch.cat([cv, v], dim=1)
            o = cm.sdpa(q, keys, vals, mask, cfg.logit_softcap)
            x = x + cm.settled(o @ p["attn/wo"])
            ck[:, has] = k[:, last_rel]
            cv[:, has] = v[:, last_rel]
        else:
            conv, h = _states(cache, sec, g, i)
            o, new_conv, new_h = _rglru_chunk(cfg, p, h_in, conv, h,
                                              valid_len, use_k)
            conv.copy_(new_conv)
            h.copy_(new_h)
            x = x + o
        x = _mlp_residual(cfg, p, x)
        if sec == "groups" and i == len(pat) - 1:
            x = cm.constrain_batch(cfg, x)
    if attn_idx:
        cache["pos_map"][:, has] = new_pos
    return _final(cfg, params, x), cache


def embed_tokens(cfg: ModelConfig, params, tokens):
    return cm.embed(cfg, params, tokens)
