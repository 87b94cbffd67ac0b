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
``prefill_chunk``, paged decode for ``decode_step``. The kernels have no
backward: training runs the ``reference`` route.

``forward_seq`` and ``decode_step`` also run on DTensors (the step builders
of :mod:`repro_torch.distributed.steps`): the kernels then run on each
rank's batch rows and heads (``cm.on_shards``), and the new cache is built
and written on each rank's block.

The VLM family (qwen2-vl) is this backbone with M-RoPE: its stub vision
frontend hands ``forward_seq`` embeddings and (t, h, w) positions.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.weights import layer, layers


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
                mrope_positions=None, window: Optional[int] = None,
                cache_capacity: Optional[int] = None, remat: bool = False):
    """Full-sequence forward. x (B,S,d) embeddings, positions (S,) (the
    VLM's M-RoPE takes ``mrope_positions`` (B,3,S) instead). Returns
    (logits (B,S,V_padded), cache | None); the cache is new. ``remat``
    recomputes each layer's activations in the backward pass."""
    B, S, _ = x.shape
    x = cm.constrain_batch(cfg, x)
    cos, sin, rope_dim = cm.rope_for(cfg, positions, mrope_positions)
    use_k = _use_kernels(cfg)
    mask = None if use_k else cm.causal_mask(S, S, window=window,
                                             device=x.device)

    def body(x, lp):
        h = cm.apply_norm(cfg, lp, "ln1", x)
        q, k, v = cm.attention_qkv(cfg, lp, h, cos, sin, rope_dim)
        q, k, v = cm.constrain_seq_attention(cfg, q, k, v)
        if use_k:
            o = _flash_seq(q, k, v, window)
        else:
            o = cm.sdpa(q, k, v, mask, cfg.logit_softcap)
        x = _mlp_residual(cfg, lp, x + cm.settled(o @ lp["attn/wo"]))
        return cm.constrain_batch(cfg, x), k, v

    ks, vs = [], []
    for lp in layers(params):
        x, k, v = cm.run_layer(remat, body, x, lp)
        ks.append(k)
        vs.append(v)
    logits = _final(cfg, params, x)
    cache = None
    if cache_capacity is not None:
        cache = seq_cache(torch.stack(ks), torch.stack(vs), cache_capacity)
    return logits, cache


def _flash_seq(q, k, v, window):
    """The flash kernel over q (B,S,H,D), k/v (B,S,Hk,D) -> (B,S,H*D); on
    DTensors on each rank's batch rows and heads."""
    from repro_torch.kernels.flash_prefill import flash_seq_op

    def local(q, k, v, mask, split):
        _whole_sequence(q, split)
        return flash_seq_op(q, k, v, window=window).reshape(
            q.shape[0], q.shape[1], -1)

    if isinstance(q, cm.DTensor):
        _whole_sequence(q, ())
        return cm.on_shards(local, q, k, v, None)
    return local(q, k, v, None, ())


def _whole_sequence(q, split):
    """The kernels take whole sequences: no query or key blocks."""
    if split or (isinstance(q, cm.DTensor) and any(
            p == cm.Shard(1) and q.device_mesh.size(i) > 1
            for i, p in enumerate(q.placements))):
        raise NotImplementedError("attn_impl='hopper' does not split the "
                                  "sequence over ranks")


def seq_cache(ks, vs, C: int):
    """The decode cache of a full-sequence pass: K/V (L,B,S,Hk,D) of
    positions [0, S) placed in a new cache of capacity ``C``; with C < S
    the last C positions at their ring slots (slot = pos % C). On DTensors
    each rank builds its block (split on batch and heads as ks is)."""
    if isinstance(ks, cm.DTensor):
        return _seq_cache_sharded(ks, vs, C)
    B, S = ks.shape[1], ks.shape[2]
    dev = ks.device
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
    return {"k": kc, "v": vc, "pos_map": pos_map}


def _seq_cache_sharded(ks, vs, C: int):
    mesh, R = ks.device_mesh, cm.Replicate()
    kv_pl = [R if p == cm.Shard(2) or p.is_partial() else p
             for p in ks.placements]
    pm_pl = [cm.Shard(0) if p == cm.Shard(1) else R for p in kv_pl]
    out = seq_cache(ks.redistribute(mesh, kv_pl).to_local(),
                    vs.redistribute(mesh, kv_pl).to_local(), C)
    pl = {"k": kv_pl, "v": kv_pl, "pos_map": pm_pl}
    return {name: cm.DTensor.from_local(t, mesh, pl[name], run_check=False)
            for name, t in out.items()}


def decode_step(cfg: ModelConfig, params, cache, x, pos, *,
                mrope_positions=None, window: Optional[int] = None):
    """x (B,1,d) new-token embeddings; pos (B,) absolute positions (a
    device tensor; the VLM's M-RoPE takes ``mrope_positions`` (B,3,1)).
    Writes each row's K/V at slot ``pos % C`` and its
    position into ``pos_map`` in place; returns (logits (B,1,V), cache).

    With ``cfg.attn_impl == "hopper"`` attention runs the paged decode
    kernel over the slot cache viewed as contiguous pages; that path
    assumes a non-ring cache whose positions [0, pos] are valid (the
    serving engine's contract) and masks by context length instead of the
    pos_map."""
    B = x.shape[0]
    x = cm.constrain_batch(cfg, x)
    kc, vc, pos_map = cache["k"], cache["v"], cache["pos_map"]
    C = kc.shape[2]
    pos = pos.long()
    slot = pos % C
    bidx = torch.arange(B, device=x.device)
    cm.write_slots(pos_map, pos.to(torch.int32), slot, bidx)
    cos, sin, rope_dim = cm.rope_for(cfg, pos[:, None], mrope_positions)
    use_k = _use_kernels(cfg)
    if use_k:
        if window is not None:
            raise NotImplementedError(
                "attn_impl='hopper' decode has no sliding-window variant")
        lengths = (pos + 1).to(torch.int32)
        table = None if isinstance(kc, cm.DTensor) else page_table(B, C,
                                                                    x.device)
    else:
        mask = cm.decode_mask(pos_map, pos, window=window)
    for i in range(cfg.n_layers):
        lp = layer(params, i)
        h = cm.apply_norm(cfg, lp, "ln1", x)
        q, k, v = cm.attention_qkv(cfg, lp, h, cos, sin, rope_dim)
        ck, cv = kc[i], vc[i]                          # (B,C,Hk,D) views
        cm.write_slots(ck, k[:, 0], slot, bidx)
        cm.write_slots(cv, v[:, 0], slot, bidx)
        if use_k:
            o = _paged(q, ck, cv, lengths, table)
        else:
            o = cm.sdpa(q, ck, cv, mask, cfg.logit_softcap)
        x = _mlp_residual(cfg, lp, x + cm.settled(o @ lp["attn/wo"]))
    return _final(cfg, params, x), cache


def page_table(B: int, C: int, device):
    """(B, C // page) int32: row b's slot cache viewed as its own run of
    contiguous pages."""
    from repro_torch.kernels.flash_prefill.ops import _block_size
    MP = C // _block_size(C)              # pages tile the slot's capacity
    return (torch.arange(B, device=device)[:, None] * MP + torch.arange(
        MP, device=device)[None, :]).to(torch.int32)


def _paged(q, ck, cv, lengths, table):
    """The paged decode kernel over one layer's slot cache ck/cv (B,C,Hk,D),
    viewed as contiguous pages (``table``, from :func:`page_table`), for q
    (B,1,H,D) at context ``lengths`` (B,) -> (B,1,H*D); on DTensors on each
    rank's batch rows and heads, with the table of its rows."""
    from repro_torch.kernels.paged_attention import paged_attention_op

    def local(q, ck, cv, lengths, split):
        _whole_sequence(q, split)
        B, C, Hk, D = ck.shape
        t = table if table is not None else page_table(B, C, q.device)
        page = C // t.shape[1]
        return paged_attention_op(q[:, 0], ck.view(-1, page, Hk, D),
                                  cv.view(-1, page, Hk, D), t,
                                  lengths).reshape(B, 1, -1)

    if isinstance(q, cm.DTensor):
        return cm.on_shards(local, q, ck, cv, lengths)
    return local(q, ck, cv, lengths, ())


def prefill_chunk(cfg: ModelConfig, params, cache, x, offset: int, *,
                  mrope_positions=None, window: Optional[int] = None):
    """Chunked prefill: run a chunk x (B,Sq,d) whose tokens sit at absolute
    positions [offset, offset+Sq) against an existing cache (same layout as
    decode; non-ring, offset + Sq <= C). ``offset`` is a host int shared by
    the batch rows (the VLM's M-RoPE takes ``mrope_positions`` (B,3,Sq)).
    Writes the chunk's K/V and positions in place; returns (logits
    (B,Sq,V), cache).

    With ``cfg.attn_impl == "hopper"`` attention runs the flash kernel
    against the whole cache with positional causal masking; positions
    [0, offset) must be contiguously valid (the engine's KV prefix
    contract)."""
    B, Sq, _ = x.shape
    x = cm.constrain_batch(cfg, x)
    kc, vc, pos_map = cache["k"], cache["v"], cache["pos_map"]
    offset = int(offset)
    if offset + Sq > kc.shape[2]:
        raise ValueError(f"chunk [{offset}, {offset + Sq}) overruns the "
                         f"cache capacity {kc.shape[2]}")
    positions = offset + torch.arange(Sq, device=x.device)
    pos_map[:, offset:offset + Sq] = positions.to(torch.int32)
    cos, sin, rope_dim = cm.rope_for(cfg, positions, mrope_positions)
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
        x = _mlp_residual(cfg, lp, x + cm.settled(o @ lp["attn/wo"]))
    return _final(cfg, params, x), cache


def verify_rows(cfg: ModelConfig, params, cache, x, slots, offsets):
    """The speculative verify: row ``j`` of x (n, Sq, d) holds the tokens at
    absolute positions [offsets[j], offsets[j]+Sq) of cache slot
    ``slots[j]`` (host int arrays, distinct slots, non-ring, positions
    [0, offsets[j]) valid). Every op but attention runs once for all rows:
    RoPE on the (n, Sq) positions, K/V and ``pos_map`` written per row by
    advanced indexing, in place. Attention runs per row against its own
    slot (the flash kernel takes one offset a launch). Returns logits
    (n, Sq, V)."""
    n, Sq, _ = x.shape
    kc, vc, pos_map = cache["k"], cache["v"], cache["pos_map"]
    dev = x.device
    offs = [int(o) for o in offsets]
    sl = [int(s) for s in slots]
    if max(offs) + Sq > kc.shape[2]:
        raise ValueError(f"verify rows overrun the cache capacity "
                         f"{kc.shape[2]}")
    positions = torch.as_tensor(offs, device=dev)[:, None] \
        + torch.arange(Sq, device=dev)[None, :]            # (n, Sq)
    rows = torch.as_tensor(sl, device=dev)[:, None]
    pos_map[rows, positions] = positions.to(torch.int32)
    cos, sin, rope_dim = cm.rope_for(cfg, positions)
    use_k = _use_kernels(cfg)
    if use_k:
        from repro_torch.kernels.flash_prefill import flash_chunk_op
    else:
        mask = torch.cat([cm.chunk_mask(pos_map[s:s + 1], positions[j])
                          for j, s in enumerate(sl)])
    for i in range(cfg.n_layers):
        lp = layer(params, i)
        h = cm.apply_norm(cfg, lp, "ln1", x)
        q, k, v = cm.attention_qkv(cfg, lp, h, cos, sin, rope_dim)
        ck, cv = kc[i], vc[i]
        ck[rows, positions] = k
        cv[rows, positions] = v
        if use_k:
            o = torch.cat([flash_chunk_op(q[j:j + 1].contiguous(),
                                          ck[s:s + 1], cv[s:s + 1], off)
                           for j, (s, off) in enumerate(zip(sl, offs))])
        else:
            o = cm.sdpa(q, ck[rows[:, 0]], cv[rows[:, 0]], mask,
                        cfg.logit_softcap)
        x = _mlp_residual(cfg, lp, x + o.reshape(n, Sq, -1) @ lp["attn/wo"])
    return _final(cfg, params, x)


def embed_tokens(cfg: ModelConfig, params, tokens):
    return cm.embed(cfg, params, tokens)
