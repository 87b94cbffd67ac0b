"""Mixture-of-Experts decoder (dbrx, olmoe), in PyTorch. Attention is the
dense family's reference attention (``cm.sdpa``, whatever
``cfg.attn_impl`` says, as in the JAX package); the FFN is a top-k routed
expert bank with **sort-based dispatch** (a stable argsort by expert id and
a capacity-clipped scatter), so only the active experts' rows are
computed.

Routing picks each token's experts with a stable descending sort of the
router probabilities, so ties go to the lower expert index first, as
``lax.top_k`` does; ``torch.topk`` promises no order among equal values.

The dispatch scatter writes each kept (token, expert) pair to its own row
of an (E*C + 1)-row buffer per group; every dropped pair goes to the last
row, which is discarded. So duplicate indices, whose winner a CUDA scatter
leaves to chance, only ever meet in a row nobody reads.

Cache layout and in-place updates as :mod:`repro_torch.models.dense`.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models import dense
from repro_torch.weights import layer, layers


def _check(cfg: ModelConfig) -> None:
    if cfg.moe_ep_axis:
        raise NotImplementedError(
            "moe_ep_axis (expert-parallel sharding) belongs to the "
            "distributed slice (ROADMAP Queue 1 item 7), not ported yet")


def capacity(cfg: ModelConfig, Ng: int) -> int:
    """Slots per expert of a group of ``Ng`` tokens: the reference's
    expression, in Python floats, rounded up to a multiple of 8."""
    m = cfg.moe
    C = int(max(8, -(-Ng * m.top_k // m.n_experts) * m.capacity_factor))
    return -(-int(C) // 8) * 8


def route(cfg: ModelConfig, p, x):
    """x (B,S,d) -> (probs (G,Ng,E) float32, top_p (G,Ng,K) renormalised,
    top_e (G,Ng,K)): the tokens cut into ``cfg.moe_groups`` groups when
    they divide evenly (else one)."""
    B, S, d = x.shape
    N, K = B * S, cfg.moe.top_k
    G = cfg.moe_groups if cfg.moe_groups and N % max(cfg.moe_groups, 1) \
        == 0 else 1
    xg = x.reshape(G, N // G, d)
    probs = torch.softmax((xg @ p["router"]).float(), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :K], top_e[..., :K]
    return probs, top_p / torch.sum(top_p, dim=-1, keepdim=True), top_e


def moe_ffn(cfg: ModelConfig, p, x):
    """x (B,S,d) -> (B,S,d), plus the Switch-style load-balance term
    ``aux`` (a float32 scalar). ``p`` holds one layer's ``router`` (d,E),
    ``w_gate``, ``w_up`` (E,d,ff) and ``w_down`` (E,ff,d). Each group
    packs its own (E, C, d) buffer; the groups fold into the capacity axis
    of the expert products."""
    _check(cfg)
    B, S, d = x.shape
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    probs, top_p, top_e = route(cfg, p, x)
    G, Ng = probs.shape[:2]
    dev = x.device

    density = torch.mean(F.one_hot(top_e, E).sum(dim=2).float(), dim=(0, 1))
    aux = E * torch.sum(density / K * torch.mean(probs, dim=(0, 1)))

    C = capacity(cfg, Ng)
    R = E * C + 1                                  # row E*C drops
    grp = torch.arange(G, device=dev)[:, None]
    flat_e = top_e.reshape(G, Ng * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    counts = torch.bincount((flat_e + E * grp).flatten(),
                            minlength=G * E).view(G, E)
    starts = torch.cumsum(counts, dim=-1) - counts
    rank = torch.arange(Ng * K, device=dev)[None] \
        - torch.gather(starts, 1, sorted_e)
    dest = (torch.where(rank < C, sorted_e * C + rank, E * C)
            + R * grp).flatten()
    xg = x.reshape(G, Ng, d)
    src = torch.gather(xg, 1, (order // K)[..., None].expand(-1, -1, d))
    buf = x.new_zeros(G * R, d).index_copy(0, dest, src.reshape(-1, d))
    h = buf.view(G, R, d)[:, :E * C].reshape(G, E, C, d) \
        .transpose(0, 1).reshape(E, G * C, d)

    if cfg.activation in ("swiglu", "geglu"):
        act = F.silu if cfg.activation == "swiglu" else cm._gelu
        h = torch.bmm(act(torch.bmm(h, p["w_gate"]))
                      * torch.bmm(h, p["w_up"]), p["w_down"])
    else:
        h = torch.bmm(cm._gelu(torch.bmm(h, p["w_gate"])), p["w_down"])

    hbuf = h.reshape(E, G, C, d).transpose(0, 1).reshape(G, E * C, d)
    hflat = torch.cat([hbuf, hbuf.new_zeros(G, 1, d)], dim=1) \
        .reshape(G * R, d)
    got = hflat[dest]
    y = got.new_zeros(G * Ng * K, d).index_copy(
        0, (order + Ng * K * grp).flatten(), got)
    y = torch.sum(y.view(G, Ng, K, d) * top_p[..., None].to(y.dtype), dim=2)
    return y.reshape(B, S, d), aux


def _experts(lp):
    """A layer's ``moe/...`` leaves, keyed as :func:`moe_ffn` takes them."""
    return {k[4:]: v for k, v in lp.items() if k.startswith("moe/")}


def _attend(cfg, lp, x, q, k, v, mask):
    return x + cm.sdpa(q, k, v, mask, cfg.logit_softcap) @ lp["attn/wo"]


def forward_seq(cfg: ModelConfig, params, x, positions, *,
                window: Optional[int] = None,
                cache_capacity: Optional[int] = None, remat: bool = False):
    """Full-sequence forward. x (B,S,d), positions (S,). Returns (logits,
    cache | None, aux): ``aux`` the layers' mean load-balance term."""
    _check(cfg)
    S = x.shape[1]
    cos, sin, rope_dim = cm.rope_for(cfg, positions)
    mask = cm.causal_mask(S, S, window=window, device=x.device)

    def body(x, lp, mp):
        h = cm.apply_norm(cfg, lp, "ln1", x)
        q, k, v = cm.attention_qkv(cfg, lp, h, cos, sin, rope_dim)
        x = _attend(cfg, lp, x, q, k, v, mask)
        y, aux = moe_ffn(cfg, mp, cm.apply_norm(cfg, lp, "ln2", x))
        return x + y, k, v, aux

    ks, vs, auxs = [], [], []
    for lp in layers(params):
        x, k, v, aux = cm.run_layer(remat, body, x, lp, _experts(lp))
        ks.append(k)
        vs.append(v)
        auxs.append(aux)
    logits = dense._final(cfg, params, x)
    cache = None
    if cache_capacity is not None:
        cache = dense.seq_cache(torch.stack(ks), torch.stack(vs),
                                cache_capacity)
    return logits, cache, torch.mean(torch.stack(auxs))


def decode_step(cfg: ModelConfig, params, cache, x, pos, *,
                window: Optional[int] = None):
    """x (B,1,d) new-token embeddings; pos (B,) absolute positions. Writes
    each row's K/V at slot ``pos % C`` and its position into ``pos_map``
    in place; returns (logits (B,1,V), cache)."""
    _check(cfg)
    B = x.shape[0]
    kc, vc, pos_map = cache["k"], cache["v"], cache["pos_map"]
    pos = pos.long()
    slot = pos % kc.shape[2]
    bidx = torch.arange(B, device=x.device)
    pos_map[bidx, slot] = pos.to(torch.int32)
    mask = cm.decode_mask(pos_map, pos, window=window)
    cos, sin, rope_dim = cm.rope_for(cfg, pos[:, None])
    for i in range(cfg.n_layers):
        lp = layer(params, i)
        h = cm.apply_norm(cfg, lp, "ln1", x)
        q, k, v = cm.attention_qkv(cfg, lp, h, cos, sin, rope_dim)
        ck, cv = kc[i], vc[i]
        ck[bidx, slot] = k[:, 0]
        cv[bidx, slot] = v[:, 0]
        x = _attend(cfg, lp, x, q, ck, cv, mask)
        y, _ = moe_ffn(cfg, _experts(lp), cm.apply_norm(cfg, lp, "ln2", x))
        x = x + y
    return dense._final(cfg, params, x), cache


embed_tokens = dense.embed_tokens
