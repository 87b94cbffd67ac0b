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

On DTensors (the distributed steps) routing, dispatch and combine run on
each rank's groups, which are batch-aligned: a rank whose batch rows hold
whole groups packs their buffers alone. With ``cfg.moe_ep_axis`` the
(G, E, C, d) buffer is resharded group-split -> expert-split over that
axis before the expert products (each rank then multiplies only its own
experts' rows) and back after, the JAX package's two sharding
constraints.

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


def capacity(cfg: ModelConfig, Ng: int) -> int:
    """Slots per expert of a group of ``Ng`` tokens: the reference's
    expression, in Python floats, rounded up to a multiple of 8."""
    m = cfg.moe
    C = int(max(8, -(-Ng * m.top_k // m.n_experts) * m.capacity_factor))
    return -(-int(C) // 8) * 8


def groups(cfg: ModelConfig, n_tokens: int) -> int:
    """``cfg.moe_groups`` when it divides the tokens evenly, else one."""
    G = cfg.moe_groups
    return G if G and n_tokens % max(G, 1) == 0 else 1


def route(cfg: ModelConfig, p, x, G=None):
    """x (B,S,d) -> (probs (G,Ng,E) float32, top_p (G,Ng,K) renormalised,
    top_e (G,Ng,K)): the tokens cut into ``G`` groups (default
    :func:`groups`)."""
    B, S, d = x.shape
    K = cfg.moe.top_k
    G = G or groups(cfg, B * S)
    xg = x.reshape(G, B * S // G, d)
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
    if isinstance(x, cm.DTensor):
        return _moe_ffn_sharded(cfg, p, x)
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    probs, top_p, top_e = route(cfg, p, x)
    density = torch.mean(F.one_hot(top_e, E).sum(dim=2).float(), dim=(0, 1))
    aux = E * torch.sum(density / K * torch.mean(probs, dim=(0, 1)))
    buf, order, dest = dispatch(cfg, x, top_e)
    y = combine(cfg, expert_ffn(cfg, p, buf), order, dest, top_p)
    return y.reshape(x.shape), aux


def dispatch(cfg: ModelConfig, x, top_e):
    """The sort-based pack of x (B,S,d) by ``top_e`` (G,Ng,K): -> (buf
    (G,E,C,d), order, dest), the last two what :func:`combine` needs."""
    d = x.shape[-1]
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    G, Ng = top_e.shape[:2]
    dev = x.device
    C = capacity(cfg, Ng)
    R = E * C + 1                                  # row E*C drops
    grp = torch.arange(G, device=dev)[:, None]
    flat_e = top_e.reshape(G, Ng * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    # counts by a scatter-add, not bincount: no host read of the size
    counts = torch.zeros(G * E, dtype=torch.long, device=dev).scatter_add_(
        0, (flat_e + E * grp).flatten(),
        torch.ones(G * Ng * K, dtype=torch.long, device=dev)).view(G, E)
    starts = torch.cumsum(counts, dim=-1) - counts
    rank = torch.arange(Ng * K, device=dev)[None] \
        - torch.gather(starts, 1, sorted_e)
    dest = (torch.where(rank < C, sorted_e * C + rank, E * C)
            + R * grp).flatten()
    xg = x.reshape(G, Ng, d)
    src = torch.gather(xg, 1, (order // K)[..., None].expand(-1, -1, d))
    buf = x.new_zeros(G * R, d).index_copy(0, dest, src.reshape(-1, d))
    return buf.view(G, R, d)[:, :E * C].reshape(G, E, C, d), order, dest


def expert_ffn(cfg: ModelConfig, p, buf):
    """The expert products of the packed buffer (G,E,C,d) -> (G,E,C,d),
    batched over experts with the groups folded into the capacity axis."""
    G, E, C, d = buf.shape
    h = buf.transpose(0, 1).reshape(E, G * C, d)
    if cfg.activation in ("swiglu", "geglu"):
        act = F.silu if cfg.activation == "swiglu" else cm._gelu
        h = torch.bmm(act(torch.bmm(h, p["w_gate"]))
                      * torch.bmm(h, p["w_up"]), p["w_down"])
    else:
        h = torch.bmm(cm._gelu(torch.bmm(h, p["w_gate"])), p["w_down"])
    return h.reshape(E, G, C, d).transpose(0, 1)


def combine(cfg: ModelConfig, h, order, dest, top_p):
    """Each (token, expert) pair's row of the expert outputs h (G,E,C,d)
    back in token order (dropped pairs zero), weighted by ``top_p`` and
    summed over the K experts -> (G, Ng, d)."""
    G, E, C, d = h.shape
    Ng, K = top_p.shape[1:]
    grp = torch.arange(G, device=h.device)[:, None]
    hflat = torch.cat([h.reshape(G, E * C, d), h.new_zeros(G, 1, d)],
                      dim=1).reshape(-1, d)
    got = hflat[dest]
    y = got.new_zeros(G * Ng * K, d).index_copy(
        0, (order + Ng * K * grp).flatten(), got)
    return torch.sum(y.view(G, Ng, K, d) * top_p[..., None].to(y.dtype),
                     dim=2)


def _moe_ffn_sharded(cfg: ModelConfig, p, x):
    """:func:`moe_ffn` on DTensors: route, pack and combine on each rank's
    groups (all groups on every rank when a rank's rows do not hold whole
    groups), the expert products on DTensors between the two reshards of
    ``cfg.moe_ep_axis``."""
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.distributed.sharding import placements
    B, S, d = x.shape
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    mesh, R = x.device_mesh, cm.Replicate()
    G = groups(cfg, B * S)
    split = [i for i, pl in enumerate(x.placements)
             if pl == cm.Shard(0) and mesh.size(i) > 1]
    n = 1
    for i in split:
        n *= mesh.size(i)
    if G % n or B % n:
        split, n = [], 1
    rows = tuple(cm.Shard(0) if i in split else R for i in range(mesh.ndim))
    part = tuple(cm.Partial() if i in split else R
                 for i in range(mesh.ndim))

    def pack(x, router):
        probs, top_p, top_e = route(cfg, {"router": router}, x, G // n)
        buf, order, dest = dispatch(cfg, x, top_e)
        # each expert's pairs by a scatter-add (one_hot reads the max)
        cnt = torch.zeros(E, dtype=torch.float32, device=x.device)
        cnt.scatter_add_(0, top_e.flatten(),
                         torch.ones(top_e.numel(), device=x.device))
        return buf, order, dest, top_p, cnt, probs.sum(dim=(0, 1))

    buf, order, dest, top_p, cnt, psum = local_map(
        pack, out_placements=(rows, rows, rows, rows, part, part),
        in_placements=(rows, (R,) * mesh.ndim),
        in_grad_placements=(rows, part), device_mesh=mesh,
        redistribute_inputs=True)(x, p["router"])
    bax = cfg.act_batch_axes
    b = (tuple(bax) if len(bax) > 1 else bax[0]) if bax else None
    if cfg.moe_ep_axis:
        # group-split -> expert-split; each rank multiplies its groups'
        # rows of its own experts
        buf = buf.redistribute(mesh, placements(
            (b, cfg.moe_ep_axis, None, None), mesh))
        ws = {k: p[k] for k in ("w_gate", "w_up", "w_down") if k in p}
        grads = tuple(tuple(cm.Partial() if pb == cm.Shard(0) else pw
                            for pb, pw in zip(buf.placements, w.placements))
                      for w in ws.values())
        h = local_map(lambda buf, *w: expert_ffn(cfg, dict(zip(ws, w)), buf),
                      out_placements=list(buf.placements),
                      in_placements=(buf.placements,) + tuple(
                          w.placements for w in ws.values()),
                      in_grad_placements=(buf.placements,) + grads,
                      device_mesh=mesh)(buf, *ws.values())
        # expert-split -> group-split
        h = h.redistribute(mesh, placements((b, None, None, None), mesh))
    else:
        h = expert_ffn(cfg, p, buf)
    y = local_map(lambda h, o, t, w: combine(cfg, h, o, t, w),
                  out_placements=list(rows), in_placements=(rows,) * 4,
                  device_mesh=mesh, redistribute_inputs=True)(
                      h, order, dest, top_p)
    N = B * S
    aux = E * torch.sum(cnt / N / K * (psum / N))
    return y.reshape(B, S, d), aux


def _experts(lp):
    """A layer's ``moe/...`` leaves, keyed as :func:`moe_ffn` takes them."""
    return {k[4:]: v for k, v in lp.items() if k.startswith("moe/")}


def _attend(cfg, lp, x, q, k, v, mask):
    return x + cm.settled(
        cm.sdpa(q, k, v, mask, cfg.logit_softcap) @ lp["attn/wo"])


def forward_seq(cfg: ModelConfig, params, x, positions, *,
                window: Optional[int] = None,
                cache_capacity: Optional[int] = None, remat: bool = False):
    """Full-sequence forward. x (B,S,d), positions (S,). Returns (logits,
    cache | None, aux): ``aux`` the layers' mean load-balance term."""
    S = x.shape[1]
    x = cm.constrain_batch(cfg, x)
    cos, sin, rope_dim = cm.rope_for(cfg, positions)
    mask = cm.causal_mask(S, S, window=window, device=x.device)

    def body(x, lp, mp):
        h = cm.apply_norm(cfg, lp, "ln1", x)
        q, k, v = cm.attention_qkv(cfg, lp, h, cos, sin, rope_dim)
        q, k, v = cm.constrain_seq_attention(cfg, q, k, v)
        x = _attend(cfg, lp, x, q, k, v, mask)
        y, aux = moe_ffn(cfg, mp, cm.apply_norm(cfg, lp, "ln2", x))
        return cm.constrain_batch(cfg, x + y), k, v, aux

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
    B = x.shape[0]
    x = cm.constrain_batch(cfg, x)
    kc, vc, pos_map = cache["k"], cache["v"], cache["pos_map"]
    pos = pos.long()
    slot = pos % kc.shape[2]
    bidx = torch.arange(B, device=x.device)
    cm.write_slots(pos_map, pos.to(torch.int32), slot, bidx)
    mask = cm.decode_mask(pos_map, pos, window=window)
    cos, sin, rope_dim = cm.rope_for(cfg, pos[:, None])
    for i in range(cfg.n_layers):
        lp = layer(params, i)
        h = cm.apply_norm(cfg, lp, "ln1", x)
        q, k, v = cm.attention_qkv(cfg, lp, h, cos, sin, rope_dim)
        ck, cv = kc[i], vc[i]
        cm.write_slots(ck, k[:, 0], slot, bidx)
        cm.write_slots(cv, v[:, 0], slot, bidx)
        x = _attend(cfg, lp, x, q, ck, cv, mask)
        y, _ = moe_ffn(cfg, _experts(lp), cm.apply_norm(cfg, lp, "ln2", x))
        x = x + y
    return dense._final(cfg, params, x), cache


embed_tokens = dense.embed_tokens
