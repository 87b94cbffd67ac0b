"""Plain-torch version of flash (chunked-)prefill attention: the function
the Hopper kernel computes, and what the wrappers run on CPU tensors."""
from __future__ import annotations

import math
from typing import Optional

import torch


def flash_prefill_ref(q, k, v, *, q_offset: int = 0,
                      window: Optional[int] = None, causal: bool = True):
    """q (B,H,Sq,D); k,v (B,Hk,T,D). Query row i has absolute position
    q_offset+i; kv column j has absolute position j. Returns (B,H,Sq,D) in
    q's dtype; scores and softmax in float32."""
    B, H, Sq, D = q.shape
    Hk, T = k.shape[1], k.shape[2]
    G = H // Hk
    qg = q.reshape(B, Hk, G, Sq, D).float()
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) / math.sqrt(D)
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(T, device=q.device)[None, :]
    ok = torch.ones((Sq, T), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    s = s.masked_fill(~ok, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    return o.reshape(B, H, Sq, D).to(q.dtype)


def flash_prefill_split_ref(q, k, v, *, q_offset: int = 0,
                            window: Optional[int] = None, qp: int,
                            n_split: int):
    """The split-KV arithmetic of the wgmma route in plain torch, same
    arguments and result as :func:`flash_prefill_ref`. Each tile of ``qp``
    query positions walks the kv tiles of ``ops.kv_tile_range`` cut by
    ``ops.split_range``; split s yields an unnormalised float32 partial
    (o_s, m_s, l_s) and the partials merge by log-sum-exp. A split in which
    a row sees no live key has m_s = -1e30, l_s = 0 and weight 0."""
    from repro_torch.kernels.flash_prefill.ops import (TILE, kv_tile_range,
                                                       split_range)
    NEG = -1e30
    B, H, Sq, D = q.shape
    Hk, T = k.shape[1], k.shape[2]
    G = H // Hk
    qf = q.float()
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    out = torch.empty(B, H, Sq, D, dtype=torch.float32, device=q.device)
    for qt in range(-(-Sq // qp)):
        rows = torch.arange(qt * qp, min(qt * qp + qp, Sq), device=q.device)
        qpos = rows[:, None] + q_offset
        t0, t1 = kv_tile_range(qt, qp, Sq, T, q_offset, window)
        parts = []
        for s in range(n_split):
            a, b = split_range(t0, t1, s, n_split)
            kpos = torch.arange(a * TILE, min(b * TILE, T), device=q.device)
            sc = torch.einsum("bhsd,bhtd->bhst", qf[:, :, rows],
                              kf[:, :, kpos]) / math.sqrt(D)
            ok = kpos[None, :] <= qpos
            if window is not None:
                ok &= kpos[None, :] > qpos - window
            sc = torch.where(ok, sc, torch.full_like(sc, NEG))
            m = sc.amax(-1) if len(kpos) else \
                torch.full(sc.shape[:-1], NEG, device=q.device)
            p = torch.where(sc > 0.5 * NEG, torch.exp(sc - m[..., None]),
                            torch.zeros_like(sc))
            parts.append((p @ vf[:, :, kpos], m, p.sum(-1)))
        m_all = torch.stack([m for _, m, _ in parts])
        w = torch.where(m_all > 0.5 * NEG, torch.exp(m_all - m_all.amax(0)),
                        torch.zeros_like(m_all))
        o = sum(w_s[..., None] * o_s for w_s, (o_s, _, _) in zip(w, parts))
        lsum = sum(w_s * l_s for w_s, (_, _, l_s) in zip(w, parts))
        out[:, :, rows] = o / lsum.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)
