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
