"""Plain-torch version of paged decode attention: the function the Hopper
kernel computes, and what the wrapper runs on CPU tensors."""
from __future__ import annotations

import math

import torch


def paged_attention_ref(q, k_pages, v_pages, page_table, lengths):
    """q (B,H,D); k_pages/v_pages (P, page, Hk, D); page_table (B, MP)
    int32; lengths (B,) int32. Returns (B,H,D) in q's dtype."""
    B, H, D = q.shape
    page, Hk = k_pages.shape[1], k_pages.shape[2]
    MP = page_table.shape[1]
    G = H // Hk
    pt = page_table.long()
    k = k_pages[pt].reshape(B, MP * page, Hk, D)
    v = v_pages[pt].reshape(B, MP * page, Hk, D)
    qg = q.reshape(B, Hk, G, D).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) / math.sqrt(D)
    pos = torch.arange(MP * page, device=q.device)[None]
    live = (pos < lengths.long()[:, None])[:, None, None]
    p = torch.softmax(s.masked_fill(~live, float("-inf")), dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    return o.reshape(B, H, D).to(q.dtype)
