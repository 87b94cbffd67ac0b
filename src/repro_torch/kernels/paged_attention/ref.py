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


def paged_attention_split_ref(q, k_pages, v_pages, page_table, lengths, *,
                              pages_per_split: int, n_split: int):
    """The split-KV arithmetic of the Hopper kernel in plain torch, same
    arguments and result as :func:`paged_attention_ref`. Split s of a row
    walks the page-table entries [s*pps, min(MP, (s+1)*pps)) and yields an
    unnormalised float32 partial (o_s, m_s, l_s); the live splits (those
    holding a position below the row's length) merge by log-sum-exp in
    split order, and a row with no live position gives 0."""
    from repro_torch.kernels.paged_attention.ops import split_pages
    B, H, D = q.shape
    page, Hk = k_pages.shape[1], k_pages.shape[2]
    MP = page_table.shape[1]
    G = H // Hk
    qg = q.reshape(B, Hk, G, D).float() / math.sqrt(D)
    out = torch.zeros(B, Hk, G, D, dtype=torch.float32, device=q.device)
    for b in range(B):
        n = min(int(lengths[b]), MP * page)
        parts = []
        for s in range(n_split):
            first, last = split_pages(pages_per_split, MP, s)
            lo, hi = first * page, min(n, last * page)
            if lo >= hi:
                continue
            pos = torch.arange(lo, hi, device=q.device)
            phys = page_table[b].long()[pos // page]
            k = k_pages[phys, pos % page].float()           # (T, Hk, D)
            v = v_pages[phys, pos % page].float()
            sc = torch.einsum("kgd,tkd->kgt", qg[b], k)
            m = sc.amax(-1)
            p = torch.exp(sc - m[..., None])
            parts.append((torch.einsum("kgt,tkd->kgd", p, v), m, p.sum(-1)))
        if not parts:
            continue
        m_all = torch.stack([m for _, m, _ in parts])
        w = torch.exp(m_all - m_all.amax(0))
        o = sum(w_s[..., None] * o_s for w_s, (o_s, _, _) in zip(w, parts))
        lsum = sum(w_s * l_s for w_s, (_, _, l_s) in zip(w, parts))
        out[b] = o / lsum[..., None]
    return out.reshape(B, H, D).to(q.dtype)
