"""Plain-torch version of the RG-LRU scan: an associative (doubling) scan,
a different algorithm from the kernel's sequential walk. The wrapper runs
it on CPU tensors."""
from __future__ import annotations

import torch


def rglru_scan_ref(log_a, gated, h0=None):
    """log_a, gated (B,S,W). h_t = exp(log_a_t) h_{t-1} + gated_t, from
    h0 (B,W) (zeros when omitted). Returns (h (B,S,W), h_final (B,W)),
    float32.

    The doubling scan combines (a1, b1) then (a2, b2) into
    (a1 a2, a2 b1 + b2), as JAX's ``associative_scan`` does."""
    a = torch.exp(log_a.float())
    h = gated.float()
    S = a.shape[1]
    d = 1
    while d < S:
        h = torch.cat([h[:, :d], a[:, d:] * h[:, :-d] + h[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    if h0 is not None:
        h = h + a * h0.float()[:, None, :]
    return h, h[:, -1]
