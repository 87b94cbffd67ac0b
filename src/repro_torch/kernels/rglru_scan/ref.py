"""Plain-torch versions of the RG-LRU scan.

``rglru_scan_ref`` is an associative (doubling) scan, a different algorithm
from the kernel's; the wrapper runs it on CPU tensors.
``rglru_scan_segments_ref`` repeats the cluster kernel's arithmetic (runs
walked from zero, aggregates composed in fixed order, the closed-form
output) for the CPU tests; nothing else calls it."""
from __future__ import annotations

import torch
import torch.nn.functional as F


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


def rglru_scan_segments_ref(log_a, gated, h0=None, *, cluster: int,
                            seg: int, run: int, rounds: int):
    """The scan as the cluster route of ``csrc/rglru_scan.cu`` computes it,
    for the (cluster, seg, run, rounds) of ``ops.plan``: round r's block k
    takes steps [(r * cluster + k) * seg, + seg), cut into runs of ``run``
    steps. Each run is walked from h = 0, keeping its local state and its
    decay A_t = exp(log_a_1) ... exp(log_a_t) (a running product, as
    exp(sum log_a)); each segment's aggregate (A, e) folds its runs; the
    state entering a segment composes the earlier segments' aggregates in
    order from h0 (carry = A_j carry + e_j, round after round); and
    h_t = local_t + A_t carry_run. Steps past S are identity steps (log_a
    0, gated 0), as the kernel leaves them out. Returns (h, h_final) like
    ``rglru_scan_ref``."""
    la, g = log_a.float(), gated.float()
    B, S, W = la.shape
    nr = -(-seg // run)                       # runs of a segment
    R, K = rounds, cluster

    def cut(x):                               # (B, R, K, nr, run, W)
        x = F.pad(x, (0, 0, 0, R * K * seg - S)).view(B, R, K, seg, W)
        return F.pad(x, (0, 0, 0, nr * run - seg)).view(B, R, K, nr, run, W)

    la, g = cut(la), cut(g)
    dec, loc = torch.empty_like(la), torch.empty_like(g)
    A = torch.ones_like(la[..., 0, :])
    e = torch.zeros_like(A)
    for t in range(run):                      # phase 1: every run at once
        a = torch.exp(la[..., t, :])
        A = A * a
        e = a * e + g[..., t, :]
        dec[..., t, :], loc[..., t, :] = A, e
    segA = torch.ones_like(A[:, :, :, 0])
    sege = torch.zeros_like(segA)
    for q in range(nr):                       # each segment's aggregate
        sege = A[:, :, :, q] * sege + e[:, :, :, q]
        segA = segA * A[:, :, :, q]
    carry = la.new_zeros((B, W)) if h0 is None else h0.float()
    cin = torch.empty_like(A)                 # each run's carry
    for r in range(R):                        # phase 2: fixed order
        for k in range(K):
            x = carry
            for q in range(nr):
                cin[:, r, k, q] = x
                x = A[:, r, k, q] * x + e[:, r, k, q]
            carry = segA[:, r, k] * carry + sege[:, r, k]
    h = loc + dec * cin[..., None, :]         # phase 3
    h = h.view(B, R, K, nr * run, W)[:, :, :, :seg].reshape(B, -1, W)[:, :S]
    return h, h[:, -1]
