"""Plain-torch versions of the SSD scan. ``ssd_scan_ref`` is the
*sequential* state-space recurrence, an independent algorithm from the
kernel's chunked form, so a comparison checks the chunking algebra itself;
the wrapper runs it on CPU tensors. ``ssd_scan_phases_ref`` is the kernel's
own three-phase decomposition, step for step, for the CPU tests."""
from __future__ import annotations

import torch


def _per_head(M, H):
    """(B,S,G,N) group-level B or C -> (B,S,H,N), head h reading group
    h // (H/G) (``jnp.repeat(M, H // G, axis=2)``)."""
    G = M.shape[2]
    return M if G == H else torch.repeat_interleave(M, H // G, dim=2)


def ssd_scan_ref(x, la, Bm, Cm, h0=None):
    """x (B,S,H,P): inputs already scaled by dt; la (B,S,H): log decay
    (dt * A, negative); Bm/Cm (B,S,G,N) with G dividing H (G = H: per
    head); h0 (B,H,P,N) optional initial state (zeros when omitted).

    h_t = exp(la_t) * h_{t-1} + x_t (outer) B_t ;  y_t = C_t . h_t
    Returns (y (B,S,H,P), h_final (B,H,P,N)), float32."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    x, la = x.float(), la.float()
    Bm, Cm = _per_head(Bm.float(), H), _per_head(Cm.float(), H)
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        h = torch.exp(la[:, t])[..., None, None] * h \
            + x[:, t, :, :, None] * Bm[:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhpn->bhp", Cm[:, t], h))
    return torch.stack(ys, dim=1), h


def ssd_scan_phases_ref(x, la, Bm, Cm, chunk: int, h0=None):
    """The kernel's arithmetic in plain torch, same arguments and result as
    :func:`ssd_scan_ref` (plus the chunk Q):
      1. C.B^T once per (row, group, chunk);
      2. per (row, head, chunk), in parallel: the intra-chunk output
         (C.B^T o decay) x, the decay formed only where j <= i, and the
         chunk's own state term sum_q exp(cum_last - cum_q) x_q (outer) B_q;
      3. per (row, head), over the chunks in order: y += exp(cum_i) C_i .
         state, then state = exp(cum_last) state + the chunk's term."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = chunk
    nc = S // Q
    rep = H // G
    xq = x.float().reshape(B, nc, Q, H, P)
    cum = torch.cumsum(la.float().reshape(B, nc, Q, H), dim=2)
    Bq = Bm.float().reshape(B, nc, Q, G, N)
    Cq = Cm.float().reshape(B, nc, Q, G, N)
    cb = torch.einsum("bcign,bcjgn->bcgij", Cq, Bq)            # phase 1
    cb = torch.repeat_interleave(cb, rep, dim=2)               # (B,nc,H,Q,Q)
    low = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    cum_h = cum.permute(0, 1, 3, 2)                            # (B,nc,H,Q)
    seg = cum_h[..., :, None] - cum_h[..., None, :]
    decay = torch.where(low, torch.exp(torch.where(low, seg, 0.0)), 0.0)
    y = torch.einsum("bchij,bcjhp->bcihp", cb * decay, xq)     # phase 2
    tail = torch.exp(cum_h[..., -1:] - cum_h)                  # (B,nc,H,Q)
    Bh = torch.repeat_interleave(Bq, rep, dim=3)               # (B,nc,Q,H,N)
    local = torch.einsum("bchq,bcqhp,bcqhn->bchpn", tail, xq, Bh)
    Ch = torch.repeat_interleave(Cq, rep, dim=3)
    state = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    for c in range(nc):                                        # phase 3
        y[:, c] += torch.exp(cum[:, c])[..., None] \
            * torch.einsum("bqhn,bhpn->bqhp", Ch[:, c], state)
        state = torch.exp(cum[:, c, -1])[..., None, None] * state \
            + local[:, c]
    return y.reshape(B, S, H, P), state
