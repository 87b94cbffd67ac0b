"""Plain-torch version of the SSD scan: the *sequential* state-space
recurrence, an independent algorithm from the kernel's chunked form, so a
comparison checks the chunking algebra itself. The wrapper runs it on CPU
tensors."""
from __future__ import annotations

import torch


def ssd_scan_ref(x, la, Bm, Cm, h0=None):
    """x (B,S,H,P): inputs already scaled by dt; la (B,S,H): log decay
    (dt * A, negative); Bm/Cm (B,S,H,N) per head (pre-expanded); h0
    (B,H,P,N) optional initial state (zeros when omitted).

    h_t = exp(la_t) * h_{t-1} + x_t (outer) B_t ;  y_t = C_t . h_t
    Returns (y (B,S,H,P), h_final (B,H,P,N)), float32."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    x, la, Bm, Cm = x.float(), la.float(), Bm.float(), Cm.float()
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        h = torch.exp(la[:, t])[..., None, None] * h \
            + x[:, t, :, :, None] * Bm[:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhpn->bhp", Cm[:, t], h))
    return torch.stack(ys, dim=1), h
