"""Plain float32 reference of the published Mamba-2 language model
(arXiv:2405.21060; mamba_ssm's ``MambaLMHeadModel`` with ``Mamba2``
mixers, ``rms_norm``, ``residual_in_fp32`` and ``fused_add_norm``), one
sequence at a time, with no cache and no batching.

Per layer, on the float32 residual stream ``r``:

    z | xBC | dt = RMSNorm(r) @ w_in
    xBC          = silu(causal depthwise conv(xBC) + conv_b)
    x | B | C    = xBC                  (B and C shared by a group's heads)
    dt           = softplus(dt + dt_bias),   A = -exp(A_log)
    h_t          = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T
    y_t          = h_t C_t + D x_t
    r            = r + GatedRMSNorm(y, z) @ w_out,
                   GatedRMSNorm(y, z) = RMSNorm(y * silu(z)), per group

then ``RMSNorm(r) @ embed^T`` (the tied head). The recurrence runs one
position after another, as written above: no chunked (dual) form.
Everything is float32 with TF32 off, which is what ``residual_in_fp32``
gives the stream and more.

Departures from mamba_ssm, none of which changes the mathematics:

- The weights are read in the port's parameter layout (``tok/embed``,
  ``layers/w_in``, ... stacked over layers): RMSNorm scales are stored as
  ``w`` and applied as ``1 + w`` (mamba_ssm stores the scale
  itself, initialised to 1); the
  convolution's weight is (width, channels) (mamba_ssm's (channels, 1,
  width)); the input projection's columns are in mamba_ssm's order
  ``[z, x, B, C, dt]``.
- The embedding table may hold more rows than the vocabulary (the port
  pads to a multiple of 256, mamba_ssm to ``pad_vocab_size_multiple``);
  :func:`logits` returns the first ``vocab_size`` columns.
- One ``eps`` serves the block norms, the gated norm and the final norm.
  mamba_ssm takes the first and last from ``norm_epsilon`` and fixes the
  gated norm's at 1e-5; the published config leaves ``norm_epsilon`` at its
  default, 1e-5, so the three agree.
- No ``d_intermediate`` MLP and no attention layers (the published model
  has neither), no ``dt`` clamp (mamba_ssm's default limit is (0, inf)).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Sequence

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class Mamba2:
    """The sizes of a Mamba-2 language model (mamba_ssm's names)."""
    n_layer: int
    d_model: int
    vocab_size: int
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    ngroups: int = 1
    norm_epsilon: float = 1e-5

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def nheads(self) -> int:
        return self.d_inner // self.headdim


@contextlib.contextmanager
def _exact_float32():
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def _rms_norm(x, w, eps: float):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
        * (1.0 + w.float())


def _mixer(m: Mamba2, w: Dict[str, torch.Tensor], h):
    """One Mamba-2 mixer over a sequence: h (T, d) -> (T, d)."""
    T = h.shape[0]
    di, H, P, G, N = m.d_inner, m.nheads, m.headdim, m.ngroups, m.d_state
    z, xbc, dt = torch.split(h @ w["w_in"], [di, di + 2 * G * N, H], -1)
    past = F.pad(xbc, (0, 0, m.d_conv - 1, 0))           # causal: zeros
    conv = sum(past[j:j + T] * w["conv_w"][j] for j in range(m.d_conv))
    xbc = F.silu(conv + w["conv_b"])
    x, B, C = torch.split(xbc, [di, G * N, G * N], -1)
    x = x.reshape(T, H, P)
    grp = torch.arange(H) // (H // G)
    B = B.reshape(T, G, N)[:, grp]                       # (T, H, N)
    C = C.reshape(T, G, N)[:, grp]
    dt = F.softplus(dt + w["dt_bias"])                   # (T, H)
    A = -torch.exp(w["A_log"])
    state = torch.zeros(H, P, N)
    ys = []
    for t in range(T):
        state = torch.exp(dt[t] * A)[:, None, None] * state \
            + dt[t][:, None, None] * x[t][:, :, None] * B[t][:, None, :]
        ys.append(state @ C[t][:, :, None])
    y = torch.stack(ys)[..., 0] + w["D"][None, :, None] * x   # (T, H, P)
    g = (y.reshape(T, di) * F.silu(z)).reshape(T, G, di // G)
    scale = w["out_norm/scale"].reshape(G, di // G)
    y = _rms_norm(g, scale, m.norm_epsilon).reshape(T, di)
    return y @ w["w_out"]


@torch.no_grad()
def logits(m: Mamba2, params: Dict[str, torch.Tensor],
           tokens: Sequence[int]) -> torch.Tensor:
    """Float32 logits (len(tokens), vocab_size) of one sequence, on the
    CPU."""
    p = {k: v.detach().float().cpu() for k, v in params.items()}
    with _exact_float32():
        tok = torch.as_tensor(list(tokens), dtype=torch.long)
        r = p["tok/embed"][tok]
        for i in range(m.n_layer):
            w = {k[len("layers/"):]: v[i] for k, v in p.items()
                 if k.startswith("layers/")}
            r = r + _mixer(m, w, _rms_norm(r, w["ln/scale"],
                                           m.norm_epsilon))
        h = _rms_norm(r, p["final_norm/scale"], m.norm_epsilon)
        return h @ p["tok/embed"][:m.vocab_size].T
