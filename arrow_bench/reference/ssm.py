"""Plain float32 reference of Mamba-2 (arXiv:2405.21060, the published
block): pre-norm RMSNorm; one input projection to [z | x B C | dt]; a
depthwise causal convolution with bias and SiLU over x B C; the selective
state-space recurrence

    h_t = exp(dt_t * A) h_{t-1} + dt_t * x_t B_t^T,   y_t = h_t C_t + D x_t

with dt_t = softplus(dt_t + dt_bias), A = -exp(A_log), B and C shared by
the heads of a group; the gated RMSNorm ``norm(y * silu(z))``; the output
projection and the residual; a final RMSNorm and the tied output head.

The recurrence is evaluated exactly in its chunked (state-space dual) form,
in float32 with TF32 off: within a chunk of ``CHUNK`` positions the
quadratic form, across chunks the carried state. It reads the weights in
the serving program's parameter layout and imports nothing of the program.
``precision="fp8"`` is the control: the linear layers' operands in float8
e4m3.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from arrow_bench.reference import common as rc

CHUNK = 128


def padded_vocab(conf: dict) -> int:
    return -(-conf["vocab_size"] // 256) * 256


def _dims(conf: dict):
    ssm = conf["ssm_cfg"]
    d = conf["d_model"]
    di = ssm["expand"] * d
    P = ssm["headdim"]
    return d, di, di // P, P, ssm["ngroups"], ssm["d_state"], ssm["d_conv"]


def layout(conf: dict) -> List[Tuple[str, tuple, str]]:
    """(path, shape, init rule) of every leaf, in the program's layout."""
    d, di, H, P, G, N, W = _dims(conf)
    L = (conf["n_layer"],)
    ch = di + 2 * G * N
    if not conf["tie_embeddings"]:
        raise NotImplementedError("the ssm reference ties its embedding")
    return [("tok/embed", (padded_vocab(conf), d), "normal"),
            ("layers/ln/scale", L + (d,), "zeros"),
            ("layers/w_in", L + (d, 2 * di + 2 * G * N + H), "normal"),
            ("layers/conv_w", L + (W, ch), "conv"),
            ("layers/conv_b", L + (ch,), "zeros"),
            ("layers/A_log", L + (H,), "a_log"),
            ("layers/D", L + (H,), "ones_f32"),
            ("layers/dt_bias", L + (H,), "zeros_f32"),
            ("layers/out_norm/scale", L + (di,), "zeros"),
            ("layers/w_out", L + (di, d), "normal"),
            ("final_norm/scale", (d,), "zeros")]


def init_weights(conf: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return rc.init_from_layout(layout(conf), conf, seed, device)


def ssd(x, dt, A, B, C, chunk: int = CHUNK):
    """The recurrence over one sequence from a zero state, without the D
    skip: x (T,H,P), dt (T,H) (after softplus), A (H,), B/C (T,G,N) ->
    y (T,H,P). Pad positions get dt = 0: decay 1 and no input."""
    T, H, P = x.shape
    G, N = B.shape[1], B.shape[2]
    pad = (-T) % chunk
    if pad:
        x, B, C = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, B, C))
        dt = F.pad(dt, (0, 0, 0, pad))
    n = x.shape[0] // chunk
    grp = torch.arange(H, device=x.device) // (H // G)
    a = (dt * A).reshape(n, chunk, H)                    # log decay a step
    u = (x * dt[..., None]).reshape(n, chunk, H, P)      # dt * x
    Bc = B.reshape(n, chunk, G, N)
    Cc = C.reshape(n, chunk, G, N)
    cum = torch.cumsum(a, dim=1)                         # (n, Q, H)
    # within a chunk: y_i += sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) u_j
    seg = cum[:, :, None, :] - cum[:, None, :, :]        # (n, Qi, Qj, H)
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()[None, :, :, None]
    decay = torch.exp(seg.masked_fill(~causal, float("-inf")))
    cb = torch.einsum("cign,cjgn->cijg", Cc, Bc)[..., grp]   # (n,Qi,Qj,H)
    y = torch.einsum("cijh,cjhp->cihp", cb * decay, u)
    # each chunk's own end state, then the carried state
    tail = torch.exp(cum[:, -1:, :] - cum)               # (n, Q, H)
    ends = torch.einsum("cjh,cjhn,cjhp->chpn", tail, Bc[:, :, grp], u)
    step = torch.exp(cum[:, -1, :])                      # (n, H)
    h = torch.zeros((H, P, N), dtype=torch.float32, device=x.device)
    starts = []
    for c in range(n):
        starts.append(h)
        h = step[c][:, None, None] * h + ends[c]
    starts = torch.stack(starts)                         # (n, H, P, N)
    y = y + torch.einsum("cih,cihn,chpn->cihp", torch.exp(cum),
                         Cc[:, :, grp], starts)
    return y.reshape(n * chunk, H, P)[:T]


@torch.no_grad()
def logits_at(conf: dict, params, tokens: Sequence[int],
              positions: Sequence[int], precision: str = "f32"
              ) -> torch.Tensor:
    """Float32 logits (len(positions), vocab_size) of one sequence
    ``tokens`` at ``positions``."""
    with rc.exact_float32():
        dev = params["tok/embed"].device
        lin = rc.linear_for(precision)
        d, di, H, P, G, N, W = _dims(conf)
        eps = conf["norm_epsilon"]
        tok = torch.as_tensor(list(tokens), dtype=torch.long, device=dev)
        T = tok.shape[0]
        x = params["tok/embed"][tok].float()
        for i in range(conf["n_layer"]):
            w = {k[len("layers/"):]: v[i].float() for k, v in params.items()
                 if k.startswith("layers/")}
            zxbcdt = lin(rc.rms_norm(x, w["ln/scale"], eps), w["w_in"])
            z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * G * N, H], -1)
            xbc = F.pad(xbc, (0, 0, W - 1, 0))           # causal: W-1 zeros
            conv = sum(xbc[j:j + T] * w["conv_w"][j] for j in range(W))
            xbc = F.silu(conv + w["conv_b"])
            xs, Bm, Cm = torch.split(xbc, [di, G * N, G * N], -1)
            xs = xs.reshape(T, H, P)
            dt = torch.logaddexp(dt + w["dt_bias"], torch.zeros_like(dt))
            y = ssd(xs, dt, -torch.exp(w["A_log"]), Bm.reshape(T, G, N),
                    Cm.reshape(T, G, N))
            y = (y + w["D"][None, :, None] * xs).reshape(T, di)
            y = rc.rms_norm(y * F.silu(z), w["out_norm/scale"], eps)
            x = x + lin(y, w["w_out"])
            del w, zxbcdt, z, xbc, dt, conv, xs, Bm, Cm, y
        sel = torch.as_tensor(list(positions), dtype=torch.long, device=dev)
        h = rc.rms_norm(x[sel], params["final_norm/scale"].float(), eps)
        emb = params["tok/embed"][:conf["vocab_size"]].float()
        return lin(h, emb.T)
