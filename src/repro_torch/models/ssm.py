"""Mamba2 (SSD — state-space duality, arXiv:2405.21060), in PyTorch.
Attention-free.

Block: in_proj -> [z | xBC | dt]; causal conv1d + silu over xBC; SSD scan;
gated RMSNorm; out_proj. ``ssd_chunked`` is the plain chunked SSD of the
reference path; ``cfg.attn_impl == "hopper"`` routes the serving path's
chunk scan (``prefill_chunk``) through the hand-written ``ssd_scan`` kernel
(its plain version on CPU tensors).

Norms take ``cfg.norm_eps``. With ``cfg.residual_in_fp32`` the residual
stream runs in float32 from the embedding through the final norm, in every
entry point; each norm's output is cast to the weights' dtype and each
block's output is added to the stream in float32 (mamba_ssm's fused
add-norm). Without it the stream is in the weights' dtype.

State cache (per model):
  {"conv": (L, B, W-1, d_conv_ch), "ssm": (L, B, H, P, N) float32} — O(1)
  in sequence length.

Where the JAX package returned new cache arrays, ``prefill_chunk`` and
``decode_step`` write the new state into the given cache tensors **in
place** (a slot's view of the engine's slabs) and return the same dict.
``decode_step`` takes an optional ``active``, a row index or a bool row mask:
only those rows' state is written, so a parked slot keeps its state exactly
(the JAX fused step masked the returned cache instead). The mask's write
has one shape whatever the rows, so a CUDA graph can replay it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.weights import layer, layers


def _use_kernels(cfg: ModelConfig) -> bool:
    """The serving path's kernel switch (mirrors dense)."""
    if cfg.attn_impl == "reference":
        return False
    if cfg.attn_impl != "hopper":
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    return True


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    H = s.n_heads(cfg.d_model)
    return s, di, H, s.head_dim, s.n_groups, s.d_state


def _split_in(cfg, zxbcdt):
    _, di, H, P, G, N = _dims(cfg)
    return torch.split(zxbcdt, [di, di + 2 * G * N, H], dim=-1)


def _causal_conv(xBC, w, b, state=None):
    """xBC (B,S,Ch); w (W,Ch) depthwise. state (B,W-1,Ch) prepended if given.
    Returns (out (B,S,Ch), new_state (B,W-1,Ch))."""
    W = w.shape[0]
    if state is None:
        state = xBC.new_zeros((xBC.shape[0], W - 1, xBC.shape[2]))
    full = torch.cat([state, xBC], dim=1)                     # (B, S+W-1, Ch)
    out = cm.causal_conv(full, w, b, xBC.shape[1])
    return F.silu(out), full[:, full.shape[1] - (W - 1):]


def ssd_chunked(x, dt, A, Bm, Cm, D, chunk, h0=None):
    """Reference chunked SSD.

    x (B,S,H,P) f32; dt (B,S,H) f32 (already softplus'ed); A (H,) negative;
    Bm, Cm (B,S,G,N); D (H,). h0 optional (B,H,P,N).
    Returns (y (B,S,H,P), h_final (B,H,P,N)).
    """
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Q = chunk
    assert S % Q == 0, (S, Q)
    nc = S // Q
    Bh = torch.repeat_interleave(Bm, rep, dim=2)              # (B,S,H,N)
    Ch = torch.repeat_interleave(Cm, rep, dim=2)

    la = (dt * A).reshape(Bsz, nc, Q, H)                      # log decay
    cum = torch.cumsum(la, dim=2)                             # within chunk
    xq = (x * dt[..., None]).reshape(Bsz, nc, Q, H, P)
    Bq = Bh.reshape(Bsz, nc, Q, H, N)
    Cq = Ch.reshape(Bsz, nc, Q, H, N)

    # --- intra-chunk (quadratic within chunk); mask inside the exp
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # (B,nc,Qi,Qj,H)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=x.device))[None, None, :, :, None]
    decay = torch.exp(torch.where(mask, seg, float("-inf")))
    cb = torch.einsum("bcihn,bcjhn->bcijh", Cq, Bq)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", cb * decay, xq)

    # --- chunk states
    tail = torch.exp(cum[:, :, -1:, :] - cum)                 # (B,nc,Q,H)
    states = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", tail, Bq, xq)
    chunk_decay = torch.exp(torch.sum(la, dim=2))             # (B,nc,H)

    # --- inter-chunk scan
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = chunk_decay[:, c, :, None, None] * h + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                     # (B,nc,H,P,N)

    y_inter = torch.einsum("bcqh,bcqhn,bchpn->bcqhp",
                           torch.exp(cum), Cq, h_prevs)
    y = (y_intra + y_inter).reshape(Bsz, S, H, P) + D[None, None, :, None] * x
    return y, h


def _stream(cfg, x):
    """The residual stream of the embeddings ``x``: float32 with
    ``cfg.residual_in_fp32``, else as given."""
    return x.float() if cfg.residual_in_fp32 else x


def _in_proj(cfg, lp, u):
    # the norm's output in the weights' dtype, whatever the stream's
    x_in = cm.apply_norm(cfg, lp, "ln", u).to(lp["w_in"].dtype)
    return _split_in(cfg, x_in @ lp["w_in"])


def _out(cfg, lp, u, y, z):
    """The scan's float32 output ``y`` in the weights' dtype, gated by
    ``z``, normed and projected, then added to the stream ``u`` in ``u``'s
    dtype."""
    y = y.to(lp["w_out"].dtype)
    y = cm.apply_norm(cfg, lp, "out_norm", y * F.silu(z))
    return u + cm.settled(y @ lp["w_out"])


def _heads(cfg, xBC, B, S):
    _, di, H, P, G, N = _dims(cfg)
    xs, Bm, Cm = torch.split(xBC, [di, G * N, G * N], dim=-1)
    return (xs.reshape(B, S, H, P).float(), Bm.reshape(B, S, G, N).float(),
            Cm.reshape(B, S, G, N).float())


def _block_seq(cfg, lp, u):
    """Full-seq Mamba2 block from zero state. u (B,S,d). Returns (out,
    conv_state, h_final). On DTensors the conv and the scan run on each
    rank's batch rows (``cm.on_rows``), replicated over the model axis."""
    z, xBC, dt = _in_proj(cfg, lp, u)
    consts = (lp["conv_w"], lp["conv_b"], lp["dt_bias"], lp["A_log"],
              lp["D"])
    if isinstance(u, cm.DTensor):
        y, conv_state, h_final = cm.on_rows(
            lambda *a: _mix_seq(cfg, *a), (xBC, dt), consts, 3)
    else:
        y, conv_state, h_final = _mix_seq(cfg, xBC, dt, *consts)
    return _out(cfg, lp, u, y, z), conv_state, h_final


def _mix_seq(cfg, xBC, dt, conv_w, conv_b, dt_bias, A_log, D):
    """The conv, the gates and the chunked scan of :func:`_block_seq`:
    -> (y (B,S,di) float32, conv_state, h_final)."""
    _, di, H, P, G, N = _dims(cfg)
    B, S, _ = xBC.shape
    xBC, conv_state = _causal_conv(xBC, conv_w, conv_b)
    xs, Bm, Cm = _heads(cfg, xBC, B, S)
    dt = cm.softplus(dt.float() + dt_bias)
    y, h_final = ssd_chunked(xs, dt, -torch.exp(A_log), Bm, Cm, D,
                             cfg.ssm.chunk)
    return y.reshape(B, S, di), conv_state, h_final


def _block_step(cfg, lp, u, conv_state, h):
    """Single-token step. u (B,1,d); conv_state (B,W-1,Ch); h (B,H,P,N).
    Returns (out, new_conv, new_h) as new tensors. On DTensors the conv
    and the recurrence run on each rank's batch rows (``cm.on_rows``)."""
    z, xBC, dt = _in_proj(cfg, lp, u)
    consts = (lp["conv_w"], lp["conv_b"], lp["dt_bias"], lp["A_log"],
              lp["D"])
    if isinstance(u, cm.DTensor):
        y, new_conv, h = cm.on_rows(
            lambda *a: _mix_step(cfg, *a), (xBC, dt, conv_state, h),
            consts, 3)
    else:
        y, new_conv, h = _mix_step(cfg, xBC, dt, conv_state, h, *consts)
    return _out(cfg, lp, u, y, z), new_conv, h


def _mix_step(cfg, xBC, dt, conv_state, h, conv_w, conv_b, dt_bias, A_log,
              D):
    """The conv and the one-step recurrence of :func:`_block_step`:
    -> (y (B,1,di) float32, new_conv, new_h)."""
    _, di, H, P, G, N = _dims(cfg)
    B = xBC.shape[0]
    full = torch.cat([conv_state, xBC], dim=1)                 # (B,W,Ch)
    out = torch.einsum("bwc,wc->bc", full, conv_w) + conv_b
    xBC = F.silu(out)
    xs, Bm, Cm = torch.split(xBC, [di, G * N, G * N], dim=-1)
    xs = xs.reshape(B, H, P).float()
    Bm = torch.repeat_interleave(Bm.reshape(B, G, N), H // G, dim=1).float()
    Cm = torch.repeat_interleave(Cm.reshape(B, G, N), H // G, dim=1).float()
    dt = cm.softplus(dt[:, 0].float() + dt_bias)               # (B,H)
    a = torch.exp(dt * -torch.exp(A_log))                      # (B,H)
    h = a[:, :, None, None] * h + torch.einsum("bh,bhn,bhp->bhpn", dt, Bm, xs)
    y = torch.einsum("bhn,bhpn->bhp", Cm, h) + D[None, :, None] * xs
    return y.reshape(B, 1, di), full[:, 1:], h


def _block_chunk(cfg, lp, u, conv_state, h0, valid_len: int):
    """Mamba2 block over one serving chunk with carried state.

    u (B,S,d) where positions >= ``valid_len`` are padding; conv_state
    (B,W-1,Ch); h0 (B,H,P,N). dt is zeroed at pad positions, so their decay
    is exp(0)=1 and their input contribution dt*x is 0 — the recurrent state
    passes through padding exactly, making the returned state the state
    after ``valid_len`` real tokens. Pad outputs are garbage and must be
    ignored by the caller. Returns (out, new_conv, h_final)."""
    s, di, H, P, G, N = _dims(cfg)
    B, S, _ = u.shape
    W = s.d_conv
    z, xBC, dt = _in_proj(cfg, lp, u)
    full = torch.cat([conv_state, xBC], dim=1)                 # (B,S+W-1,Ch)
    xBC = F.silu(cm.causal_conv(full, lp["conv_w"], lp["conv_b"], S))
    # last W-1 *valid* inputs (reaching into the old state when valid_len<W-1)
    new_conv = full[:, valid_len:valid_len + W - 1]
    xs, Bm, Cm = _heads(cfg, xBC, B, S)
    dt = cm.softplus(dt.float() + lp["dt_bias"])
    valid = (torch.arange(S, device=u.device) < valid_len).float()
    dt = dt * valid[None, :, None]
    A = -torch.exp(lp["A_log"])
    Q = cfg.ssm.chunk
    pad = (-S) % Q                    # chunk widths need not align
    if pad:
        xs, Bm, Cm = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xs, Bm, Cm))
        dt = F.pad(dt, (0, 0, 0, pad))
    if _use_kernels(cfg):
        from repro_torch.kernels.ssd_scan import ssd_scan_op
        y, h_final = ssd_scan_op(xs * dt[..., None], dt * A, Bm, Cm, Q,
                                 h0=h0)            # group-level B and C
        y = y + lp["D"][None, None, :, None] * xs              # skip term
    else:
        y, h_final = ssd_chunked(xs, dt, A, Bm, Cm, lp["D"], Q, h0)
    y = y[:, :S].reshape(B, S, di)
    return _out(cfg, lp, u, y, z), new_conv, h_final


def init_cache(cfg: ModelConfig, batch: int, capacity=None, device="cuda"):
    """Zero decode state for ``batch`` fresh streams — O(1) in context
    length. ``capacity`` is accepted for interface parity with attention
    caches."""
    del capacity
    s, di, H, P, G, N = _dims(cfg)
    from repro_torch.weights import torch_dtype
    L = cfg.n_layers
    return {"conv": torch.zeros((L, batch, s.d_conv - 1, di + 2 * G * N),
                                dtype=torch_dtype(cfg.dtype), device=device),
            "ssm": torch.zeros((L, batch, H, P, N), dtype=torch.float32,
                               device=device)}


def _final(cfg, params, x):
    x = cm.apply_norm(cfg, params, "final_norm", x).to(
        params["tok/embed"].dtype)
    return cm.unembed(cfg, params, x)


def prefill_chunk(cfg: ModelConfig, params, cache, x, offset=None, *,
                  valid_len: int, window=None):
    """Serving chunked prefill: advance the decode state by one chunk.

    x (B,S,d) with positions >= ``valid_len`` padding; cache is the decode
    state {"conv": (L,B,W-1,Ch), "ssm": (L,B,H,P,N)} and is advanced in
    place past the chunk's ``valid_len`` real tokens. ``offset`` is
    accepted for interface parity with the attention families but unused —
    the recurrent state carries all positional context. Returns (logits,
    cache)."""
    del offset, window
    x = cm.constrain_batch(cfg, _stream(cfg, x))
    conv, ssm = cache["conv"], cache["ssm"]
    for i in range(cfg.n_layers):
        x, new_conv, h = _block_chunk(cfg, layer(params, i), x, conv[i],
                                      ssm[i], int(valid_len))
        x = cm.constrain_batch(cfg, x)
        conv[i] = new_conv
        ssm[i] = h
    return _final(cfg, params, x), cache


def forward_seq(cfg: ModelConfig, params, x, positions=None, *,
                window: Optional[int] = None, cache_capacity=None,
                remat: bool = False):
    """x (B,S,d). Returns (logits, cache|None); the cache is new.
    ``remat`` recomputes each layer's activations in the backward pass."""
    del positions, window
    x = cm.constrain_batch(cfg, _stream(cfg, x))
    convs, hs = [], []
    for lp in layers(params):
        x, conv_state, h = cm.run_layer(
            remat, lambda x, lp: _block_seq(cfg, lp, x), x, lp)
        x = cm.constrain_batch(cfg, x)
        convs.append(conv_state)
        hs.append(h)
    cache = None
    if cache_capacity is not None:
        cache = {"conv": torch.stack(convs), "ssm": torch.stack(hs)}
    return _final(cfg, params, x), cache


def _write_state(dst, src, active) -> None:
    """dst's rows ``active`` take src's: by index (``cm.write_rows``) for a
    long index tensor or None, else where the (B,) bool mask is set, in
    place over every row, so a masked-out row keeps its bits."""
    if active is None or active.dtype != torch.bool:
        cm.write_rows(dst, src, active)
        return
    torch.where(active.view((-1,) + (1,) * (dst.dim() - 1)), src, dst,
                out=dst)


def decode_step(cfg: ModelConfig, params, cache, x, pos=None, *,
                window=None, active=None):
    """x (B,1,d) new-token embeddings. Steps every row's recurrence and
    writes the new state in place — only rows ``active`` (a long index
    tensor, or a (B,) bool mask) when given, so the other rows keep theirs
    exactly. Returns (logits (B,1,V), cache)."""
    del pos, window
    x = cm.constrain_batch(cfg, _stream(cfg, x))
    conv, ssm = cache["conv"], cache["ssm"]
    for i in range(cfg.n_layers):
        x, new_conv, h = _block_step(cfg, layer(params, i), x, conv[i],
                                     ssm[i])
        _write_state(conv[i], new_conv, active)
        _write_state(ssm[i], h, active)
    return _final(cfg, params, x), cache


def embed_tokens(cfg: ModelConfig, params, tokens):
    return cm.embed(cfg, params, tokens)
