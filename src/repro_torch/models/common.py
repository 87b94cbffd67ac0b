"""Shared building blocks of the dense model family, in PyTorch: norms, RoPE,
the reference GQA attention, masks, the attention projections, MLPs and the
(un)embedding.

Every function is a plain function on tensors. Parameters are a flat dict
keyed by the JAX pytree's ``a/b/c`` paths (see :mod:`repro_torch.weights`);
the functions here receive one layer's slice of it, keyed by the path below
``layers/`` (``"attn/wq"``, ``"ln1/scale"``, ...). Norms and softmaxes run
in float32 and cast back, as the JAX package does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

NEG_INF = -1e30

# ---------------------------------------------------------------------- norm


def rms_norm(x, w, eps=1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def layer_norm(x, w, b, eps=1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * w.float() + b.float()).to(dt)


def apply_norm(cfg: ModelConfig, p, prefix: str, x):
    """``p`` holds ``<prefix>/scale`` (and ``<prefix>/bias`` for layernorm)."""
    if cfg.norm == "rmsnorm":
        return rms_norm(x, p[f"{prefix}/scale"])
    return layer_norm(x, p[f"{prefix}/scale"], p[f"{prefix}/bias"])


# ---------------------------------------------------------------------- rope


def rope_angles(positions, rope_dim: int, theta: float):
    """positions (..., S) -> cos,sin (..., S, rope_dim//2), float32."""
    half = rope_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    inv = 1.0 / (theta ** exps)
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin, rope_dim: int):
    """x (B, S, H, D); cos/sin broadcastable to (B, S, 1, rope_dim//2)."""
    half = rope_dim // 2
    xr, xp = x[..., :rope_dim], x[..., rope_dim:]
    x1f, x2f = xr[..., :half].float(), xr[..., half:].float()
    r1 = x1f * cos - x2f * sin
    r2 = x2f * cos + x1f * sin
    return torch.cat([r1.to(x.dtype), r2.to(x.dtype), xp], dim=-1)


def rope_for(cfg: ModelConfig, positions):
    """(cos, sin, rope_dim) ready for :func:`apply_rope`, or (None, None, 0).
    Standard and partial RoPE; M-RoPE belongs to the VLM family."""
    hd = cfg.head_dim_
    if cfg.rope in ("none", "learned"):
        return None, None, 0
    if cfg.rope == "mrope":
        raise NotImplementedError("M-RoPE is not ported yet (VLM family)")
    rope_dim = hd if cfg.rope == "standard" else int(hd * cfg.rope_fraction)
    rope_dim -= rope_dim % 2
    cos, sin = rope_angles(positions, rope_dim, cfg.rope_theta)
    # positions (S,) -> (1,S,1,half); (B,S) -> (B,S,1,half)
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    return cos[:, :, None, :], sin[:, :, None, :], rope_dim


# ----------------------------------------------------------------- attention


def sdpa(q, k, v, mask, logit_softcap: Optional[float] = None):
    """Reference GQA attention. q (B,S,H,D); k,v (B,T,Hk,D); mask additive,
    broadcastable to (B,Hk,G,S,T). Returns (B,S,H*D) in q's dtype."""
    B, S, H, D = q.shape
    Hk = k.shape[2]
    G = H // Hk
    qg = q.reshape(B, S, Hk, G, D).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) \
        * (1.0 / math.sqrt(D))
    if logit_softcap:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)
    p = torch.softmax(scores + mask, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return o.reshape(B, S, H * D).to(q.dtype)


def _additive(ok):
    return torch.where(ok, 0.0, NEG_INF).float()


def causal_mask(S: int, T: int, q_offset=0, window: Optional[int] = None,
                device=None):
    """(1,1,1,S,T) additive mask; query i sits at q_offset+i, kv j at j."""
    qpos = torch.arange(S, device=device)[:, None] + q_offset
    kpos = torch.arange(T, device=device)[None, :]
    ok = kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    return _additive(ok)[None, None, None]


def decode_mask(kv_positions, pos, window: Optional[int] = None):
    """kv_positions (B,T) absolute position per cache slot (-1 empty);
    pos (B,) current query position. -> (B,1,1,1,T)."""
    ok = (kv_positions >= 0) & (kv_positions <= pos[:, None])
    if window is not None:
        ok &= kv_positions > (pos[:, None] - window)
    return _additive(ok)[:, None, None, None]


def chunk_mask(kv_positions, q_positions, window: Optional[int] = None):
    """Chunked-prefill mask: queries at q_positions (Sq,) attend to cache
    slots whose pos_map (B,T) entry is valid and causal. -> (B,1,1,Sq,T)."""
    kv = kv_positions[:, None, :]
    q = q_positions[None, :, None]
    ok = (kv >= 0) & (kv <= q)
    if window is not None:
        ok &= kv > (q - window)
    return _additive(ok)[:, None, None]


# ----------------------------------------------------------- attention block


def attention_qkv(cfg: ModelConfig, p, x, cos, sin, rope_dim):
    """Project + rope. x (B,S,d) -> q (B,S,H,D), k,v (B,S,Hk,D)."""
    B, S, _ = x.shape
    hd = cfg.head_dim_
    q = (x @ p["attn/wq"]).reshape(B, S, cfg.n_heads, hd)
    k = (x @ p["attn/wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ p["attn/wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["attn/q_norm"])
        k = rms_norm(k, p["attn/k_norm"])
    if rope_dim:
        q = apply_rope(q, cos, sin, rope_dim)
        k = apply_rope(k, cos, sin, rope_dim)
    return q, k, v


# ----------------------------------------------------------------------- mlp


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def mlp(cfg: ModelConfig, p, x):
    if cfg.activation == "swiglu":
        return (F.silu(x @ p["mlp/w_gate"]) * (x @ p["mlp/w_up"])) \
            @ p["mlp/w_down"]
    if cfg.activation == "geglu":
        return (_gelu(x @ p["mlp/w_gate"]) * (x @ p["mlp/w_up"])) \
            @ p["mlp/w_down"]
    return _gelu(x @ p["mlp/w_in"]) @ p["mlp/w_out"]


# ----------------------------------------------------------------- embedding


def embed(cfg: ModelConfig, params, tokens):
    x = params["tok/embed"][tokens.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def unembed(cfg: ModelConfig, params, x):
    """Logits over the padded vocab."""
    if cfg.tie_embeddings:
        return x @ params["tok/embed"].T
    return x @ params["tok/unembed"]
