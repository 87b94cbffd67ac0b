"""Plain float32 reference of a dense decoder (Qwen3's published block):
pre-norm RMSNorm, grouped-query attention with RMSNorm on each query and
key head, rotary positions (rotate-half, base ``rope_theta``), a SwiGLU MLP,
a final RMSNorm and the embedding tied to the output head.

It reads the weights in the serving program's parameter layout (the flat
``a/b/c`` paths below, matrices stored as (in, out), a norm's scale ``w``
applied as ``1 + w``), and imports nothing of the program. The benchmark
makes those weights here (:func:`init_weights`) and hands the same tensors
to both sides.

``logits_at`` runs one sequence through the whole model in float32 with
TF32 off, attention in blocks of query rows, and returns the logits of the
positions asked for. ``precision="fp8"`` is the control: every linear
layer's input rows and weight columns are rounded to float8 e4m3 (each with
its own absmax scale) before an exact float32 product.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

from arrow_bench.reference import common as rc

QUERY_BLOCK = 2048       # query rows a block of the attention


def padded_vocab(conf: dict) -> int:
    return -(-conf["vocab_size"] // 256) * 256


def layout(conf: dict) -> List[Tuple[str, tuple, str]]:
    """(path, shape, init rule) of every leaf, in the program's layout."""
    d, L = conf["hidden_size"], conf["num_hidden_layers"]
    H, Hk, D = (conf["num_attention_heads"], conf["num_key_value_heads"],
                conf["head_dim"])
    ff = conf["intermediate_size"]
    out = [("tok/embed", (padded_vocab(conf), d), "normal"),
           ("layers/ln1/scale", (L, d), "zeros"),
           ("layers/attn/wq", (L, d, H * D), "normal"),
           ("layers/attn/wk", (L, d, Hk * D), "normal"),
           ("layers/attn/wv", (L, d, Hk * D), "normal"),
           ("layers/attn/wo", (L, H * D, d), "normal"),
           ("layers/attn/q_norm", (L, D), "zeros"),
           ("layers/attn/k_norm", (L, D), "zeros"),
           ("layers/ln2/scale", (L, d), "zeros"),
           ("layers/mlp/w_gate", (L, d, ff), "normal"),
           ("layers/mlp/w_up", (L, d, ff), "normal"),
           ("layers/mlp/w_down", (L, ff, d), "normal"),
           ("final_norm/scale", (d,), "zeros")]
    if not conf["tie_word_embeddings"]:
        raise NotImplementedError("the dense reference ties its embedding")
    return out


def init_weights(conf: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return rc.init_from_layout(layout(conf), conf, seed, device)


def _rope(x, positions, theta: float):
    """Rotate-half rotary embedding of x (T, heads, D) at ``positions``."""
    D = x.shape[-1]
    half = D // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float64,
                                        device=x.device) / half))
    ang = positions.double()[:, None] * inv[None, :]
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v):
    """Causal attention of q (T, H, D) over k, v (T, Hk, D), float32, in
    blocks of ``QUERY_BLOCK`` query rows -> (T, H*D)."""
    T, H, D = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1).transpose(0, 1)      # (H, T, D)
    v = v.repeat_interleave(G, dim=1).transpose(0, 1)
    out = torch.empty((T, H, D), dtype=torch.float32, device=q.device)
    scale = 1.0 / math.sqrt(D)
    for s in range(0, T, QUERY_BLOCK):
        e = min(s + QUERY_BLOCK, T)
        qb = q[s:e].transpose(0, 1)                        # (H, n, D)
        scores = torch.matmul(qb, k[:, :e].transpose(1, 2)) * scale
        rows = torch.arange(s, e, device=q.device)[:, None]
        cols = torch.arange(e, device=q.device)[None, :]
        scores.masked_fill_(cols > rows, float("-inf"))
        p = torch.softmax(scores, dim=-1)
        out[s:e] = torch.matmul(p, v[:, :e]).transpose(0, 1)
    return out.reshape(T, H * D)


@torch.no_grad()
def logits_at(conf: dict, params, tokens: Sequence[int],
              positions: Sequence[int], precision: str = "f32"
              ) -> torch.Tensor:
    """Float32 logits (len(positions), vocab_size) of one sequence
    ``tokens`` at ``positions`` (each < len(tokens))."""
    with rc.exact_float32():
        dev = params["tok/embed"].device
        lin = rc.linear_for(precision)
        d, L = conf["hidden_size"], conf["num_hidden_layers"]
        H, Hk, D = (conf["num_attention_heads"], conf["num_key_value_heads"],
                    conf["head_dim"])
        eps, theta = conf["rms_norm_eps"], float(conf["rope_theta"])
        tok = torch.as_tensor(list(tokens), dtype=torch.long, device=dev)
        T = tok.shape[0]
        pos = torch.arange(T, device=dev)
        x = params["tok/embed"][tok].float()
        for i in range(L):
            w = {k[len("layers/"):]: v[i].float() for k, v in params.items()
                 if k.startswith("layers/")}
            h = rc.rms_norm(x, w["ln1/scale"], eps)
            q = lin(h, w["attn/wq"]).reshape(T, H, D)
            k = lin(h, w["attn/wk"]).reshape(T, Hk, D)
            v = lin(h, w["attn/wv"]).reshape(T, Hk, D)
            q = _rope(rc.rms_norm(q, w["attn/q_norm"], eps), pos, theta)
            k = _rope(rc.rms_norm(k, w["attn/k_norm"], eps), pos, theta)
            x = x + lin(_attention(q, k, v), w["attn/wo"])
            h = rc.rms_norm(x, w["ln2/scale"], eps)
            x = x + lin(torch.nn.functional.silu(lin(h, w["mlp/w_gate"]))
                        * lin(h, w["mlp/w_up"]), w["mlp/w_down"])
            del w, h, q, k, v
        sel = torch.as_tensor(list(positions), dtype=torch.long, device=dev)
        h = rc.rms_norm(x[sel], params["final_norm/scale"].float(), eps)
        emb = params["tok/embed"][:conf["vocab_size"]].float()
        return lin(h, emb.T)
