"""Parameters of the dense, ssm (Mamba-2) and hybrid (RecurrentGemma)
families as a flat dict of tensors.

Leaves are keyed by the same ``a/b/c`` paths the JAX package's checkpoint
flattening uses (``tok/embed``, ``layers/attn/wq``, ``final_norm/scale``,
``groups/sub0_rglru/rglru/w_a``, ...), and stacked leaves keep their leading
layer (or group) axis, so one dict describes the whole model and a layer is
a view ``t[i]`` of each leaf.

Most leaves are in ``cfg.dtype``; a few are float32 whatever it is, as in
the JAX package: ``A_log``, ``D`` and ``dt_bias`` of Mamba-2, ``b_a``,
``b_i`` and ``lam`` of the RG-LRU. ``param_shapes`` lists each leaf's path,
shape and dtype.

``init_params`` makes parameters from a ``torch.Generator`` with the JAX
package's shapes and init rules (normal x 0.02 for matrices, x 0.2 for the
causal convolutions, zeros for RMSNorm scales, which are applied as
``1 + w``, and the fixed ``A_log``, ``D``, ``dt_bias`` and ``lam``).
``from_jax_params`` carries a JAX params pytree (already on the host as
numpy arrays) across bit for bit, each leaf in its own dtype.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

Params = Dict[str, torch.Tensor]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def flatten(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(path, leaf) pairs of a nested dict/list pytree, ``a/b/c`` keyed."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flatten(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes bf16: carry the bits
        bits = torch.from_numpy(a.view(np.uint16).astype(np.int16))
        return bits.view(torch.bfloat16)
    return torch.from_numpy(np.array(a))          # a writable copy


def from_jax_params(tree, cfg: ModelConfig, device) -> Params:
    """The JAX params pytree (leaves as numpy arrays) -> the port's flat
    dict of tensors on ``device``, bit for bit."""
    return from_tensors({path: _to_tensor(leaf)
                         for path, leaf in flatten(tree)}, cfg, device)


def load_jax_checkpoint(path, cfg: ModelConfig, device) -> Params:
    """Read a params file written by the JAX package's ``save_checkpoint``
    (msgpack of ``{path: {dtype, shape, data}}``). ``torch.frombuffer``
    reads bf16 leaves, which plain numpy cannot."""
    import msgpack
    with open(path, "rb") as f:
        payload = msgpack.unpackb(f.read(), strict_map_key=False)
    out = {}
    for key, rec in payload.items():
        dtype = torch_dtype(rec["dtype"]) if rec["dtype"] in _DTYPES \
            else torch.from_numpy(np.zeros(0, rec["dtype"])).dtype
        t = torch.frombuffer(bytearray(rec["data"]), dtype=dtype)
        out[key] = t.reshape(rec["shape"])
    return from_tensors(out, cfg, device)


def from_tensors(flat: Dict[str, torch.Tensor], cfg: ModelConfig,
                 device) -> Params:
    """Check a flat ``a/b/c``-keyed dict against ``cfg``'s parameter
    shapes and move it to ``device``."""
    out = {k: v.to(device) for k, v in flat.items()}
    expected = {path: shape for path, shape, _ in param_shapes(cfg)}
    if set(out) != set(expected):
        raise ValueError(f"param paths differ from {cfg.arch_id}'s: "
                         f"{sorted(set(out) ^ set(expected))}")
    for path, shape in expected.items():
        if tuple(out[path].shape) != shape:
            raise ValueError(f"{path}: shape {tuple(out[path].shape)} "
                             f"!= {shape}")
    return out


def _norm(cfg, prefix, lead, d, dtype):
    out = [(f"{prefix}/scale", lead + (d,), dtype)]
    if cfg.norm != "rmsnorm":
        out.append((f"{prefix}/bias", lead + (d,), dtype))
    return out


def _attention(cfg, prefix, lead, dtype):
    d, hd = cfg.d_model, cfg.head_dim_
    out = [(f"{prefix}/wq", lead + (d, cfg.n_heads * hd), dtype),
           (f"{prefix}/wk", lead + (d, cfg.n_kv_heads * hd), dtype),
           (f"{prefix}/wv", lead + (d, cfg.n_kv_heads * hd), dtype),
           (f"{prefix}/wo", lead + (cfg.n_heads * hd, d), dtype)]
    if cfg.qk_norm:
        out += [(f"{prefix}/q_norm", lead + (hd,), dtype),
                (f"{prefix}/k_norm", lead + (hd,), dtype)]
    return out


def _mlp(cfg, prefix, lead, dtype):
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.activation in ("swiglu", "geglu"):
        return [(f"{prefix}/w_gate", lead + (d, ff), dtype),
                (f"{prefix}/w_up", lead + (d, ff), dtype),
                (f"{prefix}/w_down", lead + (ff, d), dtype)]
    return [(f"{prefix}/w_in", lead + (d, ff), dtype),
            (f"{prefix}/w_out", lead + (ff, d), dtype)]


def _ssm_layers(cfg, dtype):
    s, d, L = cfg.ssm, cfg.d_model, (cfg.n_layers,)
    di, H, G, N = s.d_inner(d), s.n_heads(d), s.n_groups, s.d_state
    conv_ch = di + 2 * G * N
    f32 = torch.float32
    return (_norm(cfg, "layers/ln", L, d, dtype)
            + [("layers/w_in", L + (d, 2 * di + 2 * G * N + H), dtype),
               ("layers/conv_w", L + (s.d_conv, conv_ch), dtype),
               ("layers/conv_b", L + (conv_ch,), dtype),
               ("layers/A_log", L + (H,), f32),
               ("layers/D", L + (H,), f32),
               ("layers/dt_bias", L + (H,), f32)]
            + _norm(cfg, "layers/out_norm", L, di, dtype)
            + [("layers/w_out", L + (di, d), dtype)])


def _hybrid_sub(cfg, kind, prefix, lead, dtype):
    d = cfg.d_model
    out = (_norm(cfg, f"{prefix}/ln1", lead, d, dtype)
           + _norm(cfg, f"{prefix}/ln2", lead, d, dtype)
           + _mlp(cfg, f"{prefix}/mlp", lead, dtype))
    if kind == "attn":
        return out + _attention(cfg, f"{prefix}/attn", lead, dtype)
    lw = cfg.hybrid.lru_width or d
    r, f32 = f"{prefix}/rglru", torch.float32
    return out + [(f"{r}/w_y", lead + (d, lw), dtype),
                  (f"{r}/w_x", lead + (d, lw), dtype),
                  (f"{r}/conv_w", lead + (cfg.hybrid.conv_width, lw), dtype),
                  (f"{r}/conv_b", lead + (lw,), dtype),
                  (f"{r}/w_a", lead + (lw, lw), dtype),
                  (f"{r}/b_a", lead + (lw,), f32),
                  (f"{r}/w_i", lead + (lw, lw), dtype),
                  (f"{r}/b_i", lead + (lw,), f32),
                  (f"{r}/lam", lead + (lw,), f32),
                  (f"{r}/w_o", lead + (lw, d), dtype)]


def _hybrid_blocks(cfg, dtype):
    pat = cfg.hybrid.pattern
    n_groups, tail = divmod(cfg.n_layers, len(pat))
    out = []
    for i, kind in enumerate(pat):
        out += _hybrid_sub(cfg, kind, f"groups/sub{i}_{kind}", (n_groups,),
                           dtype)
    if tail:
        if any(k != pat[0] for k in pat[:tail]):
            raise NotImplementedError("heterogeneous tail not supported")
        out += _hybrid_sub(cfg, pat[0], f"tail/sub0_{pat[0]}", (tail,),
                           dtype)
    return out


def param_shapes(cfg: ModelConfig):
    """(path, shape, dtype) of every leaf, in JAX init order."""
    dtype = torch_dtype(cfg.dtype)
    L, d = (cfg.n_layers,), cfg.d_model
    shapes = [("tok/embed", (cfg.padded_vocab, d), dtype)]
    if not cfg.tie_embeddings:
        shapes.append(("tok/unembed", (d, cfg.padded_vocab), dtype))
    if cfg.family == "dense":
        shapes += (_norm(cfg, "layers/ln1", L, d, dtype)
                   + _attention(cfg, "layers/attn", L, dtype)
                   + _norm(cfg, "layers/ln2", L, d, dtype)
                   + _mlp(cfg, "layers/mlp", L, dtype))
    elif cfg.family == "ssm":
        shapes += _ssm_layers(cfg, dtype)
    elif cfg.family == "hybrid":
        shapes += _hybrid_blocks(cfg, dtype)
    else:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense, ssm and "
            "hybrid are)")
    return shapes + _norm(cfg, "final_norm", (), d, dtype)


_ZERO_LEAVES = ("bias", "q_norm", "k_norm", "conv_b", "dt_bias", "b_a",
                "b_i")


def _init_leaf(cfg, leaf, shape, dtype, generator, device):
    """One leaf by the JAX package's init rule for its name."""
    if leaf == "scale":
        fill = 1.0 if cfg.norm != "rmsnorm" else 0.0
        return torch.full(shape, fill, dtype=dtype, device=device)
    if leaf in _ZERO_LEAVES:
        return torch.zeros(shape, dtype=dtype, device=device)
    if leaf == "D":
        return torch.ones(shape, dtype=dtype, device=device)
    if leaf in ("A_log", "lam"):
        lo, hi = (1.0, 16.0) if leaf == "A_log" else (0.5, 4.0)
        row = torch.linspace(lo, hi, shape[-1], dtype=torch.float32,
                             device=device)
        row = torch.log(row) if leaf == "A_log" else row
        return row.expand(shape).to(dtype).contiguous()
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (w * (0.2 if leaf == "conv_w" else 0.02)).to(dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Params:
    """Seeded parameters by the JAX package's init rules (see the module
    docstring). The draws come from ``generator`` (on ``device``'s type),
    so they differ from JAX's."""
    return {path: _init_leaf(cfg, path.rsplit("/", 1)[1], shape, dtype,
                             generator, device)
            for path, shape, dtype in param_shapes(cfg)}


def layer(params: Params, i: int, prefix: str = "layers/") -> Params:
    """Entry ``i`` of the stack under ``prefix`` (``layers/`` or a hybrid
    ``groups/sub0_rglru/``), keyed by the path below it (views)."""
    n = len(prefix)
    return {k[n:]: v[i] for k, v in params.items() if k.startswith(prefix)}
