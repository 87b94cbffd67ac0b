"""Parameters of every family of the zoo (dense, vlm, moe, ssm (Mamba-2),
hybrid (RecurrentGemma) and encdec (Whisper)) as a flat dict of tensors.

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
package's shapes and init rules (normal x 0.02 for matrices, experts,
routers and learned positions, x 0.2 for the causal convolutions, zeros
for RMSNorm scales, which are applied as ``1 + w``, ones and zeros for
LayerNorm scales and biases, and the fixed ``A_log``, ``D``, ``dt_bias``
and ``lam``).
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
    """Read a params file written by either package's ``save_checkpoint``
    (msgpack of ``{path: {dtype, shape, data}}``). A trainer's file saves
    ``{"params": ...}``, so its keys carry a ``params/`` prefix, which is
    dropped; its other entries (none today) are left out."""
    from repro_torch.checkpoint import read_checkpoint
    flat = read_checkpoint(path)
    if all(k.startswith("params/") for k in flat):
        flat = {k[len("params/"):]: v for k, v in flat.items()}
    return from_tensors(flat, cfg, device)


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


def _attn_block(cfg, prefix, lead, dtype, mlp=True):
    """ln1, attention, ln2 and (with ``mlp``) the MLP of a layer stack."""
    d = cfg.d_model
    out = (_norm(cfg, f"{prefix}/ln1", lead, d, dtype)
           + _attention(cfg, f"{prefix}/attn", lead, dtype)
           + _norm(cfg, f"{prefix}/ln2", lead, d, dtype))
    return out + _mlp(cfg, f"{prefix}/mlp", lead, dtype) if mlp else out


def _moe_experts(cfg, lead, dtype):
    m, d = cfg.moe, cfg.d_model
    E, ff = m.n_experts, m.d_ff_expert
    return [("layers/moe/router", lead + (d, E), dtype),
            ("layers/moe/w_gate", lead + (E, d, ff), dtype),
            ("layers/moe/w_up", lead + (E, d, ff), dtype),
            ("layers/moe/w_down", lead + (E, ff, d), dtype)]


def _encdec(cfg, dtype):
    d = cfg.d_model
    Le, Ld = (cfg.encoder.n_layers,), (cfg.n_layers,)
    dec = "dec_layers"
    return ([("pos", (cfg.max_seq_len, d), dtype)]
            + _attn_block(cfg, "enc_layers", Le, dtype)
            + _norm(cfg, "enc_norm", (), d, dtype)
            + _norm(cfg, f"{dec}/ln1", Ld, d, dtype)
            + _attention(cfg, f"{dec}/self_attn", Ld, dtype)
            + _norm(cfg, f"{dec}/ln_x", Ld, d, dtype)
            + _attention(cfg, f"{dec}/cross_attn", Ld, dtype)
            + _norm(cfg, f"{dec}/ln2", Ld, d, dtype)
            + _mlp(cfg, f"{dec}/mlp", Ld, dtype))


def param_shapes(cfg: ModelConfig):
    """(path, shape, dtype) of every leaf."""
    dtype = torch_dtype(cfg.dtype)
    L, d = (cfg.n_layers,), cfg.d_model
    shapes = [("tok/embed", (cfg.padded_vocab, d), dtype)]
    if not cfg.tie_embeddings:
        shapes.append(("tok/unembed", (d, cfg.padded_vocab), dtype))
    if cfg.family in ("dense", "vlm"):
        shapes += _attn_block(cfg, "layers", L, dtype)
    elif cfg.family == "moe":
        shapes += _attn_block(cfg, "layers", L, dtype, mlp=False) \
            + _moe_experts(cfg, L, dtype)
    elif cfg.family == "ssm":
        shapes += _ssm_layers(cfg, dtype)
    elif cfg.family == "hybrid":
        shapes += _hybrid_blocks(cfg, dtype)
    elif cfg.family == "encdec":
        shapes += _encdec(cfg, dtype)
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
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
    return {path: _init_leaf(cfg, path.rsplit("/", 1)[-1], shape, dtype,
                             generator, device)
            for path, shape, dtype in param_shapes(cfg)}


def layer(params: Params, i: int, prefix: str = "layers/") -> Params:
    """Entry ``i`` of the stack under ``prefix`` (``layers/`` or a hybrid
    ``groups/sub0_rglru/``), keyed by the path below it (views)."""
    n = len(prefix)
    return {k[n:]: v[i] for k, v in params.items() if k.startswith(prefix)}


def layers(params: Params, prefix: str = "layers/"):
    """Every entry of the stack under ``prefix``, as :func:`layer` gives
    each, from one ``unbind`` per leaf. Under autograd a leaf's gradient is
    then one stack of the entries' gradients; indexing each entry apart
    adds a zero-filled gradient of the whole stack per entry, which costs
    the backward pass O(L^2) in the layer count."""
    n = len(prefix)
    leaves = {k[n:]: v.unbind(0) for k, v in params.items()
              if k.startswith(prefix)}
    count = len(next(iter(leaves.values())))
    return [{k: v[i] for k, v in leaves.items()} for i in range(count)]
