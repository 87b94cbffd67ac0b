"""Parameters of the dense family as a flat dict of tensors.

Leaves are keyed by the same ``a/b/c`` paths the JAX package's checkpoint
flattening uses (``tok/embed``, ``layers/attn/wq``, ``final_norm/scale``,
...), and per-layer leaves keep the stacked leading layer axis, so one dict
describes the whole model and a layer is a view ``t[i]`` of each leaf.

``init_params`` makes parameters from a ``torch.Generator`` with the JAX
package's shapes and scales (normal x 0.02 for matrices, zeros for RMSNorm
scales, which are applied as ``1 + w``). ``from_jax_params`` carries a JAX
params pytree (already on the host as numpy arrays) across bit for bit.
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
    expected = dict(param_shapes(cfg))
    if set(out) != set(expected):
        raise ValueError(f"param paths differ from {cfg.arch_id}'s: "
                         f"{sorted(set(out) ^ set(expected))}")
    for path, shape in expected.items():
        if tuple(out[path].shape) != shape:
            raise ValueError(f"{path}: shape {tuple(out[path].shape)} "
                             f"!= {shape}")
    return out


def param_shapes(cfg: ModelConfig):
    """(path, shape) of every leaf of the dense family, in JAX init order."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense only)")
    L, d, hd = cfg.n_layers, cfg.d_model, cfg.head_dim_
    shapes = [("tok/embed", (cfg.padded_vocab, d))]
    if not cfg.tie_embeddings:
        shapes.append(("tok/unembed", (d, cfg.padded_vocab)))

    def norm(prefix, lead):
        out = [(f"{prefix}/scale", lead + (d,))]
        if cfg.norm != "rmsnorm":
            out.append((f"{prefix}/bias", lead + (d,)))
        return out

    shapes += norm("layers/ln1", (L,))
    shapes += [("layers/attn/wq", (L, d, cfg.n_heads * hd)),
               ("layers/attn/wk", (L, d, cfg.n_kv_heads * hd)),
               ("layers/attn/wv", (L, d, cfg.n_kv_heads * hd)),
               ("layers/attn/wo", (L, cfg.n_heads * hd, d))]
    if cfg.qk_norm:
        shapes += [("layers/attn/q_norm", (L, hd)),
                   ("layers/attn/k_norm", (L, hd))]
    shapes += norm("layers/ln2", (L,))
    if cfg.activation in ("swiglu", "geglu"):
        shapes += [("layers/mlp/w_gate", (L, d, cfg.d_ff)),
                   ("layers/mlp/w_up", (L, d, cfg.d_ff)),
                   ("layers/mlp/w_down", (L, cfg.d_ff, d))]
    else:
        shapes += [("layers/mlp/w_in", (L, d, cfg.d_ff)),
                   ("layers/mlp/w_out", (L, cfg.d_ff, d))]
    shapes += norm("final_norm", ())
    return shapes


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Params:
    """Seeded parameters: normal x 0.02 for every matrix, zeros for norm
    scales and biases, ones for layernorm scales. The draws come from
    ``generator`` (on ``device``'s type), so they differ from JAX's."""
    dtype = torch_dtype(cfg.dtype)
    out: Params = {}
    for path, shape in param_shapes(cfg):
        leaf = path.rsplit("/", 1)[1]
        if leaf in ("scale", "bias", "q_norm", "k_norm"):
            fill = 1.0 if (leaf == "scale" and cfg.norm != "rmsnorm") else 0.0
            out[path] = torch.full(shape, fill, dtype=dtype, device=device)
        else:
            w = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device)
            out[path] = (w * 0.02).to(dtype)
    return out


def layer(params: Params, i: int) -> Params:
    """Layer ``i``'s leaves keyed by their path below ``layers/`` (views)."""
    return {k[7:]: v[i] for k, v in params.items() if k.startswith("layers/")}
