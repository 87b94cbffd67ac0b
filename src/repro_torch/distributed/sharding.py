"""Sharding rules of the port, as the JAX package's
``repro.distributed.sharding``: parameters Megatron-style over the ``model``
mesh axis, activations batch-sharded over (``pod``,) ``data``. The rules go
by a leaf's name and shape, and shard a dimension only when it divides the
axis size (DESIGN.md §5).

A spec is a plain tuple with one entry per tensor dimension: a mesh axis
name, a tuple of names (that dimension split over several mesh axes, major
to minor), or ``None`` (not split). ``tuple(jax PartitionSpec)`` of the same
rule compares equal to it. :func:`placements` turns a spec into DTensor
placements on a ``DeviceMesh``; :func:`param_shardings` and
:func:`cache_shardings` walk the port's flat ``a/b/c``-keyed dicts (the
JAX pytree's paths) and an ``AdamWState`` (``mu/...``, ``nu/...``, as the
JAX optimizer's pytree).

A mesh here is anything with ``mesh_dim_names`` and ``shape`` (a
``DeviceMesh``), or a plain ``{axis name: size}`` dict for the pure rules.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

BATCH_AXES = ("pod", "data")      # pod present only on the multi-pod mesh

Spec = Tuple


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (or of a dict, as given)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def batch_axes(mesh):
    sizes = axis_sizes(mesh)
    ax = tuple(a for a in BATCH_AXES if a in sizes)
    return ax if len(ax) > 1 else (ax[0] if ax else None)


def model_size(mesh) -> int:
    return axis_sizes(mesh).get("model", 1)


def batch_size_divides(mesh, b: int) -> bool:
    sizes = axis_sizes(mesh)
    n = 1
    for a in BATCH_AXES:
        n *= sizes.get(a, 1)
    return b % n == 0


def _maybe(axis: str, dim: int, size: int) -> Optional[str]:
    return axis if dim % size == 0 and size > 1 else None


def param_spec(path: str, shape, msize: int) -> Spec:
    """path: '/'-joined key path, e.g. 'layers/attn/wq'."""
    leaf = path.split("/")[-1]
    parent = path.split("/")[-2] if "/" in path else ""
    nd = len(shape)

    def tail(spec_tail):
        """Pad with leading Nones (stacked layer/group dims)."""
        return tuple([None] * (nd - len(spec_tail)) + list(spec_tail))

    if leaf == "embed":                          # (V, d): shard vocab
        return (_maybe("model", shape[0], msize), None)
    if leaf == "unembed":                        # (d, V)
        return (None, _maybe("model", shape[1], msize))
    if leaf == "pos":
        return (None, None)
    if leaf in ("wq", "wk", "wv"):               # (..., d, H*hd): shard out
        return tail([None, _maybe("model", shape[-1], msize)])
    if leaf == "wo":                             # (..., H*hd, d): shard in
        return tail([_maybe("model", shape[-2], msize), None])
    if leaf in ("w_gate", "w_up", "w_in"):
        if parent == "moe":                      # (L, E, d, ff): expert-parallel
            return tail([_maybe("model", shape[-3], msize), None, None])
        return tail([None, _maybe("model", shape[-1], msize)])
    if leaf in ("w_down", "w_out"):
        if parent == "moe":                      # (L, E, ff, d)
            return tail([_maybe("model", shape[-3], msize), None, None])
        return tail([_maybe("model", shape[-2], msize), None])
    if leaf == "router":                         # (L, d, E): replicate
        return tail([None, None])
    if leaf in ("conv_w", "conv_b"):
        return tail([None])
    if leaf in ("w_y", "w_x"):                   # (..., d, lw)
        return tail([None, _maybe("model", shape[-1], msize)])
    if leaf in ("w_a", "w_i"):                   # (..., lw, lw): shard out
        return tail([None, _maybe("model", shape[-1], msize)])
    if leaf == "w_o":                            # (..., lw, d): shard in
        return tail([_maybe("model", shape[-2], msize), None])
    return (None,) * nd                          # norms, biases, A_log, ...


def placements(spec: Spec, mesh):
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on every mesh
    dim that entry ``i`` names (a tuple of names shards dim ``i`` over those
    mesh dims, which must be in mesh order, major to minor), ``Replicate()``
    on every mesh dim the spec does not name."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in mesh order "
                             f"{tuple(names)}")
        for i in idx:
            out[i] = Shard(dim)
    return out


def local_shape_offset(shape, mesh, placements):
    """(this rank's shard shape, its offset in the whole tensor) under
    ``placements``, DTensor's even split (``torch.chunk``'s sizes), mesh
    dims major to minor: plain arithmetic, no tensor read."""
    size, off = list(shape), [0] * len(shape)
    for i, p in enumerate(placements):
        if not p.is_shard():
            continue
        d, n = p.dim, mesh.size(i)
        full = -(-size[d] // n)
        c = mesh.get_local_rank(i)
        off[d] += c * full
        size[d] = max(0, min(full, size[d] - c * full))
    return tuple(size), tuple(off)


def distribute(t: torch.Tensor, spec: Spec, mesh):
    """``t`` (the whole tensor, the same on every rank) as a DTensor placed
    by ``spec``."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, placements(spec, mesh))


def _walk(tree, leaf_fn, prefix=""):
    """Map ``leaf_fn(path, leaf)`` over a flat ``a/b/c`` dict, nested dicts
    and NamedTuples (``AdamWState``), keeping the container types."""
    if isinstance(tree, dict):
        return {k: _walk(v, leaf_fn, f"{prefix}{k}/") for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(**{k: _walk(getattr(tree, k), leaf_fn,
                                      f"{prefix}{k}/") for k in tree._fields})
    return leaf_fn(prefix[:-1], tree)


def param_specs(params, mesh):
    """The spec of every leaf of a params dict or an ``AdamWState``."""
    msize = model_size(mesh)
    return _walk(params, lambda path, t: param_spec(path, t.shape, msize))


def param_shardings(params, mesh):
    """DTensor placements of every leaf of a params dict or an
    ``AdamWState`` (as :func:`param_specs`)."""
    return _walk(param_specs(params, mesh),
                 lambda path, spec: placements(spec, mesh))


def distribute_params(params, mesh):
    """A params dict (or an ``AdamWState``) placed on ``mesh`` by
    :func:`param_spec`'s rules: each leaf a DTensor of the same global
    tensor. The optimizer's 0-d step count stays a host tensor."""
    msize = model_size(mesh)
    return _walk(params, lambda path, t: t if t.ndim == 0 else distribute(
        t, param_spec(path, t.shape, msize), mesh))


# --------------------------------------------------------------- activations


def batch_spec(shape, mesh, *, batch_dim: int = 0) -> Spec:
    """Shard the batch dimension over (pod, data) when it divides."""
    nd = len(shape)
    ax = batch_axes(mesh)
    if ax is None or not batch_size_divides(mesh, shape[batch_dim]):
        return (None,) * nd
    spec = [None] * nd
    spec[batch_dim] = ax
    return tuple(spec)


def cache_spec(path: str, shape, mesh, *, seq_shard: bool = False) -> Spec:
    """KV/state cache leaves. k/v (L,B,C,Hk,D): batch over data, kv-heads over
    model when divisible; states (L,B,...) batch over data + widest trailing
    dim over model when divisible.

    seq_shard: when the kv-head count does not divide the model axis, shard
    the cache *sequence* dim over 'model' instead (flash-decoding-style
    distributed attention). Cuts per-device KV residency by model_size."""
    leaf = path.split("/")[-1]
    msize = model_size(mesh)
    ax = batch_axes(mesh)
    nd = len(shape)
    bdim = 1 if nd >= 2 else 0
    spec = [None] * nd
    if leaf.startswith("pos_map"):
        if batch_size_divides(mesh, shape[0]):
            spec[0] = ax
        return tuple(spec)
    if ax is not None and batch_size_divides(mesh, shape[bdim]):
        spec[bdim] = ax
    if leaf.startswith(("k", "v", "ck", "cv")) and nd == 5:
        spec[3] = _maybe("model", shape[3], msize)
        if spec[3] is None and seq_shard:
            spec[2] = _maybe("model", shape[2], msize)
    elif leaf.startswith("ssm") and nd == 5:     # (L,B,H,P,N)
        spec[2] = _maybe("model", shape[2], msize)
    elif leaf.startswith("conv") and nd == 4:    # (L,B,W-1,Ch)
        spec[3] = _maybe("model", shape[3], msize)
    elif leaf.startswith("h") and nd >= 3:       # (G,B,lw)
        spec[-1] = _maybe("model", shape[-1], msize)
    return tuple(spec)


def cache_specs(cache, mesh, *, seq_shard: bool = False):
    return _walk(cache, lambda path, t: cache_spec(
        path, t.shape, mesh, seq_shard=seq_shard))


def cache_shardings(cache, mesh, *, seq_shard: bool = False):
    return _walk(cache_specs(cache, mesh, seq_shard=seq_shard),
                 lambda path, spec: placements(spec, mesh))


def distribute_cache(cache, mesh, *, seq_shard: bool = False):
    """A cache dict placed on ``mesh`` by :func:`cache_spec`'s rules."""
    return _walk(cache, lambda path, t: distribute(
        t, cache_spec(path, t.shape, mesh, seq_shard=seq_shard), mesh))


def act_batch_axes_for(mesh, global_batch: int):
    """Mesh axes to pin activation batch dims to (None when B doesn't divide)."""
    sizes = axis_sizes(mesh)
    ax = tuple(a for a in BATCH_AXES if a in sizes)
    n = 1
    for a in ax:
        n *= sizes[a]
    if not ax or global_batch % n != 0:
        return None
    return ax
