"""Distributed step builders and dry-run inputs of the port, as the JAX
package's ``repro.distributed.steps``.

``make_train_step`` / ``make_prefill_step`` / ``make_decode_step`` return
``(model, step)``: the step runs eagerly on whatever it is given, plain
tensors or DTensors placed by :mod:`repro_torch.distributed.sharding`
(``distribute_params``, ``distribute_cache``, ``shard_batch``), under
``implicit_replication`` so that tensors the model makes (RoPE tables,
masks, positions) enter as replicated DTensors. ``build_dryrun(cfg, shape,
mesh, opts)`` returns ``(step, args)`` with every argument a DTensor of its
local shard's shape, to be called under ``FakeTensorMode`` on the fake
process group of ``launch.mesh.make_production_mesh``: the port's
counterpart of lowering and compiling (``launch.dryrun``).

A :class:`TensorSpec` (shape and dtype) stands in for
``jax.ShapeDtypeStruct``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import build_model
from repro_torch.optim import AdamWState, adamw_update
from repro_torch.weights import param_shapes, torch_dtype


class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _sds(shape, dtype) -> TensorSpec:
    if isinstance(dtype, str):
        dtype = torch.int32 if dtype == "int32" else torch_dtype(dtype)
    return TensorSpec(tuple(shape), dtype)


def _prep_cfg(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    if cfg.family == "encdec" and cfg.max_seq_len < shape.seq_len:
        cfg = cfg.replace(max_seq_len=shape.seq_len)  # stretch learned pos table
    return cfg


def window_for(cfg: ModelConfig, shape: InputShape) -> Optional[int]:
    if shape.name == "long_500k":
        if cfg.long_context_window is None and cfg.family in ("dense", "vlm", "moe"):
            raise ValueError(f"{cfg.arch_id} cannot run long_500k")
        return cfg.long_context_window
    return cfg.sliding_window


def supports(cfg: ModelConfig, shape: InputShape) -> bool:
    """DESIGN.md §4 skips: whisper has no sub-quadratic long-context variant."""
    if shape.name == "long_500k":
        if cfg.family == "encdec":
            return False
        if cfg.family in ("dense", "vlm", "moe") and cfg.long_context_window is None:
            return False
    return True


def cache_capacity(cfg: ModelConfig, shape: InputShape) -> int:
    w = window_for(cfg, shape)
    cap = shape.seq_len
    if w is not None:
        cap = min(cap, w)
    return cap


# ------------------------------------------------------------- batch specs


def batch_specs(cfg: ModelConfig, shape: InputShape):
    B, S = shape.global_batch, shape.seq_len
    dt = cfg.dtype
    if shape.kind in ("train", "prefill"):
        if cfg.family == "encdec":
            return {"audio_embeds": _sds((B, cfg.encoder.n_frames, cfg.d_model), dt),
                    "tokens": _sds((B, S), "int32")}
        if cfg.family == "vlm":
            return {"embeds": _sds((B, S, cfg.d_model), dt),
                    "positions": _sds((B, 3, S), "int32"),
                    "labels": _sds((B, S), "int32")}
        return {"tokens": _sds((B, S), "int32")}
    # decode: one new token against a seq_len-deep cache
    b = {"token": _sds((B, 1), "int32"), "pos": _sds((B,), "int32")}
    if cfg.family == "vlm":
        b["positions"] = _sds((B, 3, 1), "int32")
    return b


def batch_shardings(specs, mesh):
    """DTensor placements of each batch entry (batch dim over pod/data)."""
    return {k: shd.placements(shd.batch_spec(v.shape, mesh), mesh)
            for k, v in specs.items()}


def shard_batch(batch, mesh):
    """A batch dict (whole tensors, the same on every rank) placed on
    ``mesh`` by :func:`sharding.batch_spec`."""
    return {k: shd.distribute(v, shd.batch_spec(v.shape, mesh), mesh)
            for k, v in batch.items()}


def prefill_like_specs_for_decode(cfg: ModelConfig, shape: InputShape):
    """A small prefill batch spec used only to shape the cache (cache
    capacity is what matters, not the prefill length)."""
    B = shape.global_batch
    dt = cfg.dtype
    S = min(shape.seq_len, cache_capacity(cfg, shape))
    if cfg.family == "ssm":
        S = max(cfg.ssm.chunk, S - S % cfg.ssm.chunk)
    if cfg.family == "encdec":
        return {"audio_embeds": _sds((B, cfg.encoder.n_frames, cfg.d_model), dt),
                "tokens": _sds((B, S), "int32")}
    if cfg.family == "vlm":
        return {"embeds": _sds((B, S, cfg.d_model), dt),
                "positions": _sds((B, 3, S), "int32"),
                "labels": _sds((B, S), "int32")}
    return {"tokens": _sds((B, S), "int32")}


# --------------------------------------------------------------- steps


def _replicating():
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _placed_as(new, old):
    """``new`` redistributed to ``old``'s placements where both are
    DTensors (the step's outputs keep their inputs' layout, as JAX's
    donated buffers do)."""
    from torch.distributed.tensor import DTensor
    if isinstance(new, DTensor) and isinstance(old, DTensor) \
            and new.placements != old.placements:
        return new.redistribute(old.device_mesh, old.placements)
    return new


def make_train_step(cfg: ModelConfig, shape: InputShape):
    """(model, train_step); ``train_step(params, opt_state, batch) ->
    (params, opt_state, loss)``: the gradient of ``model.loss`` with each
    layer recomputed in the backward pass (``remat``), then one
    ``adamw_update``. The inputs are left as they were."""
    cfg = _prep_cfg(cfg, shape)
    model = build_model(cfg)
    w = cfg.sliding_window

    def train_step(params, opt_state, batch):
        with _replicating():
            leaves = {k: p.detach().requires_grad_(True)
                      for k, p in params.items()}
            loss = model.loss(leaves, batch, window=w, remat=True)
            grads = {k: torch.zeros_like(p) if g is None else g
                     for (k, p), g in zip(leaves.items(), torch.autograd.grad(
                         loss, list(leaves.values()), allow_unused=True))}
            new_p, new_opt = adamw_update(
                {k: p.detach() for k, p in leaves.items()}, grads, opt_state)
            new_p = {k: _placed_as(v, params[k]) for k, v in new_p.items()}
            new_opt = AdamWState(
                new_opt.step,
                {k: _placed_as(v, opt_state.mu[k])
                 for k, v in new_opt.mu.items()},
                {k: _placed_as(v, opt_state.nu[k])
                 for k, v in new_opt.nu.items()})
        return new_p, new_opt, loss.detach()

    return model, train_step


def make_prefill_step(cfg: ModelConfig, shape: InputShape):
    """(model, prefill_step); ``prefill_step(params, batch) -> (logits of
    the last position (B, V), cache)``: serving returns last-position
    logits only (the sampler's input)."""
    cfg = _prep_cfg(cfg, shape)
    model = build_model(cfg)
    w = window_for(cfg, shape)
    cap = cache_capacity(cfg, shape)

    @torch.no_grad()
    def prefill_step(params, batch):
        with _replicating():
            logits, cache = model.prefill(params, batch, cache_capacity=cap,
                                          window=w)
            return logits[:, -1], cache

    return model, prefill_step


def make_decode_step(cfg: ModelConfig, shape: InputShape):
    """(model, decode_step); ``decode_step(params, cache, batch) ->
    (logits (B, 1, V), cache)``, the cache written in place."""
    cfg = _prep_cfg(cfg, shape)
    model = build_model(cfg)
    w = window_for(cfg, shape)

    @torch.no_grad()
    def decode_step(params, cache, batch):
        with _replicating():
            return model.decode(params, cache, batch, window=w)

    return model, decode_step


# ------------------------------------------------------- dry-run assembly


def _local(spec: TensorSpec, placements, mesh):
    """A DTensor of ``spec``'s global shape placed as ``placements``, whose
    local tensor is an empty one of this rank's shard shape (under
    ``FakeTensorMode``, no memory)."""
    from torch.distributed.tensor import DTensor
    local_shape, _ = shd.local_shape_offset(spec.shape, mesh, placements)
    glob = torch.empty(spec.shape, dtype=spec.dtype, device="meta")
    return DTensor.from_local(
        torch.empty(local_shape, dtype=spec.dtype), mesh, placements,
        run_check=False, shape=glob.shape, stride=glob.stride())


def apply_opts(cfg: ModelConfig, shape: InputShape, mesh,
               opts: frozenset = frozenset()) -> ModelConfig:
    """The config of a §Perf hillclimb variant:
      "act_shard"     pin activation batch dims to the mesh (the models'
                      ``constrain_batch``)
      "seq_attn"      sequence-parallel full-sequence attention over
                      'model' (``constrain_seq_attention``)
      "moe_ep"        grouped MoE dispatch with expert parallelism over
                      'model'
    ("kv_seq_shard", the decode cache's sequence split, is a cache
    placement: :func:`build_dryrun`)."""
    cfg = _prep_cfg(cfg, shape)
    if "act_shard" in opts:
        axes = shd.act_batch_axes_for(mesh, shape.global_batch)
        if axes:
            cfg = cfg.replace(act_batch_axes=axes)
    if "seq_attn" in opts and shape.seq_len % shd.model_size(mesh) == 0:
        cfg = cfg.replace(attn_seq_axis="model")
    if "moe_ep" in opts and cfg.moe is not None and \
            cfg.moe.n_experts % shd.model_size(mesh) == 0:
        groups = 1
        ax = shd.act_batch_axes_for(mesh, shape.global_batch)
        if ax:
            sizes = shd.axis_sizes(mesh)
            for a in ax:
                groups *= sizes[a]
        cfg = cfg.replace(moe_ep_axis="model", moe_groups=groups)
    return cfg


def build_dryrun(cfg: ModelConfig, shape: InputShape, mesh,
                 opts: frozenset = frozenset()):
    """Returns (step, args): the step of ``shape.kind`` at ``cfg`` (with
    ``opts`` applied, :func:`apply_opts`) and its arguments as DTensors on
    ``mesh`` of each rank's shard shape — params and optimizer state by
    the parameter rules, the cache by the cache rules ("kv_seq_shard"
    splits its sequence dim where the kv heads do not divide 'model'), the
    batch over (pod, data). Call under ``FakeTensorMode``."""
    if not supports(_prep_cfg(cfg, shape), shape):
        raise ValueError(f"{cfg.arch_id} x {shape.name} skipped (DESIGN.md §4)")
    cfg = apply_opts(cfg, shape, mesh, opts)
    seq_shard = "kv_seq_shard" in opts
    msize = shd.model_size(mesh)

    def fake_tree(specs, spec_fn):
        return {k: _local(v, shd.placements(spec_fn(k, v), mesh), mesh)
                for k, v in specs.items()}

    pspecs = {path: TensorSpec(s, dt) for path, s, dt in param_shapes(cfg)}
    params = fake_tree(pspecs, lambda k, v: shd.param_spec(k, v.shape, msize))
    bspecs = batch_specs(cfg, shape)
    batch = fake_tree(bspecs, lambda k, v: shd.batch_spec(v.shape, mesh))

    if shape.kind == "train":
        _, step = make_train_step(cfg, shape)
        moments = {k: TensorSpec(v.shape, torch.float32)
                   for k, v in pspecs.items()}
        opt = AdamWState(
            torch.zeros((), dtype=torch.int32),
            *(fake_tree(moments, lambda k, v: shd.param_spec(k, v.shape,
                                                             msize))
              for _ in range(2)))
        return step, (params, opt, batch)

    if shape.kind == "prefill":
        _, step = make_prefill_step(cfg, shape)
        return step, (params, batch)

    # decode: the cache's leaves shaped by a prefill on plain tensors
    model, step = make_decode_step(cfg, shape)
    cap = cache_capacity(cfg, shape)
    w = window_for(cfg, shape)
    plain = {k: torch.empty(v.shape, dtype=v.dtype) for k, v in
             pspecs.items()}
    pf = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in
          prefill_like_specs_for_decode(cfg, shape).items()}
    with torch.no_grad():
        _, cshape = model.prefill(plain, pf, cache_capacity=cap, window=w)
    cache = shd._walk(cshape, lambda path, t: _local(
        TensorSpec(tuple(t.shape), t.dtype), shd.placements(
            shd.cache_spec(path, t.shape, mesh, seq_shard=seq_shard), mesh),
        mesh))
    return step, (params, cache, batch)
