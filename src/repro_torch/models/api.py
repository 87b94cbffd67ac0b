"""One model API over all families, as the JAX package's
``repro.models.api``.

``build_model(cfg)`` returns a :class:`Model`:

  params = model.init(generator, device)
  loss   = model.loss(params, batch)                  # batch per family, below
  logits, cache = model.prefill(params, batch, cache_capacity)
  logits, cache = model.decode(params, cache, batch)  # one token per request

Batch formats (dicts of tensors on the model's device; positions integer):
  dense/moe/ssm/hybrid : train/prefill {"tokens": (B,S)}
                         decode        {"token": (B,1), "pos": (B,)}
  vlm                  : train/prefill {"embeds": (B,S,d), "positions": (B,3,S),
                                        "labels": (B,S)}
                         decode        {"token": (B,1), "positions": (B,3,1),
                                        "pos": (B,)}
  encdec (whisper)     : train/prefill {"audio_embeds": (B,F,d), "tokens": (B,S)}
                         decode        {"token": (B,1), "pos": (B,)}

``decode`` writes the new token's state into ``cache`` in place (see each
family's module). ``remat=True`` recomputes each layer's activations in
the backward pass. Attention follows ``cfg.attn_impl``: the dense and VLM
paths reach the Hopper kernels under ``"hopper"``, which have no backward,
so training keeps the default ``"reference"``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models import dense, encdec, hybrid, moe, ssm
from repro_torch.weights import init_params

FAMILIES = {"dense": dense, "vlm": dense, "moe": moe, "ssm": ssm,
            "hybrid": hybrid, "encdec": encdec}


@dataclass
class Model:
    cfg: ModelConfig
    init: Callable[..., Any]
    loss: Callable[..., Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]


def _shift_loss(cfg, logits, tokens):
    return cm.lm_loss(cfg, logits[:, :-1], tokens[:, 1:])


def _arange(batch, key):
    t = batch[key]
    return torch.arange(t.shape[1], device=t.device)


def build_model(cfg: ModelConfig) -> Model:
    fam = cfg.family
    if fam not in FAMILIES:
        raise ValueError(f"unknown family {fam!r}")
    mod = FAMILIES[fam]

    def init(generator: torch.Generator, device):
        return init_params(cfg, generator, device)

    # ----------------------------------------------------------- enc-dec
    if fam == "encdec":
        def loss(params, batch, *, window=None, remat=False):
            logits, _ = encdec.forward_seq(cfg, params, batch["tokens"],
                                           batch["audio_embeds"], remat=remat)
            return _shift_loss(cfg, logits, batch["tokens"])

        def prefill(params, batch, cache_capacity, *, window=None,
                    remat=False):
            return encdec.forward_seq(cfg, params, batch["tokens"],
                                      batch["audio_embeds"],
                                      cache_capacity=cache_capacity,
                                      remat=remat)

        def decode(params, cache, batch, *, window=None):
            return encdec.decode_step(cfg, params, cache, batch["token"],
                                      batch["pos"])

        return Model(cfg, init, loss, prefill, decode)

    # --------------------------------------------------------------- vlm
    if fam == "vlm":
        def prefill(params, batch, cache_capacity=None, *, window=None,
                    remat=False):
            return dense.forward_seq(
                cfg, params, batch["embeds"], _arange(batch, "embeds"),
                mrope_positions=batch["positions"], window=window,
                cache_capacity=cache_capacity, remat=remat)

        def loss(params, batch, *, window=None, remat=False):
            logits, _ = prefill(params, batch, window=window, remat=remat)
            return _shift_loss(cfg, logits, batch["labels"])

        def decode(params, cache, batch, *, window=None):
            x = dense.embed_tokens(cfg, params, batch["token"])
            return dense.decode_step(cfg, params, cache, x, batch["pos"],
                                     mrope_positions=batch["positions"],
                                     window=window)

        return Model(cfg, init, loss, prefill, decode)

    # ------------------------------------------- dense / moe / ssm / hybrid
    def forward(params, batch, cache_capacity, window, remat):
        x = mod.embed_tokens(cfg, params, batch["tokens"])
        return mod.forward_seq(cfg, params, x, _arange(batch, "tokens"),
                               window=window, cache_capacity=cache_capacity,
                               remat=remat)

    def loss(params, batch, *, window=None, remat=False):
        out = forward(params, batch, None, window, remat)
        base = _shift_loss(cfg, out[0], batch["tokens"])
        if fam == "moe":
            base = base + 0.01 * out[2]
        return base

    def prefill(params, batch, cache_capacity, *, window=None, remat=False):
        out = forward(params, batch, cache_capacity, window, remat)
        return out[0], out[1]

    def decode(params, cache, batch, *, window=None):
        x = mod.embed_tokens(cfg, params, batch["token"])
        return mod.decode_step(cfg, params, cache, x, batch["pos"],
                               window=window)

    return Model(cfg, init, loss, prefill, decode)
