"""Mamba-2 as published on the serving program: the ssm family's
configuration with the published RMSNorm eps (``norm_epsilon``) and the
float32 residual stream (``residual_in_fp32``). The scan's shape and the
model operations of a token are the ssm family's.

A program whose ``ModelConfig`` has no field for either cannot run this
configuration as published, and this module refuses it when it is loaded,
before any kernel is built.

Neither property shows in what a run serves: on the configuration's own
random weights, in bf16, each moves the logits by less than the bf16
rounding a sound program carries (relative RMS error of whole logit rows
against the float32 reference, 16 layers on the CPU: 0.019 sound, 0.020
with a bf16 stream, 0.021 at eps 1e-6), so no comparison of the served
tokens or logits can tell them. ``model_config`` therefore holds the
program to both before it hands the configuration over (``check``): on
the device it will serve from, at the configuration's widths with
``PROBE_LAYERS`` layers and a ``PROBE_VOCAB`` vocabulary, on seeded
weights scaled so that each property decides the logits (``PROBES``), the
program's own entry points as the engine's recurrent steps call them
(chunked prefill on a slot of the state slabs, the last chunk ragged, then
decode steps beside a parked slot) against the plain reference, by the
relative RMS error of the logit rows. A program that fails either limit
(``correct.probe_rel_rms`` of the configuration) is refused: the run
fails before its cluster is built.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from arrow_bench.bench import HERE, load_module
from arrow_bench.families import ssm
from arrow_bench.families.ssm import (head_flops, layer_flops,  # noqa: F401
                                      n_layers, scan_shape)
from repro_torch.configs.base import ModelConfig

REFERENCE = "ssm"
KERNELS = ssm.KERNELS
NEEDS = ("norm_eps", "residual_in_fp32")

_missing = set(NEEDS) - {f.name for f in dataclasses.fields(ModelConfig)}
if _missing:
    raise ImportError(f"the program's ModelConfig has no {sorted(_missing)}: "
                      "it cannot run Mamba-2 as published")

PROBE_LAYERS = 16
PROBE_VOCAB = 1024
PROBE_CHUNKS = (128, 72)    # prompt chunks, each padded to the first's size
PROBE_DECODE = 8
PROBE_SEED = 27
# property -> (embedding scale, output-projection scale) of the weights on
# which it decides the logits: an embedding of std 0.005, whose mean square
# (2.5e-5) the eps shifts by 40% at 1e-5 and 4% at 1e-6; and a stream of
# std 1 beside per-layer updates of std 0.002, which a bf16 stream rounds
# at every layer while the updates it carries are small
PROBES = {"norm_eps": (0.25, 1.0), "residual_in_fp32": (50.0, 0.1)}


def _reference():
    return load_module(HERE / "reference" / f"{REFERENCE}.py",
                       f"arrow_bench_reference_{REFERENCE}")


@torch.no_grad()
def probe_errors(conf: dict, cfg, device) -> dict:
    """For each property of ``PROBES``, the relative RMS error of the
    logit rows the program ``cfg`` gives on that property's weights."""
    from repro_torch.models import ssm as model
    ref = _reference()
    dev = torch.device(device)
    pconf = dict(conf, n_layer=PROBE_LAYERS, vocab_size=PROBE_VOCAB)
    pcfg = cfg.replace(n_layers=PROBE_LAYERS, vocab_size=PROBE_VOCAB)
    n_in, Q = sum(PROBE_CHUNKS), PROBE_CHUNKS[0]
    tokens = np.random.default_rng(PROBE_SEED).integers(
        1, PROBE_VOCAB, n_in + PROBE_DECODE)
    out = {}
    for prop, (emb, w_out) in PROBES.items():
        p = ref.init_weights(pconf, PROBE_SEED, dev)
        p["tok/embed"] = p["tok/embed"] * emb
        p["layers/w_out"] = p["layers/w_out"] * w_out
        # slot 0 serves the probe, slot 1 is parked
        cache = model.init_cache(pcfg, 2, device=dev)
        view = {k: v[:, :1] for k, v in cache.items()}
        rows, off = [], 0
        for n in PROBE_CHUNKS:
            chunk = np.zeros((1, Q), np.int64)
            chunk[0, :n] = tokens[off:off + n]
            x = model.embed_tokens(pcfg, p, torch.as_tensor(chunk,
                                                            device=dev))
            lg, _ = model.prefill_chunk(pcfg, p, view, x, off, valid_len=n)
            rows.append(lg[0, :n])
            off += n
        active = torch.tensor([0], device=dev)
        for j in range(n_in, n_in + PROBE_DECODE):
            step = torch.tensor([[tokens[j]], [1]], device=dev)
            x = model.embed_tokens(pcfg, p, step)
            lg, _ = model.decode_step(pcfg, p, cache, x,
                                      torch.tensor([j, 0], device=dev),
                                      active=active)
            rows.append(lg[0])
        got = torch.cat(rows)[:, :PROBE_VOCAB].float()
        want = ref.logits_at(pconf, p, tokens.tolist(), range(len(tokens)))
        err = (got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt()
        out[prop] = float(err)
    return out


def check(conf: dict, cfg, device) -> dict:
    """``probe_errors`` of the program ``cfg``; raises unless each is
    within its limit."""
    limits = conf["correct"]["probe_rel_rms"]
    errs = probe_errors(conf, cfg, device)
    bad = {k: (v, limits[k]) for k, v in errs.items() if not v <= limits[k]}
    if bad:
        raise RuntimeError("the program does not run Mamba-2 as published: "
                           "relative RMS error of the probe's logits "
                           f"(reading, limit) {bad}")
    return errs


def model_config(conf: dict):
    """The program's ``ModelConfig`` of ``conf``: the ssm family's, with
    the published norm eps and residual dtype, once the program has passed
    ``check`` on the device it will serve from."""
    cfg = ssm.model_config(conf).replace(
        norm_eps=conf["norm_epsilon"],
        residual_in_fp32=conf["residual_in_fp32"])
    check(conf, cfg, "cuda" if torch.cuda.is_available() else "cpu")
    return cfg
