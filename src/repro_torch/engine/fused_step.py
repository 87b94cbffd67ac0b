"""Fused per-instance engine step for the dense family: the whole mixed plan
(decode batch, then every prefill chunk) as one host call that enqueues its
device work without a sync, with on-device replayable sampling.

The SlotKVCache slabs (``k``, ``v``, ``pos_map``) are updated **in place**
(the JAX package donated them to a jitted call). The small per-row step
arguments — positions, slots, offsets, lengths, sampling parameters — stay
host numpy arrays: the loop over chunks walks host-side offsets (the JAX
package's ``lax.scan``), and a row whose temperature is ``<= 0`` skips the
sampled branch, decided from the host ``temps`` without a device sync.

Token selection stays on device. Each row samples with a key derived
*statelessly* as ``fold_in(fold_in(PRNGKey(seed), rid), position)`` —
bit-identical to JAX's threefry keys (:mod:`repro_torch.engine.prng`) — so a
stream replays across runs, across KV migration and crash-recovery
re-prefill. ``temperature <= 0`` selects the exact argmax on the un-cast
logits. Each entry point returns a single stacked int32 token tensor, which
the instance fetches with one device-to-host copy at finalize time.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from repro_torch.engine import prng
from repro_torch.models import dense

# ------------------------------------------------------------- sampling


def sample_tokens(cfg, logits, temps, top_ps, seeds, rids, pos):
    """Select one token per logits row (N, V_padded).

    Greedy rows take the argmax of the un-cast row. Sampled rows take
    Gumbel-max over the temperature-scaled, top-p-masked logits: the nucleus
    keeps tokens whose *exclusive* prefix mass is < top_p (the top-1 token
    always survives), and the noise is JAX's ``gumbel`` under the row's
    stateless key. ``temps``/``top_ps``/``seeds``/``rids``/``pos`` are host
    arrays (N,). Returns (N,) int32 on logits' device."""
    V = cfg.vocab_size
    rows = logits[:, :V]
    toks = torch.argmax(rows, dim=-1).to(torch.int32)
    hot = np.nonzero(np.asarray(temps) > 0.0)[0]
    if hot.size == 0:
        return toks
    dev = logits.device
    idx = torch.as_tensor(hot, device=dev)
    t = np.maximum(np.asarray(temps, np.float32)[hot], np.float32(1e-6))
    p = np.maximum(np.asarray(top_ps, np.float32)[hot], np.float32(1e-6))
    scaled = rows[idx].float() / torch.as_tensor(t, device=dev)[:, None]
    probs = torch.softmax(scaled, dim=-1)
    order = torch.argsort(-probs, dim=-1, stable=True)
    sp = torch.gather(probs, -1, order)
    keep_sorted = (torch.cumsum(sp, dim=-1) - sp) \
        < torch.as_tensor(p, device=dev)[:, None]
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    key = prng.prng_key(np.asarray(seeds, np.int64)[hot], device=dev)
    key = prng.fold_in(key, torch.as_tensor(
        np.asarray(rids, np.int64)[hot], device=dev))
    key = prng.fold_in(key, torch.as_tensor(
        np.asarray(pos, np.int64)[hot], device=dev))
    g = prng.gumbel(key, V)
    sampled = torch.argmax(torch.where(keep, scaled + g, float("-inf")),
                           dim=-1)
    toks[idx] = sampled.to(torch.int32)
    return toks


# ------------------------------------------------------------ core steps

def _decode_core(cfg, params, k, v, pos_map, tokens, pos, temps, top_ps,
                 seeds, rids):
    """Batched decode over every slot (active rows carry real tokens,
    parked slots get the dummy write at their own next position — see
    EngineInstance.dispatch_step). ``tokens`` (B,1) is a device tensor,
    ``pos`` a host array. Returns per-slot sampled tokens, keyed by each
    row's absolute position."""
    x = dense.embed_tokens(cfg, params, tokens)
    logits, _ = dense.decode_step(
        cfg, params, {"k": k, "v": v, "pos_map": pos_map}, x,
        torch.as_tensor(pos, device=k.device))
    return sample_tokens(cfg, logits[:, 0], temps, top_ps, seeds, rids, pos)


def _chunk_scan(cfg, params, k, v, pos_map, toks, slots, offsets, lens,
                temps, top_ps, seeds, rids):
    """Run every prefill chunk of the plan against its own slot, in order
    (chunks target distinct slots, so the order only matters vs the decode
    dummy-writes, which ran first). ``toks`` is a (N, Sq) device tensor of
    bucket-padded chunk tokens; ``slots``/``offsets``/``lens`` are host
    arrays. Pad positions [off+len, off+Sq) are invalidated in the pos_map.
    Returns the per-chunk sampled token at each chunk's last real token,
    keyed by its absolute position ``offset + len - 1`` (meaningful only
    for final chunks; the host decides which)."""
    Sq = toks.shape[1]
    last_rows = []
    for i in range(toks.shape[0]):
        s, off, ln = int(slots[i]), int(offsets[i]), int(lens[i])
        x = dense.embed_tokens(cfg, params, toks[i:i + 1])
        sub = {"k": k[:, s:s + 1], "v": v[:, s:s + 1],
               "pos_map": pos_map[s:s + 1]}            # views: in place
        logits, _ = dense.prefill_chunk(cfg, params, sub, x, off)
        pos_map[s, off + ln:off + Sq] = -1
        last_rows.append(logits[0, max(ln - 1, 0)])
    last_pos = (np.asarray(offsets, np.int64)
                + np.maximum(np.asarray(lens, np.int64) - 1, 0))
    return sample_tokens(cfg, torch.stack(last_rows), temps, top_ps, seeds,
                        rids, last_pos)


def decode_only(cfg, params, k, v, pos_map, tokens, pos, temps, top_ps,
                seeds, rids):
    """Decode batch, no prefill chunks. -> (B,) tokens."""
    return _decode_core(cfg, params, k, v, pos_map, tokens, pos, temps,
                        top_ps, seeds, rids)


def chunks_only(cfg, params, k, v, pos_map, toks, slots, offsets, lens,
                temps, top_ps, seeds, rids):
    """Prefill chunks, no decode. -> (N,) tokens."""
    return _chunk_scan(cfg, params, k, v, pos_map, toks, slots, offsets,
                       lens, temps, top_ps, seeds, rids)


def mixed_step(cfg, params, k, v, pos_map, tokens, pos, dtemps, dtop_ps,
               dseeds, drids, toks, slots, offsets, lens, ctemps, ctop_ps,
               cseeds, crids):
    """The LocalScheduler's full mixed plan — decode batch first (so
    parked-slot dummy writes land before chunks overwrite them), then every
    prefill chunk. -> (B+N,) stacked tokens."""
    dtoks = _decode_core(cfg, params, k, v, pos_map, tokens, pos, dtemps,
                         dtop_ps, dseeds, drids)
    ctoks = _chunk_scan(cfg, params, k, v, pos_map, toks, slots, offsets,
                        lens, ctemps, ctop_ps, cseeds, crids)
    return torch.cat([dtoks, ctoks])


def prefill_place(cfg, params, k, v, pos_map, tokens, slot, length, temp,
                  top_p, seed, rid):
    """Whole-prompt prefill fused with the slot placement: forward the
    padded prompt ``tokens`` (S,) (a device tensor), write its KV into
    ``slot`` in place, select o_1 keyed at absolute position ``length - 1``.
    -> (1,) token tensor."""
    C = k.shape[2]
    S = tokens.shape[0]
    x = dense.embed_tokens(cfg, params, tokens[None])
    logits, cache = dense.forward_seq(
        cfg, params, x, torch.arange(S, device=k.device), cache_capacity=C)
    k[:, slot] = cache["k"][:, 0]
    v[:, slot] = cache["v"][:, 0]
    idx = torch.arange(C, dtype=torch.int32, device=k.device)
    pos_map[slot] = torch.where(idx < length, idx, -1)
    last = max(length - 1, 0)
    return sample_tokens(cfg, logits[0, last][None], np.array([temp]),
                        np.array([top_p]), np.array([seed]),
                        np.array([rid]), np.array([last]))


_OPS = {
    "dense": SimpleNamespace(decode_only=decode_only, chunks_only=chunks_only,
                             mixed_step=mixed_step),
}


def ops_for(family: str):
    """The family's fused-step entry points, with the calling convention
    ``op(cfg, params, *slots.slabs(), *step_args) -> tokens``."""
    if family not in _OPS:
        raise NotImplementedError(
            f"no fused step for family {family!r} yet (dense only)")
    return _OPS[family]
