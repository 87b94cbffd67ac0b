"""Fused per-instance engine step for the dense, ssm (Mamba-2) and hybrid
(RecurrentGemma) families. Each family has two entry points, looked up by
``ops_for``: ``decode`` runs the batched decode over every slot, ``chunks``
every prefill chunk of the plan in order; the instance calls the decode
half first (so the parked slots' dummy writes land before any chunk
overwrites them), then ``chunks`` once per chunk group. Each enqueues its
device work without a sync, with on-device replayable sampling.

The decode-state slabs (``SlotKVCache``'s ``k``, ``v``, ``pos_map``; the
ssm ``conv``/``ssm`` slabs; the hybrid cache dict) are updated **in place**
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
logits. Each entry point returns one int32 token tensor, which the instance
fetches, stacked with the step's others, in one device-to-host copy at
finalize time. ``spec_decode`` is the dense family's self-speculative
round.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.engine import prng
from repro_torch.models import dense, hybrid
from repro_torch.models import ssm as ssm_models

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


# ------------------------------------------------------------ dense steps

def decode(cfg, params, k, v, pos_map, tokens, pos, temps, top_ps, seeds,
           rids, active):
    """Batched decode over every slot (active rows carry real tokens,
    parked slots get the dummy write at their own next position — see
    EngineInstance.dispatch_step — so ``active`` is not read). ``tokens``
    (B,1) is a device tensor, ``pos`` a host array. Returns per-slot
    sampled tokens (B,), keyed by each row's absolute position."""
    x = dense.embed_tokens(cfg, params, tokens)
    logits, _ = dense.decode_step(
        cfg, params, {"k": k, "v": v, "pos_map": pos_map}, x,
        torch.as_tensor(pos, device=k.device))
    return sample_tokens(cfg, logits[:, 0], temps, top_ps, seeds, rids, pos)


def chunks(cfg, params, k, v, pos_map, toks, slots, offsets, lens, temps,
           top_ps, seeds, rids):
    """Run every prefill chunk of the group against its own slot, in order
    (chunks target distinct slots, so the order only matters vs the decode
    dummy-writes, which ran first). ``toks`` is a (N, Sq) device tensor of
    bucket-padded chunk tokens; ``slots``/``offsets``/``lens`` are host
    arrays. Pad positions [off+len, off+Sq) are invalidated in the pos_map.
    Returns the per-chunk sampled token (N,) at each chunk's last real
    token, keyed by its absolute position ``offset + len - 1`` (meaningful
    only for final chunks; the host decides which)."""
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


# -------------------------------------------- self-speculative decoding


def spec_decode(cfg, draft_layers, k_draft, params, k, v, pos_map, tokens,
                pos, temps, top_ps, seeds, rids, active):
    """One self-speculative decode round for the whole slot batch.

    Draft: ``k_draft`` sequential batched decode steps through only the
    first ``draft_layers`` layers (``decode_step`` on the truncated config
    and the first ``draft_layers`` K/V layers). Each draft token at
    absolute position ``p`` samples with the *same* key the full model uses
    at ``p`` (Gumbel-max coupling), so where the truncated logits agree
    with the full ones the draft is accepted. The draft writes in place, so
    it leaves nothing behind: ``pos_map`` is restored afterwards, parked
    rows (``active`` False) keep their position across the draft steps and
    get back the K/V bytes of their one dummy write, and active rows' draft
    K/V at ``pos..pos+k-1`` is overwritten by the verify.

    Verify: one full-layer pass over ``[t0, d1..dk]`` of every active row
    at its own offset (``dense.verify_rows``), sampling the target at every
    position with its own positional key. The longest prefix of drafts that
    agrees with the targets is accepted; the emitted tokens are exactly the
    targets ``g_0..g_a`` — the non-speculative stream, because every
    target was sampled from the same context with the same key as
    sequential decode would. Positions past the accepted prefix revert to
    invalid; parked rows are not verified.

    ``tokens`` (B,1) is a device tensor; ``pos``, the sampling arrays and
    ``active`` are host arrays. Callers ensure every active row satisfies
    ``pos + k_draft + 1 <= capacity``. -> (B, k_draft+2) packed
    ``[a, g_0..g_k]`` (rows of parked slots are zero)."""
    dev = k.device
    B = pos_map.shape[0]
    pos = np.asarray(pos, np.int64)
    active = np.asarray(active, bool)
    act = np.nonzero(active)[0]
    idle = np.nonzero(~active)[0]
    dcfg = cfg.replace(n_layers=draft_layers)
    dk, dv = k[:draft_layers], v[:draft_layers]
    pm0 = pos_map.clone()
    if idle.size:
        it = torch.as_tensor(idle, device=dev)
        ip = torch.as_tensor(pos[idle], device=dev)
        saved = (dk[:, it, ip].clone(), dv[:, it, ip].clone())
    tok, drafts = tokens, []
    for j in range(k_draft):
        p = pos + j * active
        x = dense.embed_tokens(dcfg, params, tok)
        logits, _ = dense.decode_step(
            dcfg, params, {"k": dk, "v": dv, "pos_map": pos_map}, x,
            torch.as_tensor(p, device=dev))
        tok = sample_tokens(cfg, logits[:, 0], temps, top_ps, seeds, rids,
                            p)[:, None]
        drafts.append(tok)
    pos_map.copy_(pm0)
    if idle.size:
        dk[:, it, ip], dv[:, it, ip] = saved

    K1 = k_draft + 1
    rows = torch.as_tensor(act, device=dev)
    ver = torch.cat([tokens] + drafts, dim=1)[rows]           # (n, k+1)
    logits = dense.verify_rows(
        cfg, params, {"k": k, "v": v, "pos_map": pos_map},
        dense.embed_tokens(cfg, params, ver), act, pos[act])
    n = len(act)
    rel = np.arange(K1)
    g = sample_tokens(
        cfg, logits.reshape(n * K1, -1),
        np.repeat(np.asarray(temps)[act], K1),
        np.repeat(np.asarray(top_ps)[act], K1),
        np.repeat(np.asarray(seeds)[act], K1),
        np.repeat(np.asarray(rids)[act], K1),
        (pos[act][:, None] + rel[None, :]).reshape(-1)).view(n, K1)
    agree = torch.cumprod((ver[:, 1:] == g[:, :-1]).to(torch.int32), dim=1)
    a = agree.sum(dim=1).to(torch.int32)              # accepted drafts, 0..k
    # valid context after the round: [0, off + a]; the rejected draft
    # positions off+a+1 .. off+k revert to invalid
    relt = torch.arange(K1, device=dev)
    posn = torch.as_tensor(pos[act], device=dev)[:, None] + relt[None, :]
    pos_map[rows[:, None], posn] = torch.where(
        relt[None, :] > a[:, None], -1, posn).to(torch.int32)
    packed = torch.zeros((B, K1 + 1), dtype=torch.int32, device=dev)
    packed[rows] = torch.cat([a[:, None], g], dim=1)
    return packed


# ------------------------------------- constant-state families (ssm, hybrid)
#
# Same calling convention as the dense entries but over the family's
# decode-state slabs. Two differences forced by recurrence: the decode batch
# reads the ``active`` mask (a recurrent update is irreversible, so parked
# slots keep their old state instead of the dense dummy-write trick: the
# model writes only the active rows), and chunked prefill passes each
# chunk's ``valid_len`` into the model so pad positions leave the state
# untouched.


def _active_rows(active, device):
    """The host bool mask ``active`` (B,) as a long index tensor."""
    return torch.as_tensor(np.nonzero(np.asarray(active))[0], device=device)


def _recurrent_decode(model, cfg, params, cache, tokens, pos, temps, top_ps,
                      seeds, rids, active):
    dev = tokens.device
    x = model.embed_tokens(cfg, params, tokens)
    logits, _ = model.decode_step(cfg, params, cache, x,
                                  torch.as_tensor(pos, device=dev),
                                  active=_active_rows(active, dev))
    return sample_tokens(cfg, logits[:, 0], temps, top_ps, seeds, rids, pos)


def _recurrent_chunks(model, slot_view, cfg, params, toks, slots, offsets,
                      lens, temps, top_ps, seeds, rids):
    """Every chunk in order on its slot's batch-1 view (written in place),
    with ``valid_len`` = the chunk's real length; sampled at the chunk's
    last real token, keyed by its absolute position."""
    last_rows = []
    for i in range(toks.shape[0]):
        s, ln = int(slots[i]), int(lens[i])
        x = model.embed_tokens(cfg, params, toks[i:i + 1])
        logits, _ = model.prefill_chunk(cfg, params, slot_view(s), x,
                                        int(offsets[i]), valid_len=ln)
        last_rows.append(logits[0, max(ln - 1, 0)])
    last_pos = (np.asarray(offsets, np.int64)
                + np.maximum(np.asarray(lens, np.int64) - 1, 0))
    return sample_tokens(cfg, torch.stack(last_rows), temps, top_ps, seeds,
                         rids, last_pos)


def _ssm_view(conv, ssm):
    return lambda s: {"conv": conv[:, s:s + 1], "ssm": ssm[:, s:s + 1]}


def ssm_decode(cfg, params, conv, ssm, tokens, pos, temps, top_ps, seeds,
               rids, active):
    return _recurrent_decode(ssm_models, cfg, params,
                             {"conv": conv, "ssm": ssm}, tokens, pos, temps,
                             top_ps, seeds, rids, active)


def ssm_decode_greedy(cfg, params, conv, ssm, tokens, mask):
    """:func:`ssm_decode` for a batch whose rows are all greedy, in a form
    a CUDA graph captures: every argument a device tensor of fixed shape,
    the state written where the (B,) bool ``mask`` is set, and the argmax
    of ``sample_tokens``' greedy branch. -> (B,) int32."""
    x = ssm_models.embed_tokens(cfg, params, tokens)
    logits, _ = ssm_models.decode_step(cfg, params,
                                       {"conv": conv, "ssm": ssm}, x,
                                       active=mask)
    return torch.argmax(logits[:, 0, :cfg.vocab_size], dim=-1).to(
        torch.int32)


def ssm_chunks(cfg, params, conv, ssm, toks, slots, offsets, lens, temps,
               top_ps, seeds, rids):
    return _recurrent_chunks(ssm_models, _ssm_view(conv, ssm), cfg, params,
                             toks, slots, offsets, lens, temps, top_ps,
                             seeds, rids)


def _hyb_view(cache):
    def view(s):
        sub = {"groups": {k: a[:, s:s + 1]
                          for k, a in cache["groups"].items()},
               "pos_map": cache["pos_map"][s:s + 1]}
        if "tail" in cache:
            sub["tail"] = {k: a[:, s:s + 1] for k, a in cache["tail"].items()}
        return sub
    return view


def hybrid_decode(cfg, params, cache, tokens, pos, temps, top_ps, seeds,
                  rids, active):
    return _recurrent_decode(hybrid, cfg, params, cache, tokens, pos, temps,
                             top_ps, seeds, rids, active)


def hybrid_chunks(cfg, params, cache, toks, slots, offsets, lens, temps,
                  top_ps, seeds, rids):
    return _recurrent_chunks(hybrid, _hyb_view(cache), cfg, params, toks,
                             slots, offsets, lens, temps, top_ps, seeds,
                             rids)


# ---------------------------------------------------- family dispatch

_OPS = {"dense": (decode, chunks),
        "ssm": (ssm_decode, ssm_chunks),
        "hybrid": (hybrid_decode, hybrid_chunks)}


def ops_for(family: str):
    """The family's ``(decode, chunks)`` entry points, with the calling
    convention ``op(cfg, params, *slots.slabs(), *step_args) -> tokens``."""
    if family not in _OPS:
        raise NotImplementedError(
            f"no fused step for family {family!r} yet (dense, ssm and "
            "hybrid are ported)")
    return _OPS[family]
