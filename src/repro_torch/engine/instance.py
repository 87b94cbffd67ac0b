"""A stateless engine instance: real PyTorch compute (dense-family models),
a slot-granular KV cache and the Arrow local scheduler. "Stateless" in the
paper's sense — the instance carries no prefill/decode role; it executes
whatever sub-requests the global scheduler hands it.

Execution model: the LocalScheduler's mixed plan — the full decode batch
plus every prefill chunk — runs as one fused step that writes the KV slabs
in place (``repro_torch.engine.fused_step``). ``dispatch_step`` enqueues the
device work and returns immediately with the device-side token tensors and
a CUDA event; ``finalize_step`` performs the step's single device-to-host
copy and advances the host bookkeeping, so a cluster can dispatch every
instance before fetching any.

Only the fused step mode is ported; the legacy (pre-fusion) mode and
self-speculative decoding come in a later slice.
"""
from __future__ import annotations

import time
import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.local_scheduler import LocalScheduler
from repro_torch.engine import fused_step as fs
from repro_torch.engine.state_slots import make_state_slots


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (no silent
    fallback to the CPU — the caller asks for ``"cpu"`` explicitly)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port on the CPU")
    return dev


class CorruptPayload(RuntimeError):
    """Typed transfer-integrity failure: the migration payload's checksum
    does not match what the exporter computed. Raised by ``import_state``
    *before* any slot is allocated, so the importer's state is untouched;
    the cluster treats it as a failed transfer attempt and retries."""

    def __init__(self, iid: int, rid: int):
        super().__init__(f"instance {iid}: corrupt migration payload for "
                         f"rid {rid}")
        self.iid = iid
        self.rid = rid


def state_checksum(payload) -> int:
    """CRC32 over the migration payload's raw bytes, chained across
    tensors (equal to the JAX package's CRC over the same values)."""
    crc = 0
    for p in payload:
        raw = torch.as_tensor(p).contiguous().view(torch.uint8)
        crc = zlib.crc32(raw.cpu().numpy().tobytes(), crc)
    return crc


class NoFreeSlots(RuntimeError):
    """Typed admission failure: the slot cache is full. Callers (the
    cluster, the profiler) keep the request queued and retry once a slot
    frees or a retained prefix is evicted."""

    def __init__(self, iid: int, rid: int):
        super().__init__(f"instance {iid}: no free KV slot for rid {rid}")
        self.iid = iid
        self.rid = rid


@dataclass
class ChunkWork:
    """One prefill chunk of a fused step."""

    rid: int
    offset: int
    length: int               # real tokens in the chunk
    tokens: np.ndarray        # the chunk's token ids, shape (length,)
    total_len: int            # the request's full prompt length


class PendingStep:
    """A dispatched step whose token tensors still live on device. Groups
    are (chunks, device_tokens) pairs; when ``decode_in_group0`` the first
    group carries the decode batch's per-slot tokens stacked ahead of its
    chunk tokens. ``ready`` polls a CUDA event recorded after the step's
    work (always True on the CPU, where the work already ran); ``fetch`` is
    the step's one device-to-host copy."""

    def __init__(self, decode_rids: List[int],
                 groups: List[Tuple[List[ChunkWork], Any]],
                 decode_in_group0: bool = True):
        self.decode_rids = decode_rids
        self.groups = groups
        self.decode_in_group0 = decode_in_group0
        self.event = None
        dev = groups[0][1].device if groups else None
        if dev is not None and dev.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(dev))

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def fetch(self) -> List[np.ndarray]:
        parts = [arr for _, arr in self.groups]
        if not parts:
            return []
        flat = (parts[0] if len(parts) == 1 else torch.cat(parts)).cpu()
        flat = flat.numpy()
        out, i = [], 0
        for p in parts:
            out.append(flat[i:i + p.shape[0]])
            i += p.shape[0]
        return out


def _bucket32(n: int, cap: int) -> int:
    return min(-(-n // 32) * 32, cap)


class EngineInstance:
    def __init__(self, iid: int, cfg: ModelConfig, params, *,
                 n_slots: int = 8, capacity: int = 256,
                 chunk_tokens: Optional[int] = None,
                 step_mode: str = "fused", run_seed: int = 0,
                 speculate: int = 0, draft_layers: Optional[int] = None,
                 device="cuda"):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (dense only)")
        if step_mode != "fused":
            raise NotImplementedError(
                "step_mode='legacy' is not ported yet (later slice)")
        if speculate:
            raise NotImplementedError(
                "self-speculative decoding is not ported yet (later slice)")
        self.device = resolve_device(device)
        self.run_seed = int(run_seed)
        self.iid = iid
        self.cfg = cfg
        self.params = params
        self.capacity = capacity
        self.step_mode = step_mode
        self.speculate = 0
        self.kv = make_state_slots(cfg, n_slots, capacity, self.device)
        self._ops = fs.ops_for(cfg.family)
        self.local = LocalScheduler(
            iid, token_budget=chunk_tokens or capacity,
            mixed_chunk_budget=chunk_tokens or 2048,
            kv_capacity_tokens=n_slots * capacity)
        # request bookkeeping
        self.last_token: Dict[int, int] = {}
        self.generated: Dict[int, List[int]] = {}

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device, non_blocking=True)

    # ------------------------------------------------------------- slots
    def alloc_slot(self, rid: int) -> int:
        slot = self.kv.alloc(rid)
        if slot is None:
            raise NoFreeSlots(self.iid, rid)
        return slot

    # ---------------------------------------------------------- sampling
    def set_sampling(self, rid: int, sp) -> None:
        """Record a request's ``SamplingParams`` as slot state so it
        travels with the KV on migration/recovery. None/greedy clears to
        the default (exact argmax)."""
        if sp is None or sp.greedy:
            self.kv.samp_of.pop(rid, None)
        else:
            seed = self.run_seed if sp.seed is None else int(sp.seed)
            self.kv.samp_of[rid] = (float(sp.temperature), float(sp.top_p),
                                    seed)

    def _samp_of(self, rid: int) -> Tuple[float, float, int]:
        return self.kv.samp_of.get(rid, (0.0, 1.0, self.run_seed))

    def _slot_samp_arrays(self, decode_rids: List[int]):
        """Per-slot (temps, top_ps, seeds, rids) for a decode batch; rows
        whose slot is not decoding this step keep greedy defaults (their
        sampled token is never read)."""
        B = self.kv.n_slots
        temps = np.zeros((B,), np.float32)
        tops = np.ones((B,), np.float32)
        seeds = np.zeros((B,), np.int32)
        rids = np.zeros((B,), np.int32)
        for rid in decode_rids:
            s = self.kv.slot_of[rid]
            t, p, sd = self._samp_of(rid)
            temps[s], tops[s] = t, p
            seeds[s] = sd & 0x7FFFFFFF
            rids[s] = rid & 0x7FFFFFFF
        return temps, tops, seeds, rids

    # ----------------------------------------------------------- prefill
    def run_prefill(self, rid: int, prompt: np.ndarray) -> int:
        """Whole-prompt prefill; returns the first output token (o_1).
        Prompts are right-padded to 32-token buckets (causal masking keeps
        the live positions exact; the pad KV is marked invalid). Raises
        :class:`NoFreeSlots` when the cache is full."""
        S = len(prompt)
        S_pad = _bucket32(S, self.capacity)
        padded = np.zeros((S_pad,), np.int32)
        padded[:S] = prompt
        s = self.alloc_slot(rid)
        t, p, sd = self._samp_of(rid)
        tok = fs.prefill_place(
            self.cfg, self.params, *self.kv.slabs(), self._dev(padded), s, S,
            t, p, sd & 0x7FFFFFFF, rid & 0x7FFFFFFF)
        self.kv.len_of[rid] = S
        tok = int(tok.cpu()[0])
        self.last_token[rid] = tok
        self.generated[rid] = [tok]
        return tok

    def begin_cached_prefill(self, rid: int, src_rid: int,
                             cached_len: int) -> None:
        """Prefix reuse: seed ``rid``'s slot with the first ``cached_len``
        positions of ``src_rid``'s retained KV; subsequent chunks start at
        ``offset == cached_len``."""
        self.alloc_slot(rid)
        self.kv.copy_prefix(src_rid, rid, cached_len)

    def run_prefill_chunk(self, rid: int, chunk: np.ndarray, offset: int,
                          total_len: int) -> Optional[int]:
        """Chunked prefill: process prompt tokens [offset, offset+len)
        against this request's slot cache. Returns o_1 on the final chunk,
        else None. (Single-chunk convenience over dispatch/finalize.)"""
        if rid not in self.kv.slot_of:
            if offset != 0:
                raise KeyError(
                    f"rid {rid} has no KV slot at chunk offset {offset}")
            self.alloc_slot(rid)
        cw = ChunkWork(rid, offset, len(chunk),
                       np.asarray(chunk, np.int32), total_len)
        pending = self.dispatch_step([], [cw])
        _, chunk_out = self.finalize_step(pending)
        return chunk_out[0][1]

    # ------------------------------------------------------------ decode
    def run_decode_iteration(self, rids: List[int]) -> Dict[int, int]:
        """One token for each running request. Returns rid -> token.
        (Decode-only convenience over dispatch/finalize.)"""
        if not rids:
            return {}
        pending = self.dispatch_step(list(rids), [])
        decode_out, _ = self.finalize_step(pending)
        return decode_out

    # ------------------------------------------------------- fused step
    def dispatch_step(self, decode_rids: List[int],
                      chunks: Sequence[ChunkWork]):
        """Enqueue this instance's whole iteration — the decode batch plus
        every prefill chunk — on device and return without a sync. The KV
        slabs are written in place; token ids stay on device until
        :meth:`finalize_step`."""
        if not decode_rids and not chunks:
            return None
        dec_args = None
        if decode_rids:
            B = self.kv.n_slots
            tokens = np.zeros((B, 1), np.int32)
            pos = np.zeros((B,), np.int32)
            # Inactive-but-occupied slots (e.g. parked awaiting migration)
            # still get a batched dummy write; aim it at the slot's own next
            # position, which any real future decode/chunk overwrites before
            # attending to it.
            for rid, s in self.kv.slot_of.items():
                pos[s] = min(self.kv.len_of.get(rid, 0), self.capacity - 1)
            for rid in decode_rids:
                s = self.kv.slot_of[rid]
                tokens[s, 0] = self.last_token[rid]
                pos[s] = self.kv.len_of[rid]
            dec_args = (self._dev(tokens), pos) \
                + self._slot_samp_arrays(decode_rids)
        groups: List[Tuple[List[ChunkWork], Any]] = []
        for gi, (Sq, group) in enumerate(self._group_chunks(chunks)):
            n = len(group)
            ctoks = np.zeros((n, Sq), np.int32)
            slots = np.zeros((n,), np.int32)
            offsets = np.zeros((n,), np.int32)
            lens = np.zeros((n,), np.int32)
            ctemps = np.zeros((n,), np.float32)
            ctops = np.ones((n,), np.float32)
            cseeds = np.zeros((n,), np.int32)
            crids = np.zeros((n,), np.int32)
            for i, cw in enumerate(group):
                ctoks[i, :cw.length] = cw.tokens
                slots[i] = self.kv.slot_of[cw.rid]
                offsets[i] = cw.offset
                lens[i] = cw.length
                t, p, sd = self._samp_of(cw.rid)
                ctemps[i], ctops[i] = t, p
                cseeds[i] = sd & 0x7FFFFFFF
                crids[i] = cw.rid & 0x7FFFFFFF
            c_args = (self._dev(ctoks), slots, offsets, lens, ctemps, ctops,
                      cseeds, crids)
            if gi == 0 and dec_args is not None:
                out = self._ops.mixed_step(
                    self.cfg, self.params, *self.kv.slabs(), *dec_args,
                    *c_args)
            else:
                out = self._ops.chunks_only(
                    self.cfg, self.params, *self.kv.slabs(), *c_args)
            groups.append((group, out))
        if not groups and dec_args is not None:
            out = self._ops.decode_only(
                self.cfg, self.params, *self.kv.slabs(), *dec_args)
            groups.append(([], out))
        return PendingStep(list(decode_rids), groups,
                           decode_in_group0=dec_args is not None)

    def finalize_step(self, pending) -> Tuple[Dict[int, Any],
                                              List[Tuple[int, Optional[int]]]]:
        """Fetch the step's stacked token tensor (the one device-to-host
        copy) and advance host bookkeeping. Returns (decode rid->token, and
        per-chunk (rid, o_1|None) in dispatch order)."""
        if pending is None:
            return {}, []
        decode_out: Dict[int, Any] = {}
        chunk_out: List[Tuple[int, Optional[int]]] = []
        arrays = pending.fetch()
        for gi, ((group, _), a) in enumerate(zip(pending.groups, arrays)):
            base = 0
            if gi == 0 and pending.decode_in_group0 and pending.decode_rids:
                for rid in pending.decode_rids:
                    s = self.kv.slot_of[rid]
                    tok = int(a[s])
                    self.kv.advance(rid)
                    self.last_token[rid] = tok
                    self.generated[rid].append(tok)
                    decode_out[rid] = tok
                base = self.kv.n_slots
            for i, cw in enumerate(group):
                end = cw.offset + cw.length
                if end >= cw.total_len:
                    self.kv.len_of[cw.rid] = cw.total_len
                    tok = int(a[base + i])
                    self.last_token[cw.rid] = tok
                    self.generated[cw.rid] = [tok]
                    chunk_out.append((cw.rid, tok))
                else:
                    self.kv.len_of[cw.rid] = end
                    chunk_out.append((cw.rid, None))
        return decode_out, chunk_out

    def _group_chunks(self, chunks: Sequence[ChunkWork]
                      ) -> List[Tuple[int, List[ChunkWork]]]:
        """Group the plan's chunks by padded width. A chunk's width is its
        32-bucket clipped to the slot tail (offset + width <= capacity), so
        the chunk's KV write never overruns the slot."""
        by_w: Dict[int, List[ChunkWork]] = {}
        for cw in chunks:
            w = min(_bucket32(cw.length, self.capacity),
                    self.capacity - cw.offset)
            by_w.setdefault(w, []).append(cw)
        return [(w, g) for w, g in by_w.items()]

    # --------------------------------------------------------- transfer
    def export_state(self, rid: int):
        """Family-agnostic migration export: (payload host tensors, context
        length, last token, generated tokens). ``sum(p.nbytes)`` over the
        payload is the real wire size."""
        payload, L = self.kv.extract_state(rid)
        return payload, L, self.last_token[rid], self.generated[rid]

    def import_state(self, rid: int, payload, L: int, last_token: int,
                     generated: List[int], sampling=None,
                     checksum: Optional[int] = None) -> bool:
        # Verify before alloc so a corrupt payload leaves the importer's
        # state untouched and the sender can simply retry.
        if checksum is not None and state_checksum(payload) != checksum:
            raise CorruptPayload(self.iid, rid)
        if self.kv.alloc(rid) is None:
            return False
        if sampling is not None:
            # the source slot's sampling state rides along with the state,
            # so a migrated stream keeps its key derivation
            self.kv.samp_of[rid] = tuple(sampling)
        self.kv.place_state(rid, payload, L)
        self.last_token[rid] = last_token
        self.generated[rid] = list(generated)
        return True

    def drop(self, rid: int) -> None:
        if rid in self.kv.slot_of:
            self.kv.release(rid)
        self.last_token.pop(rid, None)

    # -------------------------------------------------------- profiling
    def profile_prefill(self, lengths=(16, 32, 64, 128)) -> List[Tuple[int, float]]:
        """Real wall-clock profiling pass for the TTFT predictor (paper §5.3:
        'profiles each instance's prefill processing capability when the
        cluster is first launched'). Each ``run_prefill`` ends in a
        device-to-host copy of o_1, so the time includes the device work.
        Raises :class:`NoFreeSlots` when the slot cache is already full."""
        if not self.kv.free:
            raise NoFreeSlots(self.iid, -1)
        samples = []
        for L in lengths:
            if L > self.capacity:
                continue
            prompt = np.ones((L,), np.int32)
            self.run_prefill(-1, prompt)          # warm-up
            self.drop(-1)
            t0 = time.perf_counter()
            self.run_prefill(-1, prompt)
            dt = time.perf_counter() - t0
            self.drop(-1)
            samples.append((L, dt))
        return samples
