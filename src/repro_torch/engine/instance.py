"""A stateless engine instance: real PyTorch compute (dense, ssm and hybrid
families), slot-granular decode state and the Arrow local scheduler.
"Stateless" in the paper's sense — the instance carries no prefill/decode
role; it executes whatever sub-requests the global scheduler hands it.

Execution model: the LocalScheduler's mixed plan — the full decode batch
plus every prefill chunk — runs as one fused step that writes the decode
state in place (``repro_torch.engine.fused_step``): the decode half first,
then each group of chunks. ``dispatch_step`` enqueues the device work and
returns immediately with the device-side token tensors and a CUDA event;
``finalize_step`` performs the step's single device-to-host copy and
advances the host bookkeeping, so a cluster can dispatch every instance
before fetching any.

The decode half is one of three, chosen from what the instance observes:
with ``speculate=k`` (dense only), a decode step whose rows all have room
is a self-speculative round (``fused_step.spec_decode``): k draft tokens
from the first ``draft_layers`` layers, one verify over the k+1 positions,
and the longest agreeing prefix plus one token emitted — the sequential
stream, id for id. A Mamba-2 instance on a card captures its greedy decode
step once as a CUDA graph and replays it on every decode batch whose rows
are all greedy (``repro_torch.engine.decode_graph``). Every other decode
batch runs the family's eager ``decode``.

The decode state is per family (``repro_torch.engine.state_slots``): KV
rings for dense models, constant-size recurrent state for Mamba-2 and
RecurrentGemma.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.local_scheduler import LocalScheduler
from repro_torch.engine import decode_graph, fused_step as fs
from repro_torch.engine.state_slots import (byte_image, make_state_slots,
                                            split_image)
from repro_torch.kernels.crc32 import crc32_op


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (no silent
    fallback to the CPU — the caller asks for ``"cpu"`` explicitly)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port on the CPU")
    return dev


# timed prefills a length in profile_prefill (the least is kept)
PROFILE_REPS = 3


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
    """zlib's CRC32 over the migration payload's raw bytes, chained across
    tensors (equal to the JAX package's CRC over the same values). Each
    tensor is read where it lies: on the card by the ``crc32`` kernel, on
    the host by ``zlib``."""
    crc = 0
    for p in payload:
        crc = crc32_op(torch.as_tensor(p), crc)
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
    """A dispatched step whose token tensors still live on device:
    ``decode`` the decode half's (B,) per-slot tokens (None when the step
    has no decode rows or runs a speculative round), ``spec`` a speculative
    round's packed (B, k+2) ``[a, g_0..g_k]`` tensor, ``groups`` the
    (chunks, (N,) tokens) pairs of the chunk groups. ``ready`` polls a CUDA
    event recorded after the step's work (always True on the CPU, where
    the work already ran); ``fetch`` is the step's one device-to-host copy.
    A traced dispatch sets ``graph0``, the instance's graph counts before
    it (``EngineInstance.dispatch_counters``)."""

    def __init__(self, decode_rids: List[int], decode: Any, spec: Any,
                 groups: List[Tuple[List[ChunkWork], Any]]):
        self.decode_rids = decode_rids
        self.decode = decode
        self.spec = spec
        self.groups = groups
        self.event = None
        dev = self._parts()[0].device
        if dev.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(dev))

    def _parts(self) -> List[torch.Tensor]:
        head = [t.reshape(-1) for t in (self.spec, self.decode)
                if t is not None]
        return head + [arr for _, arr in self.groups]

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def fetch(self) -> Tuple[Optional[np.ndarray], Optional[np.ndarray],
                             List[np.ndarray]]:
        """(the packed speculative array or None, the decode tokens or
        None, each group's tokens), from one device-to-host copy of
        everything stacked."""
        parts = self._parts()
        flat = (parts[0] if len(parts) == 1 else torch.cat(parts)).cpu()
        flat = flat.numpy()
        out, i = [], 0
        for p in parts:
            out.append(flat[i:i + p.shape[0]])
            i += p.shape[0]
        spec = None if self.spec is None else out.pop(0).reshape(
            self.spec.shape)
        decode = None if self.decode is None else out.pop(0)
        return spec, decode, out


def _bucket32(n: int, cap: int) -> int:
    return min(-(-n // 32) * 32, cap)


class EngineInstance:
    def __init__(self, iid: int, cfg: ModelConfig, params, *,
                 n_slots: int = 8, capacity: int = 256,
                 chunk_tokens: Optional[int] = None, run_seed: int = 0,
                 speculate: int = 0, draft_layers: Optional[int] = None,
                 device="cuda"):
        if cfg.family not in ("dense", "ssm", "hybrid"):
            raise NotImplementedError(
                f"no engine decode state for family {cfg.family!r}")
        self.device = resolve_device(device)
        self.run_seed = int(run_seed)
        self.speculate = int(speculate)
        self.draft_layers = (int(draft_layers) if draft_layers
                             else max(1, cfg.n_layers // 2))
        self.iid = iid
        self.cfg = cfg
        self.params = params
        self.capacity = capacity
        self.kv = make_state_slots(cfg, n_slots, capacity, self.device)
        self._decode, self._chunks = fs.ops_for(cfg.family)
        # the greedy decode step as one CUDA graph, captured now, while
        # every slot is free (engine/decode_graph.py); None: always eager
        self._graph = (decode_graph.SSMDecodeGraph(cfg, params, self.kv)
                       if decode_graph.fits(cfg, self.kv.slabs()) else None)
        if not self.kv.supports_speculation:
            # a rejected draft cannot roll back a recurrent state update,
            # so constant-state families serve the plain sequential stream
            self.speculate = 0
        if self.speculate and not 1 <= self.draft_layers < cfg.n_layers:
            raise ValueError(
                f"draft_layers must be a strict truncation of the model: "
                f"1 <= {self.draft_layers} < {cfg.n_layers}")
        self.local = LocalScheduler(
            iid, token_budget=chunk_tokens or capacity,
            mixed_chunk_budget=chunk_tokens or 2048,
            kv_capacity_tokens=n_slots * capacity)
        # request bookkeeping
        self.last_token: Dict[int, int] = {}
        self.generated: Dict[int, List[int]] = {}
        # the cluster's span recorder (core/trace.py), None when off
        self.tracer = None

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device, non_blocking=True)

    @property
    def graph_replays(self) -> int:
        """Decode steps run as a replay of the captured graph, so far."""
        return 0 if self._graph is None else self._graph.replays

    @property
    def graph_captures(self) -> int:
        """Captures of the decode graph, so far (the first at
        construction; again whenever the slabs moved)."""
        return 0 if self._graph is None else self._graph.captures

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
        if self.cfg.family != "dense":
            # constant-state families prefill via the chunk path: the slot
            # starts from zero recurrent state (the release invariant) and
            # the whole prompt scans as one fused chunk
            return self.run_prefill_chunk(rid, np.asarray(prompt, np.int32),
                                          0, S)
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
        """Enqueue this instance's whole iteration on device and return
        without a sync: the decode half (a speculative round, a replay of
        the decode graph, or the family's eager ``decode``), then every
        group of prefill chunks through the family's ``chunks``. The state
        slabs are written in place; token ids stay on device until
        :meth:`finalize_step`."""
        if not decode_rids and not chunks:
            return None
        # spans: instance.prepare while this method builds host arrays and
        # uploads tokens, instance.launch over each fused_step call (its own
        # host arrays and uploads, then the kernels' enqueue) or replay
        tr = self.tracer
        if tr is not None:
            graph0 = (self.graph_replays, self.graph_captures)
            span = tr.open("instance.prepare", self.iid)
        dec = spec = None
        if decode_rids:
            B = self.kv.n_slots
            tokens = np.zeros((B, 1), np.int32)
            pos = np.zeros((B,), np.int32)
            active = np.zeros((B,), bool)
            # Inactive-but-occupied slots (e.g. parked awaiting migration)
            # still get a batched dummy write in the dense family; aim it at
            # the slot's own next position, which any real future
            # decode/chunk overwrites before attending to it. (A speculative
            # round restores the bytes its draft wrote there and never
            # verifies the parked rows; recurrent families mask them out.)
            for rid, s in self.kv.slot_of.items():
                pos[s] = min(self.kv.len_of.get(rid, 0), self.capacity - 1)
            for rid in decode_rids:
                s = self.kv.slot_of[rid]
                tokens[s, 0] = self.last_token[rid]
                pos[s] = self.kv.len_of[rid]
                active[s] = True
            samp = self._slot_samp_arrays(decode_rids)
            # speculative round: every active row must fit its k drafts plus
            # the bonus token; otherwise plain decode this step
            use_spec = self.speculate and all(
                self.kv.len_of[r] + self.speculate + 1 <= self.capacity
                for r in decode_rids)
            use_graph = (not use_spec and self._graph is not None
                         and not (samp[0] > 0).any())
            dev_tokens = None if use_graph else self._dev(tokens)
            if tr is not None:
                span = tr.next(span, "instance.launch", self.iid)
            if use_spec:
                spec = fs.spec_decode(
                    self.cfg, self.draft_layers, self.speculate,
                    self.params, *self.kv.slabs(), dev_tokens, pos, *samp,
                    active)
            elif use_graph:
                dec = self._graph.replay(tokens, active)
            else:
                dec = self._decode(self.cfg, self.params, *self.kv.slabs(),
                                   dev_tokens, pos, *samp, active)
        groups: List[Tuple[List[ChunkWork], Any]] = []
        for Sq, group in self._group_chunks(chunks):
            if tr is not None:
                span = tr.next(span, "instance.prepare", self.iid)
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
            if tr is not None:
                span = tr.next(span, "instance.launch", self.iid)
            groups.append((group, self._chunks(
                self.cfg, self.params, *self.kv.slabs(), *c_args)))
        pending = PendingStep(list(decode_rids), dec, spec, groups)
        if tr is not None:
            pending.graph0 = graph0
            tr.close(span)
        return pending

    def dispatch_counters(self, pending: PendingStep) -> Dict[str, int]:
        """The counters of the traced dispatch ``pending``, as its
        instance holds them just after it: the rows and prompt tokens it
        was given, what the slots hold (``state_slots.counters``), the
        chunks run one after another in a constant-state family, and the
        graph replays and captures it made."""
        chunks = [cw for group, _ in pending.groups for cw in group]
        out = {"decode_rows": len(pending.decode_rids),
               "batch_rows": self.kv.n_slots if pending.decode_rids else 0,
               "prompt_tokens": sum(cw.length for cw in chunks),
               **self.kv.counters()}
        if self.cfg.family != "dense":
            out["chunk_calls"] = len(chunks)
        out["graph_replays"] = self.graph_replays - pending.graph0[0]
        out["graph_captures"] = self.graph_captures - pending.graph0[1]
        return out

    def finalize_step(self, pending) -> Tuple[Dict[int, Any],
                                              List[Tuple[int, Optional[int]]]]:
        """Fetch the step's stacked token tensor (the one device-to-host
        copy) and advance host bookkeeping. Returns (decode rid->token — or
        rid->[tokens] for a speculative round — and per-chunk (rid,
        o_1|None) in dispatch order)."""
        if pending is None:
            return {}, []
        decode_out: Dict[int, Any] = {}
        chunk_out: List[Tuple[int, Optional[int]]] = []
        spec_np, dec_np, arrays = pending.fetch()
        for rid in pending.decode_rids:
            s = self.kv.slot_of[rid]
            if spec_np is None:
                toks = [int(dec_np[s])]
            else:
                toks = [int(x) for x in spec_np[s, 1:int(spec_np[s, 0]) + 2]]
            self.kv.advance(rid, len(toks))
            self.last_token[rid] = toks[-1]
            self.generated[rid].extend(toks)
            decode_out[rid] = toks[0] if spec_np is None else toks
        for (group, _), a in zip(pending.groups, arrays):
            for cw, tok in zip(group, a):
                end = cw.offset + cw.length
                if end >= cw.total_len:
                    self.kv.len_of[cw.rid] = cw.total_len
                    tok = int(tok)
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
        length, last token, generated tokens, checksum). The checksum is
        the payload's ``state_checksum``, taken once on the slots' own
        image of the state where it lies (on the card, by the kernel).
        ``sum(p.nbytes)`` over the payload is the real wire size."""
        tr = self.tracer
        if tr is not None:
            span = tr.open("migration.export", rid)
        image, L = self.kv.state_image(rid)
        payload = self.kv.to_payload(image)
        if tr is not None:
            span = tr.next(span, "migration.checksum", rid)
        crc = crc32_op(image)
        if tr is not None:
            tr.close(span)
        return payload, L, self.last_token[rid], self.generated[rid], crc

    def import_state(self, rid: int, payload, L: int, last_token: int,
                     generated: List[int], sampling=None,
                     checksum: Optional[int] = None) -> bool:
        # With a checksum, the wire lands on this instance's device as one
        # image, is verified there before alloc (so a corrupt payload
        # leaves the importer's state untouched and the sender can simply
        # retry), then placed from that image.
        tr = self.tracer
        if tr is not None:
            span = tr.open("migration.import", rid)
        if checksum is not None:
            image = byte_image(payload, self.device)
            if tr is not None:
                span = tr.next(span, "migration.checksum", rid)
            if crc32_op(image) != checksum:
                if tr is not None:
                    tr.close(span)
                raise CorruptPayload(self.iid, rid)
            if tr is not None:
                span = tr.next(span, "migration.import", rid)
            payload = split_image(image,
                                  [(p.shape, p.dtype) for p in payload])
        ok = self.kv.alloc(rid) is not None
        if ok:
            if sampling is not None:
                # the source slot's sampling state rides along with the
                # state, so a migrated stream keeps its key derivation
                self.kv.samp_of[rid] = tuple(sampling)
            self.kv.place_state(rid, payload, L)
            self.last_token[rid] = last_token
            self.generated[rid] = list(generated)
        if tr is not None:
            tr.close(span)
        return ok

    def export_kv(self, rid: int):
        """Dense-layout export kept for compatibility (tests, tools):
        (k (L,S,Hk,D), v, length, last token, generated tokens)."""
        k, v, L = self.kv.extract(rid)
        return k, v, L, self.last_token[rid], self.generated[rid]

    def import_kv(self, rid: int, k, v, L: int, last_token: int,
                  generated: List[int], sampling=None) -> bool:
        """Inverse of :meth:`export_kv`; False when no slot is free."""
        return self.import_state(rid, [k, v], L, last_token, generated,
                                 sampling=sampling)

    def drop(self, rid: int) -> None:
        if rid in self.kv.slot_of:
            self.kv.release(rid)
        self.last_token.pop(rid, None)

    # -------------------------------------------------------- profiling
    def profile_prefill(self, lengths=(16, 32, 64, 128, 256, 512, 1024)
                        ) -> List[Tuple[int, float]]:
        """Real wall-clock profiling pass for the TTFT predictor (paper §5.3:
        'profiles each instance's prefill processing capability when the
        cluster is first launched'). Each ``run_prefill`` ends in a
        device-to-host copy of o_1, so the time includes the device work.
        Every length up to the slot capacity is run once untimed, then
        timed ``PROFILE_REPS`` times, keeping the least (a busy host only
        adds time). On an H100 80GB HBM3 (700 W) a full-width prefill is
        host-bound and flat in length up to ~1k tokens: one timed call a
        length, over 16-128
        tokens only, fitted a line falling from 34 ms to 27 ms that
        predicted 0 s for a 1000-token prompt, so the Eq.(2) backlog never
        grew. Raises :class:`NoFreeSlots` when the slot cache is already
        full."""
        if not self.kv.free:
            raise NoFreeSlots(self.iid, -1)
        samples = []
        for L in lengths:
            if L > self.capacity:
                continue
            prompt = np.ones((L,), np.int32)
            self.run_prefill(-1, prompt)          # warm-up
            self.drop(-1)
            best = float("inf")
            for _ in range(PROFILE_REPS):
                t0 = time.perf_counter()
                self.run_prefill(-1, prompt)
                best = min(best, time.perf_counter() - t0)
                self.drop(-1)
            samples.append((L, best))
        return samples
