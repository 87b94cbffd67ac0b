"""Real-compute Arrow cluster: a ``ServingSystem`` backend over N
EngineInstances (one PyTorch process on one device, cooperative round-robin
execution standing in for N accelerators) with real tensor movement for KV
transfers.

Wall-clock time drives everything: the TTFT predictor is fitted from a real
profiling pass at launch, token intervals are measured, and the scheduler
makes the same decisions it would on a hardware cluster. Runs on the card by default
(``device="cuda"``); the CPU tests pass ``device="cpu"``.

All scheduling glue (prefill dispatch, decode placement, the FCFS migration
manager, monitor-tick scraping, the ``POLICIES`` registry) comes from the
shared ``RuntimeCore`` (core/runtime.py) — so the engine runs the same
baseline policies (``colocated``, ``minimal_load``, ...) and replays the same
traces as the simulator, and streams real token ids through per-request
``on_token`` callbacks as they land.

Each cooperative pass is two-phase (DESIGN.md §9): every instance's fused
step — its full decode batch plus all planned prefill chunks, written into
the KV slabs in place — is enqueued before any token tensor is fetched, and
each instance pays a single device-to-host copy per pass.
"""
from __future__ import annotations

import heapq
import time
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import Request, SLO, SchedulerConfig, TTFTPredictor
from repro_torch.core.clock import WallClock
from repro_torch.core.local_scheduler import LocalScheduler
from repro_torch.core.prefix_index import content_keys, lineage_keys
from repro_torch.core.runtime import DecodePlacement, RuntimeCore
from repro_torch.core.serving import (FinishCallback, RequestHandle,
                                      ServeReport, TokenCallback)
from repro_torch.engine.instance import (ChunkWork, CorruptPayload,
                                         EngineInstance, NoFreeSlots,
                                         resolve_device, state_checksum)
from repro_torch.weights import init_params


@dataclass
class ServeRequest:
    """Legacy batch-mode request (kept for the ``serve()`` shim)."""

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    arrival_offset: float = 0.0        # seconds after serve() start
    # outcomes
    req: Request = None
    output_tokens: List[int] = field(default_factory=list)


class ArrowEngineCluster(RuntimeCore):
    def __init__(self, cfg: ModelConfig, *, n_instances: int = 2,
                 n_prefill: int = 1, n_slots: int = 8, capacity: int = 256,
                 slo: SLO = SLO(ttft=2.0, tpot=0.5),
                 sched_cfg: Optional[SchedulerConfig] = None, seed: int = 0,
                 params=None, chunk_tokens: Optional[int] = None,
                 policy: str = "arrow", autoscaler_cfg=None,
                 prefix_cache: bool = False, fault_plan=None,
                 step_mode: str = "fused", tenants=None, admission=False,
                 deflection=None, speculate: int = 0,
                 draft_layers: Optional[int] = None, health=False,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.capacity = capacity
        self.n_slots = n_slots
        self.chunk_tokens = chunk_tokens
        self.step_mode = step_mode
        self.run_seed = int(seed)
        self.speculate = int(speculate)
        self.draft_layers = draft_layers
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
            params = init_params(cfg, gen, self.device)
        self.params = params           # shared by reference across instances
        self.instances: Dict[int, EngineInstance] = {
            i: self._new_instance(i) for i in range(n_instances)}
        # real profiling pass on instance 0 (instances are homogeneous here)
        samples = self.instances[0].profile_prefill()
        predictor = TTFTPredictor.fit(samples)
        sched_cfg = sched_cfg or SchedulerConfig(
            max_running_tokens=n_slots * capacity, monitor_interval=0.05)
        self._init_runtime(list(self.instances), n_prefill=n_prefill,
                           policy=policy, slo=slo, sched_cfg=sched_cfg,
                           predictor=predictor, clock=WallClock(),
                           autoscaler_cfg=autoscaler_cfg,
                           prefix_cache=prefix_cache, fault_plan=fault_plan,
                           tenants=tenants, admission=admission,
                           deflection=deflection, run_seed=seed,
                           health=health,
                           prefix_reuse=next(iter(
                               self.instances.values())).kv.prefix_reuse)
        for i in self.instances:
            self._arm_deflect(i)     # §11 micro-batch knob (no-op if unarmed)
        self._pending: list = []                # heap: (arrival, rid)
        self._live: Dict[int, RequestHandle] = {}
        # async step state (DESIGN.md §12): iid -> dispatched-step context
        # whose token arrays are still computing on device; populated by the
        # dispatch-all phase of step() and drained by collect-ready
        self._inflight: Dict[int, tuple] = {}
        self._prompts: Dict[int, np.ndarray] = {}
        self._last_tick = 0.0
        # multi-turn sessions (DESIGN.md §7): the evolving token stream per
        # session (prompt ‖ generated of the last finished turn) — follow-up
        # prompts literally extend it, which is what makes lineage keys
        # *true in compute* on the engine. ``_session_epoch`` bumps when a
        # turn truncates the stream (capacity clamp): stale lineage keys
        # must not collide with the forked content.
        self._session_tail: Dict[int, np.ndarray] = {}
        self._session_epoch: Dict[int, int] = {}
        self._rid_epoch: Dict[int, tuple] = {}   # rid -> (lookup, retain)

    def _new_instance(self, iid: int) -> EngineInstance:
        return EngineInstance(
            iid, self.cfg, self.params, n_slots=self.n_slots,
            capacity=self.capacity, chunk_tokens=self.chunk_tokens,
            step_mode=self.step_mode, run_seed=self.run_seed,
            speculate=self.speculate, draft_layers=self.draft_layers,
            device=self.device)

    @property
    def gs(self):
        """Back-compat alias from when the engine hard-wired GlobalScheduler;
        with ``policy='arrow'`` this is the GlobalScheduler subclass."""
        return self.policy

    # ----------------------------------------------------- RuntimeCore hooks
    def local_of(self, iid: int) -> LocalScheduler:
        return self.instances[iid].local

    def _begin_transfer(self, rid: int, dst: int, kv: int, rem: int) -> bool:
        # real decode-state movement between instances (synchronous array
        # export/import); both endpoints must first land any inflight async
        # step — the source so the exported state includes every token
        # already emitted, the destination so its in-place slab writes
        # are not mid-flight
        src = self._kv_source(rid)
        self._finalize_now(src)
        self._finalize_now(dst)
        samp = self.instances[src].kv.samp_of.get(rid)
        payload, L, last, gen = self.instances[src].export_state(rid)
        # end-to-end integrity (§14): checksum at export, verify at import.
        # The source slot is retained until complete_migration acknowledges,
        # so every retry re-sends pristine state.
        checksum = state_checksum(payload)
        while True:
            nf = self.netslow_factor(self.clock.now())
            if nf > 1.0:                  # degraded interconnect window (§14)
                time.sleep(min((nf - 1.0) * 1e-3, 0.05))
            wire = payload
            if self.xfer_should_drop(self.clock.now()):
                # a dropped attempt materializes as a corrupt wire image;
                # corrupt a *copy* so the source tensors stay pristine
                # (bf16 cannot go through numpy: flip bytes via uint8 views)
                wire = [p.clone() for p in payload]
                for p in wire:
                    if p.numel():
                        p.view(torch.uint8).view(-1)[0] ^= 0xFF
                        break
                self.health_stats["xfer_corrupt"] += 1
            try:
                ok = self.instances[dst].import_state(
                    rid, wire, L, last, gen, sampling=samp, checksum=checksum)
            except CorruptPayload:
                attempt = self.note_xfer_drop(rid)
                if attempt <= self.xfer_retry_budget():
                    self.health_stats["xfer_retries"] += 1
                    time.sleep(min(self.xfer_backoff(attempt), 0.05))
                    continue
                # retries exhausted: fall through to re-prefill recovery
                # (§8); the transfer item is consumed, not requeued
                self.fail_transfer(rid, dst, kv, self.clock.now())
                return True
            break
        if not ok:
            # no free slot: cached prefixes are reclaimable capacity (§7)
            if not (self.prefix_mgr is not None
                    and self.prefix_mgr.evict_one(dst) is not None
                    and self.instances[dst].import_state(rid, payload, L, last,
                                                         gen, sampling=samp)):
                return False                    # genuinely full: retry later
        # the wire cost is the payload's actual bytes — O(1) in context for
        # constant-state families, tokens × per-token KV for dense (§13)
        self._record_migration(rid, L, sum(int(p.nbytes) for p in payload))
        self.complete_migration(rid, dst, kv, rem, self.clock.now())
        return True

    def _release_source_kv(self, src: int, rid: int, kv: int) -> None:
        # free the slot *and* the LocalScheduler token accounting (the gate
        # for migration admission) — mirror of the sim's release
        self.instances[src].local.release_prefill_kv(rid, kv)
        self.instances[src].drop(rid)

    def _arrival_due(self, rid: int) -> None:
        heapq.heappush(self._pending, (self.handles[rid].req.arrival, rid))

    def _schedule_retry(self, rid: int, at: float) -> None:
        """Admission deferred ``rid`` (§10): re-enter the arrival heap at a
        strictly future wall-clock time (NOT the original arrival — that is
        already due and would spin inside the current step's pop loop)."""
        heapq.heappush(self._pending, (max(at, self.clock.now() + 1e-6), rid))

    def _request_rejected(self, rid: int) -> None:
        """Admission rejected ``rid`` (§10): free its synthesized prompt —
        it never entered scheduling, so there is nothing else to unwind."""
        self._prompts.pop(rid, None)

    # ------------------------------------------------ fault hooks (§8)
    def _on_instance_failed(self, iid: int) -> None:
        # the EngineInstance — and with it the slot KV cache — dies here;
        # the LocalScheduler bookkeeping was already inventoried. An inflight
        # async step dies with it: its tokens were never emitted, so the
        # stream consistently resumes from the last *emitted* token (§8)
        self._inflight.pop(iid, None)
        self.instances.pop(iid, None)

    def _request_lost(self, rid: int) -> None:
        # strawman: stranded for good — drop it from the serving loop and
        # free its prompt (kept until finish for recovery, which never comes)
        self._live.pop(rid, None)
        self._prompts.pop(rid, None)

    def _prepare_recovery(self, handle: RequestHandle) -> None:
        """Crash recovery (§8): extend the stored prompt with the streamed
        tokens not yet folded in, minus the last (its logits are what the
        recovery prefill recomputes to seed the next decode step) — so the
        re-prefill rebuilds the exact pre-crash KV and greedy decode
        continues token-identically."""
        req = handle.req
        prompt = self._prompts.get(req.rid)
        emitted = [t for t in handle.tokens if t is not None]
        if prompt is None or not emitted:
            return
        folded = max(req.resumed_tokens - 1, 0)   # already in the prompt
        tail = np.asarray(emitted[folded:len(emitted) - 1], np.int32)
        self._prompts[req.rid] = np.concatenate([prompt, tail])

    # ------------------------------------- prefix cache / sessions (§7)
    def _release_retained(self, iid: int, rid: int) -> None:
        super()._release_retained(iid, rid)
        inst = self.instances.get(iid)
        if inst is not None:
            inst.drop(rid)                      # free the real slot

    def _retain_kv(self, iid: int, rid: int, kv_tokens: int) -> bool:
        inst = self.instances.get(iid)
        if inst is None or rid not in inst.kv.slot_of:
            return False
        # a full slot's tail position keeps receiving the batched dummy
        # write (instance.run_decode_iteration) — don't retain it
        if inst.kv.len_of.get(rid, 0) >= inst.capacity:
            return False
        return super()._retain_kv(iid, rid, kv_tokens)

    def _prepare_dispatch(self, handle: RequestHandle, now: float) -> None:
        """Materialize the session prompt once parent gating has cleared:
        the prompt extends the session transcript (real tokens), padded
        with deterministic fresh tokens up to the trace's input_len."""
        req = handle.req
        if req.session_id is None or req.rid in self._prompts:
            return
        sid = req.session_id
        ctx = self._session_tail.get(sid, np.zeros((0,), np.int32))
        n = max(1, min(req.input_len, self.capacity - req.output_len))
        epoch = self._session_epoch.get(sid, 0)
        if n < len(ctx):
            # capacity clamp truncated the stream: this turn forks the
            # session — future retentions use a fresh lineage namespace
            self._session_epoch[sid] = epoch + 1
            self._rid_epoch[req.rid] = (epoch, epoch + 1)
            prompt = ctx[:n].copy()
        else:
            self._rid_epoch[req.rid] = (epoch, epoch)
            rng = np.random.default_rng(0xA44 + req.rid)
            fresh = rng.integers(1, self.cfg.vocab_size,
                                 size=n - len(ctx)).astype(np.int32)
            prompt = np.concatenate([ctx, fresh]).astype(np.int32)
        req.input_len = n
        self._prompts[req.rid] = prompt

    def _lookup_keys(self, req: Request):
        if req.session_id is not None:
            epoch = self._rid_epoch.get(req.rid, (0, 0))[0]
            return lineage_keys((req.session_id, epoch), req.input_len - 1,
                                self.prefix_mgr.block)
        prompt = self._prompts.get(req.rid)
        if prompt is None:
            return None
        return content_keys(prompt[:req.input_len - 1], self.prefix_mgr.block)

    def _retention_keys(self, handle: RequestHandle):
        req = handle.req
        if req.session_id is not None:
            epoch = self._rid_epoch.get(req.rid, (0, 0))[1]
            return lineage_keys((req.session_id, epoch),
                                req.input_len + req.decoded_tokens,
                                self.prefix_mgr.block)
        prompt = self._prompts.get(req.rid)
        if prompt is None:
            return None
        # resident KV = prompt + every generated token except the last
        # (o_m is returned but never fed back into the cache); a crash
        # recovery (§8) already folded tokens[:resumed-1] into the prompt
        folded = max(req.resumed_tokens - 1, 0)
        gen = np.asarray([t for t in handle.tokens[folded:-1]
                          if t is not None], np.int32)
        return content_keys(np.concatenate([prompt, gen]),
                            self.prefix_mgr.block)

    def _session_note_finish(self, handle: RequestHandle) -> None:
        req = handle.req
        if req.session_id is None:
            if self.prefix_mgr is None:
                # prompts are kept through decode for crash recovery (§8);
                # with the cache off nothing else will free this one
                self._prompts.pop(req.rid, None)
            return
        prompt = self._prompts.get(req.rid)
        if prompt is None:
            return
        folded = max(req.resumed_tokens - 1, 0)   # recovery extended prompt
        gen = np.asarray([t for t in handle.tokens[folded:]
                          if t is not None], np.int32)
        self._session_tail[req.session_id] = np.concatenate([prompt, gen])
        self._prompts.pop(req.rid, None)   # folded into the tail; free it

    def _maybe_retain(self, handle: RequestHandle) -> None:
        super()._maybe_retain(handle)
        self._prompts.pop(handle.req.rid, None)   # keys computed; free it

    # ------------------------------------- elastic lifecycle hooks (§6)
    def _quiesce_for_evacuation(self, iid: int) -> None:
        # land any inflight async step first: its decode tokens belong to
        # requests that evacuation (retirement or quarantine, §14) is about
        # to flip to MIGRATING (and pop from the local scheduler) — emit
        # them before the state moves
        self._finalize_now(iid)

    def _preempt_release(self, iid: int, rid: int) -> None:
        # SLO-aware preemption (§14): the victim's real slot is freed; its
        # stream resumes through the re-prefill recovery path
        inst = self.instances.get(iid)
        if inst is not None:
            inst.drop(rid)

    def _create_instance(self, iid: int) -> float:
        """Spawn a real EngineInstance; params are shared by reference and
        the kernels are built once per process, so the cost is the KV-cache
        allocation, which happens right here, i.e. the
        warm-up is real elapsed wall-clock, and the instance is ACTIVE the
        moment construction returns."""
        self.instances[iid] = self._new_instance(iid)
        return 0.0

    def _destroy_instance(self, iid: int) -> None:
        # retirement is gated on _instance_quiesced, so there is no inflight
        # step by now; the pop is a belt-and-braces invariant
        self._inflight.pop(iid, None)
        self.instances.pop(iid, None)

    # --------------------------------------------------------- ServingSystem
    def submit(self, req: Request, *, prompt: Optional[np.ndarray] = None,
               tier: str = "standard", tenant_id: Optional[str] = None,
               on_token: Optional[TokenCallback] = None,
               on_finish: Optional[FinishCallback] = None) -> RequestHandle:
        """``req.arrival`` is wall-clock seconds after the serving loop
        starts. When ``prompt`` is omitted a deterministic synthetic prompt is
        generated (clamped so prompt + decode tokens fit a KV slot), which is
        what lets ``repro_torch.traces`` traces replay directly on the engine."""
        if prompt is None and req.session_id is None:
            n = max(1, min(req.input_len, self.capacity - req.output_len))
            rng = np.random.default_rng(0xA44 + req.rid)
            prompt = rng.integers(1, self.cfg.vocab_size,
                                  size=n).astype(np.int32)
        handle = self._register(req, tier, on_token, on_finish,
                                tenant_id=tenant_id)
        if prompt is not None:
            req.input_len = len(prompt)
            self._prompts[req.rid] = np.asarray(prompt, np.int32)
        # else: a session request — its prompt extends the session
        # transcript and is materialized at dispatch time, once the parent
        # turn has finished (_prepare_dispatch)
        heapq.heappush(self._pending, (req.arrival, req.rid))
        return handle

    def _finalize_now(self, iid: int) -> None:
        """Land ``iid``'s inflight async step immediately (blocking fetch).
        Used where host state must be consistent with the device — KV
        export/import endpoints — and as the no-progress fallback."""
        ctx = self._inflight.pop(iid, None)
        if ctx is None:
            return
        inst = self.instances.get(iid)
        if inst is not None:
            self._finalize_instance_step(iid, inst, ctx)

    def _instance_quiesced(self, iid: int) -> bool:
        # elastic retirement / recycling must not reap an instance whose
        # async step is still computing on device
        return iid not in self._inflight

    def step(self) -> bool:
        """One fully-async cooperative pass (DESIGN.md §12): collect the
        instances whose dispatched step has finished on device (non-blocking
        ``ready()`` poll), then dispatch a new fused step on every idle
        instance. An instance's step may stay inflight across many step()
        calls — fast instances are never barriered on slow ones (the PR 5/7
        two-phase step still joined all instances every pass). When nothing
        is ready and nothing can be dispatched, the oldest inflight step is
        force-finalized so the pass always makes progress instead of
        spinning the host."""
        t = self.clock.now()
        if self.fault_injector is not None:    # polled firing (§8)
            self.fault_injector.poll(t)
        # arrivals due
        while self._pending and self._pending[0][0] <= t:
            _, rid = heapq.heappop(self._pending)
            handle = self.handles[rid]
            if self.dispatch_prefill(handle, t) is None:
                continue       # deferred: re-enters _pending via _arrival_due
            self._live[rid] = handle
        # migrations (instant data move + admission gate); snapshot the id
        # lists — elastic retirement may remove instances mid-pass
        for dst in list(self.instances):
            self.admit_migrations(dst)
        # collect-ready: finalize any inflight step whose token arrays have
        # landed; the rest keep computing
        progressed = 0
        for iid in list(self._inflight):
            inst = self.instances.get(iid)
            if inst is None:                  # died while inflight
                self._inflight.pop(iid, None)
                continue
            if self._inflight[iid][0].ready():
                ctx = self._inflight.pop(iid)
                self._finalize_instance_step(iid, inst, ctx)
                progressed += 1
        # dispatch-all: every instance without an inflight step launches its
        # next fused step and returns immediately
        for iid, inst in list(self.instances.items()):
            if iid in self._inflight or iid not in self.instances:
                continue
            ctx = self._dispatch_instance(iid, inst)
            if ctx is not None:
                self._inflight[iid] = ctx
                progressed += 1
        if not progressed and self._inflight:
            # nothing landed, nothing to launch: block on the oldest
            # inflight step rather than busy-spinning the host
            self._finalize_now(next(iter(self._inflight)))
        # monitor tick
        now = self.clock.now()
        if now - self._last_tick >= self.sched_cfg.monitor_interval:
            self._last_tick = now
            self.collect_stats(now)
        return bool(self._live or self._pending or self._inflight)

    def run_until(self, t: float) -> None:
        while self.clock.now() < t:
            if not self.step():
                time.sleep(min(1e-3, max(t - self.clock.now(), 0.0)))

    def drain(self, *, timeout: Optional[float] = 300.0) -> ServeReport:
        limit = (float("inf") if timeout is None
                 else self.clock.now() + timeout)
        while (self._pending or self._live) and self.clock.now() < limit:
            self.step()
            self._check_undispatchable()   # §8: raise, don't spin to timeout
            if not self._live and not self._inflight and self._pending:
                time.sleep(max(self._pending[0][0] - self.clock.now(), 0.0))
        return self.report()

    # ------------------------------------------------- deprecated batch shim
    def serve(self, reqs: List[ServeRequest], *, timeout: float = 300.0
              ) -> List[ServeRequest]:
        """Batch entrypoint kept for compatibility; new code should use
        ``submit()`` + ``drain()`` (the unified ServingSystem API)."""
        warnings.warn("ArrowEngineCluster.serve(reqs) is deprecated; use the "
                      "ServingSystem API (submit/step/drain)",
                      DeprecationWarning, stacklevel=2)
        handles = []
        for sr in reqs:
            sr.req = Request(sr.rid, arrival=sr.arrival_offset,
                             input_len=len(sr.prompt),
                             output_len=sr.max_new_tokens)
            handles.append(self.submit(sr.req, prompt=sr.prompt))
        self.drain(timeout=timeout)
        for sr, h in zip(reqs, handles):
            sr.output_tokens = [t for t in h.tokens if t is not None]
        return reqs

    # ---------------------------------------------------------- internals
    def _dispatch_instance(self, iid: int, inst: EngineInstance):
        """Phase 1: admit the plan's chunks (slot allocation / cached-prefix
        seeding) and launch the instance's fused step without blocking."""
        plan = inst.local.plan_iteration()
        if plan.is_empty:
            return None
        t_start = self.clock.now()
        chunks = []
        # the legacy baseline is the *pre-fusion* path faithfully: it
        # processed at most one prefill chunk per cooperative pass
        plan_chunks = (plan.prefill_chunks[:1] if self.step_mode == "legacy"
                       else plan.prefill_chunks)
        for rid, start, ln in plan_chunks:
            handle = self._live.get(rid)
            if handle is None:
                continue
            if rid not in inst.kv.slot_of:         # first chunk: need a slot
                if not inst.kv.free and not (
                        self.prefix_mgr is not None
                        and self.prefix_mgr.evict_one(iid) is not None):
                    continue                       # no slot: retry next round
                try:
                    if start > 0:
                        # prefix reuse (§7): seed the fresh slot with the
                        # cached prefix, then compute only the suffix chunks
                        src = self._prefix_src[rid]
                        inst.begin_cached_prefill(rid, src[1], start)
                    else:
                        inst.alloc_slot(rid)
                except NoFreeSlots:
                    continue                       # stays queued; retry later
                # sampling params become slot state alongside the fresh KV
                # (recovery re-runs this path, so a recovered stream keeps
                # its keys — DESIGN.md §12)
                inst.set_sampling(rid, handle.req.sampling)
            prompt = self._prompts[rid]
            chunks.append(ChunkWork(rid, start, ln,
                                    prompt[start:start + ln],
                                    handle.req.input_len))
        pending = inst.dispatch_step(plan.decode_rids, chunks)
        if pending is None:
            return None
        # t_disp closes this instance's own dispatch span; the finalize span
        # is measured separately so an instance's iteration duration (the
        # TPOT signal) and any injected slowdown never absorb the *other*
        # instances' dispatch/finalize work done in between
        return pending, chunks, t_start, self.clock.now()

    def _finalize_instance_step(self, iid: int, inst: EngineInstance,
                                ctx) -> None:
        """Phase 2: the step's one blocking token fetch + host bookkeeping
        (stream emission, decode/prefill completion, Eq.(2) resync)."""
        pending, chunks, t_start, t_disp = ctx
        slow = self.slow_factor(iid, t_start)    # injected lag (§8)
        t_fin0 = self.clock.now()
        done_tokens, chunk_tokens = inst.finalize_step(pending)
        t_after = self.clock.now()
        # this instance's own work: its dispatch span + its blocking fetch
        # (the device compute overlapped the other instances' phases)
        span = (t_disp - t_start) + (t_after - t_fin0)
        emitted = 0
        for rid, tok in done_tokens.items():
            handle = self._live.get(rid)
            if handle is None:
                continue
            spec_round = isinstance(tok, list)
            toks = tok if spec_round else [tok]
            if spec_round:
                self._spec_stats["rounds"] += 1
                self._spec_stats["drafted"] += inst.speculate
                self._spec_stats["accepted"] += len(toks) - 1
            for tk in toks:
                self.emit_token(handle, t_after, tk)
                emitted += 1
                if spec_round:
                    self._spec_stats["emitted"] += 1
                if inst.local.complete_decode_iteration(rid):
                    self.finish(handle, t_after)
                    if rid not in inst.local.retained:  # kept as prefix (§7)
                        inst.drop(rid)
                    self._live.pop(rid, None)
                    break                 # overshot accepts are discarded
        if done_tokens:
            self.monitor.record_iteration(iid, t_after, emitted, span)
        # chunked prefill (§5.4): the fused step ran *every* chunk of the
        # plan; finalize_step reports them in dispatch order
        by_rid = dict(chunk_tokens)
        for cw in chunks:
            handle = self._live.get(cw.rid)
            if handle is None:
                continue
            tok = by_rid.get(cw.rid)
            t_fin = self.clock.now()
            inst.local.complete_prefill_chunk(cw.rid, cw.length)
            if tok is None:                        # more chunks to go
                continue
            # (the prompt stays resident until finish — crash recovery §8
            # may need to re-prefill it)
            # resync Eq.(2) bookkeeping against reality: predicted drain time
            # of the instance = now + predicted time of the remaining queue
            # (a cached prefix shrinks a queued request to its suffix)
            backlog = sum(self.predictor.predict_chunk(w.done, w.remaining)
                          for w in inst.local.prefill_queue.values())
            self.policy.prefill_ready_at[iid] = t_fin + backlog
            placement, _ = self.after_prefill(handle, iid, t_fin, token=tok)
            if placement is DecodePlacement.FINISHED:
                # release the prefill's kv_used accounting (mirror of the
                # sim path); a retained prefix re-added its own tokens
                inst.local.release_prefill_kv(cw.rid, handle.req.input_len)
                if cw.rid not in inst.local.retained:
                    inst.drop(cw.rid)
                self._live.pop(cw.rid, None)
        if slow > 1.0:                           # lagging instance (§8)
            time.sleep(min((slow - 1.0)
                           * max(self.clock.now() - t_fin0 + (t_disp - t_start),
                                 0.0), 0.25))
