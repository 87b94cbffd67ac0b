"""Shared serving runtime both ``ServingSystem`` backends are rebuilt on.

Everything the discrete-event simulator and the real JAX engine used to
duplicate lives here once:

  * policy wiring — pools / monitor / ``POLICIES`` registry / flip counters,
    including the colocated-deployment convention (all instances serve both
    phases, so the prefill pool spans the cluster);
  * request lifecycle glue — prefill dispatch (Algorithm 1), the post-prefill
    decode-placement decision (Algorithm 2) with its local-decode vs
    KV-migration outcome, streaming token delivery, finish accounting;
  * the migration manager — FCFS, memory-gated admission at the destination
    (§5.4), source-side KV release once the transfer lands;
  * monitor-tick stat collection — one ``InstanceStats`` snapshot per
    instance per tick, then the policy's instance-scheduling triggers.

Backends supply the physical substrate through four hooks: ``local_of``
(their per-instance ``LocalScheduler``), ``_begin_transfer`` (async DMA with
a modeled delay in the sim; real array export/import on the engine),
``_release_source_kv`` and ``_decode_started`` (post-migration nudges).

Elastic scaling (DESIGN.md §6) adds the instance lifecycle: ``scale_up``
provisions a new instance (backend hook ``_create_instance`` builds the
substrate and returns its warm-up delay), ``begin_retire`` drains one —
re-dispatching its queued migrations and migrating its KV-resident decode
requests away through the *same* FCFS migration manager — and
``_maybe_finalize_retires`` removes it once drained. An ``AutoScaler``
(core/autoscaler.py) drives these from the monitor tick when the policy is
elastic (``arrow_elastic``).

Fault tolerance (DESIGN.md §8) adds the crash path: ``fail_instance``
tears an instance down *without* a drain — its resident KV is gone, so the
runtime invalidates its prefix-index entries, aborts every migration
touching it, re-routes migrations whose KV survives elsewhere, and
re-dispatches the lost requests (decode-phase victims re-prefill prompt +
already-streamed tokens so recovered greedy streams stay token-identical).
A ``FaultInjector`` (core/faults.py) fires scripted crash/slowdown events;
the AutoScaler spawns replacements when the policy is elastic.
"""
from __future__ import annotations

import enum
import random
from collections import Counter, deque
from typing import Dict, List, Optional, Tuple

from repro_torch.core.autoscaler import AutoScaler, AutoScalerConfig
from repro_torch.core.clock import Clock
from repro_torch.core.faults import FaultInjector, FaultPlan
from repro_torch.core.health import HealthConfig, HealthMonitor
from repro_torch.core.global_scheduler import (DeflectionConfig, DeflectionPolicy,
                                         NoSchedulableInstance)
from repro_torch.core.local_scheduler import LocalScheduler
from repro_torch.core.monitor import InstanceMonitor, InstanceStats
from repro_torch.core.policies import POLICIES
from repro_torch.core.pools import InstancePools, Lifecycle, Pool
from repro_torch.core.prefix_index import (DEFAULT_BLOCK, PrefixCacheManager,
                                     PrefixHit, lineage_keys)
from repro_torch.core.request import Request, RequestState
from repro_torch.core.serving import (FinishCallback, RequestHandle, ServeReport,
                                ServingSystem, TIERS, TokenCallback,
                                UndispatchableError)
from repro_torch.core.slo import SLO, SchedulerConfig
from repro_torch.core.tenants import (DEFAULT_TENANT, AdmissionConfig,
                                AdmissionController, Deferred, Rejected,
                                TenantRegistry)
from repro_torch.core.ttft_predictor import TTFTPredictor


class DecodePlacement(enum.Enum):
    FINISHED = "finished"      # output_len <= 1: request ends at o_1
    LOCAL = "local"            # decode continues on the prefill instance
    MIGRATE = "migrate"        # KV must move to another instance


class RuntimeCore(ServingSystem):
    """Scheduling machinery shared by the simulator and the engine cluster."""

    # ------------------------------------------------------------- wiring
    def _init_runtime(self, ids, *, n_prefill: int, policy: str, slo: SLO,
                      sched_cfg: SchedulerConfig, predictor: TTFTPredictor,
                      clock: Clock,
                      autoscaler_cfg: Optional[AutoScalerConfig] = None,
                      prefix_cache: bool = False,
                      prefix_block: int = DEFAULT_BLOCK,
                      fault_plan: Optional[FaultPlan] = None,
                      tenants: Optional[TenantRegistry] = None,
                      admission=False,
                      deflection: Optional[DeflectionConfig] = None,
                      run_seed: int = 0,
                      prefix_reuse: str = "block",
                      health=False,
                      ) -> None:
        ids = list(ids)
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; "
                             f"choose from {sorted(POLICIES)}")
        if policy == "colocated":
            n_prefill = len(ids)           # pools unused; all serve both
        self.slo = slo
        self.sched_cfg = sched_cfg
        self.predictor = predictor
        self.clock = clock
        self.pools = InstancePools(ids, n_prefill=n_prefill)
        self.monitor = InstanceMonitor(
            ids, window=sched_cfg.token_interval_window)
        self.policy = POLICIES[policy](self.pools, self.monitor, predictor,
                                       slo, sched_cfg, self)
        self.policy_name = policy
        self.handles: Dict[int, RequestHandle] = {}
        # decision counters: deterministic across backends for a given trace
        # (one prefill dispatch per request, one decode dispatch per request
        # with output_len > 1); migrations additionally depend on timing.
        self.decisions: Dict[str, int] = {
            "prefill": 0, "decode": 0, "migrations": 0}
        # ---- elastic lifecycle state (DESIGN.md §6)
        self._next_iid = max(ids) + 1 if ids else 0
        self._spawned_at: Dict[int, float] = {i: 0.0 for i in ids}
        self._instance_seconds_closed = 0.0
        self._retire_started: Dict[int, float] = {}
        self._migrating_from: Dict[int, int] = {}   # rid -> current KV holder
        self._kv_outbound = Counter()   # iid -> in-flight outbound transfers
        self._kv_inbound = Counter()    # iid -> admitted, not-yet-landed
        # per-rid migration bookkeeping so a crash can find and abort every
        # transfer touching the dead instance (DESIGN.md §8):
        self._transfers: Dict[int, Tuple[int, int, int]] = {}  # rid->(s,d,kv)
        self._migration_kv: Dict[int, int] = {}     # rid -> kv while MIGRATING
        # completed transfers with their real wire size (DESIGN.md §13):
        # dense KV grows with context; constant-state families move O(1)
        # bytes regardless of context length. Diagnostic only — not a
        # ServeReport summary field.
        self.migration_log: List[Dict[str, int]] = []
        self._recent_finish: deque = deque(maxlen=128)  # SLO window
        # ---- replayable sampling + self-speculative decoding (§12)
        self.run_seed = run_seed
        self._sampling_stats: Dict[str, float] = {"sampled_requests": 0}
        self._spec_stats: Dict[str, float] = {
            "rounds": 0, "drafted": 0, "accepted": 0, "emitted": 0}
        # ---- fault domain (DESIGN.md §8)
        self.fault_stats: Dict[str, float] = {
            "crashes": 0, "slowdowns": 0, "skipped_events": 0,
            "requests_recovered": 0, "requests_lost": 0,
            "kv_tokens_lost": 0, "re_prefill_tokens": 0,
            "migrations_aborted": 0, "replacements": 0}
        self._slowdowns: Dict[int, Tuple[float, float]] = {}  # iid->(f,until)
        self._failed_pending: Dict[int, float] = {}  # iid -> crash time
        self.fault_injector: Optional[FaultInjector] = None
        if fault_plan is not None:
            # backends arm the firing (sim: exact virtual-clock events;
            # engine: polled every cooperative pass)
            self.fault_injector = FaultInjector(fault_plan, self)
        # ---- self-healing layer (DESIGN.md §14)
        self.health_cfg: Optional[HealthConfig] = None
        self.health_monitor: Optional[HealthMonitor] = None
        if health:
            self.health_cfg = health if isinstance(health, HealthConfig) \
                else HealthConfig()
            self.health_monitor = HealthMonitor(self, self.health_cfg)
        self.health_stats: Dict[str, float] = {
            "quarantines": 0, "restores": 0, "escalations": 0,
            "xfer_retries": 0, "xfer_drops": 0, "xfer_corrupt": 0,
            "xfer_failures": 0, "preemptions": 0, "preempt_refused": 0}
        # transient transfer-fault windows (droptransfer/netslow, §14) —
        # cluster-wide, self-expiring like _slowdowns
        self._xfer_drop: Optional[Tuple[float, float]] = None  # (p, until)
        self._netslow: Optional[Tuple[float, float]] = None    # (f, until)
        # dedicated RNG for drop decisions: drawn only while a window is
        # active, so fault-free runs never consume it (replayability)
        self._xfer_rng = random.Random(run_seed + 0x7EA1)
        self._xfer_attempts: Dict[int, int] = {}   # rid -> failed attempts
        self._preempt_log: Dict[int, deque] = {}   # iid -> recent preempt ts
        # ---- deferred dispatch: multi-turn parent gating + the no-ACTIVE-
        # instance queue (both retried through the backend's _arrival_due)
        self._gated: Dict[int, list] = {}       # parent rid -> waiting rids
        self._unplaced: deque = deque()         # rids awaiting any ACTIVE
        # ---- prefix-aware KV reuse (DESIGN.md §7; §13 for the capability)
        # "block": per-token KV — any block-aligned prefix is reusable.
        # "exact": constant-size recurrent state — only a full-stream match
        # (the state is a lossy summary with no per-position truncation).
        self.prefix_reuse = prefix_reuse
        self.prefix_mgr: Optional[PrefixCacheManager] = None
        self._prefix_src: Dict[int, tuple] = {}  # rid -> (iid, src_rid, len)
        # predictor-derived timing totals (the manager owns the token/hit
        # counters — keep each statistic in exactly one place)
        self._prefix_timing = {"saved_prefill_s": 0.0, "full_prefill_s": 0.0,
                               "prefill_tokens": 0.0}
        if prefix_cache:
            self.prefix_mgr = PrefixCacheManager(
                block=prefix_block, release=self._on_prefix_release)
            # a role change drops the instance's cached prefixes (§7):
            # memory belongs to the new duty, and correctness stays trivial
            self.pools.on_flip = \
                lambda iid, frm, to: self.prefix_mgr.invalidate_instance(iid)
        # ---- multi-tenancy + admission control (DESIGN.md §10)
        self.tenants: Optional[TenantRegistry] = tenants
        self.admission_ctl: Optional[AdmissionController] = None
        if admission:
            if self.tenants is None:
                self.tenants = TenantRegistry()   # auto-registering roster
            cfg = admission if isinstance(admission, AdmissionConfig) \
                else AdmissionConfig()
            self.admission_ctl = AdmissionController(self, self.tenants, cfg)
        self.autoscaler: Optional[AutoScaler] = None
        if getattr(self.policy, "elastic", False):
            self.autoscaler = AutoScaler(
                self, autoscaler_cfg or AutoScalerConfig())
        elif autoscaler_cfg is not None:
            raise ValueError(
                f"policy {policy!r} is not elastic; autoscaler_cfg requires "
                f"an elastic policy (e.g. 'arrow_elastic')")
        # ---- cross-pool prefill deflection (DESIGN.md §11)
        self.deflection_cfg: Optional[DeflectionConfig] = None
        self._deflect_closed = {"chunks": 0, "tokens": 0}  # dead instances
        if getattr(self.policy, "deflective", False):
            self.deflection_cfg = deflection or DeflectionConfig()
            self.policy.deflection = DeflectionPolicy(self.deflection_cfg)
        elif deflection is not None:
            raise ValueError(
                f"policy {policy!r} is not deflective; deflection requires "
                f"a deflective policy (e.g. 'arrow_deflect')")

    # ------------------------------------------------------ backend hooks
    def local_of(self, iid: int) -> LocalScheduler:
        raise NotImplementedError

    def _begin_transfer(self, rid: int, dst: int, kv: int, rem: int) -> bool:
        """Start moving ``rid``'s KV to ``dst``. Return False when the
        destination cannot take it right now (the item is requeued at the
        front and admission stops — FCFS order is preserved)."""
        raise NotImplementedError

    def _release_source_kv(self, src: int, rid: int, kv: int) -> None:
        raise NotImplementedError

    def _decode_started(self, iid: int) -> None:
        """A request joined ``iid``'s decode set (event-driven backends kick
        the instance; polling backends need nothing)."""

    def _arrival_due(self, rid: int) -> None:
        """Re-deliver a deferred request (gated on its parent, or unplaced
        while no instance was ACTIVE) into the backend's arrival path."""
        raise NotImplementedError

    def _schedule_retry(self, rid: int, at: float) -> None:
        """Admission deferred ``rid`` (§10): re-deliver it into the arrival
        path at system-clock time ``at`` — strictly later than now, unlike
        ``_arrival_due`` which re-delivers immediately."""
        raise NotImplementedError

    def _request_rejected(self, rid: int) -> None:
        """Admission rejected ``rid`` for good (§10): drop any backend-side
        bookkeeping (the engine pops its synthesized prompt; the sim holds
        nothing). The request never entered scheduling or KV accounting."""

    def _prepare_dispatch(self, handle: RequestHandle, now: float) -> None:
        """Called once per request right before placement, after any parent
        gating has cleared (the engine materializes session prompts here —
        the transcript is only complete once the parent finished)."""

    # ------------------------------------------------ fault backend hooks (§8)
    def _abort_transfer(self, rid: int, dst: int, kv: int) -> None:
        """A migration in flight toward ``dst`` was aborted by a crash: undo
        whatever the backend reserved in ``_begin_transfer`` and drop the
        pending completion (sim: stale-token the heap event; engine:
        transfers are synchronous, nothing is ever in flight)."""

    def _on_instance_failed(self, iid: int) -> None:
        """Crash teardown of the physical substrate (sim: cancel the running
        iteration; engine: drop the real ``EngineInstance`` and its slots).
        Called after the runtime inventoried the lost work."""

    def _prepare_recovery(self, handle: RequestHandle) -> None:
        """A decode-phase request lost its KV: extend the backend's notion of
        its prompt with the already-streamed tokens minus the last (the
        engine rebuilds the actual token array; the sim models no content).
        Called before the runtime updates the request's bookkeeping."""

    def _request_lost(self, rid: int) -> None:
        """No-recovery strawman: the request is stranded for good — drop it
        from the backend's live set so ``drain()`` terminates."""

    # ---------------------------------------- prefix-cache backend hooks (§7)
    def _retain_kv(self, iid: int, rid: int, kv_tokens: int) -> bool:
        """Keep ``rid``'s finished KV resident on ``iid`` as a reusable
        prefix. Default: LocalScheduler bookkeeping only (the sim models no
        content); the engine additionally keeps the real slot."""
        self.local_of(iid).retain_kv(rid, kv_tokens)
        return True

    def _release_retained(self, iid: int, rid: int) -> None:
        """Free a retained prefix KV (eviction/invalidation)."""
        self.local_of(iid).release_retained(rid)

    def _on_prefix_release(self, iid: int, rid: int, kv_tokens: int) -> None:
        # the instance may be long gone, or a FAILED corpse whose substrate
        # (and with it the retained KV) no longer exists (§8)
        if iid in self.pools.all_ids() and \
                self.pools.lifecycle_of(iid) is not Lifecycle.FAILED:
            self._release_retained(iid, rid)

    # -------------------------------------------------- prefix-key schemes
    def _lookup_keys(self, req: Request):
        """Block keys of ``req``'s prompt for the index lookup, capped so at
        least one token is always recomputed (the last position's logits
        produce o_1). Backends with real prompts override to add content
        keys for session-less requests."""
        if req.session_id is None:
            return None
        return lineage_keys(self._lineage_namespace(req),
                            req.input_len - 1, self.prefix_mgr.block)

    def _retention_keys(self, handle: RequestHandle):
        """Block keys of the *resident* context at finish: the prompt plus
        the generated tokens that entered the KV (the final token never
        does, hence input_len + decoded_tokens)."""
        req = handle.req
        if req.session_id is None:
            return None
        return lineage_keys(self._lineage_namespace(req),
                            req.input_len + req.decoded_tokens,
                            self.prefix_mgr.block)

    def _lineage_namespace(self, req: Request):
        """Namespace for lineage keys; backends that can fork a session
        (engine prompt truncation) override with (session_id, epoch)."""
        return req.session_id

    def _session_note_finish(self, handle: RequestHandle) -> None:
        """Called on every finish, cache on or off (the engine appends the
        generated tokens to the session transcript here)."""

    # ------------------------------------------ elastic backend hooks (§6)
    def _create_instance(self, iid: int) -> float:
        """Provision the physical substrate for a new instance (cost model +
        LocalScheduler on the sim; a real ``EngineInstance`` on the engine).
        Returns the warm-up delay in clock seconds (0 = ready now)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support elastic scaling")

    def _schedule_activation(self, iid: int, delay: float) -> None:
        """Arrange for ``activate_instance(iid)`` after ``delay`` seconds."""
        raise NotImplementedError

    def _destroy_instance(self, iid: int) -> None:
        """Release the substrate of a drained, removed instance."""

    def _instance_ready(self, iid: int) -> None:
        """An instance just became ACTIVE (event-driven backends kick it)."""

    def _instance_quiesced(self, iid: int) -> bool:
        """True when the backend has no in-flight work for ``iid`` beyond
        what the LocalScheduler queues show (sim: no running iteration)."""
        return True

    # --------------------------------------------------------- ClusterView
    def has_pending_prefill(self, iid: int) -> bool:
        return self.local_of(iid).has_pending_prefill()

    def has_pending_decode(self, iid: int) -> bool:
        return self.local_of(iid).has_pending_decode()

    # ---------------------------------------------------- request tracking
    def _register(self, req: Request, tier: str,
                  on_token: Optional[TokenCallback],
                  on_finish: Optional[FinishCallback],
                  tenant_id: Optional[str] = None) -> RequestHandle:
        if req.rid in self.handles:
            raise ValueError(f"rid {req.rid} already submitted")
        if tenant_id is not None:
            req.tenant_id = tenant_id
        if self.tenants is not None:
            if req.tenant_id is not None:
                # a registered tenant's declared tier overrides the
                # call-site default; unknown tenants auto-register as
                # standard/1.0
                tier = self.tenants.ensure(req.tenant_id).tier
            else:
                # untagged requests in a tenanted run share the anonymous
                # bucket so admission charges, WDRR labels, and per-tenant
                # report rows all agree; the call-site tier is kept
                req.tenant_id = DEFAULT_TENANT
                self.tenants.ensure(DEFAULT_TENANT)
            self.tenants.note_submit(req.tenant_id)
        if tier not in TIERS:
            raise ValueError(f"unknown SLO tier {tier!r}; "
                             f"choose from {sorted(TIERS)}")
        handle = RequestHandle(req=req, slo=TIERS[tier].apply(self.slo),
                               tier=tier, on_token=on_token,
                               on_finish=on_finish)
        if req.sampling is not None and not req.sampling.greedy:
            self._sampling_stats["sampled_requests"] += 1
        self.handles[req.rid] = handle
        return handle

    # ----------------------------------------------------- lifecycle glue
    def dispatch_prefill(self, handle: RequestHandle,
                         now: float) -> Optional[int]:
        """Place ``handle``'s prefill (Algorithm 1 + §7 prefix affinity).
        Returns the instance, or None when the request was deferred: a
        multi-turn follow-up whose parent has not finished yet (released in
        ``finish``), admission parked it in the RetryQueue or rejected it
        outright (§10 — before placement, so rejected requests never touch
        KV accounting), or no ACTIVE instance exists (released on the next
        ``activate_instance``)."""
        req = handle.req
        if req.parent_rid is not None:
            parent = self.handles.get(req.parent_rid)
            if parent is not None and not parent.done:
                if parent.rejected:
                    # the conversation cannot continue without the parent's
                    # answer: cascade the typed rejection to the follow-up
                    self._reject(handle,
                                 self.admission_ctl.cascade(handle, now),
                                 now)
                    return None
                self._gated.setdefault(req.parent_rid, []).append(req.rid)
                return None
        if self.admission_ctl is not None:
            decision = self.admission_ctl.consider(handle, now)
            if isinstance(decision, Rejected):
                self._reject(handle, decision, now)
                return None
            if isinstance(decision, Deferred):
                self._schedule_retry(req.rid, decision.retry_at)
                return None
        self._prepare_dispatch(handle, now)
        hits = None
        if self.prefix_mgr is not None:
            hits = self.prefix_mgr.lookup(self._lookup_keys(req))
        try:
            iid, hit, deflected = self.policy.place_prefill(
                req, now, prefix_hits=hits)
        except NoSchedulableInstance:
            self._unplaced.append(req.rid)
            return None
        cached = 0
        if hit is not None and self.prefix_mgr is not None:
            cached = min(hit.cached_len, req.input_len - 1)
            if cached > 0 and self.prefix_reuse == "exact":
                # Constant-state architectures (§13): the recurrent state
                # summarizes the source's *whole* stream — there is no
                # per-position KV to truncate, so reuse degrades to exact
                # full-stream matches. The hit must cover the entry's entire
                # key chain (a partial match is useless), and the query must
                # strictly extend the full resident stream (lineage chains
                # guarantee the sub-block tail: a follow-up turn literally
                # extends the session stream).
                ent = self.prefix_mgr.index.entries.get((hit.iid, hit.rid))
                if (ent is None
                        or hit.cached_len < len(ent.keys) * self.prefix_mgr.block
                        or ent.kv_tokens > req.input_len - 1):
                    cached = 0
                else:
                    cached = ent.kv_tokens
            if cached > 0 and iid == hit.iid:
                self.prefix_mgr.record_hit(PrefixHit(hit.iid, hit.rid,
                                                     cached))
                self.prefix_mgr.pin(hit.iid, hit.rid)
                self._prefix_src[req.rid] = (hit.iid, hit.rid, cached)
                req.cached_len = cached
            else:
                cached = 0
        if self.prefix_mgr is not None:
            p = self.predictor
            full = p.predict(req.input_len)
            t = self._prefix_timing
            t["full_prefill_s"] += full
            t["prefill_tokens"] += req.input_len
            if cached:
                t["saved_prefill_s"] += full - p.predict_chunk(
                    cached, req.input_len - cached)
        req.prefill_instance = iid
        req.state = RequestState.PREFILLING
        # tenant labels reach the scheduler only when a registry is armed:
        # a registry-less run stays exact plain FIFO even on a
        # tenant-labelled trace (WDRR is part of the tenancy subsystem, §10)
        tenant = weight = None
        if self.tenants is not None and req.tenant_id is not None:
            tenant = req.tenant_id
            t = self.tenants.get(req.tenant_id)
            weight = t.weight if t is not None else 1.0
        self.local_of(iid).enqueue_prefill(req.rid, req.input_len,
                                           cached=cached,
                                           tenant=tenant,
                                           weight=weight or 1.0,
                                           deflected=deflected)
        self.decisions["prefill"] += 1
        if req.recoveries:
            # recovery recompute (§8): tokens prefilled again because a
            # crash lost the KV — a surviving prefix holder shrinks this
            self.fault_stats["re_prefill_tokens"] += \
                max(req.input_len - cached, 0)
        return iid

    def emit_token(self, handle: RequestHandle, now: float,
                   token: Optional[int] = None, *, first: bool = False) -> None:
        req = handle.req
        if first:
            req.first_token_time = now       # o_1 returned to user
        else:
            req.token_times.append(now)
            req.decoded_tokens += 1
        handle.tokens.append(token)
        if handle.on_token is not None:
            handle.on_token(handle, token, now)

    def _reject(self, handle: RequestHandle, decision, now: float) -> None:
        """Admission turned ``handle`` away (§10): terminal, typed, and
        outside every scheduling/KV structure — the request was never
        placed, so there is nothing to unwind. Children gated on it are
        released (they cascade through ``dispatch_prefill``), and
        ``on_finish`` fires so callers waiting on the handle observe the
        terminal state (check ``handle.rejected``)."""
        req = handle.req
        req.state = RequestState.REJECTED
        handle.rejection = decision
        self._request_rejected(req.rid)
        for rid in self._gated.pop(req.rid, []):
            child = self.handles[rid]
            child.req.arrival = max(child.req.arrival, now)
            self._arrival_due(rid)
        if handle.on_finish is not None:
            handle.on_finish(handle)

    def finish(self, handle: RequestHandle, now: float) -> None:
        handle.req.finish_time = now
        handle.req.state = RequestState.FINISHED
        self._recent_finish.append(handle.meets_slo())
        if self.tenants is not None and handle.req.tenant_id is not None:
            self.tenants.note_finish(handle.req.tenant_id, handle.meets_slo())
        self._session_note_finish(handle)
        if self.prefix_mgr is not None:
            self._maybe_retain(handle)
        # release follow-up turns gated on this request (multi-turn): the
        # user cannot send a follow-up before seeing the answer, so the
        # effective arrival is no earlier than the parent's finish.
        for rid in self._gated.pop(handle.req.rid, []):
            child = self.handles[rid]
            child.req.arrival = max(child.req.arrival, now)
            self._arrival_due(rid)
        if handle.on_finish is not None:
            handle.on_finish(handle)

    def _maybe_retain(self, handle: RequestHandle) -> None:
        """Retain the finished request's KV as a reusable prefix (§7) on the
        instance where it is resident — unless that instance is retiring
        (its memory is on the way out) or already gone."""
        req = handle.req
        iid = req.decode_instance if req.decode_instance is not None \
            else req.prefill_instance
        if iid is None or iid not in self.pools.all_ids() or \
                self.pools.lifecycle_of(iid) in (Lifecycle.RETIRING,
                                                 Lifecycle.FAILED):
            return
        keys = self._retention_keys(handle)
        if not keys:
            return
        kv = req.input_len + req.decoded_tokens
        if self._retain_kv(iid, req.rid, kv):
            self.prefix_mgr.retain(iid, req.rid, keys, kv)

    def recent_attainment(self, min_samples: int = 16) -> Optional[float]:
        """SLO attainment over the sliding window of recent finishes; None
        until ``min_samples`` finishes have been observed."""
        if len(self._recent_finish) < min_samples:
            return None
        return sum(self._recent_finish) / len(self._recent_finish)

    def after_prefill(self, handle: RequestHandle, iid: int, now: float,
                      token: Optional[int] = None,
                      ) -> Tuple[DecodePlacement, Optional[int]]:
        """Prefill finished on ``iid``: stream o_1, then place the decode
        phase (Algorithm 2). Returns the placement and, for MIGRATE, the
        target instance whose admission queue now holds the request.

        A crash-recovery prefill (§8) re-computed the already-streamed
        context: nothing new is emitted — the computed token is the last
        one the user already saw (it seeds the next decode step) — and
        decode resumes with the post-crash remainder."""
        req = handle.req
        src = self._prefix_src.pop(req.rid, None)
        if src is not None and self.prefix_mgr is not None:
            # copy-on-extend done (the suffix is computed): unpin the source
            self.prefix_mgr.unpin(src[0], src[1])
        resumed = req.resumed_tokens > 0 and \
            req.resumed_tokens == len(handle.tokens)
        if not resumed:
            self.emit_token(handle, now, token, first=True)
            if req.output_len <= 1:
                self.finish(handle, now)
                return DecodePlacement.FINISHED, None
        try:
            target = self.policy.schedule_decode_req(req, now)
        except NoSchedulableInstance:
            # nothing ACTIVE (e.g. a crash took the last one while this
            # prefill drained on a retiring instance): decode in place —
            # the KV is already here, and a retiring holder draining extra
            # decode work is the same situation as a migration landing on
            # it mid-retire. A crash of ``iid`` recovers it like any other
            # resident decode.
            target = iid
        self.decisions["decode"] += 1
        req.decode_instance = target
        remaining = req.output_len - len(handle.tokens)
        if target == iid:
            req.state = RequestState.DECODING
            self.local_of(iid).start_local_decode(
                req.rid, req.input_len, remaining)
            return DecodePlacement.LOCAL, iid
        req.state = RequestState.MIGRATING
        self._kv_outbound[iid] += 1
        self._migration_kv[req.rid] = req.input_len
        self.local_of(target).enqueue_migration(
            req.rid, req.input_len, remaining)
        self.decisions["migrations"] += 1
        return DecodePlacement.MIGRATE, target

    # -------------------------------------------------- migration manager
    def admit_migrations(self, iid: int) -> None:
        """FCFS, memory-gated admission (§5.4) at destination ``iid``; the
        backend's ``_begin_transfer`` performs/schedules the data movement."""
        loc = self.local_of(iid)
        while True:
            item = loc.next_migration()
            if item is None:
                # memory-blocked head: cached prefixes are the first thing
                # to go (§7 — reclaimable capacity, LRU, unpinned only)
                if self.prefix_mgr is not None and loc.migration_queue:
                    need = loc.kv_used + loc.migration_queue[0][1] \
                        - loc.kv_capacity
                    if need > 0 and \
                            self.prefix_mgr.make_room(iid, need) > 0:
                        continue
                # still blocked and no eviction helped: SLO-aware preemption
                # (§14) releases the lowest-value decode resident
                if loc.migration_queue and self._maybe_preempt(iid, loc):
                    continue
                return
            rid, kv, rem = item
            if rid not in self.handles:        # stale entry: drop it
                continue
            # count the transfer as inbound before starting it: async
            # backends land it later, and a retiring destination must not
            # finalize while data is in the air (the engine's synchronous
            # path completes inside _begin_transfer, netting back to zero).
            # _transfers keys the in-flight set a crash must abort (§8).
            self._kv_inbound[iid] += 1
            self._transfers[rid] = (self._kv_source(rid), iid, kv)
            if not self._begin_transfer(rid, iid, kv, rem):
                self._kv_inbound[iid] -= 1
                self._transfers.pop(rid, None)
                loc.migration_queue.appendleft((rid, kv, rem))
                return

    def _kv_source(self, rid: int) -> Optional[int]:
        """Instance currently holding ``rid``'s KV: its prefill instance, or
        — for retire-triggered re-migrations — the retiring decode holder."""
        return self._migrating_from.get(
            rid, self.handles[rid].req.prefill_instance)

    def _record_migration(self, rid: int, ctx_tokens: int,
                          nbytes: int) -> None:
        """Log a state transfer's real wire size (§13). Backends call this
        with the actual payload bytes — the engine sums the exported arrays'
        ``nbytes``, the simulator asks ``CostModel.migration_bytes``."""
        self.migration_log.append(
            {"rid": rid, "ctx_tokens": int(ctx_tokens), "bytes": int(nbytes)})

    def complete_migration(self, rid: int, dst: int, kv: int, rem: int,
                           now: float) -> None:
        """KV landed on ``dst``: release it at the source, join the decode
        set. (``now`` kept for symmetry/overrides; completion itself is not a
        scheduling decision.)"""
        req = self.handles[rid].req
        src = self._kv_source(rid)
        self._migrating_from.pop(rid, None)
        self._transfers.pop(rid, None)
        self._migration_kv.pop(rid, None)
        self._xfer_attempts.pop(rid, None)
        if src is not None and src != dst:
            self._release_source_kv(src, rid, kv)
        if src is not None and self._kv_outbound[src] > 0:
            self._kv_outbound[src] -= 1
        if self._kv_inbound[dst] > 0:
            self._kv_inbound[dst] -= 1
        self.local_of(dst).admit_migrated(rid, kv, rem)
        req.state = RequestState.DECODING
        req.decode_instance = dst
        self._decode_started(dst)

    # ----------------------------------- instance lifecycle (DESIGN.md §6)
    def scale_up(self, pool: Pool, now: float) -> int:
        """Provision one new instance into ``pool``. It joins WARMING when the
        backend models a spawn delay, ACTIVE immediately otherwise."""
        iid = self._next_iid
        self._next_iid += 1
        delay = self._create_instance(iid)
        self._arm_deflect(iid)
        self.pools.add_instance(iid, pool, warming=delay > 0)
        self.monitor.add_instance(iid)
        self.policy.on_instance_added(iid)
        self._spawned_at[iid] = now
        if delay > 0:
            self._schedule_activation(iid, delay)
        else:
            self._instance_ready(iid)
        return iid

    def activate_instance(self, iid: int) -> None:
        """Warm-up finished: the instance becomes schedulable. Requests that
        found no ACTIVE instance at dispatch time retry now. A stale
        activation (the instance crashed while warming, §8) is a no-op."""
        if iid not in self.pools.all_ids() or \
                self.pools.lifecycle_of(iid) is not Lifecycle.WARMING:
            return
        self.pools.activate(iid)
        self._instance_ready(iid)
        while self._unplaced:
            self._arrival_due(self._unplaced.popleft())

    def begin_retire(self, iid: int, now: float) -> None:
        """ACTIVE → RETIRING: the instance accepts no new work. Its queued
        inbound migrations are re-dispatched and its KV-resident decode
        requests are migrated away through the existing FCFS migration
        manager; prefill work it already holds drains in place. Removal
        happens in ``_maybe_finalize_retires`` once everything left."""
        self.pools.begin_retire(iid)
        self._retire_started[iid] = now
        if self.prefix_mgr is not None:
            # cached prefixes are disposable state: invalidate (free) rather
            # than migrate — pinned entries (a copy-on-extend in flight on
            # this very instance) are doomed and freed on the last unpin
            self.prefix_mgr.invalidate_instance(iid)
        self._evacuate_residents(iid)

    def _evacuate_residents(self, iid: int) -> None:
        """Drain ``iid``'s migratable state through the FCFS migration
        manager: re-dispatch its queued (never-admitted) inbound migrations —
        their KV is still elsewhere, only the queue entry moves — and migrate
        its KV-resident decode requests away (source KV stays resident until
        the transfer lands, exactly like a post-prefill migration). Shared by
        retirement (§6) and straggler quarantine (§14); prefill work drains
        in place either way."""
        self._quiesce_for_evacuation(iid)
        loc = self.local_of(iid)
        redispatch = []
        while loc.migration_queue:
            redispatch.append(loc.migration_queue.popleft())
        for rid in list(loc.decode_running):
            w = loc.decode_running.pop(rid)
            req = self.handles[rid].req
            req.state = RequestState.MIGRATING
            self._migrating_from[rid] = iid
            self._kv_outbound[iid] += 1
            self._migration_kv[rid] = w.context_len
            self.decisions["migrations"] += 1
            redispatch.append((rid, w.context_len, w.remaining_out))
        targets = set()
        evac_load = Counter()      # tentative KV per target within this batch
        for rid, kv, rem in redispatch:
            self._route_evacuation(rid, kv, rem, evac_load, targets)
        for dst in targets:
            self.admit_migrations(dst)

    def _quiesce_for_evacuation(self, iid: int) -> None:
        """Backend hook: settle any in-flight iteration on ``iid`` before its
        decode set is popped for evacuation (the engine force-finalizes the
        pending fused step; the sim's event loop needs nothing)."""

    def _route_evacuation(self, rid: int, kv: int, rem: int,
                          evac_load: Counter, targets: set) -> None:
        """Route one KV-holding migration item away from a retiring or
        failed instance: pick a destination, or resume decode in place when
        the chosen destination already holds the KV."""
        req = self.handles[rid].req
        dst = self._evacuation_target(kv, evac_load)
        src = self._kv_source(rid)
        if dst == src:
            # the chosen destination already holds the KV (a queued-away
            # migration whose source is now the best target): no transfer —
            # resume decode in place, like a LOCAL placement.
            if self._kv_outbound[src] > 0:
                self._kv_outbound[src] -= 1
            self._migrating_from.pop(rid, None)
            self._migration_kv.pop(rid, None)
            req.decode_instance = src
            req.state = RequestState.DECODING
            self.local_of(src).start_local_decode(rid, kv, rem)
            self._decode_started(src)
            return
        req.decode_instance = dst
        self.local_of(dst).enqueue_migration(rid, kv, rem)
        targets.add(dst)

    def _evacuation_target(self, kv: int, evac_load: Counter) -> int:
        """Destination for work leaving a retiring instance: the least-loaded
        ACTIVE decode-capable instance (any active instance as last resort).
        ``evac_load`` holds KV already routed within the current evacuation
        batch — monitor stats are tick-stale, so without it every request
        would pile onto the same pre-batch minimum."""
        ids = self.pools.decode_capable() or self.pools.active_ids()
        if not ids:
            raise RuntimeError("no active instance to evacuate to")
        dst = min(ids, key=lambda i: (self.monitor.get(i).running_tokens
                                      + evac_load[i]))
        evac_load[dst] += kv
        return dst

    def _retire_drained(self, iid: int) -> bool:
        loc = self.local_of(iid)
        return (not loc.has_pending_prefill()
                and not loc.has_pending_decode()
                and self._kv_outbound[iid] == 0
                and self._kv_inbound[iid] == 0
                and self._instance_quiesced(iid))

    def _maybe_finalize_retires(self, now: float) -> None:
        for iid in list(self._retire_started):
            if not self._retire_drained(iid):
                continue
            self._retire_started.pop(iid)
            self._finalize_instance(iid, now)
        # failed corpses (§8) have nothing to drain — the substrate is gone
        # and fail_instance already recovered the work; remove on sight
        for iid in list(self._failed_pending):
            self._failed_pending.pop(iid)
            self._finalize_instance(iid, now)

    def _finalize_instance(self, iid: int, now: float) -> None:
        if self.pools.lifecycle_of(iid) is not Lifecycle.FAILED:
            # a crashed instance's counters were banked in fail_instance
            # (its substrate — and local_of — may already be gone)
            self._harvest_deflect(self.local_of(iid))
        self.pools.remove_instance(iid)
        self.monitor.remove_instance(iid)
        self.policy.on_instance_removed(iid)
        self._instance_seconds_closed += now - self._spawned_at.pop(iid)
        self._kv_outbound.pop(iid, None)
        self._kv_inbound.pop(iid, None)
        self._preempt_log.pop(iid, None)
        if self.health_monitor is not None:
            self.health_monitor.forget(iid)
        self._destroy_instance(iid)

    def _arm_deflect(self, iid: int) -> None:
        """Set the §11 micro-batch ratio knob on ``iid``'s LocalScheduler.
        No-op when deflection is unarmed (the default ratio 0.0 stays, so
        non-deflective runs are byte-identical to pre-§11 builds)."""
        if self.deflection_cfg is not None:
            self.local_of(iid).deflect_ratio = self.deflection_cfg.ratio

    def _harvest_deflect(self, loc: LocalScheduler) -> None:
        """Bank a departing instance's executed-deflection counters so
        ``deflection_detail`` survives retirement and crashes."""
        self._deflect_closed["chunks"] += loc.deflected_chunks
        self._deflect_closed["tokens"] += loc.deflected_chunk_tokens
        loc.deflected_chunks = 0
        loc.deflected_chunk_tokens = 0

    def instance_seconds(self, now: float) -> float:
        """Σ per-instance alive time — the provisioning cost a static
        deployment pays for its full duration."""
        return self._instance_seconds_closed + \
            sum(now - t for t in self._spawned_at.values())

    # --------------------------------------------- fault domain (DESIGN.md §8)
    def fail_instance(self, iid: int, now: float, *,
                      recover: bool = True) -> Dict[str, int]:
        """Fail-stop crash of ``iid``: the substrate and every resident KV
        token are lost *instantly* — nothing drains. The runtime

          1. moves the instance to FAILED (never schedulable again),
          2. invalidates its prefix-index entries (pinned ones are doomed),
          3. aborts every migration touching it: transfers in flight *from*
             it lose their data (the request is recovered); transfers in
             flight or queued *toward* it still have live KV at the source
             and are re-routed to a surviving destination,
          4. re-dispatches its lost prefill- and decode-phase requests —
             decode victims re-prefill prompt + already-streamed tokens so
             recovered greedy streams stay token-identical (§8.2) — and
          5. asks the AutoScaler (elastic policies) for a replacement.

        ``recover=False`` is the no-recovery strawman: lost requests are
        stranded (``benchmarks/bench_faults.py`` quantifies the difference).
        Returns a per-crash summary for tests/benchmarks."""
        if iid not in self.pools.all_ids():
            raise ValueError(f"unknown instance {iid}")
        pool = self.pools.pool_of(iid)
        self.pools.fail(iid)                   # raises if already failed
        self.fault_stats["crashes"] += 1
        self._retire_started.pop(iid, None)    # a retiring instance may crash
        self._slowdowns.pop(iid, None)
        self._preempt_log.pop(iid, None)
        if self.health_monitor is not None:    # quarantine state dies with it
            self.health_monitor.forget(iid)
        loc = self.local_of(iid)
        self._harvest_deflect(loc)   # bank before the substrate is torn down
        # ---- 0. sever historical prefill pointers: a request whose KV
        # already moved on (decoding elsewhere, or re-migrating from a
        # different holder) keeps ``prefill_instance`` as attribution only —
        # left dangling it would make a live rid point at the corpse until
        # the next tick finalizes it (found by the property harness:
        # tests/corpus "max-ratio-crash-mid-deflect")
        for handle in self.handles.values():
            r = handle.req
            if r.prefill_instance != iid or r.state in (
                    RequestState.FINISHED, RequestState.REJECTED):
                continue
            if r.state is RequestState.DECODING and r.decode_instance != iid:
                r.prefill_instance = None
            elif r.state is RequestState.MIGRATING and \
                    self._migrating_from.get(r.rid) not in (None, iid):
                r.prefill_instance = None
        # ---- 1. inventory the lost work before any teardown
        lost_prefill = list(loc.prefill_queue)
        lost_decode = list(loc.decode_running)
        queued_inbound = list(loc.migration_queue)   # KV lives elsewhere
        outbound_flying, inbound_flying = [], []
        for rid, (src, dst, kv) in list(self._transfers.items()):
            if src == iid:
                outbound_flying.append((rid, dst, kv))   # data lost mid-air
            elif dst == iid:
                inbound_flying.append((rid, src, kv))    # destination gone
        queued_out = []          # queued at a live dst, KV source was iid
        inbound_rids = {q[0] for q in queued_inbound}
        for rid, kv in list(self._migration_kv.items()):
            if rid in self._transfers or rid in inbound_rids:
                continue
            req = self.handles[rid].req
            if req.state is RequestState.MIGRATING and \
                    self._kv_source(rid) == iid:
                queued_out.append((rid, req.decode_instance))
        # resident KV minus reservations for transfers still in the air
        # toward us — that data is intact at its source and gets rerouted,
        # so it was never lost
        self.fault_stats["kv_tokens_lost"] += max(
            loc.kv_used - sum(kv for _, _, kv in inbound_flying), 0)
        # ---- 2. cached prefixes are gone with the memory
        if self.prefix_mgr is not None:
            self.prefix_mgr.invalidate_instance(iid)
        # ---- 3. abort migrations touching iid
        for rid, dst, kv in outbound_flying:            # data lost mid-air
            self._abort_transfer(rid, dst, kv)
            self._transfers.pop(rid, None)
            self._migration_kv.pop(rid, None)
            if self._kv_inbound[dst] > 0:
                self._kv_inbound[dst] -= 1
            self.fault_stats["migrations_aborted"] += 1
        for rid, src, kv in inbound_flying:             # KV intact at src
            self._abort_transfer(rid, iid, kv)
            self._transfers.pop(rid, None)
            self.fault_stats["migrations_aborted"] += 1
        for rid, dst in queued_out:                     # data never moved
            q = self.local_of(dst).migration_queue
            for item in [it for it in q if it[0] == rid]:
                q.remove(item)
            self._migration_kv.pop(rid, None)
            self.fault_stats["migrations_aborted"] += 1
        self._kv_outbound.pop(iid, None)
        self._kv_inbound.pop(iid, None)
        # ---- 4. substrate teardown; the corpse is removed next tick
        self._failed_pending[iid] = now
        self._on_instance_failed(iid)
        loc.prefill_queue.clear()
        loc.decode_running.clear()
        loc.migration_queue.clear()
        loc.retained.clear()
        loc.kv_used = 0
        # ---- 5. replacement before recovery, so that when the crash took
        # the last ACTIVE instance the recovered requests have a WARMING
        # one to wait for instead of being undispatchable
        if self.autoscaler is not None:
            if self.autoscaler.on_instance_failed(iid, pool, now) is not None:
                self.fault_stats["replacements"] += 1
        # ---- 6. recovery: KV-intact migrations re-route; KV-lost requests
        # re-dispatch (scratch, or a surviving prefix holder via the normal
        # §7 affinity path)
        evac_load, targets = Counter(), set()
        kv_lost_rids = lost_prefill + lost_decode + \
            [rid for rid, _, _ in outbound_flying] + \
            [rid for rid, _ in queued_out]
        reroutes = [(rid, kv,
                     self.handles[rid].req.output_len
                     - len(self.handles[rid].tokens))
                    for rid, _, kv in inbound_flying]
        reroutes += queued_inbound
        for rid, kv, rem in reroutes:
            if self.pools.active_ids():
                self._route_evacuation(rid, kv, rem, evac_load, targets)
            else:
                # no destination anywhere: give up the surviving copy and
                # recover by re-prefill like a KV-lost request
                src = self._kv_source(rid)
                if src is not None:
                    self._release_source_kv(src, rid, kv)
                    if self._kv_outbound[src] > 0:
                        self._kv_outbound[src] -= 1
                self._migration_kv.pop(rid, None)
                kv_lost_rids.append(rid)
        for dst in targets:
            self.admit_migrations(dst)
        for rid in kv_lost_rids:
            if recover:
                self._recover_request(rid, now)
            else:
                self._migrating_from.pop(rid, None)
                self._migration_kv.pop(rid, None)
                src = self._prefix_src.pop(rid, None)
                if src is not None and self.prefix_mgr is not None:
                    self.prefix_mgr.unpin(src[0], src[1])
                self.fault_stats["requests_lost"] += 1
                self._request_lost(rid)
        return {"lost_prefill": len(lost_prefill),
                "lost_decode": len(lost_decode),
                "rerouted": len(inbound_flying) + len(queued_inbound),
                "recovered": len(kv_lost_rids) if recover else 0}

    def _recover_request(self, rid: int, now: float) -> None:
        """Re-dispatch a request whose KV was lost in a crash. Prefill-phase
        victims simply restart. Decode-phase victims must not re-emit what
        the user already saw: the context to rebuild is the prompt plus all
        streamed tokens except the last (whose logits seed the next decode
        step), so ``input_len`` absorbs those tokens — the recovery prefill
        is then costed, prefix-matched and placed like any other request,
        and ``after_prefill`` suppresses the duplicate emission."""
        handle = self.handles[rid]
        req = handle.req
        self._prepare_recovery(handle)        # engine extends the real prompt
        emitted = len(handle.tokens)
        if emitted:
            # tokens newly absorbed into the context since the last recovery
            delta = emitted - max(req.resumed_tokens, 1)
            req.input_len += delta
            req.decoded_tokens -= delta       # they are prompt now (§7 keys)
            req.resumed_tokens = emitted
        req.recoveries += 1
        req.state = RequestState.QUEUED
        req.prefill_instance = None
        req.decode_instance = None
        req.cached_len = 0
        req.prefill_done_tokens = 0
        self._migrating_from.pop(rid, None)
        self._xfer_attempts.pop(rid, None)
        src = self._prefix_src.pop(rid, None)
        if src is not None and self.prefix_mgr is not None:
            self.prefix_mgr.unpin(src[0], src[1])   # frees a doomed source
        self.fault_stats["requests_recovered"] += 1
        self._arrival_due(rid)

    def apply_slowdown(self, iid: int, factor: float, until: float) -> None:
        """A lagging instance (§3.2): iterations run ``factor`` slower until
        the system clock passes ``until``."""
        self._slowdowns[iid] = (factor, until)
        self.fault_stats["slowdowns"] += 1

    def slow_factor(self, iid: int, now: float) -> float:
        ent = self._slowdowns.get(iid)
        if ent is None:
            return 1.0
        factor, until = ent
        if now >= until:
            del self._slowdowns[iid]
            return 1.0
        return factor

    # ------------------------------------- self-healing layer (DESIGN.md §14)
    def quarantine_instance(self, iid: int, now: float) -> None:
        """ACTIVE → DEGRADED: the HealthMonitor flagged ``iid`` as a
        sustained straggler. No new work lands on it; its decode residents
        are drained away through the FCFS migration manager (their KV is
        intact — this is a planned move, not a crash); prefill it already
        holds drains in place. The interval window is cleared so the stale
        slow samples cannot re-trip detection right after probation."""
        self.pools.degrade(iid)
        self.health_stats["quarantines"] += 1
        self.monitor.reset_intervals(iid)
        self._evacuate_residents(iid)

    def restore_instance(self, iid: int, now: float) -> None:
        """DEGRADED → ACTIVE (probation passed): back in the schedulable
        set. Requests parked while nothing was ACTIVE retry now, mirroring
        ``activate_instance``."""
        self.pools.restore(iid)
        self.health_stats["restores"] += 1
        self.monitor.reset_intervals(iid)
        self._instance_ready(iid)
        while self._unplaced:
            self._arrival_due(self._unplaced.popleft())

    def escalate_unhealthy(self, iid: int, now: float) -> None:
        """Quarantine deadline expired — the instance kept relapsing: treat
        it as a hard fault (teardown + recovery + replacement, §8)."""
        self.health_stats["escalations"] += 1
        if self.health_monitor is not None:
            self.health_monitor.forget(iid)
        self.fail_instance(iid, now)

    def apply_transfer_drop(self, p: float, until: float) -> None:
        """Transient network fault window (§14): each migration transfer
        attempt started before ``until`` fails with probability ``p``."""
        self._xfer_drop = (p, until)

    def apply_netslow(self, factor: float, until: float) -> None:
        """Degraded interconnect window (§14): transfer durations are
        multiplied by ``factor`` until the clock passes ``until``."""
        self._netslow = (factor, until)

    def xfer_should_drop(self, now: float) -> bool:
        """Decide one transfer attempt's fate under the drop window. The RNG
        is only consumed while a window is active and 0 < p < 1, so runs
        without droptransfer events never draw from it."""
        if self._xfer_drop is None:
            return False
        p, until = self._xfer_drop
        if now >= until:
            self._xfer_drop = None
            return False
        if p >= 1.0:
            return True
        return self._xfer_rng.random() < p

    def netslow_factor(self, now: float) -> float:
        if self._netslow is None:
            return 1.0
        factor, until = self._netslow
        if now >= until:
            self._netslow = None
            return 1.0
        return factor

    def xfer_retry_budget(self) -> int:
        """Bounded retry attempts per transfer; 0 without ``--health`` (a
        dropped transfer then falls straight through to re-prefill recovery —
        the detection-off baseline bench_chaos measures against)."""
        return self.health_cfg.xfer_retries if self.health_cfg else 0

    def xfer_backoff(self, attempt: int) -> float:
        """Exponential backoff before retry ``attempt`` (1-based)."""
        base = self.health_cfg.xfer_backoff_s if self.health_cfg else 0.25
        return base * (2.0 ** (attempt - 1))

    def note_xfer_drop(self, rid: int) -> int:
        """One transfer attempt failed (dropped/timed out/corrupt): returns
        the attempt count so far for backoff computation."""
        self.health_stats["xfer_drops"] += 1
        self._xfer_attempts[rid] = self._xfer_attempts.get(rid, 0) + 1
        return self._xfer_attempts[rid]

    def fail_transfer(self, rid: int, dst: int, kv: int, now: float) -> None:
        """Retry budget exhausted for ``rid``'s transfer toward ``dst``: give
        up the move. The surviving source copy is released and the request
        falls through to the §8 re-prefill recovery path (streams stay
        token-identical — recovery re-computes prompt ‖ streamed[:-1])."""
        self._transfers.pop(rid, None)
        self._xfer_attempts.pop(rid, None)
        if self._kv_inbound[dst] > 0:
            self._kv_inbound[dst] -= 1
        src = self._kv_source(rid)
        if src is not None:
            self._release_source_kv(src, rid, kv)
            if self._kv_outbound[src] > 0:
                self._kv_outbound[src] -= 1
        self._migration_kv.pop(rid, None)
        self.health_stats["xfer_failures"] += 1
        self._recover_request(rid, now)

    def _maybe_preempt(self, iid: int, loc: LocalScheduler) -> bool:
        """SLO-aware preemption at the §5.4 memory gate: the head migration
        is blocked and eviction freed nothing, so release the lowest-value
        decode resident — ordered by tenant credit balance, SLO tier (batch
        first), then remaining-length estimate (longest remaining = least
        sunk progress) — and re-dispatch it through the §8 recovery path
        (streams stay bit-identical). A per-instance rate limiter keeps
        degradation graceful rather than thrashing."""
        cfg = self.health_cfg
        if cfg is None or not cfg.preemption or not loc.decode_running:
            return False
        now = self.clock.now()
        log = self._preempt_log.setdefault(iid, deque())
        while log and now - log[0] > cfg.preempt_window_s:
            log.popleft()
        if len(log) >= cfg.preempt_limit:
            self.health_stats["preempt_refused"] += 1
            return False
        victim = min(loc.decode_running,
                     key=lambda rid: self._preemption_key(rid, loc))
        self._quiesce_for_evacuation(iid)
        if victim not in loc.decode_running:
            # the settling step just finished it — its KV is free, retry
            # the gate without charging the limiter
            return True
        w = loc.decode_running.pop(victim)
        loc.kv_used -= w.context_len
        self._preempt_release(iid, victim)
        log.append(now)
        self.health_stats["preemptions"] += 1
        self._recover_request(victim, now)
        return True

    def _preemption_key(self, rid: int, loc: LocalScheduler):
        handle = self.handles[rid]
        credits = 0.0
        if self.tenants is not None and handle.req.tenant_id is not None:
            credits = self.tenants.credits(handle.req.tenant_id)
        tier_rank = {"batch": 0, "standard": 1, "interactive": 2}[handle.tier]
        remaining = loc.decode_running[rid].remaining_out
        return (credits, tier_rank, -remaining, rid)

    def _preempt_release(self, iid: int, rid: int) -> None:
        """Backend hook: free the physical decode state of a preempted
        resident (the engine drops the real slot; the sim holds nothing
        beyond the LocalScheduler bookkeeping already undone)."""

    def health_detail(self) -> Dict[str, float]:
        """Self-healing accounting (§14); empty when the layer never acted
        (so health-off reports stay byte-identical to pre-§14 builds)."""
        if not any(self.health_stats.values()):
            return {}
        return dict(self.health_stats)

    def _check_undispatchable(self) -> None:
        """Raise UndispatchableError when queued requests can never dispatch:
        nothing ACTIVE, nothing WARMING, nothing DEGRADED awaiting probation
        (drain would otherwise hang)."""
        if not self._unplaced:
            return
        if self.pools.active_ids() or self.pools.warming_ids() or \
                self.pools.degraded_ids():
            return
        raise UndispatchableError(self._unplaced, self.pools)

    # ------------------------------------------------ monitor-tick scrape
    def collect_stats(self, now: float) -> None:
        ready = getattr(self.policy, "prefill_ready_at", {})
        for iid in self.pools.all_ids():
            if self.pools.lifecycle_of(iid) is Lifecycle.FAILED:
                continue               # corpse (§8): substrate gone
            loc = self.local_of(iid)
            self.monitor.update_stats(InstanceStats(
                instance_id=iid,
                prefill_queue_len=len(loc.prefill_queue),
                prefill_backlog_tokens=loc.prefill_backlog_tokens,
                prefill_ready_at=ready.get(iid, 0.0),
                running_tokens=loc.running_tokens,
                n_decode_running=len(loc.decode_running),
                kv_tokens_used=loc.kv_used,
                kv_tokens_capacity=loc.kv_capacity,
            ))
        if self.health_monitor is not None:
            # right after the scrape, before scheduling reacts: both
            # backends see identical post-scrape signals at a barrier (§14)
            self.health_monitor.tick(now)
        self.policy.on_monitor_tick(now)
        if self.tenants is not None:
            self.tenants.on_tick(now)        # credit accrual (§10)
        if self.autoscaler is not None:
            self.autoscaler.on_monitor_tick(now)
        self._maybe_finalize_retires(now)

    # ------------------------------------------------ pool-flip accounting
    def flip_counts(self) -> Dict[str, int]:
        return {
            "total": self.pools.flips,
            "d2p": getattr(self.policy, "n_d2p_flips", 0),
            "p2d": getattr(self.policy, "n_p2d_flips", 0),
            "proactive": getattr(self.policy, "n_proactive_flips", 0),
        }

    # ----------------------------------------------------------- reporting
    def scaling_detail(self) -> Dict[str, float]:
        now = self.clock.now()
        out = {"instance_seconds": self.instance_seconds(now),
               "n_instances": len(self.pools.all_ids())}
        if self.autoscaler is not None:
            out["scale_ups"] = self.autoscaler.n_scale_ups
            out["scale_downs"] = self.autoscaler.n_scale_downs
        return out

    def prefix_detail(self) -> Dict[str, float]:
        """Prefix-cache effectiveness (§7); empty when the cache is off."""
        if self.prefix_mgr is None:
            return {}
        out = dict(self.prefix_mgr.stats)
        out.update(self._prefix_timing)
        full = out["full_prefill_s"]
        out["saved_prefill_frac"] = \
            out["saved_prefill_s"] / full if full > 0 else 0.0
        return out

    def fault_detail(self) -> Dict[str, float]:
        """Fault/recovery accounting (§8); empty when no fault ever fired
        (so fault-free reports stay byte-identical to pre-fault builds)."""
        if not any(self.fault_stats.values()):
            return {}
        return dict(self.fault_stats)

    def deflection_detail(self) -> Dict[str, float]:
        """Cross-pool deflection accounting (§11); empty when deflection is
        unarmed or never acted (so ratio=0 / non-deflective reports stay
        byte-identical to pre-deflection builds)."""
        if self.deflection_cfg is None or self.policy.deflection is None:
            return {}
        out = dict(self.policy.deflection.stats)
        chunks = self._deflect_closed["chunks"]
        tokens = self._deflect_closed["tokens"]
        for iid in self.pools.all_ids():
            if self.pools.lifecycle_of(iid) is Lifecycle.FAILED:
                continue
            loc = self.local_of(iid)
            chunks += loc.deflected_chunks
            tokens += loc.deflected_chunk_tokens
        out["chunks_executed"] = chunks
        out["chunk_tokens_executed"] = tokens
        if not any(out.values()):
            return {}
        return out

    def admission_detail(self) -> Dict[str, float]:
        """Admission-control accounting (§10); empty when admission is off
        (so tenant-less reports stay byte-identical to pre-tenancy builds)."""
        if self.admission_ctl is None:
            return {}
        return dict(self.admission_ctl.stats)

    def tenant_detail(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant report rows (§10); empty without a tenant registry.
        A tenant with zero finished requests gets ``None`` metrics (callers
        render 'n/a', never divide by zero)."""
        if self.tenants is None:
            return {}
        by_tenant: Dict[str, list] = {}
        for h in self.handles.values():
            if h.req.tenant_id is not None:
                by_tenant.setdefault(h.req.tenant_id, []).append(h)
        out: Dict[str, Dict[str, float]] = {}
        for tid in self.tenants.ids():
            hs = by_tenant.get(tid, [])
            sub = ServeReport(handles=hs)      # reuse percentile machinery
            tenant = self.tenants.get(tid)
            row = {
                "tier": tenant.tier,
                "weight": tenant.weight,
                "attainment": (sum(1 for h in hs if h.meets_slo()) / len(hs)
                               if hs else None),
                "p99_ttft": sub.percentile("ttft", 0.99),
                "p99_tpot": sub.percentile("tpot", 0.99),
                "credits": self.tenants.credits(tid),
                "violation_ewma": self.tenants.violation_ewma(tid),
            }
            row.update(self.tenants.counters.get(tid, {}))
            out[tid] = row
        return out

    def sampling_detail(self) -> Dict[str, float]:
        """Replayable-sampling accounting (§12); empty when every request
        decoded greedily (so greedy reports stay byte-identical to
        pre-sampling builds). ``seed`` is the run seed each slot's key
        stream is folded from — the replay handle."""
        if not self._sampling_stats["sampled_requests"]:
            return {}
        return {"seed": self.run_seed, **self._sampling_stats}

    def speculation_detail(self) -> Dict[str, float]:
        """Self-speculative decoding accounting (§12); empty when
        speculation is off or never ran a round."""
        if not self._spec_stats["rounds"]:
            return {}
        out = dict(self._spec_stats)
        out["acceptance"] = (out["accepted"] / out["drafted"]
                             if out["drafted"] else 0.0)
        return out

    def report(self) -> ServeReport:
        return ServeReport(handles=list(self.handles.values()),
                           flip_detail=self.flip_counts(),
                           decisions=dict(self.decisions),
                           duration=self.clock.now(),
                           scaling=self.scaling_detail(),
                           prefix=self.prefix_detail(),
                           faults=self.fault_detail(),
                           health=self.health_detail(),
                           admission=self.admission_detail(),
                           deflection=self.deflection_detail(),
                           per_tenant=self.tenant_detail(),
                           sampling=self.sampling_detail(),
                           speculation=self.speculation_detail())
