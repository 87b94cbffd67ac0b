"""Discrete-event cluster simulator: a ``ServingSystem`` backend that replays
traffic against N stateless instances driven by a scheduling policy, with the
analytic cost model of the card supplying iteration/transfer times.
Reproduces the paper's evaluation loop (Fig. 7/8/9) at cluster scale on a
laptop.

Event kinds: request arrival, iteration completion, migration completion,
monitor tick. Instances run iterations back-to-back while they have work
(continuous batching); chunked prefill mixes phases inside one iteration.

All scheduling glue (prefill dispatch, decode placement, the FCFS migration
manager, monitor-tick scraping) lives in the shared ``RuntimeCore``
(core/runtime.py); this module only supplies the event loop, the virtual
clock and the cost-model timings. Tokens stream through per-request
``on_token`` callbacks as they land in virtual time — content is not
modeled, so the streamed token ids are ``None``.
"""
from __future__ import annotations

import heapq
import itertools
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.clock import VirtualClock
from repro_torch.core.local_scheduler import LocalScheduler
from repro_torch.core.pools import Lifecycle
from repro_torch.core.request import Request
from repro_torch.core.runtime import DecodePlacement, RuntimeCore
from repro_torch.core.serving import (FinishCallback, RequestHandle, ServeReport,
                                TokenCallback)
from repro_torch.core.slo import SLO, SchedulerConfig
from repro_torch.core.ttft_predictor import TTFTPredictor
from repro_torch.sim.cost_model import (CostModel, InstanceProfile,
                                  SpeculationModel)


@dataclass
class SimResult:
    requests: List[Request]
    slo: SLO
    flips: int = 0
    sim_time: float = 0.0

    @property
    def attainment(self) -> float:
        if not self.requests:
            return 1.0
        ok = sum(1 for r in self.requests if r.meets_slo(self.slo))
        return ok / len(self.requests)

    def p90(self, metric: str) -> float:
        vals = sorted(getattr(r, metric) for r in self.requests
                      if getattr(r, metric) is not None)
        if not vals:
            return float("inf")
        return vals[min(int(0.9 * len(vals)), len(vals) - 1)]


class Simulator(RuntimeCore):
    def __init__(self, cfg: ModelConfig, *, n_instances: int = 8,
                 n_prefill: int = 4, policy: str = "arrow",
                 slo: SLO = SLO(3.0, 0.1),
                 sched_cfg: Optional[SchedulerConfig] = None,
                 profile: InstanceProfile = InstanceProfile(),
                 profiles: Optional[Dict[int, InstanceProfile]] = None,
                 token_budget: int = 8192, flip_latency: float = 0.0,
                 autoscaler_cfg=None, prefix_cache: bool = False,
                 fault_plan=None, tenants=None, admission=False,
                 deflection=None, speculate: int = 0,
                 spec_accept: float = 0.8, spec_draft_frac: float = 0.5,
                 seed: int = 0, health=False):
        """``profiles`` (iid -> InstanceProfile) enables heterogeneous
        clusters (paper §8): per-instance cost models + a per-instance-fitted
        TTFT predictor; ``profile`` is the homogeneous default (elastic
        scale-ups always materialize from it). ``autoscaler_cfg`` tunes the
        AutoScaler attached when ``policy`` is elastic (DESIGN.md §6).
        ``fault_plan`` (core/faults.py) schedules crash/slowdown injection
        as exact virtual-clock events (DESIGN.md §8). ``tenants`` attaches a
        ``TenantRegistry`` (core/tenants.py); ``admission`` (bool or an
        ``AdmissionConfig``) arms the watermark admission controller
        (DESIGN.md §10). ``deflection`` (a ``DeflectionConfig``) tunes
        cross-pool prefill deflection under a deflective policy
        (``arrow_deflect``, DESIGN.md §11). ``speculate=k`` models
        self-speculative decoding (DESIGN.md §12): decode iterations cost
        ``CostModel.spec_iteration_time`` and emit multiple tokens per
        round with per-draft acceptance ``spec_accept``. ``health`` (bool or
        a ``HealthConfig``) arms the self-healing layer (DESIGN.md §14):
        straggler quarantine, the transfer retry ladder and SLO-aware
        preemption."""
        self.cfg = cfg
        self._spawn_profile = profile
        self._token_budget = token_budget
        self.spec: Optional[SpeculationModel] = (
            SpeculationModel(k=speculate, draft_frac=spec_draft_frac,
                             accept=spec_accept) if speculate else None)
        # deterministic error-diffusion residual for integer per-round
        # emission (rid -> fractional tokens owed) — the modeled stream
        # length is exact in expectation and replayable
        self._spec_residual: Dict[int, float] = {}
        ids = list(range(n_instances))
        self.costs: Dict[int, CostModel] = {
            i: CostModel(cfg, (profiles or {}).get(i, profile))
            for i in ids}
        self.cost = self.costs[0]
        if profiles:
            from repro_torch.core.ttft_predictor import PerInstancePredictor
            predictor = PerInstancePredictor.fit_per_instance(
                {i: self.costs[i].profile_ttft_samples() for i in ids})
        else:
            predictor = TTFTPredictor.fit(self.cost.profile_ttft_samples())
        # conservative Max Running Tokens: profiled on the weakest instance
        mrt = min(
            c.max_running_tokens(
                (sched_cfg or SchedulerConfig()).tpot_threshold_frac * slo.tpot)
            for c in self.costs.values())
        base = sched_cfg or SchedulerConfig()
        overrides = {"max_running_tokens": mrt}
        if policy == "arrow_proactive":
            overrides["proactive"] = True
        sched_cfg = SchedulerConfig(**{**base.__dict__, **overrides})

        self._init_runtime(ids, n_prefill=n_prefill, policy=policy, slo=slo,
                           sched_cfg=sched_cfg, predictor=predictor,
                           clock=VirtualClock(), autoscaler_cfg=autoscaler_cfg,
                           prefix_cache=prefix_cache, fault_plan=fault_plan,
                           tenants=tenants, admission=admission,
                           deflection=deflection, run_seed=seed,
                           prefix_reuse=("block" if cfg.family == "dense"
                                         else "exact"),
                           health=health)
        self.locals: Dict[int, LocalScheduler] = {
            i: LocalScheduler(i, token_budget=token_budget,
                              kv_capacity_tokens=self.costs[i].kv_capacity_tokens())
            for i in ids}
        for i in ids:
            self._arm_deflect(i)     # §11 micro-batch knob (no-op if unarmed)

        self.requests: Dict[int, Request] = {}
        self._heap: list = []
        self._seq = itertools.count()
        self._busy: Dict[int, bool] = {i: False for i in ids}
        self._tick_armed = False
        # in-flight KV transfers carry a sequence token so a crash can
        # invalidate the pending completion event (DESIGN.md §8)
        self._xfer_seq = itertools.count(1)
        self._live_xfer: Dict[int, int] = {}      # rid -> live seq
        if self.fault_injector is not None:
            # exact virtual-time firing: one event per scripted fault
            for t in self.fault_injector.event_times():
                self._push(t, self._on_fault_due)

        # Motivation experiment (§3.2 "lagging instance scheduling"): role-bound
        # systems pay a reload/drain penalty per flip. Arrow's stateless
        # instances make it 0; flip_latency>0 simulates DistServe/Splitwise-
        # style role changes to quantify what statelessness buys.
        self._flip_latency = flip_latency
        self._flip_block: Dict[int, float] = {i: 0.0 for i in ids}
        if flip_latency > 0:
            orig_move = self.pools.move

            def move(iid, to):
                if self.pools.pool_of(iid) is not to:
                    self._flip_block[iid] = self._now + flip_latency
                orig_move(iid, to)

            self.pools.move = move

    # ----------------------------------------------------- RuntimeCore hooks
    @property
    def _now(self) -> float:
        return self.clock.now()

    def local_of(self, iid: int) -> LocalScheduler:
        return self.locals[iid]

    def _begin_transfer(self, rid: int, dst: int, kv: int, rem: int) -> bool:
        # reserve memory now; data lands after the (async DMA) transfer delay
        self.locals[dst].kv_used += kv
        self._launch_transfer(rid, dst, kv, rem, delay=0.0)
        return True

    def _launch_transfer(self, rid: int, dst: int, kv: int, rem: int,
                         delay: float) -> None:
        """Schedule one transfer attempt (§14 retry ladder: ``delay`` is the
        backoff before a retry). The attempt's fate is decided now — dropped
        under an active droptransfer window, or timed out when the (possibly
        netslow-inflated) duration exceeds the per-transfer timeout — and a
        failed attempt surfaces at the moment the failure would be noticed:
        the timeout, or the would-be landing time."""
        dur = self.costs[dst].transfer_time_bytes(
            self.costs[dst].migration_bytes(kv))
        dur *= self.netslow_factor(self._now)        # degraded interconnect
        failed = self.xfer_should_drop(self._now)
        if self.health_cfg is not None and \
                dur > self.health_cfg.xfer_timeout_s:
            failed = True
            dur = self.health_cfg.xfer_timeout_s
        seq = next(self._xfer_seq)
        self._live_xfer[rid] = seq
        self._push(self._now + delay + dur, self._on_migration_done,
                   dst, rid, kv, rem, seq, failed)

    def _abort_transfer(self, rid: int, dst: int, kv: int) -> None:
        # crash abort (§8): undo the destination reservation; the pending
        # completion event no longer matches the live seq and is dropped
        loc = self.locals.get(dst)
        if loc is not None:
            loc.kv_used = max(0, loc.kv_used - kv)
        self._live_xfer.pop(rid, None)

    def _release_source_kv(self, src: int, rid: int, kv: int) -> None:
        self.locals[src].release_prefill_kv(rid, kv)
        self._kick(src)

    def _decode_started(self, iid: int) -> None:
        self._kick(iid)

    def _arrival_due(self, rid: int) -> None:
        """Deferred request released (parent finished / instance activated):
        re-enter the arrival path at the current virtual time."""
        self._push(self._now, self._on_arrival, rid)

    def _schedule_retry(self, rid: int, at: float) -> None:
        """Admission deferred ``rid`` (§10): exact virtual-time retry event.
        These events also keep the monitor tick armed, so credit accrual
        continues while requests wait."""
        self._push(max(at, self._now), self._on_arrival, rid)

    # ------------------------------------- elastic lifecycle hooks (§6)
    def _create_instance(self, iid: int) -> float:
        """Materialize a new instance from the homogeneous InstanceProfile;
        the AutoScaler's ``warmup_s`` models provision/weight-load time."""
        self.costs[iid] = CostModel(self.cfg, self._spawn_profile)
        self.locals[iid] = LocalScheduler(
            iid, token_budget=self._token_budget,
            kv_capacity_tokens=self.costs[iid].kv_capacity_tokens())
        self._busy[iid] = False
        self._flip_block[iid] = 0.0
        return self.autoscaler.cfg.warmup_s if self.autoscaler else 0.0

    def _schedule_activation(self, iid: int, delay: float) -> None:
        self._push(self._now + delay, self.activate_instance, iid)

    def _instance_ready(self, iid: int) -> None:
        self._kick(iid)

    def _instance_quiesced(self, iid: int) -> bool:
        return not self._busy.get(iid, False)

    def _destroy_instance(self, iid: int) -> None:
        del self.locals[iid]
        del self.costs[iid]
        del self._busy[iid]
        del self._flip_block[iid]

    # ---------------------------------------------- fault hooks (§8)
    def _on_instance_failed(self, iid: int) -> None:
        # a running iteration dies with the instance: its completion event
        # is stale (the handlers check lifecycle); the corpse's LocalScheduler
        # stays until finalization so stat probes see an empty instance
        self._busy[iid] = False

    def _on_fault_due(self) -> None:
        self.fault_injector.poll(self._now)

    def _is_dead(self, iid: int) -> bool:
        return iid not in self.locals or \
            self.pools.lifecycle_of(iid) is Lifecycle.FAILED

    # --------------------------------------------------------- ServingSystem
    def submit(self, req: Request, *, prompt=None, tier: str = "standard",
               tenant_id: Optional[str] = None,
               on_token: Optional[TokenCallback] = None,
               on_finish: Optional[FinishCallback] = None) -> RequestHandle:
        handle = self._register(req, tier, on_token, on_finish,
                                tenant_id=tenant_id)
        self.requests[req.rid] = req
        self._push(max(req.arrival, self._now), self._on_arrival, req.rid)
        if not self._tick_armed:
            self._tick_armed = True
            self._push(self._now + self.sched_cfg.monitor_interval,
                       self._on_monitor_tick)
        return handle

    def step(self) -> bool:
        if not self._heap:
            return False
        t, _, fn, args = heapq.heappop(self._heap)
        self.clock.advance(t)
        fn(*args)
        return bool(self._heap)

    def run_until(self, t: float) -> None:
        while self._heap and self._heap[0][0] <= t:
            self.step()
        self.clock.advance(t)

    def drain(self, *, timeout: Optional[float] = None) -> ServeReport:
        limit = float("inf") if timeout is None else self._now + timeout
        while self._heap and self._heap[0][0] <= limit:
            self.step()
            self._check_undispatchable()   # §8: raise, don't return short
        self._check_undispatchable()
        return self.report()

    # ------------------------------------------------- deprecated batch shim
    def run(self, trace: List[Request], *, max_time: float = 1e9) -> SimResult:
        """Batch entrypoint kept for compatibility; new code should use
        ``submit()`` + ``drain()`` (the unified ServingSystem API)."""
        warnings.warn("Simulator.run(trace) is deprecated; use the "
                      "ServingSystem API (submit/step/drain)",
                      DeprecationWarning, stacklevel=2)
        for r in trace:
            self.submit(r)
        while self._heap and self._heap[0][0] <= max_time:
            self.step()
        return SimResult(list(self.requests.values()), self.slo,
                         flips=self.pools.flips, sim_time=self._now)

    # ------------------------------------------------------------ events
    def _push(self, t: float, fn, *args) -> None:
        heapq.heappush(self._heap, (t, next(self._seq), fn, args))

    # -------------------------------------------------------- handlers
    def _on_arrival(self, rid: int) -> None:
        iid = self.dispatch_prefill(self.handles[rid], self._now)
        if iid is not None:               # else deferred (gated/unplaced)
            self._kick(iid)

    def _kick(self, iid: int) -> None:
        """Start an iteration if the instance is idle and has work."""
        if self._is_dead(iid):            # removed/failed — stale event
            return
        if self._busy[iid]:
            return
        if self._flip_block[iid] > self._now:          # draining/reloading
            self._push(self._flip_block[iid], self._kick, iid)
            return
        loc = self.locals[iid]
        self.admit_migrations(iid)
        plan = loc.plan_iteration()
        if plan.is_empty:
            return
        chunks = [(start, ln) for _, start, ln in plan.prefill_chunks]
        ctx = [loc.decode_running[r].context_len for r in plan.decode_rids]
        spec_round = bool(self.spec is not None and ctx)
        if spec_round:
            # mirrors the engine's speculative step structure: one
            # spec_decode call for the decode batch plus a *separate*
            # chunks call (the fused mixed step doesn't speculate), so the
            # per-call overhead is paid twice exactly as on the engine
            dur = self.costs[iid].spec_iteration_time(ctx, self.spec)
            if chunks:
                dur += self.costs[iid].iteration_time(chunks, [])
        else:
            dur = self.costs[iid].iteration_time(chunks, ctx)
        dur *= self.slow_factor(iid, self._now)      # injected lag (§8)
        self._busy[iid] = True
        self._push(self._now + dur, self._on_iteration_done, iid, plan, dur,
                   spec_round)

    def _spec_round_tokens(self, rid: int) -> int:
        """Integer tokens emitted by ``rid``'s speculative round: the
        expected emission with per-rid error diffusion, so long streams hit
        the modeled rate exactly while every round emits at least the
        verify token and at most k+1."""
        spec = self.spec
        r = self._spec_residual.get(rid, 0.0) + spec.expected_emitted
        n = int(min(max(int(r), 1), spec.k + 1))
        self._spec_residual[rid] = r - n
        return n

    def _on_iteration_done(self, iid: int, plan, dur: float,
                           spec_round: bool = False) -> None:
        if self._is_dead(iid):            # crashed mid-iteration (§8)
            return
        loc = self.locals[iid]
        now = self._now
        # decode tokens out (streamed; the sim models timing, not content)
        emitted = 0
        for rid in plan.decode_rids:
            if rid not in loc.decode_running:
                continue
            handle = self.handles[rid]
            if not spec_round:
                self.emit_token(handle, now)
                emitted += 1
                if loc.complete_decode_iteration(rid):
                    self.finish(handle, now)
                continue
            n = self._spec_round_tokens(rid)
            self._spec_stats["rounds"] += 1
            self._spec_stats["drafted"] += self.spec.k
            self._spec_stats["accepted"] += n - 1
            for i in range(n):
                # space the round's tokens inside the iteration so virtual
                # token timestamps stay strictly ordered per request (the
                # stream invariant the property tests assert)
                t_i = now - dur + dur * (i + 1) / n
                self.emit_token(handle, t_i)
                emitted += 1
                self._spec_stats["emitted"] += 1
                if loc.complete_decode_iteration(rid):
                    self.finish(handle, t_i)
                    break                 # overshot accepts are discarded
        self.monitor.record_iteration(iid, now, emitted, dur)
        # prefill chunks
        for rid, start, ln in plan.prefill_chunks:
            if rid not in loc.prefill_queue:
                continue
            req = self.requests[rid]
            req.prefill_done_tokens = start + ln
            if loc.complete_prefill_chunk(rid, ln):
                self._on_prefill_complete(iid, rid)
        self._busy[iid] = False
        self._kick(iid)

    def _on_prefill_complete(self, iid: int, rid: int) -> None:
        handle = self.handles[rid]
        placement, target = self.after_prefill(handle, iid, self._now)
        if placement is DecodePlacement.FINISHED:
            self.locals[iid].release_prefill_kv(rid, handle.req.input_len)
        elif placement is DecodePlacement.LOCAL:
            self._kick(iid)
        else:
            self.admit_migrations(target)

    def _on_migration_done(self, dst: int, rid: int, kv: int, rem: int,
                           seq: int = 0, failed: bool = False) -> None:
        if self._live_xfer.get(rid) != seq:  # aborted by a crash (§8)
            return
        self._live_xfer.pop(rid, None)
        if failed:                           # dropped/timed out attempt (§14)
            attempt = self.note_xfer_drop(rid)
            if attempt <= self.xfer_retry_budget():
                # source KV is retained until acknowledged, so retry is
                # always safe; bounded exponential backoff between attempts
                self.health_stats["xfer_retries"] += 1
                self._launch_transfer(rid, dst, kv, rem,
                                      delay=self.xfer_backoff(attempt))
            else:
                self.locals[dst].kv_used -= kv   # undo the reservation
                self.fail_transfer(rid, dst, kv, self._now)
            return
        self.locals[dst].kv_used -= kv       # admit_migrated re-adds
        self._record_migration(rid, kv,
                               int(self.costs[dst].migration_bytes(kv)))
        self.complete_migration(rid, dst, kv, rem, self._now)

    def _on_monitor_tick(self) -> None:
        now = self._now
        self.collect_stats(now)
        # keep ticking while events remain — or while a quarantined
        # instance awaits its probation/escalation decision (§14), which
        # only the tick can deliver
        if self._heap or self.pools.degraded_ids():
            self._push(now + self.sched_cfg.monitor_interval,
                       self._on_monitor_tick)
        else:
            self._tick_armed = False
