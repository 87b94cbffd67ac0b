"""Unified online serving API: the ``ServingSystem`` protocol both the
discrete-event :class:`repro.sim.Simulator` and the real-compute
:class:`repro.engine.ArrowEngineCluster` implement.

Semantics are open-loop and streaming (DESIGN.md §1):

  * ``submit(request) -> RequestHandle`` registers a request that *arrives* at
    ``request.arrival`` on the system's clock; it does not block.
  * ``step()`` performs one unit of work (one event / one cooperative pass);
    ``run_until(t)`` advances the system's clock to ``t``; ``drain()`` runs
    until every submitted request finished (or a timeout expires).
  * Tokens are delivered as they land through per-request ``on_token``
    callbacks, so TTFT/TPOT are observable online rather than reconstructed
    from a batch result.
  * Each request carries an SLO tier (``interactive``/``standard``/``batch``)
    scaling the system's base SLO; attainment is reported per tier.

The batch entrypoints ``Simulator.run(trace)`` and
``ArrowEngineCluster.serve(reqs)`` remain as thin deprecation shims over this
API (DESIGN.md §1.3).
"""
from __future__ import annotations

import abc
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.core.clock import Clock
from repro_torch.core.request import Request
from repro_torch.core.slo import SLO


@dataclass(frozen=True)
class SLOTier:
    """Per-request SLO class: a multiplier over the system's base SLO."""

    name: str
    ttft_scale: float = 1.0
    tpot_scale: float = 1.0

    def apply(self, base: SLO) -> SLO:
        return SLO(base.ttft * self.ttft_scale, base.tpot * self.tpot_scale)


TIERS: Dict[str, SLOTier] = {
    "interactive": SLOTier("interactive", ttft_scale=0.5, tpot_scale=0.5),
    "standard": SLOTier("standard"),
    "batch": SLOTier("batch", ttft_scale=4.0, tpot_scale=4.0),
}


class UndispatchableError(RuntimeError):
    """``drain()`` can never complete: requests are waiting for an ACTIVE
    instance but every instance is FAILED or RETIRING and none is WARMING —
    nothing will ever accept them. Raised instead of hanging until the
    drain timeout (DESIGN.md §8). ``rids`` lists the stranded requests."""

    def __init__(self, rids, pools):
        self.rids = sorted(rids)
        super().__init__(
            f"drain() cannot complete: no ACTIVE or WARMING instance will "
            f"ever accept rids {self.rids} "
            f"({len(pools.retiring_ids())} retiring, "
            f"{len(pools.failed_ids())} failed); scale up first or use an "
            f"elastic policy")

# on_token(handle, token_id_or_None, t): token ids are real ints on the
# engine; the simulator streams ``None`` placeholders (it models timing, not
# content). ``t`` is the system-clock time the token landed.
TokenCallback = Callable[["RequestHandle", Optional[int], float], None]
FinishCallback = Callable[["RequestHandle"], None]


@dataclass
class RequestHandle:
    """Live view of one submitted request."""

    req: Request
    slo: SLO                               # tier-scaled effective SLO
    tier: str = "standard"
    on_token: Optional[TokenCallback] = None
    on_finish: Optional[FinishCallback] = None
    tokens: List[Optional[int]] = field(default_factory=list)
    # set iff admission turned the request away (a tenants.Rejected with
    # reason + retry_after); the request is terminal and never scheduled
    rejection: Optional[object] = None

    @property
    def rid(self) -> int:
        return self.req.rid

    @property
    def tenant_id(self) -> Optional[str]:
        return self.req.tenant_id

    @property
    def rejected(self) -> bool:
        return self.rejection is not None

    @property
    def done(self) -> bool:
        return self.req.finish_time is not None

    @property
    def ttft(self) -> Optional[float]:
        return self.req.ttft

    @property
    def tpot(self) -> Optional[float]:
        return self.req.tpot

    def meets_slo(self) -> bool:
        return self.req.meets_slo(self.slo)


@dataclass
class ServeReport:
    """One reporting path shared by sim and engine runs."""

    handles: List[RequestHandle]
    flip_detail: Dict[str, int] = field(default_factory=dict)
    decisions: Dict[str, int] = field(default_factory=dict)
    duration: float = 0.0
    # elastic-scaling accounting (DESIGN.md §6): instance_seconds,
    # n_instances and — under an elastic policy — scale_ups/scale_downs.
    scaling: Dict[str, float] = field(default_factory=dict)
    # prefix-cache accounting (DESIGN.md §7): hits/lookups, cached_tokens,
    # saved_prefill_s/saved_prefill_frac, evictions, invalidations. Empty
    # when the cache is off.
    prefix: Dict[str, float] = field(default_factory=dict)
    # fault accounting (DESIGN.md §8): crashes, slowdowns, requests
    # recovered/lost, kv_tokens_lost, re_prefill_tokens, migrations_aborted,
    # replacements. Empty when no fault ever fired.
    faults: Dict[str, float] = field(default_factory=dict)
    # self-healing accounting (DESIGN.md §14): quarantines, restores,
    # escalations, xfer_retries/drops/corrupt/failures, preemptions,
    # preempt_refused. Empty when the health layer is off or never acted —
    # default reports stay byte-identical to pre-health builds.
    health: Dict[str, float] = field(default_factory=dict)
    # admission accounting (DESIGN.md §10): admitted, deferred, retries,
    # rejected, shed. Empty when admission control is off.
    admission: Dict[str, float] = field(default_factory=dict)
    # cross-pool deflection accounting (DESIGN.md §11): requests/tokens
    # deflected, chunks/chunk tokens executed, decode_pickups,
    # interference_s, refused_* by reason. Empty when deflection is unarmed
    # or never acted (ratio=0 control stays byte-identical).
    deflection: Dict[str, float] = field(default_factory=dict)
    # per-tenant surface (DESIGN.md §10): tenant_id -> {tier, weight,
    # submitted, admitted, deferred, rejected, shed, finished, attainment,
    # p99_ttft, p99_tpot, credits, violation_ewma}. Empty when no tenant
    # registry is attached.
    per_tenant: Dict[str, Dict[str, float]] = field(default_factory=dict)
    # replayable-sampling accounting (DESIGN.md §12): seed (the run seed
    # every slot key is folded from — replaying the same trace with this
    # seed reproduces every stream bit-for-bit), sampled_requests. Empty
    # when every request decoded greedily (so greedy reports stay
    # byte-identical to pre-sampling builds).
    sampling: Dict[str, float] = field(default_factory=dict)
    # self-speculative decoding accounting (DESIGN.md §12): rounds, drafted,
    # accepted, acceptance, emitted. Empty when speculation is off.
    speculation: Dict[str, float] = field(default_factory=dict)

    #: every field name ``summary()`` can emit, in emission order —
    #: tools/check_docs.py diffs this against DESIGN.md's report-schema
    #: table, so extending summary() without documenting it fails CI.
    SUMMARY_FIELDS = ("finished", "p50_ttft", "p90_ttft", "p90_tpot",
                      "attainment", "flips", "scale_ups", "scale_downs",
                      "instance_s", "prefix_hits", "saved_prefill",
                      "crashes", "recovered", "re_prefill_toks",
                      "quarantines", "restores", "xfer_retries", "preempted",
                      "admitted", "rejected", "shed", "deflected",
                      "refused", "seed", "sampled", "spec_emitted",
                      "spec_accept", "tenants")

    @property
    def flips(self) -> int:
        return self.flip_detail.get("total", 0)

    @property
    def n_total(self) -> int:
        return len(self.handles)

    @property
    def n_finished(self) -> int:
        return sum(1 for h in self.handles if h.done)

    @property
    def attainment(self) -> float:
        """Fraction of *all* submitted requests finishing inside their
        (tier-scaled) SLO — unfinished requests count as misses."""
        if not self.handles:
            return 1.0
        return sum(1 for h in self.handles if h.meets_slo()) / len(self.handles)

    def attainment_by_tier(self, tiers: Optional[List[str]] = None,
                           ) -> Dict[str, Optional[float]]:
        """Attainment per SLO tier. By default only tiers that actually
        received requests appear; pass ``tiers`` to force specific rows,
        where a tier with zero requests maps to ``None`` (rendered "n/a" by
        callers, never a ZeroDivisionError)."""
        out: Dict[str, Optional[float]] = {}
        names = (sorted({h.tier for h in self.handles}) if tiers is None
                 else list(tiers))
        for tier in names:
            hs = [h for h in self.handles if h.tier == tier]
            out[tier] = (sum(1 for h in hs if h.meets_slo()) / len(hs)
                         if hs else None)
        return out

    def percentile(self, metric: str, q: float) -> Optional[float]:
        """q-quantile of ``metric`` ('ttft'/'tpot') over the requests where
        it is already observable (TTFT exists once o_1 streamed, TPOT once
        finished), using standard nearest-rank (ceil(q·n), 1-based);
        ``None`` when no sample exists yet (callers print 'n/a', never
        crash)."""
        vals = sorted(v for h in self.handles
                      if (v := getattr(h, metric)) is not None)
        if not vals:
            return None
        rank = max(math.ceil(q * len(vals)), 1)       # 1-based nearest rank
        return vals[min(rank, len(vals)) - 1]

    def summary(self) -> str:
        def ms(v: Optional[float]) -> str:
            return "n/a" if v is None else f"{v * 1e3:.1f}ms"

        s = (f"finished {self.n_finished}/{self.n_total} "
             f"p50_ttft={ms(self.percentile('ttft', 0.5))} "
             f"p90_ttft={ms(self.percentile('ttft', 0.9))} "
             f"p90_tpot={ms(self.percentile('tpot', 0.9))} "
             f"attainment={self.attainment:.2f} flips={self.flips}")
        if "scale_ups" in self.scaling:
            s += (f" scale_ups={self.scaling['scale_ups']:.0f}"
                  f" scale_downs={self.scaling['scale_downs']:.0f}"
                  f" instance_s={self.scaling['instance_seconds']:.0f}")
        if self.prefix:
            s += (f" prefix_hits={self.prefix['hits']:.0f}"
                  f"/{self.prefix['lookups']:.0f}"
                  f" saved_prefill={self.prefix['saved_prefill_frac']:.0%}")
        if self.faults:
            s += (f" crashes={self.faults['crashes']:.0f}"
                  f" recovered={self.faults['requests_recovered']:.0f}"
                  f" re_prefill_toks={self.faults['re_prefill_tokens']:.0f}")
        if self.health:
            s += (f" quarantines={self.health.get('quarantines', 0):.0f}"
                  f" restores={self.health.get('restores', 0):.0f}"
                  f" xfer_retries={self.health.get('xfer_retries', 0):.0f}"
                  f" preempted={self.health.get('preemptions', 0):.0f}")
        if self.admission:
            s += (f" admitted={self.admission.get('admitted', 0):.0f}"
                  f" rejected={self.admission.get('rejected', 0):.0f}"
                  f" shed={self.admission.get('shed', 0):.0f}")
        if self.deflection:
            refused = sum(v for k, v in self.deflection.items()
                          if k.startswith("refused_"))
            s += (f" deflected="
                  f"{self.deflection.get('requests_deflected', 0):.0f}"
                  f" refused={refused:.0f}")
        if self.sampling:
            s += (f" seed={self.sampling.get('seed', 0):.0f}"
                  f" sampled={self.sampling.get('sampled_requests', 0):.0f}")
        if self.speculation:
            s += (f" spec_emitted={self.speculation.get('emitted', 0):.0f}"
                  f" spec_accept={self.speculation.get('acceptance', 0):.2f}")
        if self.per_tenant:
            s += f" tenants={len(self.per_tenant)}"
        return s

    def tenant_summary(self) -> str:
        """One line per tenant (DESIGN.md §10); tenants with zero finished
        requests render 'n/a' metrics, never crash."""
        def fmt(v, spec=".2f", scale=1.0, suffix=""):
            return "n/a" if v is None else f"{v * scale:{spec}}{suffix}"

        lines = []
        for tid in sorted(self.per_tenant):
            t = self.per_tenant[tid]
            lines.append(
                f"  {tid:<12} tier={t.get('tier', '?'):<11} "
                f"att={fmt(t.get('attainment'))} "
                f"p99_ttft={fmt(t.get('p99_ttft'), '.1f', 1e3, 'ms')} "
                f"p99_tpot={fmt(t.get('p99_tpot'), '.1f', 1e3, 'ms')} "
                f"adm={t.get('admitted', 0):.0f}/{t.get('submitted', 0):.0f} "
                f"rej={t.get('rejected', 0):.0f} "
                f"shed={t.get('shed', 0):.0f} "
                f"credits={t.get('credits', 0.0):.1f}")
        return "\n".join(lines)


class ServingSystem(abc.ABC):
    """Online, streaming serving front-end over a pool of stateless instances.

    Implementations: ``repro.sim.Simulator`` (VirtualClock) and
    ``repro.engine.ArrowEngineCluster`` (WallClock).
    """

    clock: Clock

    @abc.abstractmethod
    def submit(self, req: Request, *, prompt=None, tier: str = "standard",
               tenant_id: Optional[str] = None,
               on_token: Optional[TokenCallback] = None,
               on_finish: Optional[FinishCallback] = None) -> RequestHandle:
        """Register ``req`` to arrive at ``req.arrival`` (system-clock
        seconds). ``prompt`` is the token array for real-compute backends;
        backends that only model timing ignore it, and the engine synthesizes
        a deterministic prompt of ``req.input_len`` tokens when omitted.
        ``tenant_id`` attributes the request to a registered tenant (falls
        back to ``req.tenant_id``, then to the implicit single tenant); when
        the tenant declares an SLO tier it overrides the default ``tier``."""

    @abc.abstractmethod
    def step(self) -> bool:
        """Perform one unit of work. Returns False once fully idle (no queued
        events / no pending or live requests)."""

    @abc.abstractmethod
    def run_until(self, t: float) -> None:
        """Advance the system clock to ``t``, performing all due work."""

    @abc.abstractmethod
    def drain(self, *, timeout: Optional[float] = None) -> ServeReport:
        """Run until every submitted request finished, or ``timeout`` system-
        clock seconds elapsed. Returns the report either way."""

    @abc.abstractmethod
    def report(self) -> ServeReport:
        """Snapshot metrics over everything submitted so far."""


def replay_trace(system: ServingSystem, trace: List[Request], *,
                 tier: str = "standard", time_scale: float = 1.0,
                 on_token: Optional[TokenCallback] = None,
                 on_finish: Optional[FinishCallback] = None,
                 ) -> List[RequestHandle]:
    """Submit fresh copies of ``trace`` through the unified API, so the same
    trace object can replay through several systems (sim-vs-engine runs)
    without sharing mutable Request state. Returns handles in trace order."""
    handles = []
    for r in trace:
        req = Request(rid=r.rid, arrival=r.arrival * time_scale,
                      input_len=r.input_len, output_len=r.output_len,
                      session_id=r.session_id, parent_rid=r.parent_rid,
                      history_len=r.history_len, tenant_id=r.tenant_id,
                      sampling=r.sampling)
        handles.append(system.submit(req, tier=tier, on_token=on_token,
                                     on_finish=on_finish))
    return handles
