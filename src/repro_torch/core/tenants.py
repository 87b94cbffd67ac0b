"""Multi-tenant credit scheduling + overload admission control (DESIGN.md
§10).

Arrow's elastic pools (§6) match *aggregate* capacity to *aggregate* load;
nothing stops one client from flooding ``submit()`` and killing every other
client's p99. This module adds the missing tenancy layer:

  * :class:`Tenant` / :class:`TenantRegistry` — each tenant declares an SLO
    tier (``interactive``/``standard``/``batch``) and a share weight; the
    registry also tracks per-tenant admission counters and an EWMA of SLO
    violations observed at finish/reject time.
  * :class:`CreditLedger` — credits accrue per monitor tick from
    declared-vs-observed SLO attainment (attainment earns, the violation
    EWMA debits) and are spent at admission, priced per requested token.
    Balances are clamped to a weight-scaled burst cap, so saving up cannot
    buy an unbounded flood.
  * :class:`AdmissionController` — a watermark guard over the same Eq.
    (1)/(2) cluster-pressure signals the AutoScaler reads
    (core/autoscaler.py ``prefill_pressure``/``decode_pressure``): below the
    low watermark everything admits (credits are still drained, never
    gated); between the watermarks admission is credit-gated with a bounded
    :class:`RetryQueue` (deadline-aware re-admission through the backend's
    retry event); above the high watermark load is shed *before* elastic
    scale-up saturates — only a tenant whose savings cover a premium gets
    through.
  * Typed :class:`AdmissionDecision` results — :class:`Admitted`,
    :class:`Deferred` (carries ``retry_at``/``deadline``) and
    :class:`Rejected` (carries ``reason`` ∈ {overload, no_credit,
    retry_queue_full, parent_rejected} and a ``retry_after`` hint).

The controller is backend-agnostic: it reads the runtime's pools/policy/
monitor state and never touches KV accounting — a rejected request is
turned away *before* ``place_prefill``/``enqueue_prefill``, which is what
keeps the §8.4 invariant harness (and ``drain()``'s stranded-rid check)
oblivious to rejected rids by construction.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

from repro_torch.core.autoscaler import decode_pressure, prefill_pressure
from repro_torch.core.request import Request, RequestState

DEFAULT_TENANT = "anonymous"

#: per-tier default share weights used by :func:`default_registry` —
#: interactive tenants paid for headroom, batch tenants ride the slack.
TIER_WEIGHTS = {"interactive": 2.0, "standard": 1.0, "batch": 0.5}


@dataclass(frozen=True)
class Tenant:
    """One client of the serving system: a declared SLO tier plus a share
    weight scaling both credit accrual and the WDRR dispatch quantum."""

    tenant_id: str
    tier: str = "standard"
    weight: float = 1.0

    def __post_init__(self):
        from repro_torch.core.serving import TIERS
        if self.tier not in TIERS:
            raise ValueError(f"unknown SLO tier {self.tier!r}; "
                             f"choose from {sorted(TIERS)}")
        if self.weight <= 0:
            raise ValueError(f"tenant weight must be > 0, got {self.weight}")


class EWMA:
    """Exponentially weighted moving average of a 0/1 violation stream."""

    def __init__(self, alpha: float = 0.2, init: float = 0.0):
        self.alpha = alpha
        self.value = init

    def update(self, x: float) -> float:
        self.value += self.alpha * (x - self.value)
        return self.value


@dataclass(frozen=True)
class CreditLedgerConfig:
    """Credit-economy knobs; all rates/caps scale with the tenant weight."""

    earn_rate: float = 2.0     # credits/s at weight 1.0 and zero violations
    debit_rate: float = 4.0    # credits/s drained at violation EWMA = 1.0
    initial: float = 8.0       # starting balance at weight 1.0
    cap: float = 20.0          # burst allowance ceiling at weight 1.0


class CreditLedger:
    """Per-tenant credit balances: accrue on the monitor tick, spend at
    admission. Attainment earns, the violation EWMA debits (declared-vs-
    observed SLO), and balances clamp to ``[0, cap × weight]``."""

    def __init__(self, cfg: Optional[CreditLedgerConfig] = None):
        self.cfg = cfg or CreditLedgerConfig()
        self._balance: Dict[str, float] = {}

    def open(self, tenant: Tenant) -> None:
        self._balance.setdefault(tenant.tenant_id,
                                 self.cfg.initial * tenant.weight)

    def balance(self, tenant_id: str) -> float:
        return self._balance.get(tenant_id, 0.0)

    def accrue(self, tenant: Tenant, violation_ewma: float,
               dt: float) -> float:
        """One monitor tick's worth of accrual: ``(1 - v)`` of the earn rate
        minus ``v`` of the debit rate, weight-scaled and clamped."""
        v = min(max(violation_ewma, 0.0), 1.0)
        delta = dt * tenant.weight * (self.cfg.earn_rate * (1.0 - v)
                                      - self.cfg.debit_rate * v)
        cap = self.cfg.cap * tenant.weight
        bal = min(max(self.balance(tenant.tenant_id) + delta, 0.0), cap)
        self._balance[tenant.tenant_id] = bal
        return bal

    def spend(self, tenant_id: str, cost: float) -> bool:
        """Gated spend: deduct ``cost`` iff the balance covers it."""
        bal = self.balance(tenant_id)
        if bal < cost:
            return False
        self._balance[tenant_id] = bal - cost
        return True

    def drain(self, tenant_id: str, cost: float) -> None:
        """Ungated spend (below the low watermark admission never blocks,
        but the flood still pays): deduct down to the zero floor."""
        self._balance[tenant_id] = max(self.balance(tenant_id) - cost, 0.0)


class TenantRegistry:
    """Tenant roster + ledger + per-tenant admission/SLO observation state.

    Unknown tenant ids auto-register with standard tier and weight 1.0
    (authn/z is out of scope here); use :meth:`register` to declare tiers
    and weights up front."""

    COUNTERS = ("submitted", "admitted", "deferred", "rejected", "shed",
                "finished", "slo_ok")

    def __init__(self, tenants: Iterable[Tenant] = (), *,
                 ledger: Optional[CreditLedger] = None,
                 violation_alpha: float = 0.2):
        self._tenants: "OrderedDict[str, Tenant]" = OrderedDict()
        self.ledger = ledger or CreditLedger()
        self._violation_alpha = violation_alpha
        self._viol: Dict[str, EWMA] = {}
        self.counters: Dict[str, Dict[str, int]] = {}
        self._last_tick: Optional[float] = None
        for t in tenants:
            self.register(t)

    # ------------------------------------------------------------- roster
    def register(self, tenant: Tenant) -> Tenant:
        if tenant.tenant_id in self._tenants:
            raise ValueError(f"tenant {tenant.tenant_id!r} already "
                             f"registered")
        self._tenants[tenant.tenant_id] = tenant
        self.ledger.open(tenant)
        self._viol[tenant.tenant_id] = EWMA(self._violation_alpha)
        self.counters[tenant.tenant_id] = {c: 0 for c in self.COUNTERS}
        return tenant

    def ensure(self, tenant_id: str) -> Tenant:
        t = self._tenants.get(tenant_id)
        if t is None:
            t = self.register(Tenant(tenant_id))
        return t

    def get(self, tenant_id: str) -> Optional[Tenant]:
        return self._tenants.get(tenant_id)

    def ids(self) -> List[str]:
        return list(self._tenants)

    def __contains__(self, tenant_id: str) -> bool:
        return tenant_id in self._tenants

    def __len__(self) -> int:
        return len(self._tenants)

    # -------------------------------------------------------- observation
    def note_submit(self, tenant_id: str) -> None:
        self.ensure(tenant_id)
        self.counters[tenant_id]["submitted"] += 1

    def note_admit(self, tenant_id: str) -> None:
        self.ensure(tenant_id)
        self.counters[tenant_id]["admitted"] += 1

    def note_defer(self, tenant_id: str) -> None:
        self.ensure(tenant_id)
        self.counters[tenant_id]["deferred"] += 1

    def note_reject(self, tenant_id: str, *, shed: bool) -> None:
        self.ensure(tenant_id)
        self.counters[tenant_id]["shed" if shed else "rejected"] += 1
        # a turned-away request is a violation of the declared SLO
        self._viol[tenant_id].update(1.0)

    def note_finish(self, tenant_id: str, met_slo: bool) -> None:
        self.ensure(tenant_id)
        c = self.counters[tenant_id]
        c["finished"] += 1
        c["slo_ok"] += int(met_slo)
        self._viol[tenant_id].update(0.0 if met_slo else 1.0)

    def violation_ewma(self, tenant_id: str) -> float:
        e = self._viol.get(tenant_id)
        return e.value if e is not None else 0.0

    # ------------------------------------------------------------ credits
    def on_tick(self, now: float) -> None:
        """Credit accrual, called from the runtime's monitor tick."""
        if self._last_tick is None:
            self._last_tick = now
            return
        dt = now - self._last_tick
        self._last_tick = now
        if dt <= 0:
            return
        for tid, tenant in self._tenants.items():
            self.ledger.accrue(tenant, self._viol[tid].value, dt)

    def credits(self, tenant_id: str) -> float:
        return self.ledger.balance(tenant_id)


# --------------------------------------------------------------- decisions
@dataclass(frozen=True)
class AdmissionDecision:
    """Base of the typed admission results."""

    tenant_id: str
    pressure: float            # watermark signal at decision time


@dataclass(frozen=True)
class Admitted(AdmissionDecision):
    cost: float = 0.0          # credits charged


@dataclass(frozen=True)
class Deferred(AdmissionDecision):
    """Parked in the RetryQueue; the backend re-delivers at ``retry_at``."""

    retry_at: float = 0.0
    deadline: float = 0.0


@dataclass(frozen=True)
class Rejected(AdmissionDecision):
    """Terminal: the request never enters scheduling or KV accounting.
    ``reason`` ∈ {"overload", "no_credit", "retry_queue_full",
    "parent_rejected"}; ``retry_after`` is the client back-off hint in
    seconds."""

    reason: str = "overload"
    retry_after: float = 1.0


class RetryQueue:
    """Bounded deadline bookkeeping for credit-deferred requests. The
    *events* that re-deliver a deferred request live in the backend (sim
    heap / engine pending heap); this structure only bounds how many rids
    may wait and remembers each one's deadline and attempt count."""

    def __init__(self, maxlen: int = 64):
        self.maxlen = maxlen
        self._entries: "OrderedDict[int, float]" = OrderedDict()  # rid -> ddl
        self.attempts: Dict[int, int] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, rid: int) -> bool:
        return rid in self._entries

    def deadline(self, rid: int) -> Optional[float]:
        return self._entries.get(rid)

    def offer(self, rid: int, deadline: float) -> bool:
        """Admit ``rid`` into the queue (or bump its attempt count when it
        is already waiting). False when the queue is full."""
        if rid in self._entries:
            self.attempts[rid] += 1
            return True
        if len(self._entries) >= self.maxlen:
            return False
        self._entries[rid] = deadline
        self.attempts[rid] = 1
        return True

    def remove(self, rid: int) -> None:
        self._entries.pop(rid, None)
        self.attempts.pop(rid, None)


@dataclass(frozen=True)
class AdmissionConfig:
    """Watermark-guard knobs (see docs/OPERATOR.md §8 for tuning)."""

    low_watermark: float = 0.4     # below: admit everything (credits drain)
    high_watermark: float = 1.2    # above: shed unless savings cover premium
    cost_per_token: float = 1e-4   # credits per requested (in+out) token
    shed_premium: float = 4.0      # cost multiplier to pass the shed gate
    retry_interval: float = 0.25   # seconds between re-admission attempts
    retry_queue_len: int = 64      # bounded RetryQueue size
    deadline_scale: float = 1.0    # deadline = arrival + scale × slo.ttft


class AdmissionController:
    """Watermark guard + credit gate + retry/deadline bookkeeping. One
    ``consider()`` call per delivery of a request into ``dispatch_prefill``;
    the decision is sticky for admitted rids (crash recovery and
    no-ACTIVE-instance re-dispatch must not re-charge)."""

    def __init__(self, runtime, registry: TenantRegistry,
                 cfg: Optional[AdmissionConfig] = None):
        self.runtime = runtime
        self.registry = registry
        self.cfg = cfg or AdmissionConfig()
        self.retry_queue = RetryQueue(self.cfg.retry_queue_len)
        self._status: Dict[int, str] = {}       # rid -> admitted|rejected
        self.stats: Dict[str, int] = {
            "admitted": 0, "deferred": 0, "rejected": 0, "shed": 0,
            "retries": 0}
        self.last_pressure = 0.0

    # ------------------------------------------------------------- signals
    def pressure(self, now: float) -> float:
        """Cluster pressure for the watermark guard: the max of the two
        Eq. (1)/(2) signals the AutoScaler reads (1.0 ≈ at budget; ``inf``
        when a capable set is empty — nothing can take the work)."""
        p = max(prefill_pressure(self.runtime, now),
                decode_pressure(self.runtime))
        self.last_pressure = p
        return p

    def request_cost(self, req: Request) -> float:
        return (req.input_len + req.output_len) * self.cfg.cost_per_token

    def _tenant_of(self, req: Request) -> Tenant:
        return self.registry.ensure(req.tenant_id or DEFAULT_TENANT)

    # ------------------------------------------------------------ decision
    def consider(self, handle, now: float) -> AdmissionDecision:
        req = handle.req
        rid = req.rid
        tenant = self._tenant_of(req)
        tid = tenant.tenant_id
        status = self._status.get(rid)
        if status == "admitted":
            # re-delivery of an already-admitted request (crash recovery,
            # or the no-ACTIVE-instance retry path): never re-charge
            return Admitted(tid, self.last_pressure, cost=0.0)
        ledger = self.registry.ledger
        cost = self.request_cost(req)
        pressure = self.pressure(now)
        deadline = req.arrival + self.cfg.deadline_scale * handle.slo.ttft

        if pressure < self.cfg.low_watermark:
            ledger.drain(tid, cost)
            return self._admit(rid, tid, pressure, cost)

        if pressure >= self.cfg.high_watermark:
            # shed zone: only savings buy entry — reject, never queue
            # (queued work would melt an already-overloaded cluster)
            if ledger.spend(tid, cost * self.cfg.shed_premium):
                return self._admit(rid, tid, pressure, cost)
            return self._reject(rid, tid, pressure, "overload", now,
                                deadline)

        # credit zone: spend or wait (bounded, deadline-aware)
        if ledger.spend(tid, cost):
            return self._admit(rid, tid, pressure, cost)
        if now >= deadline:
            return self._reject(rid, tid, pressure, "no_credit", now,
                                deadline)
        if not self.retry_queue.offer(rid, deadline):
            return self._reject(rid, tid, pressure, "retry_queue_full",
                                now, deadline)
        if self.retry_queue.attempts[rid] > 1:
            self.stats["retries"] += 1
        else:
            self.stats["deferred"] += 1
            self.registry.note_defer(tid)
        retry_at = min(now + self.cfg.retry_interval, deadline)
        return Deferred(tid, pressure, retry_at=retry_at, deadline=deadline)

    # -------------------------------------------------------- transitions
    def _admit(self, rid: int, tid: str, pressure: float,
               cost: float) -> Admitted:
        self._status[rid] = "admitted"
        self.retry_queue.remove(rid)
        self.stats["admitted"] += 1
        self.registry.note_admit(tid)
        return Admitted(tid, pressure, cost=cost)

    def _reject(self, rid: int, tid: str, pressure: float, reason: str,
                now: float, deadline: float) -> Rejected:
        self._status[rid] = "rejected"
        self.retry_queue.remove(rid)
        shed = reason == "overload"
        self.stats["shed" if shed else "rejected"] += 1
        self.registry.note_reject(tid, shed=shed)
        retry_after = max(deadline - now, self.cfg.retry_interval)
        return Rejected(tid, pressure, reason=reason,
                        retry_after=retry_after)

    def cascade(self, handle, now: float) -> Rejected:
        """A multi-turn follow-up whose parent was rejected: the
        conversation cannot continue, so the rejection cascades."""
        req = handle.req
        tenant = self._tenant_of(req)
        deadline = req.arrival + self.cfg.deadline_scale * handle.slo.ttft
        return self._reject(req.rid, tenant.tenant_id, self.last_pressure,
                            "parent_rejected", now, deadline)

    def is_rejected(self, rid: int) -> bool:
        return self._status.get(rid) == "rejected"


def default_registry(n: int, *, flooder: bool = True) -> TenantRegistry:
    """N well-behaved tenants ``t0..t{n-1}`` with tiers cycling through
    interactive/standard/batch (tier-default weights), plus — matching the
    ``tenants`` trace preset — one adversarial ``flood`` tenant declared as
    an ordinary standard-tier client."""
    tiers = ("interactive", "standard", "batch")
    reg = TenantRegistry()
    for i in range(n):
        tier = tiers[i % len(tiers)]
        reg.register(Tenant(f"t{i}", tier=tier, weight=TIER_WEIGHTS[tier]))
    if flooder:
        reg.register(Tenant("flood", tier="standard", weight=1.0))
    return reg


def rejected_state_consistent(handle) -> bool:
    """§8.4-style probe helper for external checkers: a rejected request
    must hold nothing — no placement, no tokens, no KV. (The invariant
    harness applies a stricter version of this check inline.)"""
    req = handle.req
    return (req.state is RequestState.REJECTED
            and req.prefill_instance is None
            and req.decode_instance is None
            and not handle.tokens)
