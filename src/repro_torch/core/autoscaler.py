"""AutoScaler: elastic cluster sizing on top of Arrow's adaptive pools
(DESIGN.md §6).

Arrow's scheduler (core/global_scheduler.py) rebalances a *fixed* set of
stateless instances between the prefill and decode pools. Under diurnal load
or traffic spikes the right pool split still leaves the whole cluster either
over-provisioned or saturated, so this module closes the loop on the
instance *count*: every monitor tick it reads the same Eq. (1)/(2) signals
the scheduler already maintains and decides whether to spawn or retire an
instance, with hysteresis (patience + cooldown) and hard min/max bounds.

Signals (all dimensionless pressures in [0, ∞), 1.0 ≈ "at budget"):

  * prefill pressure — mean predicted prefill-queue drain delay (the
    scheduler's ``prefill_ready_at`` bookkeeping, Eq. 2) over the active
    prefill-capable instances, normalized by the TTFT scheduling budget
    (``ttft_threshold_frac × SLO.ttft`` — the same budget Algorithm 1
    schedules against).
  * decode pressure — total decode running-tokens over the active
    decode-capable instances, normalized by their aggregate Max Running
    Tokens (the §5.3 profiled decode capacity).
  * SLO attainment — fraction of recently finished requests that met their
    (tier-scaled) SLO, from the runtime's sliding finish window. A low
    value escalates scale-up even when instantaneous pressures look fine.

Scale-up picks the pool for the new instance by comparing the two pressures
(the Eq. (1)/(2) decision restated at cluster granularity); scale-down
retires the least-loaded instance of the slacker side and lets the runtime
drain/migrate its residual work (core/runtime.py ``begin_retire``).

The AutoScaler is backend-agnostic: it only talks to the runtime through
``scale_up(pool, now)`` / ``begin_retire(iid, now)`` and reads pools,
monitor and policy state — so the same controller drives the discrete-event
simulator and the real JAX engine.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from repro_torch.core.pools import Pool


def prefill_pressure(runtime, now: float) -> float:
    """Eq. (2) restated as a dimensionless pressure: mean predicted
    prefill-queue drain delay over the prefill-capable instances, normalized
    by the TTFT scheduling budget. ``inf`` when no instance can take
    prefills. Shared by the AutoScaler and the admission watermark guard
    (core/tenants.py)."""
    ids = runtime.pools.prefill_capable()
    if not ids:
        return float("inf")
    budget = max(runtime.sched_cfg.ttft_threshold_frac * runtime.slo.ttft,
                 1e-9)
    ready = getattr(runtime.policy, "prefill_ready_at", {})
    delays = [max(ready.get(i, 0.0) - now, 0.0) for i in ids]
    return (sum(delays) / len(delays)) / budget


def decode_pressure(runtime) -> float:
    """Eq. (1) restated: total decode running-tokens over the aggregate Max
    Running Tokens of the decode-capable instances. ``inf`` when no instance
    can decode."""
    ids = runtime.pools.decode_capable()
    if not ids:
        return float("inf")
    cap = len(ids) * max(runtime.sched_cfg.max_running_tokens, 1)
    running = sum(runtime.monitor.get(i).running_tokens for i in ids)
    return running / cap


@dataclass(frozen=True)
class AutoScalerConfig:
    """Elasticity knobs. Defaults favour stability over reaction speed; see
    docs/OPERATOR.md for tuning guidance."""

    min_instances: int = 2        # never retire below this many ACTIVE
    max_instances: int = 16       # never provision above this many live
    # thresholds on the normalized pressures
    prefill_up: float = 0.75      # prefill pressure triggering scale-up
    decode_up: float = 0.85       # decode utilization triggering scale-up
    down: float = 0.25            # both pressures below this → scale-down
    attainment_floor: float = 0.90   # recent SLO attainment escalating up
    # hysteresis
    up_patience: int = 2          # consecutive breach ticks before growing
    down_patience: int = 8        # consecutive slack ticks before shrinking
    cooldown_s: float = 10.0      # dead time after any scaling action
    # provisioning model
    warmup_s: float = 5.0         # modeled spawn→ready delay (simulator);
    #                               the engine's warm-up is real construction
    min_slo_samples: int = 16     # finishes needed before trusting attainment


@dataclass
class ScaleEvent:
    """One scaling action, for reports/benchmarks."""

    kind: str                     # "up" | "down"
    instance: int
    pool: Pool
    t: float
    reason: str = ""


@dataclass
class ScaleSignals:
    """One tick's observed pressures (kept for observability/tests)."""

    t: float
    prefill_pressure: float
    decode_pressure: float
    attainment: Optional[float]   # None until min_slo_samples finishes seen
    n_live: int
    n_active: int


class AutoScaler:
    """Hysteresis controller over the runtime's instance set."""

    def __init__(self, runtime, cfg: AutoScalerConfig):
        self.runtime = runtime        # RuntimeCore (pools/monitor/policy/...)
        self.cfg = cfg
        self.events: List[ScaleEvent] = []
        self.last_signals: Optional[ScaleSignals] = None
        self._up_streak = 0
        self._down_streak = 0
        self._cooldown_until = 0.0

    # ------------------------------------------------------------- signals
    def _prefill_pressure(self, now: float) -> float:
        return prefill_pressure(self.runtime, now)

    def _decode_pressure(self) -> float:
        return decode_pressure(self.runtime)

    def signals(self, now: float) -> ScaleSignals:
        rt = self.runtime
        return ScaleSignals(
            t=now,
            prefill_pressure=self._prefill_pressure(now),
            decode_pressure=self._decode_pressure(),
            attainment=rt.recent_attainment(self.cfg.min_slo_samples),
            # failed corpses awaiting removal are not capacity (§8)
            n_live=len(rt.pools.all_ids()) - len(rt.pools.failed_ids()),
            n_active=len(rt.pools.active_ids()),
        )

    # ------------------------------------------------------------ decision
    def on_monitor_tick(self, now: float) -> None:
        cfg = self.cfg
        sig = self.signals(now)
        self.last_signals = sig

        slo_bad = sig.attainment is not None and \
            sig.attainment < cfg.attainment_floor
        want_up = (sig.prefill_pressure > cfg.prefill_up
                   or sig.decode_pressure > cfg.decode_up
                   or slo_bad)
        want_down = (sig.prefill_pressure < cfg.down
                     and sig.decode_pressure < cfg.down
                     and not slo_bad)
        self._up_streak = self._up_streak + 1 if want_up else 0
        self._down_streak = self._down_streak + 1 if want_down else 0

        if now < self._cooldown_until:
            return
        # n_live counts warming instances: capacity already on its way up
        # must damp further scale-ups (classic thundering-herd guard).
        # Quarantined (DEGRADED, §14) instances are not serving capacity —
        # provisioning around a sick instance must not be blocked by its
        # headcount.
        if self._up_streak >= cfg.up_patience and \
                sig.n_live - len(self.runtime.pools.retiring_ids()) \
                - len(self.runtime.pools.degraded_ids()) < \
                cfg.max_instances:
            self._scale_up(now, sig)
        elif self._down_streak >= cfg.down_patience and \
                sig.n_active > cfg.min_instances:
            self._scale_down(now, sig)

    # ----------------------------------------------------- fault path (§8)
    def on_instance_failed(self, iid: int, pool: Pool,
                           now: float) -> Optional[int]:
        """A crash removed capacity outright: spawn a replacement into the
        dead instance's pool, bypassing patience (the signal is unambiguous)
        but respecting ``max_instances``. Returns the new iid, or None when
        the ceiling blocks the replacement."""
        rt = self.runtime
        live = len(rt.pools.all_ids()) - len(rt.pools.failed_ids()) \
            - len(rt.pools.retiring_ids())
        if live >= self.cfg.max_instances:
            return None
        new = rt.scale_up(pool, now)
        self.events.append(ScaleEvent("up", new, pool, now,
                                      reason=f"replace failed {iid}"))
        self._after_action(now)
        return new

    # ------------------------------------------------------------- actions
    def _scale_up(self, now: float, sig: ScaleSignals) -> None:
        # Eq. (1)/(2) at cluster granularity: grow the side whose normalized
        # pressure is higher (ties go to prefill — it leads decode, Insight 5).
        pp = sig.prefill_pressure / max(self.cfg.prefill_up, 1e-9)
        dp = sig.decode_pressure / max(self.cfg.decode_up, 1e-9)
        pool = Pool.PREFILL if pp >= dp else Pool.DECODE
        iid = self.runtime.scale_up(pool, now)
        self.events.append(ScaleEvent(
            "up", iid, pool, now,
            reason=f"pp={sig.prefill_pressure:.2f} "
                   f"dp={sig.decode_pressure:.2f} "
                   f"att={'n/a' if sig.attainment is None else f'{sig.attainment:.2f}'}"))
        self._after_action(now)

    def _pick_retire_candidate(self, sig: ScaleSignals) -> Optional[int]:
        """Least-loaded ACTIVE instance of the slacker side, respecting the
        policy's min pool sizes (never strand a side)."""
        rt = self.runtime
        cands = []
        if rt.pools.count(Pool.DECODE, Pool.P2D) > \
                max(1, rt.sched_cfg.min_decode_instances) and \
                sig.decode_pressure <= sig.prefill_pressure:
            ids = rt.pools.decode_capable()     # DECODE ∪ P2D, like the gate
            cands = [(rt.monitor.get(i).running_tokens, i) for i in ids]
        if not cands and rt.pools.count(Pool.PREFILL, Pool.D2P) > \
                max(1, rt.sched_cfg.min_prefill_instances):
            ids = rt.pools.prefill_capable()    # PREFILL ∪ D2P, like the gate
            cands = [(rt.monitor.get(i).prefill_backlog_tokens, i)
                     for i in ids]
        if not cands:
            return None
        return min(cands)[1]

    def _scale_down(self, now: float, sig: ScaleSignals) -> None:
        iid = self._pick_retire_candidate(sig)
        if iid is None:
            return
        pool = self.runtime.pools.pool_of(iid)
        self.runtime.begin_retire(iid, now)
        self.events.append(ScaleEvent(
            "down", iid, pool, now,
            reason=f"pp={sig.prefill_pressure:.2f} "
                   f"dp={sig.decode_pressure:.2f}"))
        self._after_action(now)

    def _after_action(self, now: float) -> None:
        self._up_streak = 0
        self._down_streak = 0
        self._cooldown_until = now + self.cfg.cooldown_s

    # ------------------------------------------------------------ reporting
    @property
    def n_scale_ups(self) -> int:
        return sum(1 for e in self.events if e.kind == "up")

    @property
    def n_scale_downs(self) -> int:
        return sum(1 for e in self.events if e.kind == "down")
