"""Arrow global scheduler — Algorithms 1–4 of the paper plus the §5.5
SLO-aware instance-scheduling triggers and the overload (decode-priority)
guard. Engine-agnostic: drives any cluster exposing the ClusterView protocol
(the discrete-event simulator and the real JAX engine both do).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Protocol

from repro_torch.core.monitor import InstanceMonitor
from repro_torch.core.pools import InstancePools, Pool
from repro_torch.core.prefix_index import PrefixHit
from repro_torch.core.request import Request
from repro_torch.core.slo import SLO, SchedulerConfig
from repro_torch.core.ttft_predictor import TTFTPredictor


class NoSchedulableInstance(RuntimeError):
    """No ACTIVE instance can accept the request's phase right now (every
    instance is WARMING or RETIRING). The runtime queues the request and
    retries when an instance activates (core/runtime.py) instead of
    crashing."""

    def __init__(self, phase: str, pools: InstancePools):
        super().__init__(
            f"no ACTIVE instance to schedule {phase} on: "
            f"{len(pools.warming_ids())} warming, "
            f"{len(pools.retiring_ids())} retiring, "
            f"{len(pools.failed_ids())} failed, 0 active")


class ClusterView(Protocol):
    """What the global scheduler needs to see of the cluster."""

    def has_pending_prefill(self, iid: int) -> bool: ...
    def has_pending_decode(self, iid: int) -> bool: ...


@dataclass
class ScheduleOutcome:
    instance: int
    flipped: Optional[int] = None      # instance moved between pools, if any
    predicted_ttft: Optional[float] = None
    via_fallback: bool = False
    prefix_hit: Optional[PrefixHit] = None   # cached-prefix reuse chosen (§7)
    deflected: bool = False            # prefill routed onto a decode host (§11)


@dataclass(frozen=True)
class DeflectionConfig:
    """Cross-pool prefill deflection knobs (DESIGN.md §11).

    ratio        fraction of the victim's mixed-chunk budget a deflected
                 prefill may consume per fused step (0 disables deflection;
                 the local schedulers enforce it via a deficit counter).
    watermark    Eq.(1) normalized prefill-pool pressure above which
                 deflection activates. Kept below AutoScalerConfig.prefill_up
                 (0.75) so deflection soaks a spike in milliseconds while a
                 sustained breach still reaches the autoscaler.
    step_budget  assumed victim mixed-chunk budget for the interference
                 model (tokens per fused step).
    idle_pickup  symmetric direction: idle PREFILL-pool instances accept
                 decode work instead of forcing a P→D flip.
    """
    ratio: float = 0.25
    watermark: float = 0.60
    step_budget: int = 2048
    idle_pickup: bool = True


class DeflectionPolicy:
    """Interference-charged prefill deflection onto decode instances.

    When the prefill pool's Eq.(1) pressure exceeds the watermark, bounded
    prefill chunks are routed onto pure-DECODE instances. The victim is
    charged the predicted interference through the same Eq.(1)/(2)
    bookkeeping used for native prefill, and deflection is *refused*
    whenever the predictors say it would break either pool's SLO budget.
    Refusals are counted by reason so reports can explain why a spike was
    not absorbed.
    """

    REFUSALS = ("below_watermark", "no_victim", "tpot_budget",
                "kv_headroom", "victim_backlog")

    def __init__(self, cfg: DeflectionConfig):
        self.cfg = cfg
        self.stats: Dict[str, float] = {
            "requests_deflected": 0,
            "tokens_deflected": 0,
            "decode_pickups": 0,
            "interference_s": 0.0,
        }
        for r in self.REFUSALS:
            self.stats["refused_" + r] = 0

    def per_step_tokens(self) -> int:
        """Max deflected prefill tokens per fused step on the victim."""
        return max(1, int(self.cfg.ratio * self.cfg.step_budget))

    def _refuse(self, reason: str) -> None:
        self.stats["refused_" + reason] += 1

    # ------------------------------------------- prefill → decode victims
    def try_deflect(self, sched: "GlobalScheduler", req: Request, now: float,
                    ttft_budget: float) -> Optional[ScheduleOutcome]:
        """Place req's prefill on a pure-DECODE instance, or refuse."""
        if self.cfg.ratio <= 0:
            return None
        if sched.prefill_pool_pressure(now) <= self.cfg.watermark:
            self._refuse("below_watermark")
            return None
        victims = sched.pools.members(Pool.DECODE)
        if not victims:
            self._refuse("no_victim")
            return None
        per_step = self.per_step_tokens()
        n_steps = -(-req.input_len // per_step)      # ceil
        tpot_budget = sched.cfg.tpot_threshold_frac * sched.slo.tpot
        # Most-preferred victim first: least Eq.(2) backlog, then lightest.
        order = sorted(victims, key=lambda i: (
            sched._prefill_delay(i, now),
            sched.monitor.get(i).running_tokens))
        reason = None
        for v in order:
            s = sched.monitor.get(v)
            chunk_t = sched._predict_chunk(v, 0, per_step)
            # TPOT guard: every victim step stretches by one deflected
            # chunk; the stretched interval must stay inside the budget.
            if s.avg_token_interval + chunk_t > tpot_budget:
                reason = reason or "tpot_budget"
                continue
            if s.running_tokens + req.input_len > sched.cfg.max_running_tokens:
                reason = reason or "kv_headroom"
                continue
            # TTFT of the deflected request: one chunk lands per victim
            # step, so the drain takes n_steps stretched intervals on top
            # of any deflected backlog already charged to the victim.
            drain = n_steps * (s.avg_token_interval + chunk_t)
            if sched._prefill_delay(v, now) + drain > ttft_budget:
                reason = reason or "victim_backlog"
                continue
            ttft = sched.account_prefill_dispatch(v, now, drain)
            self.stats["requests_deflected"] += 1
            self.stats["tokens_deflected"] += req.input_len
            self.stats["interference_s"] += n_steps * chunk_t
            return ScheduleOutcome(v, predicted_ttft=ttft, deflected=True)
        self._refuse(reason or "no_victim")
        return None

    # ------------------------------------------- decode → idle prefillers
    def try_pickup(self, sched: "GlobalScheduler", req: Request,
                   now: float) -> Optional[int]:
        """Symmetric slack pickup: an idle PREFILL-pool instance hosts the
        decode phase instead of forcing a P→D flip. No pool state changes —
        decode work on an ACTIVE prefill instance is already legal (the
        Alg. 2 last-resort path does the same)."""
        if not self.cfg.idle_pickup or self.cfg.ratio <= 0:
            return None
        cands = [i for i in sched.pools.members(Pool.PREFILL)
                 if not sched.cluster.has_pending_prefill(i)
                 and sched._prefill_delay(i, now) <= 0.0
                 and sched.monitor.get(i).running_tokens + req.input_len
                 <= sched.cfg.max_running_tokens]
        if not cands:
            return None
        pick, _ = sched._min_running_tokens(cands)
        self.stats["decode_pickups"] += 1
        return pick


class GlobalScheduler:
    """SLO-aware request + instance scheduling over elastic pools."""

    def __init__(self, pools: InstancePools, monitor: InstanceMonitor,
                 predictor: TTFTPredictor, slo: SLO,
                 cfg: SchedulerConfig, cluster: ClusterView):
        self.pools = pools
        self.monitor = monitor
        self.predictor = predictor
        self.slo = slo
        self.cfg = cfg
        self.cluster = cluster
        # Eq. (1)/(2) bookkeeping: predicted prefill drain time per instance.
        # The global scheduler dispatches every prefill, so it can maintain
        # e_i exactly (Insight 1) instead of waiting for monitor scrapes.
        self.prefill_ready_at: Dict[int, float] = {
            iid: 0.0 for iid in pools.all_ids()}
        # counters for the ablation/e2e reports
        self.n_d2p_flips = 0
        self.n_p2d_flips = 0
        # cross-pool deflection (DESIGN.md §11); armed by the runtime when
        # the policy is deflective, None otherwise.
        self.deflection: Optional[DeflectionPolicy] = None
        # beyond-paper proactive burst detector state
        self._arrivals: list = []          # (t, input_len) ring
        self.n_proactive_flips = 0

    # ----------------------------------- elastic lifecycle (DESIGN.md §6)
    def on_instance_added(self, iid: int) -> None:
        """A new instance joined the cluster: start its Eq.(2) bookkeeping."""
        self.prefill_ready_at.setdefault(iid, 0.0)

    def on_instance_removed(self, iid: int) -> None:
        self.prefill_ready_at.pop(iid, None)

    # ------------------------------------------------------------- helpers
    def _predict(self, iid: int, input_len: int) -> float:
        """Instance-aware prefill-time prediction (heterogeneous clusters use
        PerInstancePredictor — paper §8; homogeneous predictors ignore iid)."""
        p = self.predictor
        if hasattr(p, "for_instance"):
            return p.for_instance(iid).predict(input_len)
        return p.predict(input_len)

    def _predict_chunk(self, iid: int, start: int, length: int) -> float:
        """Suffix-prefill prediction for prefix reuse (§7): the chunk cost is
        the difference of the cumulative quadratic."""
        p = self.predictor
        if hasattr(p, "for_instance"):
            return p.for_instance(iid).predict_chunk(start, length)
        return p.predict_chunk(start, length)

    def _prefill_delay(self, iid: int, now: float) -> float:
        return max(self.prefill_ready_at[iid] - now, 0.0)

    def _min_prefill_delay(self, ids, now):
        best, best_d = None, None
        for iid in ids:
            d = self._prefill_delay(iid, now)
            if best_d is None or d < best_d:
                best, best_d = iid, d
        return best, best_d

    def _min_running_tokens(self, ids):
        best, best_t = None, None
        for iid in ids:
            t = self.monitor.get(iid).running_tokens
            if best_t is None or t < best_t:
                best, best_t = iid, t
        return best, best_t

    def prefill_pool_pressure(self, now: float) -> float:
        """Eq.(1) pressure of the prefill pool, normalized by the TTFT
        budget: mean predicted queueing delay across prefill-capable
        instances over ttft_threshold_frac * SLO_ttft. Mirrors
        autoscaler.prefill_pressure but needs only the scheduler's own
        Eq.(2) state (usable from unit tests without a runtime)."""
        ids = self.pools.prefill_capable()
        if not ids:
            return float("inf")
        delay = sum(self._prefill_delay(i, now) for i in ids) / len(ids)
        return delay / (self.cfg.ttft_threshold_frac * self.slo.ttft)

    def _decode_load_low(self) -> bool:
        """Overload guard (§5.5): decode has priority; only pull decode
        instances into prefill when decode load is comfortably low."""
        ids = self.pools.decode_capable()
        if not ids:
            return True
        for iid in ids:
            s = self.monitor.get(iid)
            if s.running_tokens > self.cfg.decode_low_load_frac * self.cfg.max_running_tokens:
                return False
            if s.avg_token_interval > self.cfg.tpot_threshold_frac * self.slo.tpot:
                return False
        return True

    def account_prefill_dispatch(self, iid: int, now: float,
                                 prefill_time: float) -> float:
        """e_i = max(e_{i-1}, a_i) + p_i  (Eq. 2). Returns predicted TTFT."""
        start = max(self.prefill_ready_at[iid], now)
        self.prefill_ready_at[iid] = start + prefill_time
        return self.prefill_ready_at[iid] - now

    # ------------------------------------------------- Algorithm 3 (D → P)
    def try_move_decode_to_prefill(self) -> Optional[int]:
        n_decoders = self.pools.count(Pool.DECODE, Pool.P2D)
        if n_decoders <= max(1, self.cfg.min_decode_instances):
            return None
        p2d = self.pools.members(Pool.P2D)
        pick, _ = self._min_running_tokens(p2d if p2d else
                                           self.pools.members(Pool.DECODE))
        if pick is None:
            return None
        self.pools.flip_to_prefill(pick, self.cluster.has_pending_decode(pick))
        self.n_d2p_flips += 1
        return pick

    # ------------------------------------------------- Algorithm 4 (P → D)
    def try_move_prefill_to_decode(self, now: float = 0.0) -> Optional[int]:
        n_prefillers = self.pools.count(Pool.PREFILL, Pool.D2P)
        if n_prefillers <= max(1, self.cfg.min_prefill_instances):
            return None
        d2p = self.pools.members(Pool.D2P)
        pick, _ = self._min_prefill_delay(
            d2p if d2p else self.pools.members(Pool.PREFILL), now)
        if pick is None:
            return None
        self.pools.flip_to_decode(pick, self.cluster.has_pending_prefill(pick))
        self.n_p2d_flips += 1
        return pick

    # ------------------------------------- prefix-affinity candidate (§7)
    def _best_prefix_option(self, req: Request, now: float,
                            prefix_hits: Optional[List[PrefixHit]]
                            ) -> Optional[tuple]:
        """Best admissible cached-prefix holder: ACTIVE, and — when it is on
        decode duty — only if its decode load is comfortably low (the Alg. 1
        overload guard applied per-instance). Returns (predicted_ttft,
        suffix_prefill_time, hit) minimizing predicted TTFT."""
        best = None
        for h in prefix_hits or []:
            cached = min(h.cached_len, req.input_len - 1)
            if cached <= 0 or not self.pools.is_schedulable(h.iid):
                continue
            if self.pools.pool_of(h.iid) in (Pool.DECODE, Pool.P2D):
                s = self.monitor.get(h.iid)
                if s.running_tokens > self.cfg.decode_low_load_frac * \
                        self.cfg.max_running_tokens:
                    continue
            suffix = self._predict_chunk(h.iid, cached, req.input_len - cached)
            t_h = self._prefill_delay(h.iid, now) + suffix
            if best is None or t_h < best[0]:
                best = (t_h, suffix, PrefixHit(h.iid, h.rid, cached))
        return best

    # ------------------------------------------------- Algorithm 1 (prefill)
    def schedule_prefill(self, req: Request, now: float,
                         prefix_hits: Optional[List[PrefixHit]] = None
                         ) -> ScheduleOutcome:
        ttft_budget = self.cfg.ttft_threshold_frac * self.slo.ttft
        if self.cfg.proactive:
            self._arrivals.append((now, req.input_len))

        t1, d1 = self._min_prefill_delay(self.pools.members(Pool.PREFILL), now)

        # Prefix-affinity shortcut (§7, generalizing the Alg. 2 keep-local
        # rule to prefill): route to the instance holding the longest cached
        # prefix when its predicted *suffix* TTFT is within budget and beats
        # the best cold prefill-pool candidate. Eq. (2) stays exact: the
        # holder is charged only the uncached suffix.
        opt = self._best_prefix_option(req, now, prefix_hits)
        if opt is not None:
            t_h, suffix, hit = opt
            cold1 = None if t1 is None else \
                d1 + self._predict(t1, req.input_len)
            if t_h <= ttft_budget and (cold1 is None or t_h <= cold1):
                ttft = self.account_prefill_dispatch(hit.iid, now, suffix)
                return ScheduleOutcome(hit.iid, predicted_ttft=ttft,
                                       prefix_hit=hit)

        if t1 is not None and d1 + self._predict(t1, req.input_len) <= ttft_budget:
            ttft = self.account_prefill_dispatch(
                t1, now, self._predict(t1, req.input_len))
            return ScheduleOutcome(t1, predicted_ttft=ttft)

        t2, d2 = self._min_prefill_delay(self.pools.members(Pool.D2P), now)
        if t2 is not None and d2 + self._predict(t2, req.input_len) <= ttft_budget:
            ttft = self.account_prefill_dispatch(
                t2, now, self._predict(t2, req.input_len))
            return ScheduleOutcome(t2, predicted_ttft=ttft)

        # §11 deflection: before flipping a whole instance, try to absorb
        # the prefill as bounded chunks on a decode victim. Cheaper than a
        # flip (no drain, no pool change) and refused whenever the Eq.(1)/(2)
        # predictors say it would break either pool's budget.
        if self.deflection is not None:
            out = self.deflection.try_deflect(self, req, now, ttft_budget)
            if out is not None:
                return out

        flipped = None
        if self._decode_load_low():
            t3 = self.try_move_decode_to_prefill()
            if t3 is not None:
                flipped = t3
                ttft = self.account_prefill_dispatch(
                    t3, now, self._predict(t3, req.input_len))
                return ScheduleOutcome(t3, flipped=flipped, predicted_ttft=ttft)

        # fall back to t1 (or t2 / any ACTIVE instance — never a warming or
        # retiring one). When *no* ACTIVE instance exists the request is not
        # placeable: raise a descriptive error instead of the bare
        # IndexError active_ids()[0] used to produce — the runtime queues
        # the request and retries on the next activation.
        fb = t1 if t1 is not None else t2
        if fb is None:
            active = self.pools.active_ids()
            if not active:
                raise NoSchedulableInstance("prefill", self.pools)
            fb = active[0]
        ttft = self.account_prefill_dispatch(
            fb, now, self._predict(fb, req.input_len))
        return ScheduleOutcome(fb, predicted_ttft=ttft, via_fallback=True)

    # ------------------------------------------------- Algorithm 2 (decode)
    def schedule_decode(self, req: Request, now: float) -> ScheduleOutcome:
        # If the prefill instance has itself been flipped to decode duty,
        # keep the request there: the KV cache transfer vanishes. (Not when
        # it is retiring — a retiring instance accepts no new decode work.)
        pi = req.prefill_instance
        if pi is not None and self.pools.is_schedulable(pi) and \
                self.pools.pool_of(pi) in (Pool.DECODE, Pool.P2D):
            return ScheduleOutcome(pi)

        max_rt = self.cfg.max_running_tokens
        tpot_budget = self.cfg.tpot_threshold_frac * self.slo.tpot

        t1, rt1 = self._min_running_tokens(self.pools.members(Pool.DECODE))
        if t1 is not None and rt1 + req.input_len <= max_rt and \
                self.monitor.get(t1).avg_token_interval <= tpot_budget:
            return ScheduleOutcome(t1)

        t2, rt2 = self._min_running_tokens(self.pools.members(Pool.P2D))
        if t2 is not None and rt2 + req.input_len <= max_rt and \
                self.monitor.get(t2).avg_token_interval <= tpot_budget:
            return ScheduleOutcome(t2)

        # §11 symmetric pickup: an idle prefill instance hosts the decode
        # phase instead of flipping one out of the prefill pool.
        if self.deflection is not None:
            pick = self.deflection.try_pickup(self, req, now)
            if pick is not None:
                return ScheduleOutcome(pick)

        t3 = self.try_move_prefill_to_decode(now)
        if t3 is not None:
            return ScheduleOutcome(t3, flipped=t3)

        # fallback: lighter of t1/t2
        if t1 is not None and (t2 is None or rt1 <= rt2):
            return ScheduleOutcome(t1, via_fallback=True)
        if t2 is not None:
            return ScheduleOutcome(t2, via_fallback=True)
        # last resort: both decode pools empty and no flip allowed. Pick the
        # least-loaded decode-capable instance — never an arbitrary id, which
        # could be a pure-PREFILL instance with no decode duty at all.
        ids = self.pools.decode_capable() or self.pools.active_ids()
        if not ids:
            raise NoSchedulableInstance("decode", self.pools)
        pick, _ = self._min_running_tokens(ids)
        return ScheduleOutcome(pick, via_fallback=True)

    # ----------------------------------------- beyond-paper: proactive flip
    def _proactive_check(self, now: float) -> None:
        w = self.cfg.proactive_window_s
        horizon = now - 10 * w
        self._arrivals = [(t, n) for t, n in self._arrivals if t >= horizon]
        if len(self._arrivals) < 8:
            return
        short = sum(n for t, n in self._arrivals if t >= now - w) / w
        long = sum(n for t, n in self._arrivals) / (10 * w)
        if long > 0 and short > self.cfg.proactive_ratio * long and \
                self._decode_load_low():
            if self.try_move_decode_to_prefill() is not None:
                self.n_proactive_flips += 1

    # --------------------------------------------- §5.5 monitor-driven flips
    def on_monitor_tick(self, now: float) -> None:
        if self.cfg.proactive:
            self._proactive_check(now)
        # (2) sustained TPOT breach on decode side -> add decode capacity.
        # Only *pure* DECODE-pool instances vote: P→D members still draining
        # prefill chunks are expected to show long intervals transiently.
        ids = self.pools.decode_capable()
        pure = self.pools.members(Pool.DECODE)
        if pure:
            breach = [i for i in pure
                      if self.monitor.get(i).avg_token_interval >
                      self.cfg.tpot_threshold_frac * self.slo.tpot]
            if len(breach) * 2 >= len(pure) and breach:
                self.try_move_prefill_to_decode(now)
        # (3) idle prefill + busy decode -> free resources toward decode
        if self.cfg.idle_prefill_flip:
            busy = any(
                self.monitor.get(i).running_tokens >
                self.cfg.decode_low_load_frac * self.cfg.max_running_tokens
                or self.monitor.get(i).avg_token_interval >
                0.6 * self.cfg.tpot_threshold_frac * self.slo.tpot
                for i in pure) if pure else False
            if busy:
                for iid in self.pools.members(Pool.PREFILL):
                    if self.pools.count(Pool.PREFILL, Pool.D2P) <= \
                            self.cfg.min_prefill_instances:
                        break
                    if not self.cluster.has_pending_prefill(iid) and \
                            self._prefill_delay(iid, now) <= 0.0:
                        self.pools.flip_to_decode(iid, False)
                        self.n_p2d_flips += 1
        # pool-drain transitions (black edges of Fig. 5)
        for iid in self.pools.members(Pool.P2D):
            if not self.cluster.has_pending_prefill(iid):
                self.pools.on_prefill_drained(iid)
        for iid in self.pools.members(Pool.D2P):
            if not self.cluster.has_pending_decode(iid):
                self.pools.on_decode_drained(iid)
