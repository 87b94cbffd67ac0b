"""Scheduling policies: Arrow (the paper) + the evaluation baselines
(§7: vLLM-colocated, static PD-disaggregation, and the §7.3 ablations
Minimal-Load and Round-Robin).

Backend-agnostic: policies see only pools/monitor/predictor/ClusterView, so
the same ``POLICIES`` registry drives the discrete-event simulator and the
real JAX engine through the shared runtime (core/runtime.py).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core.global_scheduler import (GlobalScheduler,  # noqa: F401
                                         NoSchedulableInstance,
                                         ScheduleOutcome)
from repro_torch.core.monitor import InstanceMonitor
from repro_torch.core.pools import InstancePools, Pool
from repro_torch.core.request import Request
from repro_torch.core.slo import SLO, SchedulerConfig
from repro_torch.core.ttft_predictor import TTFTPredictor


class BasePolicy:
    """Shared Eq.(1)/(2) prefill-queue bookkeeping."""

    name = "base"
    adaptive = False
    elastic = False          # True: RuntimeCore attaches an AutoScaler (§6)
    deflective = False       # True: RuntimeCore arms DeflectionPolicy (§11)

    def __init__(self, pools: InstancePools, monitor: InstanceMonitor,
                 predictor: TTFTPredictor, slo: SLO, cfg: SchedulerConfig,
                 cluster):
        self.pools = pools
        self.monitor = monitor
        self.predictor = predictor
        self.slo = slo
        self.cfg = cfg
        self.cluster = cluster
        self.prefill_ready_at: Dict[int, float] = {
            i: 0.0 for i in pools.all_ids()}

    # elastic lifecycle (DESIGN.md §6): keep per-instance bookkeeping in sync
    def on_instance_added(self, iid: int) -> None:
        self.prefill_ready_at.setdefault(iid, 0.0)

    def on_instance_removed(self, iid: int) -> None:
        self.prefill_ready_at.pop(iid, None)

    def _account(self, iid: int, now: float, input_len: int) -> None:
        start = max(self.prefill_ready_at[iid], now)
        self.prefill_ready_at[iid] = start + self.predictor.predict(input_len)

    def _require(self, ids, phase: str):
        """Baselines share arrow's contract under elasticity/faults: an
        empty candidate set raises NoSchedulableInstance (the runtime queues
        and retries on activation) instead of a bare min()/index crash."""
        if not ids:
            raise NoSchedulableInstance(phase, self.pools)
        return ids

    def _min_ready(self, ids, now):
        return min(ids, key=lambda i: max(self.prefill_ready_at[i] - now, 0.0))

    def _min_tokens(self, ids):
        return min(ids, key=lambda i: self.monitor.get(i).running_tokens)

    def place_prefill(self, req: Request, now: float, prefix_hits=None):
        """Prefill placement entry point used by the runtime. Baselines do
        not route by prefix affinity, but when their own choice happens to
        land on an instance that already caches a prefix of ``req`` the
        reuse is still taken (the KV is right there). Returns
        ``(iid, PrefixHit | None, deflected)``."""
        iid = self.schedule_prefill_req(req, now)
        hit = next((h for h in (prefix_hits or []) if h.iid == iid), None)
        return iid, hit, False

    def on_monitor_tick(self, now: float) -> None:
        pass


class ArrowPolicy(GlobalScheduler):
    """The paper's SLO-aware adaptive policy (GlobalScheduler as-is)."""

    name = "arrow"
    adaptive = True

    def schedule_prefill_req(self, req: Request, now: float) -> int:
        return self.schedule_prefill(req, now).instance

    def schedule_decode_req(self, req: Request, now: float) -> int:
        return self.schedule_decode(req, now).instance

    def place_prefill(self, req: Request, now: float, prefix_hits=None):
        """Arrow routes by prefix affinity (§7): Algorithm 1 considers the
        cached-prefix holder first and charges Eq. (2) only the suffix.
        Reuse is taken *only* when the affinity shortcut chose it — when
        the normal path happens to land on a holder it was charged the
        full prefill, and taking the reuse anyway would leave
        ``prefill_ready_at`` overestimating by the cached-prefix time."""
        out = self.schedule_prefill(req, now, prefix_hits=prefix_hits)
        return out.instance, out.prefix_hit, out.deflected


class ArrowElasticPolicy(ArrowPolicy):
    """Arrow request/instance scheduling + AutoScaler-driven cluster sizing:
    the instance *set* grows under sustained pressure and shrinks when slack
    (DESIGN.md §6). Request-level decisions are identical to ``arrow``."""

    name = "arrow_elastic"
    elastic = True


class ArrowDeflectPolicy(ArrowElasticPolicy):
    """arrow_elastic + cross-pool prefill deflection (DESIGN.md §11): under
    Eq.(1) prefill-pool pressure, decode instances absorb bounded prefill
    chunks in-step (and idle prefill instances pick up decode slack) while
    the autoscaler still converges pool counts for sustained shifts. The
    runtime arms ``GlobalScheduler.deflection`` with a DeflectionConfig."""

    name = "arrow_deflect"
    deflective = True


class MinimalLoadPolicy(BasePolicy):
    """§7.3 'Minimal Load': min-load request scheduling, static pools.
    Also stands in for vLLM-disaggregated / DistServe-style static PD
    deployments (configure the PD ratio via InstancePools)."""

    name = "minimal_load"

    def schedule_prefill_req(self, req: Request, now: float) -> int:
        ids = self._require(self.pools.members(Pool.PREFILL)
                            or self.pools.prefill_capable()
                            or self.pools.active_ids(), "prefill")
        iid = self._min_ready(ids, now)
        self._account(iid, now, req.input_len)
        return iid

    def schedule_decode_req(self, req: Request, now: float) -> int:
        ids = self._require(self.pools.members(Pool.DECODE)
                            or self.pools.decode_capable()
                            or self.pools.active_ids(), "decode")
        return self._min_tokens(ids)


class RoundRobinPolicy(BasePolicy):
    """§7.3 'Round Robin'."""

    name = "round_robin"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._p_idx = 0
        self._d_idx = 0

    def schedule_prefill_req(self, req: Request, now: float) -> int:
        ids = sorted(self._require(self.pools.members(Pool.PREFILL)
                                   or self.pools.active_ids(), "prefill"))
        iid = ids[self._p_idx % len(ids)]
        self._p_idx += 1
        self._account(iid, now, req.input_len)
        return iid

    def schedule_decode_req(self, req: Request, now: float) -> int:
        ids = sorted(self._require(self.pools.members(Pool.DECODE)
                                   or self.pools.active_ids(), "decode"))
        iid = ids[self._d_idx % len(ids)]
        self._d_idx += 1
        return iid


class ColocatedPolicy(BasePolicy):
    """vLLM-style PD-colocated serving: every instance runs chunked prefill +
    decode-prioritized continuous batching; a request decodes where it
    prefilled (no KV transfer ever)."""

    name = "colocated"

    def schedule_prefill_req(self, req: Request, now: float) -> int:
        # ACTIVE only: a colocated cluster under faults (§8) must not place
        # work on a crashed instance
        ids = self._require(self.pools.active_ids(), "prefill")
        # least-loaded by combined queue: predicted prefill drain + decode load
        def load(i):
            s = self.monitor.get(i)
            return (max(self.prefill_ready_at[i] - now, 0.0)
                    + s.running_tokens * self.slo.tpot / 4096.0)
        iid = min(ids, key=load)
        self._account(iid, now, req.input_len)
        return iid

    def schedule_decode_req(self, req: Request, now: float) -> int:
        pi = req.prefill_instance
        if self.pools.is_schedulable(pi):
            return pi
        # the prefill instance crashed between o_1 and placement: fall back
        # to the least-loaded live instance instead of decoding on a corpse
        return self._min_tokens(self._require(self.pools.active_ids(),
                                              "decode"))


POLICIES = {
    "arrow": ArrowPolicy,
    "arrow_proactive": ArrowPolicy,    # + SchedulerConfig.proactive=True
    "arrow_elastic": ArrowElasticPolicy,
    "arrow_deflect": ArrowDeflectPolicy,
    "minimal_load": MinimalLoadPolicy,
    "round_robin": RoundRobinPolicy,
    "colocated": ColocatedPolicy,
}
