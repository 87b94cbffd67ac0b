"""Self-healing layer (DESIGN.md §14): straggler detection + quarantine.

Arrow's scheduler assumes every ACTIVE instance decodes at roughly the fleet
rate; a lagging instance (§3.2 of the paper) silently burns the SLOs of every
resident it holds because nothing *detects* degradation — PR 4 only injects
it. The HealthMonitor closes that loop with a robust peer comparison over the
signal the InstanceMonitor already maintains:

  * **score** — each instance's ``avg_token_interval`` (sliding TPOT window)
    against the *peer median* across ACTIVE instances with data. Medians are
    robust to the straggler itself dragging the baseline, unlike means.
  * **quarantine** — sustained deviation (``straggler_factor``× median for
    ≥ ``sustain_s`` seconds, with hysteresis: the sustain clock only resets
    once the score drops below ``clear_factor``× median) moves the instance
    to the DEGRADED lifecycle state: never schedulable for new work, decode
    residents drained away through the FCFS migration manager
    (core/runtime.py ``quarantine_instance``).
  * **probation** — a drained DEGRADED instance produces no new samples, so
    the monitor re-admits it after ``probation_s`` with a cleared interval
    window and watches: if the slowdown persists it re-trips detection and
    returns to quarantine, all within the same *episode*.
  * **escalation** — an episode open for ≥ ``deadline_s`` (the instance kept
    relapsing) is treated as a hard fault: ``fail_instance`` tears it down
    and the autoscaler provisions a replacement. An episode closes once the
    instance stays clean for ``sustain_s`` after re-admission.

The same config also carries the transfer retry ladder and the SLO-aware
preemption knobs (both implemented in core/runtime.py) so one ``--health``
surface arms the whole self-healing layer.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.core.pools import Lifecycle


def _median(values):
    xs = sorted(values)
    n = len(xs)
    mid = n // 2
    return xs[mid] if n % 2 else 0.5 * (xs[mid - 1] + xs[mid])


@dataclass(frozen=True)
class HealthConfig:
    """Knobs for the self-healing layer. Defaults favour acting only on
    unambiguous stragglers; see docs/OPERATOR.md §9 for tuning."""

    # --- straggler detection / quarantine (HealthMonitor) ---
    straggler_factor: float = 3.0   # k× peer median arms the sustain clock
    clear_factor: float = 1.5      # below this × median clears it (hysteresis)
    sustain_s: float = 2.0         # deviation must persist this long
    probation_s: float = 4.0       # quarantine dwell before re-admission
    deadline_s: float = 30.0       # episode older than this → fail_instance
    min_peers: int = 3             # baselines needed before trusting a median
    # --- transfer retry ladder (core/runtime.py) ---
    xfer_retries: int = 3          # bounded retry attempts per transfer
    xfer_backoff_s: float = 0.25   # first retry delay; doubles per attempt
    xfer_timeout_s: float = 30.0   # per-transfer timeout (async sim path)
    # --- SLO-aware preemption at the §5.4 memory gate ---
    preemption: bool = False       # arm victim preemption when the gate blocks
    preempt_limit: int = 2         # max preemptions per instance per window
    preempt_window_s: float = 10.0


class HealthMonitor:
    """Peer-median straggler detector driving quarantine/probation/escalation
    through the runtime. Ticks from ``collect_stats`` right after the scrape,
    so both backends see identical (post-scrape) signals at a barrier."""

    def __init__(self, runtime, cfg: HealthConfig):
        self.runtime = runtime
        self.cfg = cfg
        self._slow_since: Dict[int, float] = {}     # sustain clock per iid
        self._episode_start: Dict[int, float] = {}  # first quarantine of run
        self._probation_until: Dict[int, float] = {}
        self._restored_at: Dict[int, float] = {}

    # ------------------------------------------------------------ lifecycle
    def forget(self, iid: int) -> None:
        """Instance left the cluster (failed/removed): drop its state."""
        self._slow_since.pop(iid, None)
        self._episode_start.pop(iid, None)
        self._probation_until.pop(iid, None)
        self._restored_at.pop(iid, None)

    # ----------------------------------------------------------------- tick
    def tick(self, now: float) -> None:
        self._detect(now)
        self._probation(now)
        self._close_episodes(now)

    def _detect(self, now: float) -> None:
        rt = self.runtime
        cfg = self.cfg
        actives = rt.pools.active_ids()
        scores = {i: rt.monitor.avg_token_interval(i) for i in actives}
        scores = {i: v for i, v in scores.items() if v > 0.0}
        if len(scores) < cfg.min_peers:
            return
        med = _median(scores.values())
        if med <= 0.0:
            return
        for iid, iv in sorted(scores.items()):
            if iv >= cfg.straggler_factor * med:
                self._slow_since.setdefault(iid, now)
            elif iv < cfg.clear_factor * med:
                self._slow_since.pop(iid, None)
            # in the hysteresis band: keep the sustain clock running
            since = self._slow_since.get(iid)
            if since is None or now - since < cfg.sustain_s:
                continue
            # never quarantine the last evacuation target
            if len(rt.pools.active_ids()) <= 1:
                continue
            self._slow_since.pop(iid, None)
            self._episode_start.setdefault(iid, now)
            self._probation_until[iid] = now + cfg.probation_s
            rt.quarantine_instance(iid, now)

    def _probation(self, now: float) -> None:
        rt = self.runtime
        for iid in sorted(rt.pools.degraded_ids()):
            start = self._episode_start.get(iid, now)
            if now - start >= self.cfg.deadline_s:
                # kept relapsing past the deadline: hard-fail and replace
                rt.escalate_unhealthy(iid, now)
            elif now >= self._probation_until.get(iid, 0.0):
                self._probation_until.pop(iid, None)
                self._restored_at[iid] = now
                rt.restore_instance(iid, now)

    def _close_episodes(self, now: float) -> None:
        rt = self.runtime
        for iid in list(self._episode_start):
            if rt.pools.lifecycle_of(iid) is not Lifecycle.ACTIVE:
                continue
            if iid in self._slow_since:
                continue
            clean_since = self._restored_at.get(iid,
                                                self._episode_start[iid])
            if now - clean_since >= self.cfg.sustain_s:
                self._episode_start.pop(iid, None)
                self._restored_at.pop(iid, None)
