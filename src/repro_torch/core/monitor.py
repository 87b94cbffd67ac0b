"""Instance monitor (§5.2): periodically scrapes per-instance performance
metrics; the global scheduler reads these snapshots (possibly slightly stale,
exactly as in the paper — Insights 3/4 make decode tolerate that)."""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict


@dataclass
class InstanceStats:
    instance_id: int
    # prefill side
    prefill_queue_len: int = 0
    prefill_backlog_tokens: int = 0
    prefill_ready_at: float = 0.0        # predicted drain time (abs seconds)
    # decode side
    running_tokens: int = 0              # Σ tokens of decode requests on instance
    n_decode_running: int = 0
    avg_token_interval: float = 0.0      # recent mean seconds/token
    # memory
    kv_tokens_used: int = 0
    kv_tokens_capacity: int = 0

    @property
    def has_prefill_work(self) -> bool:
        return self.prefill_queue_len > 0

    @property
    def has_decode_work(self) -> bool:
        return self.n_decode_running > 0


class InstanceMonitor:
    """Keeps the latest stats snapshot + a sliding window of token-generation
    intervals per instance."""

    def __init__(self, instance_ids, window: int = 32):
        self._window = window
        self.stats: Dict[int, InstanceStats] = {
            iid: InstanceStats(iid) for iid in instance_ids}
        self._intervals: Dict[int, deque] = {
            iid: deque(maxlen=window) for iid in instance_ids}

    # ----------------------------------------------------------- lifecycle
    def add_instance(self, iid: int) -> None:
        """A freshly provisioned instance joins the scrape set (DESIGN.md §6)."""
        self.stats.setdefault(iid, InstanceStats(iid))
        self._intervals.setdefault(iid, deque(maxlen=self._window))

    def remove_instance(self, iid: int) -> None:
        self.stats.pop(iid, None)
        self._intervals.pop(iid, None)

    # --------------------------------------------------------- ingestion
    def record_iteration(self, iid: int, now: float, tokens_emitted: int,
                         duration: float) -> None:
        """Called after an instance finishes one iteration that emitted decode
        tokens. The token-generation interval sample is the *iteration
        duration* (each running request got one token per iteration); gaps
        while an instance sits idle are not decode slowness and must not
        poison the TPOT signal. A straggling record for an instance already
        removed/failed is dropped silently — the async engine step can
        finalize an iteration after the crash teardown popped the monitor
        entry, and a KeyError there would take the whole step loop down."""
        if tokens_emitted > 0 and iid in self._intervals:
            self._intervals[iid].append(duration)

    def update_stats(self, s: InstanceStats) -> None:
        iv = self._intervals.get(s.instance_id)
        if iv is None:          # scrape raced instance removal: drop it
            return
        s.avg_token_interval = (sum(iv) / len(iv)) if iv else 0.0
        self.stats[s.instance_id] = s

    # ----------------------------------------------------------- queries
    def get(self, iid: int) -> InstanceStats:
        return self.stats[iid]

    def avg_token_interval(self, iid: int) -> float:
        iv = self._intervals[iid]
        return (sum(iv) / len(iv)) if iv else 0.0

    def reset_intervals(self, iid: int) -> None:
        self._intervals[iid].clear()
