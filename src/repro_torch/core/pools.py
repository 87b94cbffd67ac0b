"""Elastic instance pools (§5.2): PREFILL, DECODE, P→D, D→P with the Fig. 5
transition diagram. Flipping = pool-membership move, zero wait/restart.

Beyond the paper (DESIGN.md §6): the instance *set* itself is elastic. Each
instance carries a lifecycle state

    WARMING ──activate──▶ ACTIVE ──begin_retire──▶ RETIRING ──remove──▶ (gone)
       │                    │  ▲                      │
       │                    │  └─restore─ DEGRADED    │
       │                    │  ──degrade──▶ │         │
       └────────────────────┴───────fail────┴─────────┘──remove──▶ (gone)

Only ACTIVE instances are schedulable: ``members``/``prefill_capable``/
``decode_capable``/``count`` all restrict themselves to ACTIVE, so the
global scheduler and the flip algorithms (Alg. 1–4) never place work on — or
flip — a warming or retiring instance. RETIRING instances keep draining the
work they already hold (``all_ids`` still includes them for stat scraping and
iteration driving); the runtime removes them once drained (core/runtime.py).

FAILED (DESIGN.md §8) is the fail-stop crash state: reachable from any live
state, never schedulable, never flippable, skipped by stat scraping and the
AutoScaler's pool accounting. Unlike RETIRING nothing drains — the substrate
and its resident KV are already gone; the runtime recovers the lost work
(core/runtime.py ``fail_instance``) and removes the corpse on the next
monitor tick.

DEGRADED (DESIGN.md §14) is the straggler-quarantine state: the substrate is
alive but sustained-slow, so it takes no new placements while its decode
residents are drained away through the migration manager. Unlike RETIRING it
is reversible — ``restore`` puts a recovered instance back in service — and
unlike FAILED its KV is intact, so nothing is lost while it sits in
quarantine. The HealthMonitor (core/health.py) drives both transitions and
escalates to ``fail`` when quarantine exceeds its deadline.
"""
from __future__ import annotations

import enum
from typing import Dict, List


class Pool(enum.Enum):
    PREFILL = "P"
    DECODE = "D"
    P2D = "P->D"      # scheduled for decode; still draining prefill work
    D2P = "D->P"      # scheduled for prefill; still draining decode work


class Lifecycle(enum.Enum):
    WARMING = "warming"    # provisioning/loading weights; not schedulable yet
    ACTIVE = "active"      # schedulable member of its pool
    RETIRING = "retiring"  # draining; accepts no new work, no flips
    DEGRADED = "degraded"  # quarantined straggler; reversible (§14)
    FAILED = "failed"      # crashed: substrate + resident KV gone (§8)


class InstancePools:
    def __init__(self, instance_ids, n_prefill: int):
        """First ``n_prefill`` ids start in PREFILL, the rest in DECODE."""
        ids = list(instance_ids)
        self._pool: Dict[int, Pool] = {}
        self._life: Dict[int, Lifecycle] = {}
        for i, iid in enumerate(ids):
            self._pool[iid] = Pool.PREFILL if i < n_prefill else Pool.DECODE
            self._life[iid] = Lifecycle.ACTIVE
        self.flips = 0               # observability: pool moves performed
        # observer invoked on every actual pool move (iid, frm, to): the
        # runtime uses it to invalidate the prefix cache on a role change
        # (DESIGN.md §7) without the scheduler knowing about caching.
        self.on_flip = None

    # ------------------------------------------------------------- queries
    def pool_of(self, iid: int) -> Pool:
        return self._pool[iid]

    def lifecycle_of(self, iid: int) -> Lifecycle:
        return self._life[iid]

    def is_schedulable(self, iid: int) -> bool:
        """True when ``iid`` is a live ACTIVE member (new work may land)."""
        return self._life.get(iid) is Lifecycle.ACTIVE

    def members(self, pool: Pool) -> List[int]:
        """ACTIVE members of ``pool`` — the schedulable set."""
        return [i for i, p in self._pool.items()
                if p is pool and self._life[i] is Lifecycle.ACTIVE]

    def all_ids(self) -> List[int]:
        """Every live instance: warming + active + retiring."""
        return list(self._pool)

    def active_ids(self) -> List[int]:
        return [i for i, s in self._life.items() if s is Lifecycle.ACTIVE]

    def warming_ids(self) -> List[int]:
        return [i for i, s in self._life.items() if s is Lifecycle.WARMING]

    def retiring_ids(self) -> List[int]:
        return [i for i, s in self._life.items() if s is Lifecycle.RETIRING]

    def degraded_ids(self) -> List[int]:
        return [i for i, s in self._life.items() if s is Lifecycle.DEGRADED]

    def failed_ids(self) -> List[int]:
        return [i for i, s in self._life.items() if s is Lifecycle.FAILED]

    def prefill_capable(self) -> List[int]:
        """Instances currently accepting prefill requests: P ∪ D→P."""
        return [i for i, p in self._pool.items()
                if p in (Pool.PREFILL, Pool.D2P)
                and self._life[i] is Lifecycle.ACTIVE]

    def decode_capable(self) -> List[int]:
        return [i for i, p in self._pool.items()
                if p in (Pool.DECODE, Pool.P2D)
                and self._life[i] is Lifecycle.ACTIVE]

    def count(self, *pools: Pool) -> int:
        return sum(1 for i, p in self._pool.items()
                   if p in pools and self._life[i] is Lifecycle.ACTIVE)

    # --------------------------------------------------------- transitions
    def move(self, iid: int, to: Pool) -> None:
        frm = self._pool[iid]
        if frm is not to:
            self.flips += 1
        self._pool[iid] = to
        if frm is not to and self.on_flip is not None:
            self.on_flip(iid, frm, to)

    def flip_to_decode(self, iid: int, has_pending_prefill: bool) -> Pool:
        """PREFILL/D→P instance is reassigned to decode duty."""
        if self._life[iid] is not Lifecycle.ACTIVE:
            raise ValueError(f"cannot flip instance {iid}: "
                             f"{self._life[iid].value}")
        to = Pool.P2D if has_pending_prefill else Pool.DECODE
        self.move(iid, to)
        return to

    def flip_to_prefill(self, iid: int, has_pending_decode: bool) -> Pool:
        if self._life[iid] is not Lifecycle.ACTIVE:
            raise ValueError(f"cannot flip instance {iid}: "
                             f"{self._life[iid].value}")
        to = Pool.D2P if has_pending_decode else Pool.PREFILL
        self.move(iid, to)
        return to

    def on_prefill_drained(self, iid: int) -> None:
        """Black transition edge: P→D pool member finished its prefill queue.
        A no-op for warming/retiring instances (their pool no longer matters)."""
        if self._pool[iid] is Pool.P2D and \
                self._life[iid] is Lifecycle.ACTIVE:
            self.move(iid, Pool.DECODE)

    def on_decode_drained(self, iid: int) -> None:
        if self._pool[iid] is Pool.D2P and \
                self._life[iid] is Lifecycle.ACTIVE:
            self.move(iid, Pool.PREFILL)

    # ---------------------------------------------- lifecycle (DESIGN.md §6)
    def add_instance(self, iid: int, pool: Pool, *,
                     warming: bool = False) -> None:
        """Register a freshly provisioned instance. ``warming=True`` keeps it
        out of the schedulable set until ``activate``."""
        if iid in self._pool:
            raise ValueError(f"instance {iid} already exists")
        self._pool[iid] = pool
        self._life[iid] = Lifecycle.WARMING if warming else Lifecycle.ACTIVE

    def activate(self, iid: int) -> None:
        if self._life[iid] is not Lifecycle.WARMING:
            raise ValueError(f"instance {iid} is {self._life[iid].value}, "
                             "not warming")
        self._life[iid] = Lifecycle.ACTIVE

    def begin_retire(self, iid: int) -> None:
        """ACTIVE → RETIRING: no new work, no flips; existing work drains."""
        if self._life[iid] is not Lifecycle.ACTIVE:
            raise ValueError(f"cannot retire instance {iid}: "
                             f"{self._life[iid].value}")
        self._life[iid] = Lifecycle.RETIRING

    def degrade(self, iid: int) -> None:
        """ACTIVE → DEGRADED (quarantine, DESIGN.md §14): the instance stops
        being schedulable while its decode residents drain; reversible via
        ``restore`` once the straggler signal clears."""
        if self._life[iid] is not Lifecycle.ACTIVE:
            raise ValueError(f"cannot quarantine instance {iid}: "
                             f"{self._life[iid].value}")
        self._life[iid] = Lifecycle.DEGRADED

    def restore(self, iid: int) -> None:
        """DEGRADED → ACTIVE: probation passed, back in service."""
        if self._life[iid] is not Lifecycle.DEGRADED:
            raise ValueError(f"cannot restore instance {iid}: "
                             f"{self._life[iid].value}")
        self._life[iid] = Lifecycle.ACTIVE

    def fail(self, iid: int) -> None:
        """Fail-stop crash (DESIGN.md §8): reachable from any live state.
        The instance is instantly unschedulable and unflippable; the runtime
        recovers its lost work and removes the corpse."""
        if iid not in self._life:
            raise ValueError(f"unknown instance {iid}")
        if self._life[iid] is Lifecycle.FAILED:
            raise ValueError(f"instance {iid} already failed")
        self._life[iid] = Lifecycle.FAILED

    def remove_instance(self, iid: int) -> None:
        """Final removal of a drained RETIRING or crashed FAILED instance."""
        if self._life[iid] not in (Lifecycle.RETIRING, Lifecycle.FAILED):
            raise ValueError(f"cannot remove instance {iid}: "
                             f"{self._life[iid].value} (retire first)")
        del self._pool[iid]
        del self._life[iid]
