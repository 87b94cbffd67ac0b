"""Failure injection (DESIGN.md §8): scripted or seed-deterministic crash
and slowdown events driven through the shared runtime on both backends.

Arrow's goodput claims rest on stateless instances that can change roles at
any time (§4); a production cluster additionally loses instances outright.
A ``FaultPlan`` is a timed script of fault events; the ``FaultInjector``
fires each event when the system clock passes its time — the simulator arms
an exact virtual-clock event per fault, the engine polls at every
cooperative pass — and routes it to ``RuntimeCore.fail_instance`` (crash:
substrate and resident KV lost, lost requests recovered) or
``RuntimeCore.apply_slowdown`` (a lagging instance, §3.2).

Event grammar (``--fault-plan``, ``FaultPlan.parse``)::

    crash@20                    crash a seed-chosen ACTIVE instance at t=20
    crash@45:target=3           crash instance 3 at t=45
    slow@60:factor=4,duration=5 run 4x slower for 5 s from t=60
    droptransfer@30:p=0.5,duration=10   each transfer attempt started in
                                the window fails with probability p (§14)
    netslow@30:factor=8,duration=10     transfers run 8x slower (§14)

Events are separated by ``;``. Target selection without an explicit
``target=`` draws from the sorted ACTIVE set with the plan's seeded RNG, so
the same plan picks the same victims given the same membership history —
deterministic on the simulator, reproducible on the engine. The transfer
faults (droptransfer/netslow) are cluster-wide interconnect windows — no
victim is drawn, so adding them to a plan never perturbs the RNG stream of
its targeted events.

``recovery=False`` turns the plan into the no-recovery strawman
(``benchmarks/bench_faults.py``): crashed instances still tear down, but
their in-flight requests are stranded instead of re-dispatched.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.pools import Lifecycle

KINDS = ("crash", "slow", "droptransfer", "netslow")
CLUSTER_KINDS = ("droptransfer", "netslow")   # interconnect-wide: no victim


@dataclass(frozen=True)
class FaultEvent:
    """One scripted fault."""

    t: float                       # system-clock seconds
    kind: str = "crash"            # "crash"|"slow"|"droptransfer"|"netslow"
    target: Optional[int] = None   # iid; None = seed-deterministic pick
    factor: float = 4.0            # slow/netslow: time multiplier
    duration: float = 5.0          # slow/droptransfer/netslow: window length
    p: float = 0.5                 # droptransfer: per-attempt drop probability

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"choose from {KINDS}")
        if self.t < 0:
            raise ValueError(f"fault event at t={self.t}: time must be >= 0")
        for name, v in (("factor", self.factor), ("duration", self.duration),
                        ("p", self.p)):
            if v <= 0:
                raise ValueError(
                    f"fault event {self.kind}@{self.t:g}: {name}={v} must "
                    f"be > 0 (a non-positive {name} would never fire or "
                    f"divide by zero downstream)")


@dataclass(frozen=True)
class FaultPlan:
    """An immutable script of fault events plus the victim-selection seed."""

    events: Tuple[FaultEvent, ...] = ()
    seed: int = 0
    recovery: bool = True          # False: no-recovery strawman

    @classmethod
    def parse(cls, spec: str, *, seed: int = 0,
              recovery: bool = True) -> "FaultPlan":
        """Parse the ``--fault-plan`` grammar (module docstring)."""
        events = []
        for part in filter(None, (p.strip() for p in spec.split(";"))):
            head, _, opts = part.partition(":")
            kind, _, t_str = head.partition("@")
            if not t_str:
                raise ValueError(f"fault event {part!r}: expected kind@time")
            kw = {}
            for opt in filter(None, (o.strip() for o in opts.split(","))):
                k, _, v = opt.partition("=")
                if k == "target":
                    kw["target"] = int(v)
                elif k in ("factor", "duration", "p"):
                    kw[k] = float(v)
                else:
                    raise ValueError(f"fault event {part!r}: unknown "
                                     f"option {k!r}")
            events.append(FaultEvent(t=float(t_str), kind=kind, **kw))
        return cls(events=tuple(events), seed=seed, recovery=recovery)

    @classmethod
    def random_crashes(cls, n: int, horizon: float, *, seed: int = 0,
                       recovery: bool = True) -> "FaultPlan":
        """``n`` crashes at seed-deterministic times inside the middle 80%
        of ``horizon`` (the edges are warm-up/drain-down)."""
        rng = np.random.default_rng(seed)
        times = sorted(rng.uniform(0.1 * horizon, 0.9 * horizon, size=n))
        return cls(events=tuple(FaultEvent(t=float(t)) for t in times),
                   seed=seed, recovery=recovery)


class FaultInjector:
    """Fires a ``FaultPlan``'s events against a ``RuntimeCore`` as the
    system clock passes them. Backends drive ``poll(now)``; the simulator
    additionally arms one exact virtual-clock event per fault time so a
    crash lands at precisely its scripted instant."""

    def __init__(self, plan: FaultPlan, runtime):
        self.plan = plan
        self.runtime = runtime
        self._events = sorted(plan.events, key=lambda e: e.t)
        self._idx = 0
        self._rng = np.random.default_rng(plan.seed)
        # (fire time, event, victim iid or None when skipped)
        self.fired: List[Tuple[float, FaultEvent, Optional[int]]] = []

    def event_times(self) -> List[float]:
        return [e.t for e in self._events]

    @property
    def exhausted(self) -> bool:
        return self._idx >= len(self._events)

    def poll(self, now: float) -> int:
        """Fire every not-yet-fired event with ``t <= now``; returns the
        number fired (skipped events count — they are consumed)."""
        n = 0
        while self._idx < len(self._events) and \
                self._events[self._idx].t <= now:
            ev = self._events[self._idx]
            self._idx += 1
            self._fire(ev, now)
            n += 1
        return n

    # ------------------------------------------------------------ internal
    def _pick_target(self, ev: FaultEvent) -> Optional[int]:
        rt = self.runtime
        if ev.target is not None:
            alive = ev.target in rt.pools.all_ids() and \
                rt.pools.lifecycle_of(ev.target) is not Lifecycle.FAILED
            return ev.target if alive else None
        eligible = sorted(rt.pools.active_ids())
        if not eligible:
            return None
        return int(eligible[int(self._rng.integers(len(eligible)))])

    def _fire(self, ev: FaultEvent, now: float) -> None:
        rt = self.runtime
        if ev.kind in CLUSTER_KINDS:          # interconnect-wide: no victim
            if ev.kind == "droptransfer":
                rt.apply_transfer_drop(ev.p, now + ev.duration)
            else:
                rt.apply_netslow(ev.factor, now + ev.duration)
            self.fired.append((now, ev, None))
            return
        iid = self._pick_target(ev)
        if iid is None:                       # victim gone / nothing ACTIVE
            rt.fault_stats["skipped_events"] += 1
            self.fired.append((now, ev, None))
            return
        if ev.kind == "crash":
            rt.fail_instance(iid, now, recover=self.plan.recovery)
        else:
            rt.apply_slowdown(iid, ev.factor, now + ev.duration)
        self.fired.append((now, ev, iid))
