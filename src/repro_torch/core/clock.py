"""Clock abstraction: one scheduling code path over simulated and real time.

The global/local schedulers, the migration manager and the monitor all take
``now`` as a plain float; the ``Clock`` is what a ``ServingSystem`` driver
consults to produce that float. ``VirtualClock`` is advanced explicitly by the
discrete-event simulator; ``WallClock`` measures real elapsed seconds for the
JAX engine. Everything above the clock is shared (core/runtime.py).
"""
from __future__ import annotations

import time
from typing import Optional, Protocol, runtime_checkable


@runtime_checkable
class Clock(Protocol):
    """Minimal time source: monotonically non-decreasing seconds."""

    def now(self) -> float: ...


class VirtualClock:
    """Discrete-event time, advanced explicitly by the simulator's event loop.

    ``advance`` clamps backwards moves to keep time monotone even if two
    events carry the same timestamp.
    """

    def __init__(self, t0: float = 0.0):
        self._t = t0

    def now(self) -> float:
        return self._t

    def advance(self, t: float) -> None:
        if t > self._t:
            self._t = t


class WallClock:
    """Real elapsed seconds since ``start()``; starts lazily on first use so a
    batch of ``submit()`` calls before the serving loop doesn't eat into the
    requests' arrival offsets."""

    def __init__(self):
        self._t0: Optional[float] = None

    @property
    def started(self) -> bool:
        return self._t0 is not None

    def start(self) -> None:
        if self._t0 is None:
            self._t0 = time.perf_counter()

    def now(self) -> float:
        self.start()
        return time.perf_counter() - self._t0
