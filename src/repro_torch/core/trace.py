"""Spans and counters of the engine's serving path, on the cluster's clock.

A ``Tracer`` records nothing until a caller attaches one
(``cluster.tracer = Tracer(cluster.clock)``). Every site in the program
tests ``tracer is not None`` first, so a cluster without one reads no
clock and allocates nothing that it would not otherwise.

A span is one row of five parallel lists: its name, start, end (NaN while
open), the row of its parent (-1 for none) and a key (the request id of a
request or migration span, the instance id of an instance span, -1
otherwise). ``open`` puts a span on the stack of open spans, whose top is
the parent of the next; ``close`` takes it off; ``next`` closes one span
and opens the following phase at the same reading; ``record`` adds a
finished span without a parent, for an interval whose ends were read
elsewhere (a request's wait for its first chunk). A caller that already
read the clock at a boundary passes that reading as ``t``. A counter is
(span row, name, value); a span's counters of one name add up.

Spans are host time. The device's time comes from a profiler, on the same
clock once the two are aligned.

What the engine records (``engine/cluster.py``, ``engine/instance.py``):

- ``cluster.step``, one ``step()``, with its phases as children:
  ``step.arrivals`` (due arrivals), ``step.migrations``
  (``admit_migrations``), ``step.collect`` (ready polls and their
  finalizes), ``step.dispatch``, ``step.block`` (the forced finalize of the
  oldest step) and ``step.monitor`` (``collect_stats``, on a tick);
- ``request.queue`` (rid): from the request's arrival to the dispatch of
  its first prefill chunk;
- ``instance.dispatch`` (iid), one instance step dispatched, with children
  ``instance.prepare`` (the instance's host arrays of tokens, positions,
  slots and sampling parameters, and the token uploads it makes itself)
  and ``instance.launch`` (each call into ``engine/fused_step.py``: the
  call's own host arrays and uploads, then the enqueue of the step's
  kernels; the span does not tell those apart; or the replay of the
  decode graph: its inputs' staging and upload, then one graph launch),
  and counters
  ``decode_rows`` (decoding rows), ``batch_rows`` (the rows the decode batch
  runs over: every slot), ``prompt_tokens``, ``kv_tokens`` (positions held
  by the instance's occupied slots) and ``kv_reserved`` (slots x capacity),
  and in a constant-state family (ssm, hybrid) also ``state_bytes`` (the
  bytes of the slab rows its occupied slots hold), ``state_reserved_bytes``
  (the bytes of its slabs) and ``chunk_calls`` (the prefill chunks the
  step runs one after another), and in every family ``graph_replays`` (1
  when the step's decode batch ran as a replay of the instance's captured
  CUDA graph, ``engine/decode_graph.py``, else 0) and ``graph_captures``
  (captures of that graph made inside the dispatch: the slabs had moved);
- ``instance.finalize`` (iid): the step's blocking fetch, then its child
  ``instance.emit``, the host bookkeeping of the tokens;
- ``migration`` (rid), one ``_begin_transfer``, with children
  ``migration.land`` (both endpoints' inflight steps finalized),
  ``migration.export``, ``migration.checksum`` (at export, and again at
  each import's verification) and ``migration.import`` (the wire image's
  upload to the destination's device before each verification, then
  slot allocation and placement), and the counter ``completed`` on a
  transfer that landed (its bytes are ``migration_log``'s).
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional, Tuple

Span = Tuple[str, float, float, int, int]      # name, start, end, parent, key


class Tracer:
    def __init__(self, clock):
        self.clock = clock
        self.names: List[str] = []
        self.starts: List[float] = []
        self.ends: List[float] = []
        self.parents: List[int] = []
        self.keys: List[int] = []
        self.counters: List[Tuple[int, str, float]] = []
        self._stack: List[int] = []

    def __len__(self) -> int:
        return len(self.names)

    def open(self, name: str, key: int = -1,
             t: Optional[float] = None) -> int:
        i = len(self.names)
        self.names.append(name)
        self.starts.append(self.clock.now() if t is None else t)
        self.ends.append(math.nan)
        self.parents.append(self._stack[-1] if self._stack else -1)
        self.keys.append(key)
        self._stack.append(i)
        return i

    def close(self, i: int, t: Optional[float] = None) -> float:
        """Close span ``i`` (and any span opened inside it and left open)
        at ``t`` or now; returns the reading."""
        t = self.clock.now() if t is None else t
        self.ends[i] = t
        while self._stack and self._stack.pop() != i:
            pass
        return t

    def next(self, i: int, name: str, key: int = -1,
             t: Optional[float] = None) -> int:
        """Close span ``i`` and open ``name`` beside it at one reading;
        span ``i`` itself if it already has that name."""
        if self.names[i] == name:
            return i
        return self.open(name, key, self.close(i, t))

    def record(self, name: str, start: float, end: float,
               key: int = -1) -> int:
        i = len(self.names)
        self.names.append(name)
        self.starts.append(start)
        self.ends.append(end)
        self.parents.append(-1)
        self.keys.append(key)
        return i

    def count(self, i: int, name: str, value: float) -> None:
        self.counters.append((i, name, value))

    # ------------------------------------------------------------ reading
    def spans(self) -> Iterator[Span]:
        return zip(self.names, self.starts, self.ends, self.parents,
                   self.keys)

    def counts(self) -> Dict[int, Dict[str, float]]:
        """Span row -> {counter name: sum of its values}."""
        out: Dict[int, Dict[str, float]] = {}
        for i, name, v in self.counters:
            c = out.setdefault(i, {})
            c[name] = c.get(name, 0.0) + v
        return out

    def children(self) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        for i, p in enumerate(self.parents):
            if p >= 0:
                out.setdefault(p, []).append(i)
        return out

    def self_time(self, rows) -> Dict[str, float]:
        """Seconds by span name over ``rows``: each closed span's duration
        less what its closed children cover."""
        kids = self.children()
        out: Dict[str, float] = {}
        for i in rows:
            d = self.ends[i] - self.starts[i]
            if math.isnan(d):
                continue
            d -= sum(self.ends[c] - self.starts[c] for c in kids.get(i, ())
                     if not math.isnan(self.ends[c]))
            out[self.names[i]] = out.get(self.names[i], 0.0) + d
        return out
