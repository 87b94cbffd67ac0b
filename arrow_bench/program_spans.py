"""Readers of the program's own spans and counters
(``repro_torch.core.trace.Tracer``), over a run's records (``Run`` in
``run_cell``) and its profiled slice (``trace.Profile``).

The harness does not attach a tracer yet; ``tools/trace_cell.py`` does,
from outside it, until the harness's traced run attaches one at ``t0`` and
hands it to these readers. Every time is on the cluster clock; the window
is [open, close). A reader that finds nothing to read returns None.

- ``queue_wait_ms``: mean ``request.queue`` of the requests due in the
  window; one still queued at the close enters with its wait so far;
- ``migration_ms``: mean ``migration`` of the completed transfers that
  start in the window; ``checksum_frac``: their ``migration.checksum``
  children over them;
- ``dispatch_ms``: mean ``instance.dispatch`` of the window's dispatched
  steps; ``decode_rows_frac``: their ``decode_rows`` over their
  ``batch_rows``, the share of the decode batch's rows that hold a
  request;
- ``idle_split``: each idle gap of the slice split among the innermost
  spans it overlaps, in proportion to the overlap.
"""
from __future__ import annotations

import heapq
import math
from typing import Dict, List, Optional, Tuple

# a request's wait is not work the host does, so it takes no idle
NOT_HOST = ("request.queue",)


def _closed(tr, window, name) -> List[int]:
    a, b = window
    return [i for i, (n, s, e, _, _) in enumerate(tr.spans())
            if n == name and a <= s < b and not math.isnan(e)]


def _mean_ms(tr, rows) -> Optional[float]:
    d = [tr.ends[i] - tr.starts[i] for i in rows]
    return 1e3 * sum(d) / len(d) if d else None


def queue_wait_ms(run, tr) -> Optional[float]:
    a, close = run.window
    first: Dict[int, Tuple[float, float]] = {}
    for n, s, e, _, k in tr.spans():
        if n == "request.queue" and k not in first:
            first[k] = (s, e)
    v = []
    for r in run.requests:
        if a <= r.due < close:
            s, e = first.get(r.rid, (r.due, close))
            v.append(min(e, close) - s)
    return 1e3 * sum(v) / len(v) if v else None


def migrations(run, tr) -> List[int]:
    """The window's completed ``migration`` spans (``migration_log``'s
    entries: a transfer that found no slot is left out)."""
    cnt = tr.counts()
    return [i for i in _closed(tr, run.window, "migration")
            if cnt.get(i, {}).get("completed")]


def migration_ms(run, tr) -> Optional[float]:
    return _mean_ms(tr, migrations(run, tr))


def checksum_frac(run, tr) -> Optional[float]:
    rows = migrations(run, tr)
    kids = tr.children()
    tot = sum(tr.ends[i] - tr.starts[i] for i in rows)
    ck = sum(tr.ends[c] - tr.starts[c] for i in rows
             for c in kids.get(i, ()) if tr.names[c] == "migration.checksum")
    return ck / tot if tot > 0 else None


def steps(run, tr) -> Tuple[List[int], List[Dict[str, float]]]:
    """The ``instance.dispatch`` spans of the window's dispatched steps
    (those with counters), and their counters."""
    cnt = tr.counts()
    rows = [i for i in _closed(tr, run.window, "instance.dispatch")
            if i in cnt]
    return rows, [cnt[i] for i in rows]


def dispatch_ms(run, tr) -> Optional[float]:
    return _mean_ms(tr, steps(run, tr)[0])


def decode_rows_frac(run, tr) -> Optional[float]:
    _, st = steps(run, tr)
    rows = sum(c["batch_rows"] for c in st)
    return sum(c["decode_rows"] for c in st) / rows if rows else None


METRICS = {"sched.queue_wait_ms": queue_wait_ms,
           "sched.migration_ms": migration_ms,
           "sched.migration_checksum_frac": checksum_frac,
           "engine.dispatch_ms": dispatch_ms,
           "engine.decode_rows_frac": decode_rows_frac}


def info(run, tr) -> dict:
    """The info line's numbers: self time by span name (top 10), KV in use
    over the reserved pool and prompt tokens a dispatched step, spans a
    pass, and every ``migration`` by the program and by the harness's
    wrapper (their number and seconds), with the program's completed ones
    last."""
    disp, st = steps(run, tr)
    a, b = run.window
    rows = [i for i, s in enumerate(tr.starts) if a <= s < b]
    own = sorted(((n, s) for n, s in tr.self_time(rows).items()
                  if n not in NOT_HOST), key=lambda x: -x[1])[:10]
    passes = _closed(tr, run.window, "cluster.step")
    mig = _closed(tr, run.window, "migration")
    done = migrations(run, tr)
    wrapper = [(s, e) for s, e, label in run.spans
               if label == "migration" and a <= s < b]
    return {
        "self_time_s": [[n, s] for n, s in own],
        "kv_in_use_frac": (sum(c["kv_tokens"] / c["kv_reserved"]
                               for c in st) / len(st) if st else None),
        "prompt_tokens_per_step": (sum(c["prompt_tokens"] for c in st)
                                   / len(st) if st else None),
        "spans_per_pass": len(rows) / len(passes) if passes else None,
        "migrations": [len(mig), len(wrapper), len(done)],
        "migration_s": [sum(tr.ends[i] - tr.starts[i] for i in mig),
                        sum(e - s for s, e in wrapper),
                        sum(tr.ends[i] - tr.starts[i] for i in done)]}


# ------------------------------------------------------ the slice's idle


def idle_gaps(profile) -> List[Tuple[float, float]]:
    """The slice's intervals with nothing running on the device."""
    gaps, t = [], profile.start
    for a, b in profile.busy():
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if profile.end > t:
        gaps.append((t, profile.end))
    return gaps


def idle_split(gaps, spans, min_len: float = 0.0) -> Dict[str, float]:
    """Seconds of ``gaps`` by label. ``spans``: (start, end, label, rank);
    each instant of a gap goes to the span of least rank, then shortest,
    among those around it ("harness loop" where there is none), so a gap
    that crosses spans is split in proportion to the overlap and the
    labels sum to the gaps. Spans shorter than ``min_len`` are left out."""
    ev = []
    for i, (a, b, _, _) in enumerate(spans):
        if b - a >= min_len and b > a:
            ev.append((a, 1, i))
            ev.append((b, 0, i))
    ev.sort()
    tot: Dict[str, float] = {}
    heap: list = []
    live = set()
    g = 0

    def add(x, y):
        nonlocal g
        if y <= x:
            return
        while heap and heap[0][2] not in live:
            heapq.heappop(heap)
        label = spans[heap[0][2]][2] if heap else "harness loop"
        while g < len(gaps) and gaps[g][1] <= x:
            g += 1
        j = g
        while j < len(gaps) and gaps[j][0] < y:
            o = min(y, gaps[j][1]) - max(x, gaps[j][0])
            if o > 0:
                tot[label] = tot.get(label, 0.0) + o
            j += 1

    prev = gaps[0][0] if gaps else 0.0
    for t, kind, i in ev:
        add(prev, t)
        prev = max(prev, t)
        a, b, _, rank = spans[i]
        if kind:
            live.add(i)
            heapq.heappush(heap, (rank, b - a, i))
        else:
            live.discard(i)
    if gaps:
        add(prev, gaps[-1][1])
    return tot


def clock_skew_us(profile, close_host) -> Optional[float]:
    """A marker launched on the device as the slice closes, right after
    the host read ``close_host``: its start as mapped onto the cluster's
    clock (the slice's last event) less that reading."""
    if close_host is None or not profile.events:
        return None
    return 1e6 * (max(a for _, a, _ in profile.events) - close_host)


def idle_by_span(run, tr, waits, close_host, k: int = 10) -> dict:
    """The slice's idle time and its split: the program's spans and the
    harness's sleeps (``waits``) first, then the harness's wrappers
    (``run.spans``); spans shorter than a clock skew past 100 us are left
    out. Also device events a dispatched step."""
    p = run.profile
    skew = clock_skew_us(p, close_host)
    spans = [(a, b, "harness.wait", 0) for a, b in waits]
    spans += [(a, b, label, 1) for a, b, label in run.spans]
    if tr is not None:
        spans += [(s, e, n, 0) for n, s, e, _, _ in tr.spans()
                  if not math.isnan(e) and n not in NOT_HOST]
    gaps = idle_gaps(p)
    split = idle_split(gaps, spans, 1e-6 * abs(skew)
                       if skew is not None and abs(skew) > 100 else 0.0)
    return {"clock_skew_us": skew,
            "idle_s": sum(b - a for a, b in gaps),
            "idle_split_s": sum(split.values()),
            "idle_gaps": sorted(([n, s] for n, s in split.items()),
                                key=lambda x: -x[1])[:k],
            "kernels_per_step": (len(p.events) / len(run.dispatches)
                                 if run.dispatches else None)}
