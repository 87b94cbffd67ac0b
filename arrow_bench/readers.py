"""Arithmetic the metric readers share, over a run's records (``Run`` in
``run_cell``): the window's requests, their first-token times and token
gaps, and the work and device time of the profiled slice.

Every time is on the cluster clock; the window is [open, close). A reader
that finds nothing to read returns None, and its metric is left out of
the line.
"""
from __future__ import annotations

import bisect
from typing import List, Optional

from arrow_bench import peaks


def in_window(run) -> List:
    """Requests due inside the window."""
    a, b = run.window
    return [r for r in run.requests if a <= r.due < b]


def ttfts(run) -> List[float]:
    """Time to first token of every request due in the window, from its
    due time; one still waiting when the window closes enters with its
    wait so far."""
    close = run.window[1]
    out = []
    for r in in_window(run):
        first = r.times[0] if r.times and r.times[0] <= close else None
        out.append((first if first is not None else close) - r.due)
    return out


def token_gaps(run) -> List[float]:
    """Every gap between consecutive output tokens of one request whose
    later token landed inside the window (the first gap holds the
    migration)."""
    a, b = run.window
    out = []
    for r in run.requests:
        t = r.times
        out.extend(t[i] - t[i - 1] for i in range(1, len(t))
                   if a <= t[i] < b)
    return out


def tokens_in_window(run) -> int:
    a, b = run.window
    return sum(1 for r in run.requests for t in r.times if a <= t < b)


def meets_slo(r, slo) -> bool:
    """A finished request's first token within ``slo[0]`` of its due time,
    and the mean gap after it within ``slo[1]``."""
    if not r.finished or len(r.times) != r.output_len:
        return False
    t = r.times
    per = (t[-1] - t[0]) / (len(t) - 1) if len(t) > 1 else 0.0
    return t[0] - r.due <= slo[0] and per <= slo[1]


def good_in_window(run) -> int:
    """Requests that finished inside the window within both of the mix's
    SLOs."""
    a, b = run.window
    return sum(1 for r in run.requests
               if meets_slo(r, run.slo) and a <= r.times[-1] < b)


def percentile(values, q: float) -> Optional[float]:
    """The ``q``-th percentile, linear between order statistics (numpy's
    default)."""
    import numpy as np
    return float(np.percentile(values, q)) if len(values) else None


# ------------------------------------------------------- the traced slice


def slice_dispatches(run):
    return run.dispatches if run.profile is not None else []


def kernel_roofline(run, names, bound_of_dispatch) -> Optional[float]:
    """Percent of the least time the card could take for the slice's calls
    of a kernel (``bound_of_dispatch(d)``: seconds of one dispatched step's
    calls) against their device time (kernels whose names hold one of
    ``names``)."""
    if run.profile is None:
        return None
    dev = run.profile.kernel_s(names)
    bound = sum(bound_of_dispatch(d) for d in slice_dispatches(run))
    if dev <= 0 or bound <= 0:
        return None
    return 100.0 * bound / dev


def step_flops(run) -> float:
    """Model operations of the work dispatched in the slice: each prompt
    token and each decoded token through every layer (attention at the
    token's context), and the output head at each sampled position."""
    fam, conf = run.family, run.conf
    total = 0.0
    for d in slice_dispatches(run):
        for off, ln, _, final in d.chunks:
            total += fam.layer_flops(conf, ln, ln * off + ln * (ln + 1) // 2)
            total += fam.head_flops(conf) if final else 0.0
        for ctx in d.decode_ctx:
            total += fam.layer_flops(conf, 1, ctx) + fam.head_flops(conf)
    return total


def working(run) -> List[tuple]:
    """The slice's engine time: the harness's ``step()`` calls inside the
    slice that dispatched or finalized a step (where it blocks on the
    oldest inflight step, the wait is in it). Time the harness spent with
    nothing in flight, waiting for the next arrival, is not in it."""
    p = run.profile
    return [(max(a, p.start), min(b, p.end)) for a, b, worked in run.passes
            if worked and b > p.start and a < p.end]


def step_mfu(run) -> Optional[float]:
    """Percent of the bf16 peak that the slice's model operations take of
    the slice's engine time."""
    if run.profile is None:
        return None
    t = sum(b - a for a, b in working(run))
    f = step_flops(run)
    return 100.0 * f / (t * peaks.BF16_FLOPS) if f and t > 0 else None


def covered(busy, spans) -> float:
    """Seconds of ``busy`` (sorted, disjoint intervals) inside each of
    ``spans``, summed over ``spans`` (which may overlap): by the running
    sum of ``busy``'s lengths at each span's ends."""
    starts = [a for a, _ in busy]
    cum = [0.0]
    for a, b in busy:
        cum.append(cum[-1] + (b - a))

    def upto(x):
        i = bisect.bisect_right(starts, x)
        if not i:
            return 0.0
        a, b = busy[i - 1]
        return cum[i - 1] + min(b, x) - a
    return sum(max(0.0, upto(d) - upto(c)) for c, d in spans)


def idle_frac(run) -> Optional[float]:
    """Share of the slice's engine time with nothing running on the
    device."""
    p = run.profile
    if p is None or not p.events:
        return None
    work = working(run)
    t = sum(b - a for a, b in work)
    if t <= 0:
        return None
    return 1.0 - covered(p.busy(), work) / t


def pass_ms(run) -> Optional[float]:
    """Mean host milliseconds of a window's ``step()`` that dispatched or
    finalized an instance step."""
    v = [b - a for a, b, worked in run.passes
         if worked and run.window[0] <= a < run.window[1]]
    return 1e3 * sum(v) / len(v) if v else None


def migrated_mb(run) -> Optional[float]:
    """Megabytes of decode state moved per migration in the window."""
    log = run.migrations
    return sum(m["bytes"] for m in log) / len(log) / 1e6 if log else None
