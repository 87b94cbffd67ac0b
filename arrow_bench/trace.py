"""The profiled slice of a traced run: ``torch.profiler`` (device activity
only) over the end of the window.

The slice is the harness's: it starts at the first step once the clock
reads the window's close less ``profile_slice_s`` and lasts at least that
long; the run serves past the close until it has. The device is
synchronised as the slice opens and again before it closes,
so the kernels in the trace are exactly those of the steps dispatched in
the slice. As it opens, one small fill is launched right after a
synchronise: its start on the device, against the host clock read just
before, puts device time on the cluster's clock (to within the launch
latency), which is how each idle gap is put beside what the host was doing.

The trace is read from the profiler's raw kineto events where the PyTorch
version has them (the per-op parse behind ``key_averages`` is what makes a
profile's collection take several times its span), else from ``events()``.
"""
from __future__ import annotations

import heapq
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch


@dataclass
class Profile:
    start: float = 0.0                  # the slice, on the cluster clock
    end: float = 0.0
    events: List[Tuple[str, float, float]] = field(default_factory=list)
    collect_s: float = 0.0              # stopping and reading the profiler

    @property
    def wall(self) -> float:
        return self.end - self.start

    def busy(self) -> List[Tuple[float, float]]:
        """The union of device activity inside the slice."""
        iv = sorted((max(a, self.start), min(b, self.end))
                    for _, a, b in self.events if b > self.start
                    and a < self.end)
        out: List[Tuple[float, float]] = []
        for a, b in iv:
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def kernel_s(self, names) -> float:
        """Device seconds of the kernels whose name holds one of
        ``names``."""
        return sum(b - a for n, a, b in self.events
                   if any(k in n for k in names))

    def top_ops(self, k: int = 10):
        tot = {}
        for n, a, b in self.events:
            key = n[:120]
            tot[key] = tot.get(key, 0.0) + (b - a)
        return sorted(([n, s] for n, s in tot.items()),
                      key=lambda x: -x[1])[:k]

    def idle_by_host(self, spans, k: int = 10):
        """Idle device time inside the slice, by the innermost host span
        (``spans``: (start, end, label) on the cluster clock) around each
        idle gap's middle: the shortest of those with start <= middle <=
        end, the earliest in ``spans`` among equals; outside every span:
        "harness loop". One sweep: the gaps' middles rise, so a span that
        ends before one ends before every later one."""
        gaps, t = [], self.start
        for a, b in self.busy():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.end > t:
            gaps.append((t, self.end))
        order = sorted(range(len(spans)), key=lambda i: spans[i][0])
        heap: list = []                 # (length, index, end) of open spans
        j = 0
        tot = {}
        for a, b in gaps:
            mid = 0.5 * (a + b)
            while j < len(order) and spans[order[j]][0] <= mid:
                s = spans[order[j]]
                heapq.heappush(heap, (s[1] - s[0], order[j], s[1]))
                j += 1
            while heap and heap[0][2] < mid:
                heapq.heappop(heap)
            label = spans[heap[0][1]][2] if heap else "harness loop"
            tot[label] = tot.get(label, 0.0) + (b - a)
        return sorted(([n, s] for n, s in tot.items()),
                      key=lambda x: -x[1])[:k]


def _raw_events(prof):
    from torch.autograd import DeviceType
    res = getattr(prof.profiler, "kineto_results", None)
    if res is not None:
        return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                for e in res.events() if e.device_type() == DeviceType.CUDA]
    return [(e.name, int(e.time_range.start * 1e3),
             int(e.time_range.end * 1e3)) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


class Slicer:
    """Starts the profiler at the first step the harness makes once the
    clock reads ``start``; ``ends_at`` is then ``length`` seconds later.
    A step can block for seconds, so the slice may begin late and end late,
    but never lasts less than ``length``."""

    def __init__(self, clock, device, start: float, length: float):
        self.clock, self.device = clock, device
        self.t_start, self.length = start, length
        self.prof = None
        self.profile: Optional[Profile] = None
        self._host0 = 0.0

    @property
    def ends_at(self) -> float:
        return self._host0 + self.length

    def on_time(self, now: float, recorder) -> None:
        if self.profile is None and self.prof is None \
                and now >= self.t_start:
            self.begin(recorder)

    def begin(self, recorder) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize(self.device)
        self._host0 = self.clock.now()
        torch.zeros(1, device=self.device)          # the clock's marker
        recorder.recording = True

    def stop(self, recorder) -> None:
        if self.prof is None:
            return
        recorder.recording = False
        torch.cuda.synchronize(self.device)
        end = self.clock.now()
        t = time.perf_counter()
        self.prof.__exit__(None, None, None)
        raw = _raw_events(self.prof)
        self.prof = None
        p = Profile(start=self._host0, end=end)
        if raw:
            m = min(a for _, a, _ in raw)
            p.events = [(n, self._host0 + (a - m) * 1e-9,
                         self._host0 + (b - m) * 1e-9) for n, a, b in raw]
        p.collect_s = time.perf_counter() - t
        self.profile = p
