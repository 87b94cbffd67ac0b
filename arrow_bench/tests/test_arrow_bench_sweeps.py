"""The slice's two interval readers, ``Profile.idle_by_host`` and
``readers.idle_frac``, are sweeps over sorted intervals: they give what
the pairwise scans they replaced gave (kept here as the reference), on
random nested and overlapping intervals, and a slice of a million idle
gaps under ten thousand host spans takes seconds, where the scans took
minutes."""
import random
import time
from types import SimpleNamespace

import pytest

from arrow_bench import readers
from arrow_bench.trace import Profile


def idle_by_host_scan(p, spans, k=10):
    gaps, t = [], p.start
    for a, b in p.busy():
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if p.end > t:
        gaps.append((t, p.end))
    tot = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inner = [s for s in spans if s[0] <= mid <= s[1]]
        label = min(inner, key=lambda s: s[1] - s[0])[2] if inner \
            else "harness loop"
        tot[label] = tot.get(label, 0.0) + (b - a)
    return sorted(([n, s] for n, s in tot.items()),
                  key=lambda x: -x[1])[:k]


def idle_frac_scan(run):
    p = run.profile
    work = readers.working(run)
    t = sum(b - a for a, b in work)
    busy = sum(max(0.0, min(b, d) - max(a, c))
               for a, b in p.busy() for c, d in work)
    return 1.0 - busy / t


def intervals(rng, n, lo, hi, longest):
    out = []
    for _ in range(n):
        a = rng.uniform(lo - longest, hi)
        out.append((a, a + rng.choice([0.0, rng.uniform(0, longest)])))
    return out


def nested(rng, a, b, depth, labels):
    """Spans inside [a, b], each holding a few shorter ones."""
    out = [(a, b, rng.choice(labels))]
    if depth:
        for _ in range(rng.randint(0, 3)):
            c = rng.uniform(a, b)
            out += nested(rng, c, rng.uniform(c, b), depth - 1, labels)
    return out


def case(seed, n_events=400, n_spans=60):
    rng = random.Random(seed)
    p = Profile(start=1.0, end=9.0)
    p.events = [("k", a, b) for a, b in intervals(rng, n_events, 0.0, 10.0,
                                                  0.05)]
    labels = ["dispatch_step", "finalize_step", "migration"]
    spans = [(a, b, rng.choice(labels))
             for a, b in intervals(rng, n_spans // 2, 0.0, 10.0, 2.0)]
    while len(spans) < n_spans:
        c = rng.uniform(0.0, 10.0)
        spans += nested(rng, c, c + rng.uniform(0, 3.0), 3, labels)
    # equal lengths and shared ends, where ties decide the label
    spans += [(s[0], s[1], "twin") for s in rng.sample(spans, 5)]
    spans += [(p.start, p.start + 1.0, "edge"), (p.end - 1.0, p.end, "edge")]
    rng.shuffle(spans)
    passes = [(a, b, rng.random() < 0.8)
              for a, b in intervals(rng, 80, 0.0, 10.0, 0.5)]
    run = SimpleNamespace(profile=p, passes=passes)
    return p, spans, run


@pytest.mark.parametrize("seed", range(40))
def test_the_sweeps_give_what_the_scans_gave(seed):
    p, spans, run = case(seed)
    old, new = idle_by_host_scan(p, spans, k=100), p.idle_by_host(spans,
                                                                 k=100)
    assert [n for n, _ in new] == [n for n, _ in old]
    assert [s for _, s in new] == pytest.approx([s for _, s in old],
                                                rel=0, abs=1e-12)
    assert readers.idle_frac(run) == pytest.approx(idle_frac_scan(run),
                                                   rel=0, abs=1e-12)


def test_a_gap_takes_the_innermost_span_around_its_middle():
    p = Profile(start=0.0, end=10.0)
    p.events = [("k", 1.0, 2.0), ("k", 4.0, 5.0), ("k", 6.0, 8.0),
                ("k", 8.5, 9.0)]
    spans = [(0.0, 3.0, "outer"), (0.5, 1.5, "inner"),   # gap 0-1: mid .5
             (2.0, 5.0, "b"), (2.5, 3.5, "c"), (3.0, 4.0, "c2"),  # 2-4: 3
             (5.5, 5.7, "starts"),                       # 5-6: 5.5
             (8.0, 8.25, "ends"),                        # 8-8.5: 8.25
             (9.0, 9.49, "before")]                      # 9-10: none
    assert p.idle_by_host(spans) == [["c", 2.0], ["inner", 1.0],
                                     ["starts", 1.0], ["harness loop", 1.0],
                                     ["ends", 0.5]]


def test_a_million_gaps_under_ten_thousand_spans_take_seconds():
    rng = random.Random(7)
    n = 1_000_000
    p = Profile(start=0.0, end=float(n))
    p.events = [("k", i + 0.25, i + 0.75 + 0.1 * rng.random())
                for i in range(n)]
    spans = []
    for i in range(10_000):
        a = rng.uniform(0, n)
        spans.append((a, a + rng.uniform(0, 2_000.0), "dispatch_step"))
    passes = [(a, b, True) for a, b, _ in spans]
    run = SimpleNamespace(profile=p, passes=passes)
    t = time.perf_counter()
    gaps = p.idle_by_host(spans)
    frac = readers.idle_frac(run)
    took = time.perf_counter() - t
    assert sum(s for _, s in gaps) == pytest.approx(
        n - p.busy_s(), rel=1e-9)
    assert 0.0 < frac < 1.0
    assert took < 60.0, took
