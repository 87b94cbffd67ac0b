"""The readers of the program's spans (``arrow_bench/program_spans.py``):
their arithmetic on a hand-made tracer and run; the split of the device's
idle gaps among the spans they cross; and on the tiny cells' traced runs,
with the tracer attached as ``tools/trace_cell.py`` attaches it, every
reader reads, the decode rows count what the harness's ``Dispatch``
records count, and the program's migrations are the harness's."""
import importlib.util
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from arrow_bench import program_spans as ps
from arrow_bench.bench import load_cell
from arrow_bench.harness import run_cell
from arrow_bench.serve import Recorder
from arrow_bench.tests.conftest import make_bench
from arrow_bench.trace import Profile
from repro_torch.core.trace import Tracer

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 11
CELLS = ["tiny-dense.tiny", "tiny-ssm.tiny"]


class Clock:
    t = 0.0

    def now(self):
        return self.t


def _span(tr, clock, name, a, b, key=-1, kids=()):
    """Span ``name`` over [a, b] with ``kids`` (name, a, b) inside it."""
    clock.t = a
    i = tr.open(name, key)
    for n, x, y in kids:
        clock.t = x
        j = tr.open(n, key)
        clock.t = y
        tr.close(j)
    clock.t = b
    tr.close(i)
    return i


def test_readers_on_hand_made_spans():
    clock = Clock()
    tr = Tracer(clock)
    r = [SimpleNamespace(rid=k, due=d) for k, d in
         enumerate([9.0, 10.0, 12.0, 19.0])]
    run = SimpleNamespace(window=(10.0, 20.0), requests=r, spans=[
        (11.0, 13.0, "migration"), (15.0, 15.5, "migration")])
    tr.record("request.queue", 9.0, 10.5, 0)     # due before the window
    tr.record("request.queue", 10.0, 10.25, 1)
    tr.record("request.queue", 12.0, 13.0, 2)    # 3 still queued at 20
    m = _span(tr, clock, "migration", 11.0, 13.0, 1,
              [("migration.land", 11.0, 11.5),
               ("migration.checksum", 11.5, 12.0),
               ("migration.checksum", 12.5, 12.75)])
    tr.count(m, "completed", 1)
    _span(tr, clock, "migration", 15.0, 15.5, 2,          # found no slot
          [("migration.checksum", 15.0, 15.5)])
    for a, b, dec, rows in [(14.0, 14.1, 2, 8), (16.0, 16.3, 0, 0),
                            (25.0, 25.1, 8, 8)]:      # after the close
        d = _span(tr, clock, "instance.dispatch", a, b, 0,
                  [("instance.prepare", a, a + 0.01),
                   ("instance.launch", a + 0.01, b)])
        for k, v in dict(decode_rows=dec, batch_rows=rows,
                         prompt_tokens=64 - 8 * dec, kv_tokens=32,
                         kv_reserved=128).items():
            tr.count(d, k, v)
    _span(tr, clock, "instance.dispatch", 17.0, 17.2, 0)   # nothing ran
    _span(tr, clock, "cluster.step", 18.0, 19.0)
    got = {k: f(run, tr) for k, f in ps.METRICS.items()}
    assert got == pytest.approx({
        "sched.queue_wait_ms": 1e3 * (0.25 + 1.0 + 1.0) / 3,
        "sched.migration_ms": 2000.0,
        "sched.migration_checksum_frac": 0.75 / 2.0,
        "engine.dispatch_ms": 200.0,
        "engine.decode_rows_frac": 0.25})
    info = ps.info(run, tr)
    assert info["migrations"] == [2, 2, 1]
    assert info["migration_s"] == pytest.approx([2.5, 2.5, 2.0])
    assert info["kv_in_use_frac"] == 0.25
    assert info["prompt_tokens_per_step"] == 56
    assert dict(info["self_time_s"])["instance.launch"] == pytest.approx(
        0.09 + 0.29)
    assert "request.queue" not in dict(info["self_time_s"])
    empty = SimpleNamespace(window=(30.0, 40.0), requests=[], spans=[])
    assert all(f(empty, tr) is None for f in ps.METRICS.values())


def test_idle_gaps_are_split_among_the_spans_they_cross():
    p = Profile(start=0.0, end=10.0,
                events=[("k", 1.0, 2.0), ("k", 6.0, 7.0)])
    gaps = ps.idle_gaps(p)
    assert gaps == [(0.0, 1.0), (2.0, 6.0), (7.0, 10.0)]
    spans = [(1.5, 4.0, "a", 0),            # 2..4 of the middle gap
             (3.0, 5.0, "b", 0),            # overlaps a: 4..5 is b's
             (3.5, 3.75, "c", 0),           # inside both: innermost
             (0.0, 9.0, "wrapper", 1),      # ranks after the program's
             (2.5, 2.6, "short", 0)]        # left out below 0.2 s
    split = ps.idle_split(gaps, spans, min_len=0.2)
    # 2..3 a; 3..3.5 b (shorter than a); 3.5..3.75 c; 3.75..5 b; the
    # wrapper 0..1, 5..6 and 7..9; nothing 9..10
    assert split == pytest.approx({"a": 1.0, "b": 1.75, "c": 0.25,
                                   "wrapper": 4.0, "harness loop": 1.0})
    assert sum(split.values()) == pytest.approx(8.0)
    assert ps.clock_skew_us(p, 6.5) == pytest.approx(-0.5e6)
    run = SimpleNamespace(profile=p, spans=[(0.0, 9.0, "wrapper")],
                          dispatches=[1, 2])
    got = ps.idle_by_span(run, None, [(7.0, 8.0)], 6.5)
    assert got["idle_s"] == got["idle_split_s"] == pytest.approx(8.0)
    assert dict(got["idle_gaps"]) == pytest.approx(
        {"wrapper": 6.0, "harness.wait": 1.0, "harness loop": 1.0})
    assert got["kernels_per_step"] == 1.0


def _tool():
    spec = importlib.util.spec_from_file_location(
        "trace_cell", ROOT / "tools" / "trace_cell.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["trace_cell"] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each tiny cell's traced run with the program's tracer attached; the
    harness notes every dispatched step, not only the profiled slice's
    (the CPU has none)."""
    root, bench = make_bench(tmp_path_factory.mktemp("bench"))
    tool = _tool()
    install = Recorder.install

    def note_every_step(self):
        self.recording = True
        return install(self)

    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(Recorder, "install", note_every_step)
            for w in CELLS:
                with tool.attached() as cap:
                    res = run_cell(load_cell(root, w, bench), SEED, 1.5,
                                   True, "cpu", time.perf_counter())
                out[w] = (res, cap)
    finally:
        torch.set_num_threads(threads)
    return out


@pytest.mark.parametrize("workload", CELLS)
def test_readers_read_the_tiny_cells(runs, workload):
    res, cap = runs[workload]
    run, tr = cap["run"], cap["cluster"].tracer
    assert res["correct"] and tr is not None and cap["waits"]
    got = {k: f(run, tr) for k, f in ps.METRICS.items()}
    assert all(v is not None and v >= 0 for v in got.values()), got
    assert 0 < got["sched.migration_checksum_frac"] < 1
    # over every step the harness noted, the program's counters count the
    # rows its ``Dispatch`` records count
    d = run.dispatches
    whole = SimpleNamespace(window=(-math.inf, math.inf))
    assert len(ps.steps(whole, tr)[0]) == len(d) > 0
    assert ps.decode_rows_frac(whole, tr) == pytest.approx(
        sum(len(x.decode_ctx) for x in d)
        / sum(x.n_slots for x in d if x.decode_ctx))
    info = ps.info(run, tr)
    n_prog, n_harness, n_done = info["migrations"]
    s_prog, s_harness, s_done = info["migration_s"]
    assert n_prog == n_harness >= n_done > 0
    # the harness counts the log's entries made while the window is open,
    # these the migrations that start in it: one may straddle the close
    assert abs(n_done - res["info"]["migrations_in_window"]) <= 1
    assert 0 < s_done <= s_prog <= s_harness
    assert 0 < info["kv_in_use_frac"] < 1 and info["spans_per_pass"] > 1
    assert not any(math.isnan(e) for e in tr.ends)
