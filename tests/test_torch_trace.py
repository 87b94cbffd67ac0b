"""The port's span and counter recorder (``repro_torch.core.trace``) on the
CPU: the tracer's own arithmetic; a cluster hands its tracer to every
instance, later ones too; and on a small dense and a small Mamba-2 cluster
that serve a burst with a migration, a run without a tracer records
nothing and serves the same streams as one with it, spans nest, and each
dispatched step's counters count what the instance itself was given and
holds; and each family's dispatched steps carry their counter names."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import Request  # noqa: E402
from repro_torch.core.trace import Tracer  # noqa: E402
from repro_torch.engine import ArrowEngineCluster  # noqa: E402
from repro_torch.engine.instance import EngineInstance  # noqa: E402

ARCHS = ["qwen3-1.7b", "mamba2-370m"]
# (arrival s, prompt length, output length): prompts of one to three
# 32-token chunks, so steps mix chunks and decode rows
BURST = [(0.0, 20, 6), (0.0, 70, 5), (0.02, 41, 7), (0.05, 9, 4),
         (0.08, 90, 6)]
# the counter names of a dispatched step's instance.dispatch span, by family
# (the harness's span readers and tools/trace_cell.py read them by name)
DENSE_COUNTERS = {"decode_rows", "batch_rows", "prompt_tokens", "kv_tokens",
                  "kv_reserved", "graph_replays", "graph_captures"}
STATE_COUNTERS = {"decode_rows", "batch_rows", "prompt_tokens", "kv_tokens",
                  "kv_reserved", "state_bytes", "state_reserved_bytes",
                  "chunk_calls", "graph_replays", "graph_captures"}


class StepClock:
    def __init__(self):
        self.t = 0.0

    def now(self):
        self.t += 1.0
        return self.t


def test_tracer_nests_counts_and_takes_self_time():
    tr = Tracer(StepClock())
    top = tr.open("a")                                  # t=1
    kid = tr.open("b", key=7)                           # t=2
    kid = tr.next(kid, "c", key=7)                      # b ends, c opens: 3
    assert tr.next(kid, "c") == kid                     # same name: kept
    tr.count(kid, "rows", 2)
    tr.count(kid, "rows", 3)
    tr.close(kid)                                       # 4
    q = tr.record("wait", 0.5, 1.5, key=9)
    tr.close(top)                                       # 5
    assert list(tr.spans()) == [("a", 1, 5, -1, -1), ("b", 2, 3, 0, 7),
                                ("c", 3, 4, 0, 7), ("wait", 0.5, 1.5, -1, 9)]
    assert tr.counts() == {kid: {"rows": 5.0}} and q == 3
    assert tr.self_time(range(len(tr))) == {"a": 2.0, "b": 1.0, "c": 1.0,
                                            "wait": 1.0}
    # a span left open inside a closed one is taken off the stack with it
    o = tr.open("outer")
    tr.open("left open")
    tr.close(o)
    assert tr.open("after") and tr.parents[-1] == -1
    assert math.isnan(tr.ends[o + 1])


@pytest.mark.parametrize("speculate", [0, 2])
def test_cluster_hands_its_tracer_to_every_instance(speculate):
    """Instances built later get the tracer too; a corrupt wire image and
    its re-send nest under one migration; a speculative round is a
    launch like any other."""
    c = ArrowEngineCluster(get_smoke_config("qwen3-1.7b"), n_instances=2,
                           n_slots=2, capacity=64, speculate=speculate,
                           health=True, device="cpu")
    assert c.tracer is None
    assert all(i.tracer is None for i in c.instances.values())
    tr = Tracer(c.clock)
    c.tracer = tr
    c._create_instance(5)                    # elastic scale-up, replacement
    assert all(i.tracer is tr for i in c.instances.values())
    drops = iter([True])
    c.xfer_should_drop = lambda now: next(drops, False)
    h = c.submit(Request(0, arrival=0.0, input_len=20, output_len=6),
                 prompt=np.arange(1, 21, dtype=np.int32))
    c.drain(timeout=60)
    assert h.done and c.health_stats["xfer_retries"] == 1
    assert (c._spec_stats["rounds"] > 0) == bool(speculate)
    spans = list(tr.spans())
    (m,) = [i for i, sp in enumerate(spans) if sp[0] == "migration"]
    assert tr.counts()[m] == {"completed": 1.0}
    assert [spans[k][0] for k in tr.children()[m]] == [
        "migration.land", "migration.export", "migration.checksum",
        "migration.import", "migration.checksum",
        "migration.import", "migration.checksum", "migration.import"]
    assert {"cluster.step", "request.queue", "instance.dispatch",
            "instance.prepare", "instance.launch"} <= set(tr.names)
    c.tracer = None
    assert all(i.tracer is None for i in c.instances.values())


def slot_bytes(cfg):
    """A Mamba-2 slot's state, from its config: the convolution's last
    W-1 inputs and the scan state of every layer, in their dtypes."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    conv = (s.d_conv - 1) * (di + 2 * s.n_groups * s.d_state) \
        * torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    scan = s.n_heads(cfg.d_model) * s.head_dim * s.d_state * 4
    return cfg.n_layers * (conv + scan)


def _serve(arch, traced, mp):
    """The burst on a fresh 1P+1D cluster (weights from one seed); returns
    the cluster, the streams by rid, and what each dispatched step was
    given and left in its instance, in dispatch order."""
    c = ArrowEngineCluster(get_smoke_config(arch), n_instances=2, n_slots=4,
                           capacity=128, chunk_tokens=32, seed=3,
                           device="cpu")
    if traced:
        c.tracer = Tracer(c.clock)
    steps = []
    dispatch = EngineInstance.dispatch_step

    def noted(inst, decode_rids, chunks):
        graph0 = (inst.graph_replays, inst.graph_captures)
        out = dispatch(inst, decode_rids, chunks)
        if out is not None:
            kv = inst.kv
            steps.append({
                "decode_rows": len(decode_rids),
                "batch_rows": kv.n_slots if decode_rids else 0,
                "prompt_tokens": sum(cw.length for cw in chunks),
                "kv_tokens": sum(kv.len_of.get(r, 0) for r in kv.slot_of),
                "kv_reserved": kv.n_slots * inst.capacity,
                "graph_replays": inst.graph_replays - graph0[0],
                "graph_captures": inst.graph_captures - graph0[1]})
            if inst.cfg.family != "dense":
                steps[-1].update({
                    "state_bytes": len(kv.slot_of) * slot_bytes(inst.cfg),
                    "state_reserved_bytes":
                        kv.n_slots * slot_bytes(inst.cfg),
                    "chunk_calls": len(chunks)})
        return out

    mp.setattr(EngineInstance, "dispatch_step", noted)
    rng = np.random.default_rng(11)
    hs = [c.submit(Request(rid, arrival=t, input_len=n, output_len=m),
                   prompt=rng.integers(1, c.cfg.vocab_size, n)
                   .astype(np.int32))
          for rid, (t, n, m) in enumerate(BURST)]
    c.drain(timeout=120)
    mp.undo()
    assert all(h.done for h in hs)
    return c, {h.rid: list(h.tokens) for h in hs}, steps


@pytest.fixture(scope="module")
def runs():
    """Each arch served traced and untraced. One intra-op thread: torch's
    pool stalls on a host whose cores are busy."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            return {a: {t: _serve(a, t, mp) for t in (True, False)}
                    for a in ARCHS}
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("arch", ARCHS)
def test_untraced_run_records_nothing_and_serves_the_same_streams(
        runs, arch):
    (on, s_on, _), (off, s_off, _) = runs[arch][True], runs[arch][False]
    assert off.tracer is None and len(on.tracer) > 0
    assert all(i.tracer is None for i in off.instances.values())
    assert s_on == s_off and all(len(v) == BURST[r][2]
                                 for r, v in s_on.items())
    assert len(on.migration_log) == len(off.migration_log) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_spans_nest_and_close(runs, arch):
    c = runs[arch][True][0]
    tr = c.tracer
    spans = list(tr.spans())
    assert not any(math.isnan(e) for _, _, e, _, _ in spans)
    for n, s, e, p, k in spans:
        assert s <= e
        if p < 0:
            assert n in ("cluster.step", "request.queue")
            continue
        pn, ps, pe, _, pk = spans[p]
        assert ps <= s and e <= pe, (n, pn)
        if n.startswith("step."):
            assert pn == "cluster.step"
        if n.startswith("migration."):
            assert pn == "migration" and k == pk
        if n in ("instance.prepare", "instance.launch"):
            assert pn == "instance.dispatch" and k == pk
        if n == "instance.emit":
            assert pn == "instance.finalize" and k == pk
    kids = tr.children()
    mig = [i for i, (n, *_) in enumerate(spans) if n == "migration"]
    cnt = tr.counts()
    assert len([i for i in mig if cnt.get(i, {}).get("completed")]) == len(
        c.migration_log)
    for i in mig:
        names = [spans[j][0] for j in kids[i]]
        assert names == ["migration.land", "migration.export",
                         "migration.checksum", "migration.import",
                         "migration.checksum", "migration.import"]
    # each request waits once, from its arrival to its first chunk
    waits = [k for n, _, _, _, k in spans if n == "request.queue"]
    assert sorted(waits) == list(range(len(BURST)))


@pytest.mark.parametrize("arch", ARCHS)
def test_step_counters_count_what_the_instance_was_given(runs, arch):
    """Every dispatched step's counters equal its plan (decoding rows,
    chunk tokens) and its instance's slots and KV just after dispatch."""
    c, _, steps = runs[arch][True]
    cnt = c.tracer.counts()
    got = [cnt[i] for i, n in enumerate(c.tracer.names)
           if n == "instance.dispatch" and i in cnt]
    assert got == steps and len(steps) > 0
    assert sum(s["decode_rows"] for s in steps) > 0
    assert sum(s["prompt_tokens"] for s in steps) == sum(
        n for _, n, _ in BURST)


def test_constant_state_counters_sum_to_the_slabs_and_chunks(runs):
    """Over the small Mamba-2 run the new counters add up to the slabs'
    size a step, whole slots' states held, and the chunks the prompts
    need; the dense run has none of them."""
    c = runs["mamba2-370m"][True][0]
    cnt = c.tracer.counts()
    got = [cnt[i] for i, n in enumerate(c.tracer.names)
           if n == "instance.dispatch" and i in cnt]
    per = slot_bytes(c.cfg)
    assert per == 39680                   # 2 x (3 x 288 x 4 + 8 x 32 x 16 x 4)
    assert sum(g["state_reserved_bytes"] for g in got) == \
        len(got) * 4 * per                # 4 slots an instance
    held = sum(g["state_bytes"] for g in got)
    assert held % per == 0 and 0 < held < len(got) * 4 * per
    # a prompt of n tokens takes at least ceil(n / 32) chunks
    assert sum(g["chunk_calls"] for g in got) >= sum(
        -(-n // 32) for _, n, _ in BURST)
    dense = runs["qwen3-1.7b"][True][0].tracer
    assert not any("chunk_calls" in v for v in dense.counts().values())


@pytest.mark.parametrize("arch,names", [
    ("qwen3-1.7b", DENSE_COUNTERS), ("mamba2-370m", STATE_COUNTERS),
    ("recurrentgemma-9b", STATE_COUNTERS)])
def test_dispatch_spans_carry_the_family_counter_names(arch, names):
    """A request served in two chunks, migrated and decoded: every
    dispatched step of a dense, ssm and hybrid cluster carries exactly its
    family's counter names."""
    c = ArrowEngineCluster(get_smoke_config(arch), n_instances=2, n_slots=2,
                           capacity=64, chunk_tokens=32, device="cpu")
    c.tracer = tr = Tracer(c.clock)
    h = c.submit(Request(0, arrival=0.0, input_len=40, output_len=4),
                 prompt=np.arange(1, 41, dtype=np.int32))
    c.drain(timeout=120)
    assert h.done and c.migration_log
    cnt = tr.counts()
    got = [set(cnt[i]) for i, n in enumerate(tr.names)
           if n == "instance.dispatch" and i in cnt]
    assert len(got) > 2 and all(g == names for g in got)
