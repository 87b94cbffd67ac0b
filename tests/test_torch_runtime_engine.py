"""Arrow's runtime mechanisms on the port's engine, held against the JAX
engine on the CPU (``device="cpu"``): crash recovery under a fault plan,
prefix reuse across turns and slot eviction, tenant admission, cross-pool
prefill deflection, the colocated baseline and sim/engine parity, the
invariants step by step, and an elastic scale-up and retirement.

Each test is the counterpart of a JAX engine test (named in its
docstring): the same scenario runs on the port's ``ArrowEngineCluster``
and on the JAX one, with the JAX weights of ``PRNGKey(7)`` carried across
by ``weights.from_jax_params``. It asserts what the JAX test asserts, on
the port's engine (and, where the JAX test compares with the simulator, on
the port's simulator), and equality with the JAX run: token ids exactly,
and the report's decision counters, placements and admission decisions
with ``==`` wherever the scenario makes them independent of wall-clock
time. The port runs on the kernel wrappers (``attn_impl="hopper"``, their
plain versions on the CPU), the JAX side on its reference attention.

``check_invariants`` is the port's copy of ``tests/invariants.py``'s probe,
written for ``repro_torch`` objects; the JAX runs use the original.
"""
import dataclasses
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from invariants import check_invariants as jax_check_invariants  # noqa: E402

from repro import core as J  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.engine import ArrowEngineCluster as JCluster  # noqa: E402
from repro.engine import ServeRequest as JServeRequest  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro_torch import core as T  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.bench.bench_chaos import reference_streams  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.clock import VirtualClock  # noqa: E402
from repro_torch.core.pools import Lifecycle  # noqa: E402
from repro_torch.core.request import RequestState  # noqa: E402
from repro_torch.core.serving import replay_trace  # noqa: E402
from repro_torch.engine import ArrowEngineCluster, EngineInstance  # noqa: E402
from repro_torch.engine import ServeRequest  # noqa: E402
from repro_torch.sim import Simulator  # noqa: E402

SIM_CFG = get_config("gemma-2b")


# ------------------------------------------------- the port's invariant probe


def _fail(runtime, iid, msg):
    life = {i: runtime.pools.lifecycle_of(i).value
            for i in runtime.pools.all_ids()}
    raise AssertionError(f"invariant violated on instance {iid}: {msg} "
                         f"(lifecycles: {life})")


def _expected_kv(runtime, iid, loc) -> int:
    exp = sum(w.input_len for w in loc.prefill_queue.values())
    exp += sum(w.context_len for w in loc.decode_running.values())
    exp += sum(loc.retained.values())
    for rid, kv in runtime._migration_kv.items():
        req = runtime.handles[rid].req
        if req.state is RequestState.MIGRATING and \
                runtime._kv_source(rid) == iid:
            exp += kv
    exp += sum(kv for (_, dst, kv) in runtime._transfers.values()
               if dst == iid)
    return exp


def check_invariants(runtime, *, streams: bool = True) -> None:
    """``tests/invariants.py``'s probe on a ``repro_torch`` runtime: KV
    tokens conserved per instance, no work on a non-ACTIVE instance, sane
    prefix pins, strictly ordered streams of the right length, and no
    negative migration counter."""
    pools = runtime.pools
    strict = isinstance(runtime.clock, VirtualClock)
    for iid in pools.all_ids():
        life = pools.lifecycle_of(iid)
        if life is Lifecycle.FAILED:
            continue
        loc = runtime.local_of(iid)
        if life is Lifecycle.WARMING and (
                loc.prefill_queue or loc.decode_running
                or loc.migration_queue):
            _fail(runtime, iid, "WARMING instance holds work")
        if life in (Lifecycle.RETIRING, Lifecycle.DEGRADED) and \
                loc.migration_queue:
            _fail(runtime, iid,
                  f"{life.value} instance has queued migrations")
        if loc.kv_used < 0:
            _fail(runtime, iid, f"negative kv_used {loc.kv_used}")
        exp = _expected_kv(runtime, iid, loc)
        if loc.kv_used != exp:
            _fail(runtime, iid,
                  f"kv_used {loc.kv_used} != reconstructed {exp}")
    for ids, name in ((pools.prefill_capable(), "prefill_capable"),
                      (pools.decode_capable(), "decode_capable"),
                      (pools.active_ids(), "active_ids")):
        for iid in ids:
            if pools.lifecycle_of(iid) is not Lifecycle.ACTIVE:
                _fail(runtime, iid, f"non-ACTIVE instance in {name}")
    for rid, handle in runtime.handles.items():
        req = handle.req
        if req.state is RequestState.REJECTED:
            if (req.prefill_instance is not None
                    or req.decode_instance is not None
                    or handle.tokens or req.finish_time is not None
                    or handle.rejection is None):
                raise AssertionError(f"rejected rid {rid} holds scheduling "
                                     "state")
            continue
        for attr in ("prefill_instance", "decode_instance"):
            iid = getattr(req, attr)
            if iid is None or req.state is RequestState.FINISHED:
                continue
            if iid in pools.all_ids() and pools.lifecycle_of(iid) in (
                    Lifecycle.WARMING, Lifecycle.FAILED):
                _fail(runtime, iid,
                      f"live rid {rid} ({req.state.value}) points its "
                      f"{attr} at a {pools.lifecycle_of(iid).value} instance")
        if len(handle.tokens) > req.output_len:
            raise AssertionError(f"rid {rid} streamed {len(handle.tokens)} "
                                 f"tokens > output_len {req.output_len}")
        if req.state is RequestState.FINISHED and \
                len(handle.tokens) != req.output_len:
            raise AssertionError(f"rid {rid} finished with "
                                 f"{len(handle.tokens)} tokens, expected "
                                 f"{req.output_len}")
        if streams:
            times = ([req.first_token_time] if req.first_token_time
                     is not None else []) + list(req.token_times)
            for a, b in zip(times, times[1:]):
                if (b < a) or (strict and b <= a):
                    raise AssertionError(f"rid {rid} token times not "
                                         f"ordered: {a} then {b}")
    mgr = runtime.prefix_mgr
    if mgr is not None:
        for iid, lru in mgr._lru.items():
            for rid, entry in lru.items():
                if entry.pins < 0:
                    _fail(runtime, iid, f"entry ({iid},{rid}) pins < 0")
                if entry.doomed:
                    if entry.pins == 0:
                        _fail(runtime, iid, f"doomed unpinned entry "
                                            f"({iid},{rid}) not freed")
                    continue
                if (iid, rid) not in mgr.index.entries:
                    _fail(runtime, iid,
                          f"live entry ({iid},{rid}) missing from the trie")
                if iid not in pools.all_ids() or \
                        pools.lifecycle_of(iid) is Lifecycle.FAILED:
                    _fail(runtime, iid,
                          f"live prefix entry on dead instance ({iid},{rid})")
                got = runtime.local_of(iid).retained.get(rid)
                if got != entry.kv_tokens:
                    _fail(runtime, iid, f"entry ({iid},{rid}) kv "
                                        f"{entry.kv_tokens} != retained {got}")
    for counter, name in ((runtime._kv_outbound, "_kv_outbound"),
                          (runtime._kv_inbound, "_kv_inbound")):
        for iid, v in counter.items():
            if v < 0:
                _fail(runtime, iid, f"{name} negative ({v})")


def test_port_probe_fires_on_corrupted_state(setup):
    """The copy can fail: corrupted KV books and work on a WARMING
    instance are caught, as ``tests/test_invariants.py`` shows for the
    original."""
    sim = Simulator(SIM_CFG, n_instances=2, n_prefill=1,
                    slo=T.SLO(3.0, 0.1))
    replay_trace(sim, [T.Request(0, 0.0, 64, 4)])
    sim.drain()
    check_invariants(sim)
    sim.locals[0].kv_used += 7
    with pytest.raises(AssertionError, match="kv_used"):
        check_invariants(sim)
    sim = Simulator(SIM_CFG, n_instances=2, n_prefill=1,
                    policy="arrow_elastic", slo=T.SLO(3.0, 0.1),
                    autoscaler_cfg=T.AutoScalerConfig(min_instances=2,
                                                      max_instances=6))
    iid = sim.scale_up(T.Pool.PREFILL, 0.0)
    check_invariants(sim)
    sim.locals[iid].enqueue_prefill(99, 32)
    with pytest.raises(AssertionError, match="WARMING"):
        check_invariants(sim)


# ------------------------------------------------------------------ set-up


@pytest.fixture(scope="module")
def setup():
    """(JAX config, JAX params, port config, port params): the weights of
    ``PRNGKey(7)`` on both sides, the JAX side in the non-partitionable
    threefry mode, the port on one intra-op thread (both restored
    afterwards). The port's engines fit their TTFT predictor from a
    wall-clock prefill profile; when other processes hold the test host's
    cores, every parallel region of torch's pool waits for each pool
    thread to be scheduled, and the stalls inflate the profile until the
    deflection gate refuses what the JAX engine deflects."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    jcfg = jax_smoke("qwen3-1.7b")
    jparams = build_model(jcfg).init(jax.random.PRNGKey(7))
    tcfg = get_smoke_config("qwen3-1.7b").replace(attn_impl="hopper")
    tparams = weights.from_jax_params(jax.device_get(jparams), tcfg, "cpu")
    yield jcfg, jparams, tcfg, tparams
    jax.config.update("jax_threefry_partitionable", old)
    torch.set_num_threads(threads)


def clusters(setup, **kw):
    """The same cluster on both packages: (JAX, port). Keyword values that
    are package objects are given as ``(jax_value, port_value)``."""
    jcfg, jparams, tcfg, tparams = setup
    jkw = {k: v[0] if isinstance(v, tuple) else v for k, v in kw.items()}
    tkw = {k: v[1] if isinstance(v, tuple) else v for k, v in kw.items()}
    return (JCluster(jcfg, params=jparams, **jkw),
            ArrowEngineCluster(tcfg, params=tparams, device="cpu", **tkw))


def both(factory):
    """``factory(package)`` for the JAX core and for the port's."""
    return factory(J), factory(T)


def reference_stream(tcfg, tparams, prompt, n_new, sp=None, run_seed=0,
                     rid=0):
    """The fault-free sequential stream of request ``rid`` alone on one
    port instance (greedy unless ``sp``)."""
    return reference_streams(tcfg, tparams, {rid: prompt}, {rid: n_new},
                             "cpu", sampling={rid: sp},
                             run_seed=run_seed)[rid]


def counts(section):
    """A report section's counters without its wall-clock values (seconds
    and the fractions made of them)."""
    return {k: v for k, v in section.items()
            if not (k.endswith("_s") or k.endswith("_frac"))}


#: the fault counters that count decisions; ``kv_tokens_lost`` and
#: ``re_prefill_tokens`` count tokens, which depend on how far each stream
#: had got when the fault fired (a barrier bounds that, it does not fix it)
FAULT_DECISIONS = ("crashes", "slowdowns", "skipped_events",
                   "requests_recovered", "requests_lost",
                   "migrations_aborted", "replacements")


def decided(faults):
    return {k: faults[k] for k in FAULT_DECISIONS}


def tokens(handles):
    return {h.rid: [int(t) for t in h.tokens] for h in handles}


def prompts_of(cfg, seed, n, size):
    rng = np.random.default_rng(seed)
    return {i: rng.integers(1, cfg.vocab_size, size=size).astype(np.int32)
            for i in range(n)}


# ------------------------------------------------------- crash recovery (§8)


def test_drain_raises_instead_of_spinning(setup):
    """tests/test_faults.py::test_engine_drain_raises_instead_of_spinning_
    to_timeout: with the only instance failed, ``drain`` raises an
    ``UndispatchableError`` naming the stranded rid at once."""
    for eng, pkg in zip(clusters(setup, n_instances=1, n_prefill=1,
                                 n_slots=4, capacity=128,
                                 slo=both(lambda p: p.SLO(5.0, 2.0))),
                        (J, T)):
        eng.fail_instance(0, eng.clock.now())
        eng.submit(pkg.Request(rid=5, arrival=0.0, input_len=16,
                               output_len=2))
        t0 = time.perf_counter()
        with pytest.raises(pkg.UndispatchableError, match=r"\[5\]") as ei:
            eng.drain(timeout=300.0)
        assert ei.value.rids == [5]
        assert time.perf_counter() - t0 < 60.0


def barrier_then(system, handles, fire):
    """Step until every request decodes on instance 1 with 2 <= tokens <
    output_len (the JAX tests' state barrier), then ``fire()`` and drain."""
    for _ in range(100000):
        if all(h.req.state.name == "DECODING"
               and h.req.decode_instance == 1
               and 2 <= len(h.tokens) < h.req.output_len for h in handles):
            break
        assert system.step(), "backend drained before the barrier"
    fire()
    return system.drain(timeout=300.0)


def test_fault_parity_at_state_barrier(setup):
    """tests/test_faults.py::test_sim_engine_fault_parity: a crash of
    instance 1 fired through the FaultInjector at the mid-decode barrier
    loses the same requests on the port's simulator and engine and on the
    JAX engine (recovered rids and fault counters with ``==``), and every
    recovered stream is the fault-free greedy one, id for id the JAX
    engine's."""
    _, _, tcfg, tparams = setup
    prompts = prompts_of(tcfg, 2, 3, 24)
    out = {}

    def drive(system, handles, pkg):
        plan = pkg.FaultPlan(events=(pkg.FaultEvent(t=0.0, kind="crash",
                                                    target=1),))
        return barrier_then(system, handles, lambda: pkg.FaultInjector(
            plan, system).poll(system.clock.now()))

    sim = Simulator(SIM_CFG, n_instances=2, n_prefill=1, policy="arrow",
                    slo=T.SLO(5.0, 2.0))
    h_sim = replay_trace(sim, [T.Request(rid=i, arrival=0.0, input_len=24,
                                         output_len=8) for i in range(3)])
    out["sim"] = (drive(sim, h_sim, T), h_sim)
    for eng, pkg, key in zip(clusters(setup, n_instances=2, n_prefill=1,
                                      n_slots=4, capacity=128,
                                      slo=both(lambda p: p.SLO(5.0, 2.0))),
                             (J, T), ("jax", "port")):
        hs = [eng.submit(pkg.Request(rid=i, arrival=0.0, input_len=24,
                                     output_len=8), prompt=prompts[i])
              for i in range(3)]
        out[key] = (drive(eng, hs, pkg), hs)
    for rep, hs in out.values():
        assert rep.n_finished == 3
        assert rep.faults["crashes"] == 1
        assert rep.faults["requests_recovered"] == 3
        assert rep.faults["requests_lost"] == 0
        assert sorted(h.rid for h in hs if h.req.recoveries) == [0, 1, 2]
    assert decided(out["port"][0].faults) == decided(out["jax"][0].faults)
    port = tokens(out["port"][1])
    assert port == tokens(out["jax"][1])
    for rid, got in port.items():
        assert got == reference_stream(tcfg, tparams, prompts[rid], 8), rid


def test_timed_crash_plan_streams_match_reference(setup):
    """tests/test_faults.py::test_chaos_engine_timed_plan_streams_match_
    reference: ``crash@0.1:target=1`` lands wherever the wall clock says
    (a late straggler makes sure the fault poll fires); every stream
    equals the fault-free greedy one and the JAX engine's, the invariants
    hold, and the dead instance leaves the pools."""
    _, _, tcfg, tparams = setup
    prompts = prompts_of(tcfg, 9, 5, 20)
    out_len = {i: 32 for i in range(4)}
    out_len[4] = 4
    runs = {}
    for eng, pkg, key in zip(clusters(
            setup, n_instances=3, n_prefill=1, n_slots=4, capacity=128,
            slo=both(lambda p: p.SLO(5.0, 2.0)),
            fault_plan=both(lambda p: p.FaultPlan.parse(
                "crash@0.1:target=1"))), (J, T), ("jax", "port")):
        hs = [eng.submit(pkg.Request(rid=i, arrival=0.0 if i < 4 else 0.5,
                                     input_len=20, output_len=out_len[i]),
                         prompt=prompts[i]) for i in range(5)]
        rep = eng.drain(timeout=300.0)
        (jax_check_invariants if pkg is J else check_invariants)(eng)
        assert rep.n_finished == 5
        assert rep.faults["crashes"] == 1
        eng.collect_stats(eng.clock.now())
        assert 1 not in eng.instances and 1 not in eng.pools.all_ids()
        runs[key] = tokens(hs)
    assert runs["port"] == runs["jax"]
    for rid, got in runs["port"].items():
        assert got == reference_stream(tcfg, tparams, prompts[rid],
                                       out_len[rid]), rid


# ----------------------------------------------------- prefix reuse (§7)


def tiny_multiturn(pkg):
    """tests/test_prefix.py's two sessions (3 + 2 turns): 3 hits."""
    R = pkg.Request
    return [R(0, 0.00, 40, 3, session_id=0),
            R(1, 0.05, 36, 2, session_id=1),
            R(2, 0.10, 81, 3, session_id=0, parent_rid=0, history_len=43),
            R(3, 0.15, 68, 2, session_id=1, parent_rid=1, history_len=38),
            R(4, 0.20, 104, 2, session_id=0, parent_rid=2, history_len=84)]


def test_multiturn_prefix_hits_and_streams(setup):
    """tests/test_prefix.py::test_sim_engine_parity_multiturn_hits_and_
    streams: the port's simulator and engine and the JAX engine count the
    same 3 cached-prefix hits, and the engine's greedy streams are the
    same with the cache on and off, and the JAX engine's."""
    sim = Simulator(SIM_CFG, n_instances=2, n_prefill=1,
                    slo=T.SLO(5.0, 2.0), prefix_cache=True)
    replay_trace(sim, tiny_multiturn(T))
    rep_sim = sim.drain()
    assert rep_sim.n_finished == 5 and rep_sim.prefix["hits"] == 3
    streams, hits = {}, {}
    for on in (False, True):
        for eng, pkg, key in zip(clusters(
                setup, n_instances=2, n_prefill=1, n_slots=4, capacity=128,
                slo=both(lambda p: p.SLO(5.0, 2.0)), prefix_cache=on),
                (J, T), ("jax", "port")):
            toks = {}
            pkg.replay_trace(eng, tiny_multiturn(pkg),
                             on_token=lambda h, tok, t, toks=toks:
                             toks.setdefault(h.rid, []).append(int(tok)))
            rep = eng.drain(timeout=300.0)
            assert rep.n_finished == 5
            streams[key, on] = toks
            if on:
                hits[key] = rep.prefix
    assert hits["port"]["hits"] == hits["jax"]["hits"] == 3
    assert counts(hits["port"]) == counts(hits["jax"])
    for r in tiny_multiturn(T):
        assert len(streams["port", True][r.rid]) == r.output_len
    assert streams["port", True] == streams["port", False]
    assert streams["port", True] == streams["jax", True]


def test_retained_slot_evicted_under_pressure(setup):
    """tests/test_prefix.py::test_engine_slot_eviction_under_pressure: with
    both slots retained as prefixes, a third request evicts the LRU one
    instead of deadlocking; the prefix counters and streams equal the JAX
    engine's."""
    got = {}
    for eng, pkg, key in zip(clusters(
            setup, n_instances=1, n_prefill=1, n_slots=2, capacity=128,
            slo=both(lambda p: p.SLO(10.0, 5.0)), prefix_cache=True),
            (J, T), ("jax", "port")):
        first = pkg.replay_trace(eng, [
            pkg.Request(0, 0.0, 40, 2, session_id=0),
            pkg.Request(1, 0.0, 40, 2, session_id=1)])
        eng.drain(timeout=300.0)
        inst = eng.instances[0]
        assert len(inst.local.retained) == 2 and not inst.kv.free
        h = eng.submit(pkg.Request(2, 0.0, 40, 2))
        rep = eng.drain(timeout=300.0)
        assert h.done and rep.n_finished == 3
        assert eng.prefix_mgr.stats["evictions"] >= 1
        got[key] = (dict(eng.prefix_mgr.stats), tokens(first + [h]))
    assert got["port"] == got["jax"]


# ----------------------------------------------------- admission (§10)


def test_tenant_admission_decisions(setup):
    """tests/test_tenants.py::test_sim_engine_admission_parity: the same
    ledger (80 credits, 36 a request, no earning) admits two requests and
    rejects four for ``no_credit`` on the port's simulator and engine and
    on the JAX engine; both ledgers end at 8 credits, and the admitted
    requests' streams equal the JAX engine's."""
    def admission(pkg):
        reg = pkg.TenantRegistry([pkg.Tenant("p")], ledger=pkg.CreditLedger(
            pkg.CreditLedgerConfig(initial=80.0, earn_rate=0.0,
                                   debit_rate=0.0)))
        return reg, pkg.AdmissionConfig(low_watermark=-1.0,
                                        high_watermark=1e9,
                                        cost_per_token=1.0,
                                        deadline_scale=0.0)

    def reqs(pkg):
        return [pkg.Request(rid=i, arrival=0.0, input_len=32, output_len=4,
                            tenant_id="p") for i in range(6)]

    def decisions(handles):
        return [(h.rid, h.rejection.reason if h.rejected else "admitted")
                for h in handles]

    want = [(0, "admitted"), (1, "admitted"), (2, "no_credit"),
            (3, "no_credit"), (4, "no_credit"), (5, "no_credit")]
    reg, acfg = admission(T)
    sim = Simulator(SIM_CFG, n_instances=2, n_prefill=1, policy="arrow",
                    slo=T.SLO(5.0, 2.0), tenants=reg, admission=acfg)
    sim_h = [sim.submit(r) for r in reqs(T)]
    sim.drain()
    assert decisions(sim_h) == want
    assert reg.credits("p") == pytest.approx(8.0)
    (jreg, jacfg), (treg, tacfg) = admission(J), admission(T)
    jeng, teng = clusters(setup, n_instances=2, n_prefill=1, n_slots=4,
                          capacity=128, slo=both(lambda p: p.SLO(5.0, 2.0)),
                          tenants=(jreg, treg), admission=(jacfg, tacfg))
    jh = [jeng.submit(r) for r in reqs(J)]
    jeng.drain(timeout=300.0)
    th = [teng.submit(r) for r in reqs(T)]
    teng.drain(timeout=300.0)
    assert decisions(th) == decisions(jh) == want
    assert treg.credits("p") == jreg.credits("p") == pytest.approx(8.0)
    for h in th[:2]:
        assert h.done and len(h.tokens) == 4
    assert tokens(th[:2]) == tokens(jh[:2])
    check_invariants(teng)


# ------------------------------------------------------- deflection (§11)


def _record_placements(system):
    """Wrap the policy's place_prefill to log (rid, instance, deflected)."""
    orig = system.policy.place_prefill
    rec = []

    def place(req, now, prefix_hits=None):
        iid, hit, deflected = orig(req, now, prefix_hits=prefix_hits)
        rec.append((req.rid, iid, deflected))
        return iid, hit, deflected

    system.policy.place_prefill = place
    return rec


def test_deflection_placements_and_stream_identity(setup):
    """tests/test_scheduler.py::test_sim_engine_deflection_parity_and_
    stream_identity: at the state barrier (a pre-charged Eq.(2) backlog of
    1000 s on the prefill instance, the burst dispatched before any step)
    the port's simulator, the port's engine and the JAX engine make the
    same deflected placements and count the same deflection counters, and
    the port's greedy streams are the same with deflection on and off,
    and the JAX engine's."""
    _, _, tcfg, _ = setup
    N, IN, OUT = 6, 24, 6
    prompts = prompts_of(tcfg, 3, N, IN)

    def reqs(pkg):
        return [pkg.Request(rid=i, arrival=0.0, input_len=IN, output_len=OUT)
                for i in range(N)]

    slo = both(lambda p: p.SLO(30.0, 10.0))
    pinned = both(lambda p: p.AutoScalerConfig(min_instances=2,
                                               max_instances=2))
    sim = Simulator(SIM_CFG, n_instances=2, n_prefill=1,
                    policy="arrow_deflect", slo=slo[1],
                    autoscaler_cfg=pinned[1],
                    deflection=T.DeflectionConfig(ratio=0.25))
    sim.policy.prefill_ready_at[0] = 1000.0
    rec_sim = _record_placements(sim)
    for r in reqs(T):
        sim.submit(r)
    rep_sim = sim.drain()

    def engines(ratio):
        out = {}
        for eng, pkg, key in zip(clusters(
                setup, n_instances=2, n_prefill=1, n_slots=4, capacity=128,
                slo=slo, policy="arrow_deflect", autoscaler_cfg=pinned,
                deflection=both(lambda p: p.DeflectionConfig(ratio=ratio))),
                (J, T), ("jax", "port")):
            eng.policy.prefill_ready_at[0] = 1000.0
            rec = _record_placements(eng)
            hs = [eng.submit(r, prompt=prompts[r.rid]) for r in reqs(pkg)]
            rep = eng.drain(timeout=300.0)
            out[key] = (rec, rep, tokens(hs))
        return out

    on = engines(0.25)
    rec_on, rep_on, streams_on = on["port"]
    assert any(d for _, _, d in rec_sim), "barrier never triggered deflection"
    assert rec_sim == rec_on == on["jax"][0], rep_on.deflection
    for key in ("requests_deflected", "tokens_deflected",
                "chunks_executed", "chunk_tokens_executed"):
        assert rep_sim.deflection[key] == rep_on.deflection[key] \
            == on["jax"][1].deflection[key], key
    assert all(iid == 1 for _, iid, d in rec_sim if d)
    off = engines(0.0)
    rec_off, rep_off, streams_off = off["port"]
    assert not rep_off.deflection
    assert not any(d for _, _, d in rec_off)
    assert streams_on == streams_off == on["jax"][2] == off["jax"][2]
    assert rep_on.n_finished == rep_off.n_finished == N


# ------------------------------------- the serving API and the baselines


def tiny_trace(pkg, n, seed):
    rng = np.random.default_rng(seed)
    return [pkg.Request(rid=i, arrival=0.02 * i,
                        input_len=int(rng.integers(8, 48)),
                        output_len=int(rng.integers(2, 6)))
            for i in range(n)]


def test_serve_shim_warns_and_matches_unified_path(setup):
    """tests/test_serving_api.py::test_engine_serve_shim_warns_and_matches_
    unified_path: the deprecated ``serve()`` warns and streams the same
    greedy ids as ``submit()`` + ``drain()``, on the port as on JAX."""
    _, _, tcfg, _ = setup
    rng = np.random.default_rng(42)
    prompts = [rng.integers(1, tcfg.vocab_size, size=n).astype(np.int32)
               for n in (24, 40, 32)]
    outs = (4, 3, 2)
    kw = dict(n_instances=2, n_prefill=1, n_slots=4, capacity=128,
              slo=both(lambda p: p.SLO(5.0, 2.0)))
    served = {}
    for eng, cls, key in zip(clusters(setup, **kw), (JServeRequest,
                                                     ServeRequest),
                             ("jax", "port")):
        reqs = [cls(rid=i, prompt=p, max_new_tokens=m)
                for i, (p, m) in enumerate(zip(prompts, outs))]
        with pytest.deprecated_call():
            served[key] = eng.serve(reqs, timeout=300.0)
    _, eng2 = clusters(setup, **kw)
    handles = [eng2.submit(T.Request(rid=i, arrival=0.0, input_len=len(p),
                                     output_len=m), prompt=p)
               for i, (p, m) in enumerate(zip(prompts, outs))]
    eng2.drain(timeout=300.0)
    for sr, h in zip(served["port"], handles):
        assert sr.req.finish_time is not None and h.done
        assert sr.output_tokens == [t for t in h.tokens if t is not None]
        assert len(sr.output_tokens) == sr.max_new_tokens
    assert [sr.output_tokens for sr in served["port"]] \
        == [sr.output_tokens for sr in served["jax"]]


def test_sim_engine_parity_same_trace(setup):
    """tests/test_serving_api.py::test_sim_engine_parity_same_trace: one
    trace through the port's simulator and engine (and the JAX engine)
    completes, streams every token through the callbacks, and counts the
    same prefill and decode decisions."""
    sim = Simulator(SIM_CFG, n_instances=2, n_prefill=1, slo=T.SLO(5.0, 2.0))
    sim_tokens = {}
    replay_trace(sim, tiny_trace(T, 6, 3), on_token=lambda h, tok, t:
                 sim_tokens.setdefault(h.rid, []).append(t))
    rep_sim = sim.drain()
    out = {}
    for eng, pkg, key in zip(clusters(setup, n_instances=2, n_prefill=1,
                                      n_slots=4, capacity=128,
                                      slo=both(lambda p: p.SLO(5.0, 2.0))),
                             (J, T), ("jax", "port")):
        toks = {}
        hs = pkg.replay_trace(eng, tiny_trace(pkg, 6, 3),
                              on_token=lambda h, tok, t, toks=toks:
                              toks.setdefault(h.rid, []).append(tok))
        rep = eng.drain(timeout=300.0)
        assert all(h.done for h in hs)
        out[key] = (rep, toks)
    rep_eng, eng_tokens = out["port"]
    assert rep_sim.n_finished == rep_eng.n_finished == 6
    decided = lambda rep: (rep.decisions["prefill"],  # noqa: E731
                           rep.decisions["decode"])
    assert decided(rep_sim) == decided(rep_eng) == decided(out["jax"][0])
    for r in tiny_trace(T, 6, 3):
        assert len(sim_tokens[r.rid]) == r.output_len
        assert len(eng_tokens[r.rid]) == r.output_len
        assert all(isinstance(t, int) for t in eng_tokens[r.rid])
    assert eng_tokens == out["jax"][1]


def test_colocated_baseline(setup):
    """tests/test_serving_api.py::test_engine_runs_colocated_baseline: under
    ``colocated`` every request decodes where it was prefilled and nothing
    migrates; the streams and decision counters equal the JAX engine's."""
    out = {}
    for eng, pkg, key in zip(clusters(setup, n_instances=2, n_prefill=1,
                                      n_slots=4, capacity=128,
                                      slo=both(lambda p: p.SLO(5.0, 2.0)),
                                      policy="colocated"),
                             (J, T), ("jax", "port")):
        hs = pkg.replay_trace(eng, tiny_trace(pkg, 4, 1))
        rep = eng.drain(timeout=300.0)
        assert rep.n_finished == 4
        assert all(h.req.decode_instance == h.req.prefill_instance
                   for h in hs)
        assert rep.decisions["migrations"] == 0
        # which instance takes a request follows the wall clock (arrivals
        # 20 ms apart), so placements are not compared across engines
        out[key] = (dict(rep.decisions), tokens(hs))
    assert out["port"] == out["jax"]


def test_invariants_hold_step_by_step(setup):
    """tests/test_invariants.py::test_engine_invariants_hold_step_by_step:
    the port's probe holds after every step of a seeded trace, which
    completes with the JAX engine's streams."""
    rng = np.random.default_rng(5)
    spec = [(0.02 * i, int(rng.integers(8, 48)), int(rng.integers(2, 6)))
            for i in range(6)]
    out = {}
    for eng, pkg, key in zip(clusters(setup, n_instances=2, n_prefill=1,
                                      n_slots=4, capacity=128,
                                      slo=both(lambda p: p.SLO(5.0, 2.0))),
                             (J, T), ("jax", "port")):
        check = jax_check_invariants if pkg is J else check_invariants
        hs = pkg.replay_trace(eng, [pkg.Request(rid=i, arrival=a,
                                                input_len=n, output_len=m)
                                    for i, (a, n, m) in enumerate(spec)])
        deadline = time.time() + 300.0
        while eng.step() and time.time() < deadline:
            check(eng, streams=False)
        check(eng)
        assert eng.report().n_finished == 6
        out[key] = tokens(hs)
    assert out["port"] == out["jax"]


# ------------------------------------------------ elastic scaling (§6)


def test_elastic_spawn_serves_and_retires(setup):
    """``arrow_elastic`` on the engine: at the mid-decode barrier the
    autoscaler, fed one synthetic tick of decode pressure (as the health
    tests feed the HealthMonitor synthetic intervals; the thresholds keep
    every real tick inert), spawns a decode instance that is ACTIVE at once
    (the engine models no warm-up); it takes the residents of instance 1,
    retired at the same barrier, and is retired and destroyed itself once
    drained. Scaling counters, pools, migrations and streams equal the JAX
    engine's, and the streams the fault-free ones."""
    _, _, tcfg, tparams = setup
    prompts = prompts_of(tcfg, 4, 3, 24)
    out = {}
    for eng, pkg, key in zip(clusters(
            setup, n_instances=2, n_prefill=1, n_slots=4, capacity=128,
            slo=both(lambda p: p.SLO(5.0, 2.0)), policy="arrow_elastic",
            autoscaler_cfg=both(lambda p: p.AutoScalerConfig(
                min_instances=1, max_instances=3, prefill_up=1e6,
                decode_up=1e6, down=-1.0, attainment_floor=0.0,
                up_patience=1))),
            (J, T), ("jax", "port")):
        check = jax_check_invariants if pkg is J else check_invariants
        hs = [eng.submit(pkg.Request(rid=i, arrival=0.0, input_len=24,
                                     output_len=8), prompt=prompts[i])
              for i in range(3)]
        n_before = len(eng.instances)

        def fire():
            now = eng.clock.now()
            scaler = eng.autoscaler
            real = scaler.signals
            scaler.signals = lambda t: dataclasses.replace(
                real(t), decode_pressure=1e9)
            scaler.on_monitor_tick(now)
            scaler.signals = real
            assert len(eng.instances) == n_before + 1
            iid = max(eng.instances)
            assert eng.pools.pool_of(iid) is pkg.Pool.DECODE
            assert eng.pools.lifecycle_of(iid) is pkg.Lifecycle.ACTIVE
            eng.begin_retire(1, now)
            check(eng, streams=False)

        rep = barrier_then(eng, hs, fire)
        check(eng)
        spawned = max(eng.instances)
        assert rep.n_finished == 3
        assert all(h.req.decode_instance == spawned for h in hs)
        eng.collect_stats(eng.clock.now())
        assert 1 not in eng.instances and 1 not in eng.pools.all_ids()
        eng.begin_retire(spawned, eng.clock.now())
        eng.collect_stats(eng.clock.now())
        assert spawned not in eng.instances
        scaling = eng.report().scaling
        assert scaling["scale_ups"] == 1 and scaling["scale_downs"] == 0
        out[key] = (spawned, eng.pools.all_ids(),
                    (scaling["scale_ups"], scaling["scale_downs"]),
                    sorted(m["rid"] for m in eng.migration_log), tokens(hs))
    assert out["port"] == out["jax"]
    for rid, got in out["port"][-1].items():
        assert got == reference_stream(tcfg, tparams, prompts[rid], 8), rid


def test_profile_keeps_least_of_repeats_over_capacity(setup, monkeypatch):
    """The repair behind the elastic scale-up on the card: a host-bound
    prefill (27 ms at every length) whose first timed call at each length
    is slower by 7, 6, 4 and 0 ms at 16, 32, 64 and 128 tokens fitted,
    with one timed call a length, a falling line that predicts 0 s for a
    1000-token prompt; ``profile_prefill`` keeps the least of its repeats
    and profiles up to the slot capacity, and predicts the 27 ms."""
    from repro_torch.engine import instance as inst_mod
    _, _, tcfg, tparams = setup
    clock = [0.0]
    calls = {}
    extra = {16: 7e-3, 32: 6e-3, 64: 4e-3}

    def run_prefill(self, rid, prompt, **kw):
        L = len(prompt)
        calls[L] = calls.get(L, 0) + 1
        clock[0] += 0.027 + (extra.get(L, 0.0) if calls[L] == 2 else 0.0)

    monkeypatch.setattr(inst_mod, "time", types.SimpleNamespace(
        perf_counter=lambda: clock[0]))
    monkeypatch.setattr(EngineInstance, "run_prefill", run_prefill)
    monkeypatch.setattr(EngineInstance, "drop", lambda self, rid: None)
    inst = EngineInstance(0, tcfg, tparams, n_slots=1, capacity=128,
                          device="cpu")
    once = T.TTFTPredictor.fit([(L, 0.027 + extra.get(L, 0.0))
                                for L in (16, 32, 64, 128)])
    assert once.predict(1000) == 0.0
    samples = inst.profile_prefill()
    assert samples == [(L, pytest.approx(0.027)) for L in (16, 32, 64, 128)]
    assert T.TTFTPredictor.fit(samples).predict(1000) \
        == pytest.approx(0.027)
    wide = EngineInstance(1, tcfg, tparams, n_slots=1, capacity=1024,
                          device="cpu")
    assert [L for L, _ in wide.profile_prefill()] \
        == [16, 32, 64, 128, 256, 512, 1024]
